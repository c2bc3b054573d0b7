"""Sentinel errors of the crawl engine: the port's copy of the
reference's `distributed_crawler_tpu/crawl/errors.py`.

Each has its own recovery in the callers:
- FloodWaitRetireError -> retire the connection; an empty pool aborts
- TDLib400Error        -> the channel is permanently invalid
The reference's ``WalkbackExhaustedError`` belongs to the random walk
(ROADMAP Queue 1 part B).
"""

from __future__ import annotations

from ..clients.errors import is_telegram_400  # re-exported for the engine


class FloodWaitRetireError(Exception):
    """FLOOD_WAIT beyond the retire threshold: the client is retired for
    good."""

    def __init__(self, retry_after_s: int = 0):
        super().__init__(
            f"FLOOD_WAIT {retry_after_s}s exceeds retire threshold: client retired")
        self.retry_after_s = retry_after_s


class TDLib400Error(Exception):
    """The channel is permanently invalid or inaccessible."""


__all__ = [
    "FloodWaitRetireError",
    "TDLib400Error",
    "is_telegram_400",
]

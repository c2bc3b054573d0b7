"""The Telegram client's errors: the port's copy of the reference's
`distributed_crawler_tpu/clients/errors.py`.

FLOOD_WAIT parsing for both the TDLib form ("FLOOD_WAIT_N") and the
HTTP-429 form ("retry after N"), Telegram's 303 DC redirect
(``parse_migrate_dc``, which the native client follows), the 400 test and
the retire threshold.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

# FLOOD_WAITs at or above this many seconds permanently retire the connection
#.
FLOOD_WAIT_RETIRE_THRESHOLD_S = 300


class TelegramError(Exception):
    """An error returned by the Telegram client boundary."""

    def __init__(self, code: int, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


class FloodWaitError(TelegramError):
    """A 429 FLOOD_WAIT with a retry-after duration."""

    def __init__(self, retry_after_s: int):
        super().__init__(429, f"FLOOD_WAIT_{retry_after_s}")
        self.retry_after_s = retry_after_s


_FLOOD_RE = re.compile(r"FLOOD_WAIT_(\d+)")
_RETRY_RE = re.compile(r"retry after (\d+)")


def parse_flood_wait_seconds(err: Optional[BaseException]) -> Tuple[int, bool]:
    """Returns (seconds, is_flood_wait).

    (0, True) means a FLOOD_WAIT whose duration couldn't be parsed — treat as
    a short ban (skip, don't retire).
    """
    if err is None:
        return 0, False
    if isinstance(err, FloodWaitError):
        return err.retry_after_s, True
    s = str(err)
    if "FLOOD_WAIT_" in s:
        m = _FLOOD_RE.search(s)
        return (int(m.group(1)), True) if m else (0, True)
    if "retry after " in s:
        m = _RETRY_RE.search(s)
        return (int(m.group(1)), True) if m else (0, True)
    return 0, False


_MIGRATE_RE = re.compile(r"(?:PHONE|NETWORK|USER)_MIGRATE_(\d+)")


def parse_migrate_dc(err: Optional[BaseException]) -> Optional[int]:
    """Telegram's 303 DC-redirect family (PHONE/NETWORK/USER_MIGRATE_X):
    the target DC id, or None if this is not a migrate error."""
    if err is None:
        return None
    m = _MIGRATE_RE.search(str(err))
    return int(m.group(1)) if m else None


def is_telegram_400(err: Optional[BaseException]) -> bool:
    """Permanently invalid channel detection."""
    if err is None:
        return False
    if isinstance(err, TelegramError) and err.code == 400:
        return True
    s = str(err)
    return ("[400]" in s
            or "400 USERNAME_NOT_OCCUPIED" in s
            or "400 USERNAME_INVALID" in s
            or "no messages found in the chat" in s)

"""Structured logging: tagged JSON or console log lines, and the WARNING+
ring behind ``/logs``.

The reference's `distributed_crawler_tpu/utils/structlog.py`:
`setup_logging` configures the ``"dct"`` logger tree (level, a JSON or
console writer on stderr, ``propagate = False``) and re-attaches the
process-wide `RingHandler`, which keeps the last WARNING+ records as plain
dicts.  ``/logs`` on a worker's metrics port serves the ring and
postmortem bundles carry it (`utils/metrics.logs_snapshot`).  Records
emitted inside a span carry its ``trace_id`` and ``span``.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import trace as _trace

_RESERVED = set(logging.LogRecord("", 0, "", 0, "", (), None).__dict__) | {
    "message", "asctime"}


def _trace_fields() -> Dict[str, str]:
    """trace_id/span of the innermost open span on this thread, if any.
    Explicit extras win (setdefault)."""
    tid = _trace.current_trace_id()
    if not tid:
        return {}
    out = {"trace_id": tid}
    name = _trace.current_span_name()
    if name:
        out["span"] = name
    return out


def _extras(record: logging.LogRecord) -> Dict[str, Any]:
    fields = {k: v for k, v in record.__dict__.items()
              if k not in _RESERVED and not k.startswith("_")}
    for k, v in _trace_fields().items():
        fields.setdefault(k, v)
    return fields


class JsonFormatter(logging.Formatter):
    """One JSON object per line: level, ts (unix), logger, message,
    extras."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "level": record.levelname.lower(),
            "ts": int(time.time()),
            "logger": record.name,
            "message": record.getMessage(),
            **_extras(record),
        }
        if record.exc_info and record.exc_info[0] is not None:
            out["error"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False, default=str)


class ConsoleFormatter(logging.Formatter):
    """Human console writer with inline key=value extras."""

    def format(self, record: logging.LogRecord) -> str:
        extras = " ".join(f"{k}={v}" for k, v in _extras(record).items())
        base = (f"{self.formatTime(record, '%H:%M:%S')} "
                f"{record.levelname:<5} {record.name}: {record.getMessage()}")
        return f"{base} {extras}" if extras else base


_RING_CAPACITY = 256


class RingHandler(logging.Handler):
    """Keep the last ``capacity`` WARNING+ records as plain dicts."""

    def __init__(self, capacity: int = _RING_CAPACITY):
        super().__init__(level=logging.WARNING)
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._ring_lock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry: Dict[str, Any] = {
                "level": record.levelname.lower(),
                "ts": round(record.created, 3),
                "logger": record.name,
                "message": record.getMessage(),
                **_extras(record),
            }
            if record.exc_info and record.exc_info[0] is not None:
                entry["error"] = self.format(record) if self.formatter \
                    else logging.Formatter().formatException(record.exc_info)
            with self._ring_lock:
                self._ring.append(entry)
        except Exception:  # never let telemetry break the caller
            self.handleError(record)

    def snapshot(self, limit: int = 0) -> List[Dict[str, Any]]:
        with self._ring_lock:
            records = list(self._ring)
        if limit and limit > 0:
            records = records[-limit:]
        return records


_ring_handler: Optional[RingHandler] = None
_ring_install_lock = threading.Lock()


def install_ring_handler(capacity: int = _RING_CAPACITY) -> RingHandler:
    """Attach the process-wide WARNING+ ring to the 'dct' logger tree.
    Idempotent: repeat calls return the existing ring (the buffer survives
    `setup_logging` running again)."""
    global _ring_handler
    with _ring_install_lock:
        if _ring_handler is None:
            _ring_handler = RingHandler(capacity)
        logger = logging.getLogger("dct")
        if _ring_handler not in logger.handlers:
            logger.addHandler(_ring_handler)
        return _ring_handler


def uninstall_ring_handler() -> Optional[RingHandler]:
    """Detach the ring from the 'dct' logger tree and forget it; returns
    the detached handler (None when nothing was installed).  Pair with
    `reinstall_ring_handler`: `install_ring_handler` after an uninstall
    starts a fresh empty ring."""
    global _ring_handler
    with _ring_install_lock:
        handler = _ring_handler
        _ring_handler = None
        if handler is not None:
            logging.getLogger("dct").removeHandler(handler)
        return handler


def reinstall_ring_handler(handler: Optional[RingHandler]) -> None:
    """Reattach a handler returned by `uninstall_ring_handler`, records
    intact.  No-op on None, so save/restore composes unconditionally."""
    if handler is None:
        return
    global _ring_handler
    with _ring_install_lock:
        _ring_handler = handler
        logger = logging.getLogger("dct")
        if handler not in logger.handlers:
            logger.addHandler(handler)


def ring_snapshot(limit: int = 0) -> List[Dict[str, Any]]:
    """The ring's records oldest-first ([] before install or when quiet);
    ``limit`` keeps only the newest N.  This is the /logs body."""
    handler = _ring_handler
    if handler is None:
        return []
    return handler.snapshot(limit=limit)


def setup_logging(level: str = "info", json_output: bool = False,
                  stream=None) -> logging.Logger:
    """Configure the 'dct' logger tree; returns the root 'dct' logger."""
    logger = logging.getLogger("dct")
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter() if json_output
                         else ConsoleFormatter())
    logger.addHandler(handler)
    logger.propagate = False
    # handlers.clear() above dropped the ring; re-attach it so /logs keeps
    # its records across a second configuration.
    install_ring_handler()
    return logger

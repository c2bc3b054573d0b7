"""On-demand `torch.profiler` captures, one at a time.

The counterpart of the reference's `distributed_crawler_tpu/utils/
profiling.py`, with `torch.profiler` in place of ``jax.profiler``:

- :class:`ProfileCapture` (``/profile?seconds=N`` on the metrics port, and
  the workers' ``profile_on_slow_ms`` auto capture) profiles the whole
  process for a bounded window — CPU ops, and on a machine with a card the
  CUDA kernels through CUPTI — and writes one
  ``profile_<stamp>_<pid>_<n>/`` directory per capture under the dump
  directory, holding ``trace.json`` from ``export_chrome_trace``.  One
  capture runs at a time (409 for a second); the newest ``max_keep``
  directories are kept.
- :func:`start_profiler_server` has no torch counterpart: torch has no
  trace server a client attaches to.  It logs one WARNING pointing at
  ``/profile`` and returns False, the reference's path for a profiler that
  is unavailable.

The profiler records CPU ops of the threads it sees, so a capture started
from the HTTP or slow-batch thread may miss the feed thread's host ops;
the card's kernels come through CUPTI for the whole process.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("dct.profiling")

DEFAULT_MAX_SECONDS = 60.0   # bound on one /profile capture
DEFAULT_SECONDS = 3.0        # auto-capture window for profile_on_slow_ms
DEFAULT_MAX_KEEP = 8         # capture directories kept under dump_dir
TRACE_FILE = "trace.json"


class ProfileCapture:
    """Guarded one-at-a-time torch.profiler capture to a dump dir."""

    def __init__(self, dump_dir: str = "",
                 max_seconds: float = DEFAULT_MAX_SECONDS,
                 max_keep: int = DEFAULT_MAX_KEEP):
        self._lock = threading.Lock()
        self._active = False
        self.dump_dir = dump_dir
        self.max_seconds = max_seconds
        self.max_keep = max_keep
        self.captures = 0          # completed captures
        self._started = 0          # captures started (names each directory)
        self.last_path = ""

    def configure(self, dump_dir: Optional[str] = None,
                  max_seconds: Optional[float] = None) -> None:
        with self._lock:
            if dump_dir is not None:
                self.dump_dir = dump_dir
            if max_seconds is not None:
                self.max_seconds = max_seconds

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    def capture(self, seconds: float) -> Dict[str, Any]:
        """Run one bounded capture; returns a JSON-safe result map with an
        HTTP-shaped ``code`` (200 ok / 400 bad request / 409 already
        running / 503 profiler unavailable).  Never raises."""
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            return {"ok": False, "code": 400,
                    "error": "seconds must be a number"}
        if not seconds > 0:  # also rejects NaN
            return {"ok": False, "code": 400,
                    "error": "seconds must be > 0"}
        seconds = min(seconds, self.max_seconds)
        if not self.dump_dir:
            return {"ok": False, "code": 503,
                    "error": "no dump dir configured (profile bundles "
                             "need somewhere to land)"}
        with self._lock:
            if self._active:
                return {"ok": False, "code": 409,
                        "error": "a profiler capture is already running "
                                 "(one at a time)"}
            self._active = True
            self._started += 1
            seq = self._started
        path = os.path.join(
            self.dump_dir,
            f"profile_{time.strftime('%Y%m%d%H%M%S', time.gmtime())}"
            f"_{os.getpid()}_{seq}")
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(path, exist_ok=True)
            with profile(activities=activities) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
        except Exception as e:
            # A backend that cannot profile, or a profiler session someone
            # else in the process holds.
            return {"ok": False, "code": 503,
                    "error": f"profiler capture failed: {e}"}
        finally:
            with self._lock:
                self._active = False
        with self._lock:
            self.captures += 1
            self.last_path = path
        self._prune_old()
        logger.info("profiler capture written to %s (%.3g s)", path, seconds)
        from . import flight

        flight.record("profile_capture", path=path, seconds=seconds)
        return {"ok": True, "code": 200, "path": path, "seconds": seconds}

    def capture_async(self, seconds: float = DEFAULT_SECONDS,
                      reason: str = "") -> bool:
        """Fire-and-forget capture (the slow-batch hook); False without
        spawning when one already runs (a stream of slow batches makes one
        capture, not a thread storm) or when no dump dir is set."""
        with self._lock:
            if self._active or not self.dump_dir:
                return False

        def run():
            result = self.capture(seconds)
            if not result.get("ok"):
                logger.warning("auto profiler capture (%s) failed: %s",
                               reason or "slow batch", result.get("error"))
        threading.Thread(target=run, daemon=True,
                         name="profile-capture").start()
        return True

    def _prune_old(self) -> None:
        """Keep the newest ``max_keep`` capture directories: ``/profile``
        is side-effectful, and a dashboard probing it would otherwise fill
        the dump dir.  Best-effort."""
        if self.max_keep <= 0 or not self.dump_dir:
            return
        try:
            captures = sorted(
                e for e in os.listdir(self.dump_dir)
                if e.startswith("profile_")
                and os.path.isdir(os.path.join(self.dump_dir, e)))
            for stale in captures[:-self.max_keep]:
                shutil.rmtree(os.path.join(self.dump_dir, stale),
                              ignore_errors=True)
        except OSError as e:
            logger.debug("profile-capture pruning skipped: %s", e)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"active": self._active, "captures": self.captures,
                    "last_path": self.last_path,
                    "dump_dir": self.dump_dir,
                    "max_seconds": self.max_seconds,
                    "max_keep": self.max_keep}


PROFILER = ProfileCapture()


# Module-level conveniences reading PROFILER at call time, so tests can
# swap it.
def configure(dump_dir: Optional[str] = None,
              max_seconds: Optional[float] = None) -> None:
    PROFILER.configure(dump_dir=dump_dir, max_seconds=max_seconds)


def capture(seconds: float) -> Dict[str, Any]:
    return PROFILER.capture(seconds)


def capture_async(seconds: float = DEFAULT_SECONDS,
                  reason: str = "") -> bool:
    return PROFILER.capture_async(seconds, reason=reason)


def start_profiler_server(port: int) -> bool:
    """torch has no trace server for a client to attach to: log one
    WARNING and return False, as the reference does when its profiler is
    unavailable.  Captures go through ``/profile`` on the metrics port."""
    logger.warning(
        "profiler_port %d: torch has no attachable trace server; use "
        "/profile?seconds=N on the metrics port for a capture", port)
    return False

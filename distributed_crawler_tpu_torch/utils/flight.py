"""Flight recorder: a black box that survives the crash it describes.

The reference's `distributed_crawler_tpu/utils/flight.py`.  A bounded,
thread-safe ring of structured events (batch outcomes, SLO breaches, slow
batches, profiler captures, device stalls, kills, dispatches and alerts)
recorded by the workers and the orchestrator, and on the way down a
**postmortem bundle** — the flight ring, the trace export, the metrics
exposition, the orchestrator's ``/dtraces``, ``/alerts``, ``/tenants``
and ``/autoscaler``, the ``/clusters`` state, the partitioned bus's ``/shards`` table, the
WARNING+ log ring, recent time series and the config fingerprint —
written as one JSON file under the dump directory.
`tools/postmortem.py` renders a bundle.

:func:`install` hooks the exits: chained ``sys.excepthook`` and
``threading.excepthook`` dump a bundle, and ``faulthandler`` writes native
tracebacks to ``<dump_dir>/fatal_signal.log``.  The stall watchdog dumps
before its hard exit.  ``dump()`` is a no-op until a dump directory is
configured, and a capacity of 0 stops recording.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger("dct.flight")

DEFAULT_CAPACITY = 512  # events kept; a dump carries at most this many


class FlightRecorder:
    """Bounded ring of structured events + the postmortem bundle writer."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=max(1, capacity))
        self._enabled = capacity > 0
        self.capacity = capacity
        self.dump_dir = ""
        self._fingerprint: Dict[str, Any] = {}
        self._dumped: Dict[str, float] = {}  # reason -> wall time of dump

    # -- configuration ------------------------------------------------------
    def configure(self, capacity: Optional[int] = None,
                  dump_dir: Optional[str] = None,
                  fingerprint: Optional[Dict[str, Any]] = None) -> None:
        """Resize the ring / set the dump dir / stamp the config
        fingerprint (mode, worker id, key knobs) carried in every bundle."""
        with self._lock:
            if capacity is not None:
                self.capacity = capacity
                self._enabled = capacity > 0
                self._events = deque(self._events, maxlen=max(1, capacity))
            if dump_dir is not None:
                self.dump_dir = dump_dir
            if fingerprint is not None:
                self._fingerprint = dict(fingerprint)

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> None:
        """Append one event; cheap enough for per-dispatch call sites."""
        if not self._enabled:
            return
        event = {"ts": time.time(), "kind": kind, **fields}
        with self._lock:
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._dumped.clear()

    # -- postmortem ---------------------------------------------------------
    def bundle(self, reason: str, error: str = "") -> Dict[str, Any]:
        """The postmortem payload: everything a dead process can no longer
        serve over HTTP, in one JSON-safe dict."""
        from . import trace as _trace
        from .metrics import REGISTRY

        try:
            traces = _trace.TRACER.export()
        except Exception as e:  # a corrupt ring must not block the dump
            traces = {"error": str(e)}
        try:
            metrics = REGISTRY.expose()
        except Exception as e:
            metrics = f"# exposition failed: {e}"
        bundle = {
            "schema": "dct-postmortem-v1",
            "reason": reason,
            "error": error,
            "written_at": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "config": dict(self._fingerprint),
            "flight": self.events(),
            "traces": traces,
            "metrics": metrics,
        }
        # The orchestrator's assembled distributed traces, alert log,
        # autoscaler decisions and tenant ledger: a dead coordinator's
        # /dtraces, /alerts, /autoscaler and /tenants can no longer be
        # scraped.
        from .metrics import alerts_snapshot, autoscaler_snapshot, \
            dtraces_snapshot, tenants_snapshot

        for key, snap in (("dtraces", dtraces_snapshot),
                          ("alerts", alerts_snapshot),
                          ("autoscaler", autoscaler_snapshot),
                          ("tenants", tenants_snapshot)):
            body = snap()
            if body is not None:
                bundle[key] = body
        # The cluster worker's state: whether the centroid model was
        # healthy when the process died.
        from .metrics import clusters_snapshot

        clusters = clusters_snapshot()
        if clusters is not None:
            bundle["clusters"] = clusters
        # The partitioned bus's shard table: which shard was dead or
        # parked, and how deep its outbox ran, when the process went down.
        from .metrics import shards_snapshot

        shards = shards_snapshot()
        if shards is not None:
            bundle["bus_shards"] = shards
        # The structured-log ring: the last WARNING+ records before the
        # crash, even when stderr scrolled away.
        from .metrics import logs_snapshot

        logs = logs_snapshot()
        if logs is not None:
            bundle["logs"] = logs
        try:
            from . import timeseries as _timeseries

            # Bounded like the flight/span rings: only the last few
            # minutes of history — a long-lived fleet's full store
            # would balloon the crash-path write, and the renderer
            # shows the pre-crash trend, not the epoch.
            ts = _timeseries.STORE.snapshot(since_s=180.0)
            if ts.get("series"):
                bundle["timeseries"] = ts
        except Exception as e:
            logger.debug("timeseries bundle capture failed: %s", e)
        return bundle

    def dump(self, reason: str, error: str = "",
             dump_dir: str = "") -> Optional[str]:
        """Write the bundle; returns the path, or None when no dump dir is
        configured / the write fails (a postmortem must never raise into
        the crash path that triggered it).  Per-reason dedup: an exception
        that unwinds through both ``threading.excepthook`` and the SIGTERM
        teardown produces ONE bundle, not a cascade."""
        target = dump_dir or self.dump_dir
        if not target:
            return None
        with self._lock:
            if reason in self._dumped:
                return None
            self._dumped[reason] = time.time()
        try:
            os.makedirs(target, exist_ok=True)
            stamp = time.strftime("%Y%m%d%H%M%S", time.gmtime())
            path = os.path.join(
                target, f"postmortem_{stamp}_{os.getpid()}_{reason}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.bundle(reason, error=error), f,
                          ensure_ascii=False, default=str)
            os.replace(tmp, path)  # atomic: no half-written bundles
        except Exception as e:
            logger.error("postmortem dump failed: %s", e)
            return None
        logger.warning("postmortem bundle written", extra={
            "path": path, "reason": reason})
        return path


RECORDER = FlightRecorder()

# Module-level conveniences bound to the process-wide recorder.
record = RECORDER.record
configure = RECORDER.configure
dump = RECORDER.dump

_installed = False
_fault_log = None  # keep the faulthandler file object referenced


def install(dump_dir: str, recorder: FlightRecorder = RECORDER) -> None:
    """Arm the crash hooks: excepthooks dump a JSON bundle; faulthandler
    covers fatal signals with a native-traceback file.  Idempotent —
    installing twice (orchestrator + an embedded worker) chains once."""
    global _installed, _fault_log
    recorder.configure(dump_dir=dump_dir)
    if _installed:
        return
    _installed = True

    prev_sys = sys.excepthook

    def _sys_hook(exc_type, exc, tb):
        recorder.dump("unhandled_exception",
                      error=f"{exc_type.__name__}: {exc}")
        prev_sys(exc_type, exc, tb)

    sys.excepthook = _sys_hook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        if args.exc_type is not SystemExit:
            recorder.dump(
                "unhandled_exception",
                error=f"{args.exc_type.__name__}: {args.exc_value} "
                      f"(thread {getattr(args.thread, 'name', '?')})")
        prev_thread(args)

    threading.excepthook = _thread_hook

    try:
        import faulthandler

        os.makedirs(dump_dir, exist_ok=True)
        _fault_log = open(os.path.join(dump_dir, "fatal_signal.log"), "a",
                          encoding="utf-8")
        faulthandler.enable(file=_fault_log)
    except Exception as e:  # faulthandler is best-effort armor
        logger.warning("faulthandler arming failed: %s", e)

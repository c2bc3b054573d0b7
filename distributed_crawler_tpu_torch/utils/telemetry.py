"""Telemetry snapshots: what a heartbeat carries beyond "alive".

The reference's `distributed_crawler_tpu/utils/telemetry.py`, with the
device half read from the card: a cheap, never-raising snapshot of the
process and the device —

- process RSS (``/proc/self/statm``; peak RSS elsewhere);
- the card's memory per device (`device_memory_stats`), read from the
  caching allocator only once the process has initialised CUDA: a
  heartbeat never creates a CUDA context and never synchronises the
  device;
- first-dispatch deltas from the engine's ``compile_cache_stats()``;
- the engine's rolling efficiency window (MFU, goodput, padding density)
  and device occupancy, when the engine has them;
- labelled-counter values (batch outcomes by ok/error/requeued);
- a per-stage latency digest over the spans finished since the previous
  snapshot.

The snapshot is a nested dict of JSON-safe scalars, so it rides a
`StatusMessage` unchanged into the reference's fleet view.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from . import trace as _trace

logger = logging.getLogger("dct.telemetry")

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def process_rss_bytes() -> int:
    """Resident set size of this process; 0 when unknowable."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    try:  # macOS/BSD fallback: peak RSS (bytes on mac, KiB elsewhere)
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except (ImportError, OSError, AttributeError, ValueError):
        return 0


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card memory from the caching allocator; [] until the process
    has initialised CUDA (and on a machine without a card).

    ``bytes_in_use`` and ``peak_bytes_in_use`` are the allocator's
    ``allocated_bytes.all.current`` / ``.peak`` (what
    ``torch.cuda.memory_allocated`` reads), ``bytes_limit`` the card's
    total memory.  Reading them neither creates a context nor waits on the
    device, so a heartbeat never stalls behind a running kernel."""
    import torch

    if not torch.cuda.is_initialized():
        return []
    out: List[Dict[str, Any]] = []
    try:
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            out.append({
                "device": f"cuda:{i}",
                "bytes_in_use": int(stats.get(
                    "allocated_bytes.all.current", 0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory),
                "peak_bytes_in_use": int(stats.get(
                    "allocated_bytes.all.peak", 0)),
            })
    except Exception as e:  # a failing query must not break heartbeats
        logger.debug("device memory stats unavailable: %s", e)
        return []
    return out


class TelemetryEmitter:
    """Stateful snapshot source: one per heartbeat loop.

    Statefulness is what turns cumulative counters into the *deltas* the
    fleet view wants ("did compiles happen since the last heartbeat?"),
    and bounds the latency digest to spans completed since the previous
    snapshot instead of re-digesting the whole ring forever.
    """

    def __init__(self, engine=None, counters: Optional[Dict[str, Any]] = None,
                 include_device: bool = False, tracer=None):
        """``engine`` is anything with ``compile_cache_stats()``;
        ``counters`` maps a telemetry key to a labeled
        `utils.metrics.Counter` whose per-label values are reported (e.g.
        ``{"batch_outcomes": worker.m_outcomes}``)."""
        self.engine = engine
        self.counters = dict(counters or {})
        self.include_device = include_device
        self.tracer = tracer or _trace.TRACER
        self._lock = threading.Lock()
        self._last_wall = 0.0
        self._last_compile_misses: Optional[float] = None

    def snapshot(self) -> Dict[str, Any]:
        """One heartbeat's worth of telemetry; never raises."""
        try:
            return self._snapshot()
        except Exception as e:  # telemetry must never break a heartbeat
            logger.debug("telemetry snapshot degraded: %s", e)
            return {"rss_bytes": process_rss_bytes()}

    def _snapshot(self) -> Dict[str, Any]:
        now = time.time()
        with self._lock:
            since, self._last_wall = self._last_wall, now
        out: Dict[str, Any] = {
            "rss_bytes": process_rss_bytes(),
            "py_threads": threading.active_count(),
        }
        if self.include_device:
            mem = device_memory_stats()
            if mem:
                out["device_memory"] = mem
        if self.engine is not None:
            stats_fn = getattr(self.engine, "compile_cache_stats", None)
            if callable(stats_fn):
                stats = dict(stats_fn())
                misses = float(stats.get("misses_total", 0.0))
                with self._lock:
                    prev = self._last_compile_misses
                    self._last_compile_misses = misses
                stats["misses_delta"] = \
                    misses - prev if prev is not None else misses
                out["compile_cache"] = stats
            eff_fn = getattr(self.engine, "efficiency_snapshot", None)
            if callable(eff_fn):
                # Rolling MFU/goodput/padding-density from the engine's
                # EfficiencyMeter (`utils/costmodel.py`) — {} until the
                # first batch, so idle workers don't heartbeat zeros.
                eff = eff_fn()
                if eff:
                    out["efficiency"] = eff
            occ_fn = getattr(self.engine, "occupancy_snapshot", None)
            if callable(occ_fn):
                # Device occupancy (`utils/occupancy.py`): busy/overlap
                # fractions + bubble accounting.  This per-beat call is
                # ALSO what keeps the occupancy gauges fresh on plain
                # /metrics scrapes — the hot path records intervals but
                # never derives (O(1) by design).
                occ = occ_fn()
                if occ:
                    out["occupancy"] = occ
        for key, counter in self.counters.items():
            series = getattr(counter, "series", None)
            if not callable(series):
                continue
            values: Dict[str, float] = {}
            for labels, value in series():
                if not labels:
                    continue  # the unlabeled parent is the redundant total
                values["|".join(str(v) for v in labels.values())] = value
            out[key] = values
        digest = _trace.latency_digest(self.tracer.spans(), since_wall=since)
        if digest:
            out["latency_ms"] = digest
        return out

"""TraceCollector: assemble ONE distributed trace from many span rings.

The port's copy of the reference's `distributed_crawler_tpu/orchestrator/
tracecollect.py`.  Each process's ``/traces`` shows only its own spans;
the collector joins them:

- the serving workers ship completed spans as `SpanBatchMessage`s on
  ``TOPIC_SPANS`` (`utils/trace.SpanExporter`);
- the orchestrator folds them here, keyed by ``trace_id``, with every
  remote span's ``start_wall`` moved onto the collector's clock by the
  worker's offset from `orchestrator/fleet.FleetView.clock_offsets`
  (heartbeat receive − send walls, min-magnitude sample); a worker that
  has not heartbeated yet falls back to its span batches' own
  ``sent_wall``;
- the collector's own process's spans (the dispatch and handle_result
  legs) merge in at export, deduplicated by span id;
- served as JSON at ``/dtraces`` (`utils/metrics.set_dtraces_provider`)
  and embedded in postmortem bundles.

Bounded: at most ``MAX_TRACES`` traces (LRU by last update) and
``MAX_SPANS_PER_TRACE`` spans each, with drop counters.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from ..bus.messages import SpanBatchMessage
from ..utils import trace as _trace
from ..utils.metrics import REGISTRY

logger = logging.getLogger("dct.tracecollect")

MAX_TRACES = 512
MAX_SPANS_PER_TRACE = 512
# The lane this process's own merged spans are exported under.
PROCESS = "orchestrator"


class _TraceBucket:
    """One assembled trace: spans keyed by span_id (dedup across bus
    redelivery AND the local-merge path in a single-process test rig)."""

    __slots__ = ("spans", "processes", "last_update", "dropped")

    def __init__(self):
        self.spans: Dict[str, Dict[str, Any]] = {}
        self.processes: set = set()
        self.last_update = 0.0
        self.dropped = 0


class TraceCollector:
    """Thread-safe fold of SpanBatchMessages into distributed traces."""

    def __init__(self,
                 offsets_fn: Optional[Callable[[], Dict[str, float]]] = None):
        """``offsets_fn`` returns {worker_id: clock_offset_s} — normally
        `FleetView.clock_offsets` (receiver − sender, seconds to ADD to a
        sender wall to land on the collector's clock)."""
        self.offsets_fn = offsets_fn
        self.tracer = _trace.TRACER
        self.max_traces = MAX_TRACES
        self.max_spans_per_trace = MAX_SPANS_PER_TRACE
        registry = REGISTRY
        self._mu = threading.Lock()
        self._traces: "OrderedDict[str, _TraceBucket]" = OrderedDict()
        # Per-worker state: min-estimator offset from sent_wall (the
        # fallback when the fleet has no heartbeat offset yet) + export
        # accounting for the /dtraces "workers" map.
        self._workers: Dict[str, Dict[str, Any]] = {}
        self.m_spans = registry.counter(
            "dtrace_spans_total",
            "spans folded into the distributed-trace collector, by "
            "exporting worker")
        self.m_dropped = registry.counter(
            "dtrace_spans_dropped_total",
            "spans reported dropped by exporters plus spans the "
            "collector's own bounds rejected")
        self.m_traces = registry.gauge(
            "dtrace_assembled_traces",
            "distributed traces currently held by the collector")

    # -- offset estimation ---------------------------------------------------
    def _offset_for(self, worker_id: str, sent_wall: float,
                    now: float) -> float:
        """Seconds to add to this worker's walls.  Fleet heartbeat
        estimate wins; the span batch's own send/receive pair keeps a
        running min-estimator as fallback (same transit-bias argument)."""
        fleet = {}
        if self.offsets_fn is not None:
            try:
                fleet = self.offsets_fn() or {}
            except Exception as e:  # a wedged fleet view must not drop spans
                logger.warning("fleet clock-offset read failed: %s", e)
        state = self._workers.setdefault(worker_id, {
            "own_offset_s": None, "spans": 0, "batches": 0, "dropped": 0,
            "last_export_wall": 0.0})
        if sent_wall > 0:
            sample = now - sent_wall
            prev = state["own_offset_s"]
            # min by magnitude: transit time inflates |recv - send|
            # whichever side of zero the true offset is on.
            if prev is None or abs(sample) < abs(prev):
                state["own_offset_s"] = sample
        if worker_id in fleet:
            return float(fleet[worker_id])
        return float(state["own_offset_s"] or 0.0)

    # -- folding -------------------------------------------------------------
    def observe(self, msg: SpanBatchMessage,
                now: Optional[float] = None) -> int:
        """Fold one span batch; returns the number of spans accepted."""
        now = now if now is not None else time.time()
        accepted = 0
        with self._mu:
            offset = self._offset_for(msg.worker_id, msg.sent_wall, now)
            state = self._workers[msg.worker_id]
            state["batches"] += 1
            state["dropped"] += int(msg.dropped)
            state["last_export_wall"] = now
            state["applied_offset_s"] = round(offset, 6)
            for row in msg.spans:
                tid = row.get("trace_id")
                sid = row.get("span_id")
                if not tid or not sid:
                    continue
                bucket = self._traces.get(tid)
                if bucket is None:
                    bucket = self._traces[tid] = _TraceBucket()
                    while len(self._traces) > self.max_traces:
                        self._traces.popitem(last=False)  # LRU evict
                if len(bucket.spans) >= self.max_spans_per_trace \
                        and sid not in bucket.spans:
                    bucket.dropped += 1
                    self.m_dropped.inc()
                    continue
                corrected = dict(row)
                corrected["start_wall"] = \
                    float(row.get("start_wall") or 0.0) + offset
                corrected["process"] = msg.worker_id
                corrected["clock_offset_s"] = round(offset, 6)
                bucket.spans[sid] = corrected
                bucket.processes.add(msg.worker_id)
                bucket.last_update = now
                self._traces.move_to_end(tid)
                accepted += 1
            state["spans"] += accepted
        if accepted:
            self.m_spans.labels(worker=msg.worker_id).inc(accepted)
        if msg.dropped:
            self.m_dropped.inc(msg.dropped)
        with self._mu:
            self.m_traces.set(float(len(self._traces)))
        return accepted

    # -- export --------------------------------------------------------------
    def _local_spans_by_trace(self) -> Dict[str, List[Dict[str, Any]]]:
        out: Dict[str, List[Dict[str, Any]]] = {}
        for s in self.tracer.spans():
            row = s.to_dict()
            row["process"] = PROCESS
            row["clock_offset_s"] = 0.0
            out.setdefault(s.trace_id, []).append(row)
        return out

    def export(self, limit: int = 0) -> Dict[str, Any]:
        """The ``/dtraces`` JSON body: assembled traces (remote spans
        offset-corrected + this process's own spans merged in, deduped by
        span id), most recently updated first."""
        local = self._local_spans_by_trace()
        with self._mu:
            items = [(tid, b) for tid, b in self._traces.items()]
            workers = {w: dict(st) for w, st in self._workers.items()}
        traces = []
        for tid, bucket in reversed(items):  # newest update first
            spans = dict(bucket.spans)
            for row in local.get(tid, []):
                spans.setdefault(row["span_id"], row)
            rows = sorted(spans.values(),
                          key=lambda r: r.get("start_wall", 0.0))
            processes = sorted(bucket.processes
                               | ({PROCESS} if local.get(tid) else set()))
            start = min((r.get("start_wall", 0.0) for r in rows),
                        default=0.0)
            end = max((r.get("start_wall", 0.0)
                       + r.get("duration_ms", 0.0) / 1000.0 for r in rows),
                      default=0.0)
            traces.append({
                "trace_id": tid,
                "span_count": len(rows),
                "processes": processes,
                "duration_ms": round((end - start) * 1000.0, 3),
                "dropped_spans": bucket.dropped,
                "spans": rows,
            })
            if limit and len(traces) >= limit:
                break
        return {
            "traces": traces,
            "collector_process": PROCESS,
            "workers": workers,
            "max_traces": self.max_traces,
        }

    def reset(self) -> None:
        with self._mu:
            self._traces.clear()
            self._workers.clear()
        self.m_traces.set(0.0)

"""FleetView: fold heartbeats into one queryable picture of every worker.

The port's copy of the reference's `distributed_crawler_tpu/orchestrator/
fleet.py`.  The orchestrator's `WorkerInfo` registry keeps what work
distribution needs (status, last_seen, queue_length); this fold keeps the
telemetry-rich heartbeats (`utils/telemetry.py`) per worker, with
history:

- last accepted heartbeat + the full ``resource_usage`` telemetry map
  (card memory, MFU, latency stages, batch outcomes);
- a bounded status-history ring of (timestamp, status, queue_length)
  transitions;
- rates derived from task-counter deltas between consecutive heartbeats;
- an out-of-order guard: a heartbeat older than the newest accepted one
  is counted (``stale_dropped``) but never regresses ``last_seen`` or
  the rates;
- a clock-offset estimate per worker (receive − send wall, the
  min-magnitude sample of recent beats), which the trace collector adds
  to the worker's span walls;
- labeled fleet gauges (`fleet_worker_queue_length{worker_id=…}`,
  `fleet_worker_device_mem_bytes{worker_id=…,kind=…}`, …) and the
  ``fleet_stale_workers`` staleness rollup, computed at read time.

Served as JSON at ``/cluster`` (`utils/metrics.set_cluster_provider`).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Deque, Dict, Optional, Tuple

from ..bus.messages import (
    MSG_WORKER_STOPPING,
    StatusMessage,
    WORKER_OFFLINE,
)
from ..state.datamodels import utcnow
from ..utils.metrics import REGISTRY, MetricsRegistry

DEFAULT_HISTORY = 64  # status transitions kept per worker
# Heartbeat silence (s) past which a worker counts as stale: the
# reference's default, and the orchestrator's worker timeout.
STALE_AFTER_S = 300.0


@dataclass
class WorkerTrack:
    """Everything FleetView knows about one worker."""

    worker_id: str
    worker_type: str = "crawl"
    status: str = ""
    first_seen: Optional[datetime] = None
    last_seen: Optional[datetime] = None
    current_work: Optional[str] = None
    queue_length: int = 0
    tasks_processed: int = 0
    tasks_success: int = 0
    tasks_error: int = 0
    uptime_s: float = 0.0
    heartbeats: int = 0
    stale_dropped: int = 0     # out-of-order heartbeats ignored
    telemetry: Dict[str, Any] = field(default_factory=dict)
    # Estimated sender-clock offset (receiver wall − heartbeat send wall,
    # seconds): the min-|sample| over recent beats, because bus transit
    # only ever inflates |recv − send| — the smallest-magnitude sample is
    # the closest to the true skew.  The TraceCollector adds this to a
    # worker's span walls to land them on the orchestrator's clock.
    clock_offset_s: float = 0.0
    offset_samples: Deque[float] = field(
        default_factory=lambda: deque(maxlen=16))
    # (iso_ts, status, queue_length) ring — appended on CHANGE, not on
    # every beat, so a stable worker's history is its life story, not noise.
    history: Deque[Tuple[str, str, int]] = field(
        default_factory=lambda: deque(maxlen=DEFAULT_HISTORY))
    # task-counter deltas between consecutive accepted heartbeats
    tasks_per_s: float = 0.0
    errors_per_s: float = 0.0


class FleetView:
    """Thread-safe heartbeat fold; the data behind ``/cluster``."""

    def __init__(self, registry: MetricsRegistry = REGISTRY,
                 stale_after_s: float = STALE_AFTER_S):
        self.stale_after_s = stale_after_s
        self._mu = threading.Lock()
        self._workers: Dict[str, WorkerTrack] = {}
        self.m_queue = registry.gauge(
            "fleet_worker_queue_length",
            "per-worker queue length from the last heartbeat")
        self.m_devmem = registry.gauge(
            "fleet_worker_device_mem_bytes",
            "per-worker device memory (kind=in_use|limit|peak, summed "
            "over the worker's devices)")
        self.m_rss = registry.gauge(
            "fleet_worker_rss_bytes", "per-worker process RSS")
        self.m_mfu = registry.gauge(
            "fleet_worker_mfu",
            "per-worker rolling MFU from the last heartbeat's efficiency "
            "telemetry (utils/costmodel.py)")
        self.m_goodput = registry.gauge(
            "fleet_worker_goodput_tokens_per_s",
            "per-worker rolling real-token throughput from the last "
            "heartbeat")
        self.m_stale = registry.gauge(
            "fleet_stale_workers",
            "workers whose last heartbeat is older than the timeout")
        # Staleness is a function of NOW, not of the last health tick: a
        # stored gauge refreshed every health_interval_s would let a
        # /metrics (or /cluster) scrape between ticks report a worker
        # healthy after its heartbeat deadline had already lapsed.  The
        # fn-bound gauge recomputes at every read.
        self.m_stale.set_fn(self.stale_count)

    # -- folding -------------------------------------------------------------
    def observe(self, msg: StatusMessage,
                now: Optional[datetime] = None) -> bool:
        """Fold one heartbeat; returns False when it was dropped as
        out-of-order (older than the newest accepted beat)."""
        now = now or utcnow()
        ts = msg.timestamp or now
        with self._mu:
            track = self._workers.get(msg.worker_id)
            if track is None:
                track = WorkerTrack(worker_id=msg.worker_id, first_seen=ts)
                self._workers[msg.worker_id] = track
            if track.last_seen is not None and ts < track.last_seen:
                track.stale_dropped += 1
                return False
            status = (WORKER_OFFLINE
                      if msg.message_type == MSG_WORKER_STOPPING
                      else msg.status)
            prev_seen, prev_tasks, prev_errors = (
                track.last_seen, track.tasks_processed, track.tasks_error)
            if status != track.status or \
                    msg.queue_length != track.queue_length:
                track.history.append(
                    (ts.isoformat(), status, msg.queue_length))
            track.worker_type = msg.worker_type or track.worker_type
            track.status = status
            track.last_seen = ts
            track.current_work = msg.current_work
            track.queue_length = msg.queue_length
            track.tasks_processed = msg.tasks_processed
            track.tasks_success = msg.tasks_success
            track.tasks_error = msg.tasks_error
            track.uptime_s = msg.uptime_s
            track.heartbeats += 1
            if msg.timestamp is not None:
                # Clock-offset sample: this beat's receive − send wall.
                track.offset_samples.append(
                    (now - msg.timestamp).total_seconds())
                track.clock_offset_s = min(track.offset_samples, key=abs)
            if msg.resource_usage:
                track.telemetry = msg.resource_usage
            if prev_seen is not None:
                dt = (ts - prev_seen).total_seconds()
                if dt > 0:
                    d_tasks = msg.tasks_processed - prev_tasks
                    d_errors = msg.tasks_error - prev_errors
                    if d_tasks < 0 or d_errors < 0:
                        # Counter regression = the worker restarted under
                        # the same id; its fresh counts ARE the delta
                        # since restart (a raw difference would show a
                        # large negative rate until the next beat).
                        d_tasks, d_errors = (msg.tasks_processed,
                                             msg.tasks_error)
                    track.tasks_per_s = round(d_tasks / dt, 4)
                    track.errors_per_s = round(d_errors / dt, 4)
            # Gauges update inside the fold lock: two concurrently
            # delivered beats for one worker are serialized here, so the
            # gauge can never keep the older beat's values while the
            # JSON fold shows the newer (gauge locks nest fine — nothing
            # takes _mu while holding one).
            self._update_gauges(msg)
        return True

    def _update_gauges(self, msg: StatusMessage) -> None:
        wid = msg.worker_id
        self.m_queue.labels(worker_id=wid).set(float(msg.queue_length))
        usage = msg.resource_usage or {}
        rss = usage.get("rss_bytes")
        if isinstance(rss, (int, float)):
            self.m_rss.labels(worker_id=wid).set(float(rss))
        efficiency = usage.get("efficiency")
        if isinstance(efficiency, dict):
            mfu = efficiency.get("mfu")
            if isinstance(mfu, (int, float)):
                self.m_mfu.labels(worker_id=wid).set(float(mfu))
            goodput = efficiency.get("goodput_tokens_per_s")
            if isinstance(goodput, (int, float)):
                self.m_goodput.labels(worker_id=wid).set(float(goodput))
        devices = usage.get("device_memory")
        if isinstance(devices, list):
            sums = {"in_use": 0.0, "limit": 0.0, "peak": 0.0}
            for dev in devices:
                if not isinstance(dev, dict):
                    continue
                sums["in_use"] += float(dev.get("bytes_in_use") or 0)
                sums["limit"] += float(dev.get("bytes_limit") or 0)
                sums["peak"] += float(dev.get("peak_bytes_in_use") or 0)
            for kind, total in sums.items():
                self.m_devmem.labels(worker_id=wid, kind=kind).set(total)

    def clock_offsets(self) -> Dict[str, float]:
        """{worker_id: estimated clock offset in seconds} — what the
        TraceCollector adds to a worker's span walls (receiver − sender;
        only workers that have sent a timestamped beat appear)."""
        with self._mu:
            return {wid: t.clock_offset_s
                    for wid, t in self._workers.items()
                    if t.offset_samples}

    def _is_stale(self, t: WorkerTrack, now: datetime) -> bool:
        """The ONE staleness rule (mirrors check_worker_health): silent
        beyond ``stale_after_s`` and not cleanly offline."""
        return (t.status != WORKER_OFFLINE and t.last_seen is not None
                and (now - t.last_seen).total_seconds()
                > self.stale_after_s)

    def stale_count(self, now: Optional[datetime] = None) -> int:
        """Stale workers computed against ``now`` AT CALL TIME — the
        fn-bound ``fleet_stale_workers`` read, so every scrape (plain
        /metrics included) judges staleness live instead of replaying
        the last health tick's verdict."""
        now = now or utcnow()
        with self._mu:
            return sum(1 for t in self._workers.values()
                       if self._is_stale(t, now))

    def refresh_staleness(self, now: Optional[datetime] = None) -> int:
        """Evict long-gone workers and return the live stale count.
        Driven by the orchestrator's health tick; the gauge itself no
        longer depends on this tick (``stale_count`` recomputes at every
        read), so the tick's remaining job is the bounded-memory sweep.

        Eviction keeps the fleet view bounded for long-lived
        orchestrators whose workers restart under fresh ids (pod-name
        worker_ids): a track silent past ``10 * stale_after_s`` is
        dropped along with its per-worker gauge children — a worker that
        comes back simply re-registers on its next beat."""
        now = now or utcnow()
        stale = 0
        evicted = []
        with self._mu:
            for wid, t in list(self._workers.items()):
                if t.last_seen is None:
                    continue
                age = (now - t.last_seen).total_seconds()
                if age > 10 * self.stale_after_s:
                    del self._workers[wid]
                    evicted.append(wid)
                elif self._is_stale(t, now):
                    stale += 1
        for wid in evicted:
            for gauge in (self.m_queue, self.m_rss, self.m_mfu,
                          self.m_goodput):
                gauge.remove_labels(worker_id=wid)
            for kind in ("in_use", "limit", "peak"):
                self.m_devmem.remove_labels(worker_id=wid, kind=kind)
        return stale

    # -- export --------------------------------------------------------------
    def export(self, now: Optional[datetime] = None) -> Dict[str, Any]:
        """The ``/cluster`` JSON body: per-worker maps + a fleet rollup
        whose staleness rule mirrors `Orchestrator.check_worker_health`
        (silence beyond ``stale_after_s`` == presumed dead)."""
        now = now or utcnow()
        workers: Dict[str, Any] = {}
        stale = []
        counts = {"crawl": 0, "tpu": 0}
        # The whole walk stays under the lock: observe() mutates tracks
        # (and appends to each history deque) from bus threads, and a
        # deque iterated while appended-to raises mid-/cluster-request.
        # Building the plain-dict snapshot is cheap; JSON encoding happens
        # on the copy, outside.
        with self._mu:
            tracks = list(self._workers.values())
            for t in tracks:
                age = (now - t.last_seen).total_seconds() \
                    if t.last_seen is not None else None
                is_stale = self._is_stale(t, now)
                if is_stale:
                    stale.append(t.worker_id)
                counts[t.worker_type] = counts.get(t.worker_type, 0) + 1
                workers[t.worker_id] = {
                    "worker_type": t.worker_type,
                    "status": t.status,
                    "first_seen": t.first_seen.isoformat()
                    if t.first_seen else None,
                    "last_seen": t.last_seen.isoformat()
                    if t.last_seen else None,
                    "last_seen_age_s": round(age, 1) if age is not None
                    else None,
                    "stale": is_stale,
                    "current_work": t.current_work,
                    "queue_length": t.queue_length,
                    "tasks": {"processed": t.tasks_processed,
                              "success": t.tasks_success,
                              "error": t.tasks_error},
                    "rates": {"tasks_per_s": t.tasks_per_s,
                              "errors_per_s": t.errors_per_s},
                    "uptime_s": t.uptime_s,
                    "heartbeats": t.heartbeats,
                    "clock_offset_s": round(t.clock_offset_s, 6),
                    "stale_heartbeats_dropped": t.stale_dropped,
                    "telemetry": t.telemetry,
                    "history": list(t.history),
                }
        return {
            "workers": workers,
            "fleet": {
                "worker_count": len(workers),
                "crawl_workers": counts.get("crawl", 0),
                "tpu_workers": counts.get("tpu", 0),
                "stale_workers": stale,
                "stale_after_s": self.stale_after_s,
                "generated_at": now.isoformat(),
            },
        }

"""Device-occupancy accounting: how busy the card was.

The `DeviceTimeline` of the reference's `distributed_crawler_tpu/utils/
occupancy.py`.  One interval per device batch, from the dispatch to the
moment its results are on the host (the readback is an upper bound on when
the device finished).  From the rolling window it derives
``tpu_engine_device_busy_fraction`` (union of intervals over wall),
``tpu_engine_overlap_fraction`` (dispatched device time that overlapped
other in-flight work) and ``tpu_engine_pipeline_bubble_ms_total`` (idle
gaps between batches of one dispatch stream).  ``start_stream()`` marks
the next interval as the first of a new stream, so idle-by-no-work never
scores as a bubble.  Host-side bookkeeping only.

`QueueDepthSampler` is the reference's time-weighted queue-depth gauge:
the workers' enqueue and dequeue edges feed it and the heartbeat samples
it, so a scrape reads the depth over the window, not the last edge's.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry


def merged_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    merged = 0.0
    cur_s: Optional[float] = None
    cur_e = 0.0
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            merged += cur_e - cur_s
            cur_s, cur_e = s, e
    if cur_s is not None:
        merged += cur_e - cur_s
    return merged


class DeviceTimeline:
    """Rolling window of device intervals + derived occupancy gauges."""

    def __init__(self, registry: MetricsRegistry = REGISTRY,
                 window_s: float = 60.0, max_intervals: int = 2048,
                 clock=time.perf_counter, path: str = "text"):
        self.window_s = window_s
        # Cards one recorded dispatch spans: one until the mesh is ported.
        # Snapshots carry it and the chip-weighted bubble twins, as the
        # reference's do.
        self.n_devices = 1
        self._clock = clock
        self._lock = threading.Lock()
        self._intervals: "deque[Tuple[float, float]]" = \
            deque(maxlen=max_intervals)
        self._bubbles: "deque[Tuple[float, float]]" = \
            deque(maxlen=max_intervals)  # (at, bubble_s)
        self._prev_end: Optional[float] = None
        self._new_stream = True
        self._batches_total = 0
        self._bubble_s_total = 0.0
        self.m_busy = registry.gauge(
            "tpu_engine_device_busy_fraction",
            "rolling fraction of wall time with a device batch in flight "
            "(dispatch->readback union; readback is an upper bound on "
            "device-busy end)").labels(path=path)
        self.m_overlap = registry.gauge(
            "tpu_engine_overlap_fraction",
            "rolling fraction of dispatched device time that overlapped "
            "other in-flight work (0 = fully serial)").labels(path=path)
        self.m_bubble = registry.counter(
            "tpu_engine_pipeline_bubble_ms_total",
            "device idle between consecutive batches of one dispatch "
            "stream, cumulative").labels(path=path)

    def reset(self) -> None:
        """Forget everything recorded so far (warmup exclusion)."""
        with self._lock:
            self._intervals.clear()
            self._bubbles.clear()
            self._prev_end = None
            self._new_stream = True
            self._batches_total = 0
            self._bubble_s_total = 0.0
        self.m_busy.set(0.0)
        self.m_overlap.set(0.0)

    def start_stream(self) -> None:
        with self._lock:
            self._new_stream = True

    def record(self, start: float, end: float) -> None:
        """Account one device batch's [dispatch, readback-complete]
        interval.  O(1); the fractions are derived in :meth:`snapshot`."""
        if end < start:
            start, end = end, start
        with self._lock:
            bubble = 0.0
            if not self._new_stream and self._prev_end is not None:
                bubble = max(0.0, start - self._prev_end)
            self._new_stream = False
            self._prev_end = max(self._prev_end or end, end)
            self._intervals.append((start, end))
            self._batches_total += 1
            if bubble > 0:
                self._bubbles.append((end, bubble))
                self._bubble_s_total += bubble
        if bubble > 0:
            self.m_bubble.inc(bubble * 1000.0)

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._intervals and self._intervals[0][1] < cutoff:
            self._intervals.popleft()
        while self._bubbles and self._bubbles[0][0] < cutoff:
            self._bubbles.popleft()

    def snapshot(self) -> Dict[str, Any]:
        """Occupancy map (refreshing the gauges); {} before the first
        batch."""
        now = self._clock()
        with self._lock:
            if not self._batches_total:
                return {}
            self._prune(now)
            intervals = list(self._intervals)
            bubble_window = sum(b for _, b in self._bubbles)
            batches_total = self._batches_total
            bubble_total = self._bubble_s_total
        union = merged_length(intervals)
        total = sum(e - s for s, e in intervals)
        span = max(min(now - intervals[0][0], self.window_s), union, 1e-9) \
            if intervals else max(self.window_s, 1e-9)
        busy = union / span if intervals else 0.0
        overlap = (total - union) / total if total > 0 else 0.0
        active = union + bubble_window
        out = {
            "window_s": round(span, 3),
            "batches": len(intervals),
            "busy_fraction": round(busy, 6),
            "overlap_fraction": round(overlap, 6),
            "bubble_ms_window": round(bubble_window * 1000.0, 3),
            "bubble_share": round(bubble_window / active, 6)
            if active > 0 else 0.0,
            "bubble_ms_total": round(bubble_total * 1000.0, 3),
            "bubble_ms_per_batch": round(
                bubble_total * 1000.0 / batches_total, 4),
            "batches_total": batches_total,
            "n_devices": self.n_devices,
            "bubble_chip_ms_window": round(
                bubble_window * 1000.0 * self.n_devices, 3),
            "bubble_chip_ms_total": round(
                bubble_total * 1000.0 * self.n_devices, 3),
        }
        self.m_busy.set(out["busy_fraction"])
        self.m_overlap.set(out["overlap_fraction"])
        return out


class QueueDepthSampler:
    """Time-weighted queue-depth over a rolling window.

    ``update(depth)`` records an edge (enqueue/dequeue) AND refreshes
    the gauge with the window's exact time-weighted mean — amortized
    O(1): a running sum of closed inter-edge segments (each edge is
    added once on append and subtracted once when it ages out) plus the
    left-boundary and live-tail segments computed directly.  Call
    ``sample()`` from the heartbeat loop too, so a queue that went
    quiet (no edges) still decays instead of freezing the last mean.
    """

    def __init__(self, gauge, window_s: float = 60.0,
                 clock=time.monotonic, max_events: int = 4096):
        self.gauge = gauge
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        # (t, depth) transitions; _floor_depth is the depth in force just
        # before the oldest retained transition (pruning keeps the
        # integral exact at the window's left edge).  _seg_sum is
        # Σ depth_i · (t_{i+1} − t_i) over consecutive RETAINED pairs.
        self._events: "deque[Tuple[float, float]]" = deque()
        self._max_events = max(2, int(max_events))
        self._seg_sum = 0.0
        self._floor_depth = 0.0
        self._last_depth = 0.0

    def update(self, depth: int) -> None:
        now = self._clock()
        with self._lock:
            self._prune(now)
            if self._events:
                self._seg_sum += self._events[-1][1] \
                    * (now - self._events[-1][0])
            self._events.append((now, float(depth)))
            self._last_depth = float(depth)
            value = self._mean_locked(now)
        self._set(value)

    def current(self) -> float:
        with self._lock:
            return self._last_depth

    def sample(self) -> float:
        """Time-weighted mean depth over the window; refreshes the gauge
        (the heartbeat-side decay path for edge-quiet queues)."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            value = self._mean_locked(now)
        return self._set(value)

    def _set(self, value: float) -> float:
        if self.gauge is not None:
            self.gauge.set(round(value, 4))
        return value

    def _prune(self, now: float) -> None:
        """Expire edges older than the window (and enforce the bound);
        each edge is popped exactly once, so the cost amortizes O(1)."""
        cutoff = now - self.window_s
        while self._events and (self._events[0][0] <= cutoff
                                or len(self._events) > self._max_events):
            t0, d0 = self._events.popleft()
            if self._events:
                # Callers (update/sample) hold self._lock around every
                # _prune call; the write is lock-guarded at the call site.
                self._seg_sum -= d0 * (self._events[0][0] - t0)
            self._floor_depth = d0

    def _mean_locked(self, now: float) -> float:
        if not self._events:
            return self._last_depth  # constant since before the window
        cutoff = now - self.window_s
        head_t = self._events[0][0]
        tail_t, tail_d = self._events[-1]
        total = (self._floor_depth * max(0.0, head_t - cutoff)
                 + self._seg_sum + tail_d * (now - tail_t))
        span = now - cutoff
        return total / span if span > 0 else self._last_depth

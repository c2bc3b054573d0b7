"""Span tracing: see where every batch's millisecond went.

The reference's `distributed_crawler_tpu/utils/trace.py`:

- :func:`span` — a ``perf_counter`` context manager recording one named,
  attributed span; spans nest through a contextvar, so the bus delivery
  span, the worker's stage spans and the engine's stage spans land in one
  trace without plumbing through call signatures;
- :func:`record` — a retroactive span for a duration measured elsewhere;
- :func:`inject` / :func:`payload_span` — propagation across a bus hop;
- a bounded ring of finished spans, grouped into traces by
  ``Tracer.export`` for the ``/traces`` route, with slow-span logging;
- :func:`latency_digest` — the per-name p50/p95/max that heartbeats carry;
- :class:`SpanExporter` — the new spans since its last collect, sampled
  by whole trace and filtered by name prefix, for ``SpanBatchMessage``
  export on ``TOPIC_SPANS``.

The contextvar is per thread: the worker's feed thread re-roots each batch
from its ``trace_id`` explicitly.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import math
import secrets
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger("dct.trace")

DEFAULT_CAPACITY = 2048  # finished spans kept

# (trace_id, span_id, span_name) of the innermost open span on this
# thread/task.
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "dct_torch_trace_ctx", default=None)


def new_trace_id() -> str:
    """Same shape as the bus's trace ids (``trace_<utc stamp>_<hex>``)."""
    return ("trace_" + time.strftime("%Y%m%d%H%M%S", time.gmtime())
            + "_" + secrets.token_hex(4))


def _new_span_id() -> str:
    return "sp_" + secrets.token_hex(6)


@dataclass
class Span:
    """One finished, named timing with attribution."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str = ""
    start_wall: float = 0.0        # epoch seconds at span open
    duration_s: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_wall": self.start_wall,
            "duration_ms": round(self.duration_s * 1000.0, 3),
            "attrs": self.attrs,
        }


class _OpenSpan:
    """Handle yielded by :meth:`Tracer.span`; ``set`` adds attrs late."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


class Tracer:
    """Bounded in-process span collector with slow-span logging."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 slow_span_s: float = 0.0):
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=max(1, capacity))
        self._enabled = capacity > 0
        self._completed_total = 0  # spans ever appended (export cursor)
        self.capacity = capacity
        self.slow_span_s = slow_span_s

    def configure(self, capacity: Optional[int] = None,
                  slow_span_s: Optional[float] = None) -> None:
        """Resize the ring / set the slow threshold.  A capacity of 0
        stops recording; context propagation still works."""
        with self._lock:
            if capacity is not None:
                self.capacity = capacity
                self._enabled = capacity > 0
                self._spans = deque(self._spans, maxlen=max(1, capacity))
            if slow_span_s is not None:
                self.slow_span_s = slow_span_s

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "",
             parent_id: Optional[str] = None,
             **attrs: Any) -> Iterator[_OpenSpan]:
        """Record a named span around the block.

        ``trace_id`` wins when given; otherwise the ambient trace continues,
        or a fresh one starts.  The ambient span is the parent when it is
        of the same trace, unless ``parent_id`` overrides it."""
        ambient = _CTX.get()
        if not trace_id:
            trace_id = ambient[0] if ambient else new_trace_id()
        if parent_id is None:
            parent_id = ambient[1] if ambient and ambient[0] == trace_id \
                else ""
        span_id = _new_span_id()
        handle = _OpenSpan(name, trace_id, span_id, parent_id, dict(attrs))
        token = _CTX.set((trace_id, span_id, name))
        start_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield handle
        except BaseException:
            handle.attrs.setdefault("error", True)
            raise
        finally:
            _CTX.reset(token)
            self._finish(Span(handle.name, trace_id, span_id, parent_id,
                              start_wall, time.perf_counter() - t0,
                              handle.attrs))

    def record(self, name: str, duration_s: float, trace_id: str = "",
               parent_id: str = "", **attrs: Any) -> None:
        """Retroactive span; dropped when there is no trace to attach to."""
        ambient = _CTX.get()
        if not trace_id:
            if ambient is None:
                return
            trace_id = ambient[0]
        if not parent_id and ambient and ambient[0] == trace_id:
            parent_id = ambient[1]
        self._finish(Span(name, trace_id, _new_span_id(), parent_id,
                          time.time() - duration_s, duration_s, dict(attrs)))

    def _finish(self, s: Span) -> None:
        if self._enabled:
            with self._lock:
                self._spans.append(s)
                self._completed_total += 1
        if self.slow_span_s > 0 and s.duration_s >= self.slow_span_s:
            logger.warning(
                "slow span %s %.1fms (threshold %.0fms) trace=%s attrs=%s",
                s.name, s.duration_s * 1000.0, self.slow_span_s * 1000.0,
                s.trace_id, s.attrs)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def spans_with_total(self) -> Tuple[List[Span], int]:
        """(ring contents, spans ever completed) in one atomic read: the
        cursor a `SpanExporter` needs."""
        with self._lock:
            return list(self._spans), self._completed_total

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()

    def export(self, limit: int = 0) -> Dict[str, Any]:
        """Spans grouped into traces, the trace whose last span finished
        most recently first: the ``/traces`` body."""
        spans = self.spans()
        by_trace: Dict[str, List[Span]] = {}
        last_seen: Dict[str, int] = {}
        for idx, s in enumerate(spans):  # ring order == completion order
            by_trace.setdefault(s.trace_id, []).append(s)
            last_seen[s.trace_id] = idx
        traces = []
        for tid in sorted(last_seen, key=last_seen.__getitem__,
                          reverse=True):
            group = by_trace[tid]
            start = min(s.start_wall for s in group)
            end = max(s.start_wall + s.duration_s for s in group)
            traces.append({
                "trace_id": tid,
                "span_count": len(group),
                "duration_ms": round((end - start) * 1000.0, 3),
                "spans": [s.to_dict() for s in group],
            })
            if limit and len(traces) >= limit:
                break
        return {"traces": traces, "capacity": self.capacity,
                "slow_span_ms": self.slow_span_s * 1000.0}


TRACER = Tracer()

span = TRACER.span
record = TRACER.record
configure = TRACER.configure


def current_trace_id() -> str:
    ctx = _CTX.get()
    return ctx[0] if ctx else ""


def current_span_id() -> str:
    ctx = _CTX.get()
    return ctx[1] if ctx else ""


def current_span_name() -> str:
    ctx = _CTX.get()
    return ctx[2] if ctx else ""


def latency_digest(spans: List[Span],
                   since_wall: float = 0.0) -> Dict[str, Dict[str, float]]:
    """Per-span-name p50/p95/max/count (nearest rank) over ``spans``,
    optionally only those that finished after ``since_wall``."""
    by_name: Dict[str, List[float]] = {}
    for s in spans:
        if since_wall and (s.start_wall + s.duration_s) <= since_wall:
            continue
        by_name.setdefault(s.name, []).append(s.duration_s * 1000.0)
    out: Dict[str, Dict[str, float]] = {}
    for name, vals in by_name.items():
        vals.sort()
        n = len(vals)

        def rank(q: float) -> float:
            return vals[min(n - 1, max(0, math.ceil(q * n) - 1))]

        out[name] = {
            "count": n,
            "p50_ms": round(rank(0.5), 3),
            "p95_ms": round(rank(0.95), 3),
            "max_ms": round(vals[-1], 3),
        }
    return out


def span_from_dict(d: Dict[str, Any]) -> Span:
    """Inverse of :meth:`Span.to_dict`."""
    return Span(
        name=str(d.get("name", "") or ""),
        trace_id=str(d.get("trace_id", "") or ""),
        span_id=str(d.get("span_id", "") or ""),
        parent_id=str(d.get("parent_id", "") or ""),
        start_wall=float(d.get("start_wall") or 0.0),
        duration_s=float(d.get("duration_ms") or 0.0) / 1000.0,
        attrs=dict(d.get("attrs") or {}),
    )


class SpanExporter:
    """The finished spans new since the previous ``collect()`` (from
    construction on: a fresh exporter never re-ships the ring's history).

    - Whole traces are kept or dropped by a crc32 of the trace id, so
      every process sampling at one rate ships the same traces; untraced
      spans are never shipped.
    - At most ``max_spans`` per collect, newest kept.
    - ``name_prefixes`` keeps the spans this component produced: the ring
      is process-wide, and spans of other components in the process are
      theirs to ship (and are not counted as dropped).

    The second return value counts the spans not shipped (evicted from the
    ring between collects, sampled out, over the bound).
    """

    def __init__(self, tracer: Optional[Tracer] = None,
                 max_spans: int = 512, sample_rate: float = 1.0,
                 name_prefixes: Tuple[str, ...] = ()):
        self.tracer = tracer or TRACER
        self.max_spans = max(1, int(max_spans))
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.name_prefixes = tuple(name_prefixes)
        # The heartbeat thread and on-demand callers may race: the cursor
        # moves under this lock, so no window ships twice.
        self._lock = threading.Lock()
        _, self._cursor = self.tracer.spans_with_total()

    def keeps(self, trace_id: str) -> bool:
        """Stable per-trace sampling decision (shared across processes)."""
        if not trace_id:
            return False
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return (zlib.crc32(trace_id.encode("utf-8")) % 10_000) < \
            self.sample_rate * 10_000

    def collect(self) -> Tuple[List[Span], int]:
        """(spans to ship, dropped count) since the previous collect."""
        with self._lock:
            spans, total = self.tracer.spans_with_total()
            fresh_n, self._cursor = total - self._cursor, total
        if fresh_n <= 0:
            return [], 0
        fresh = spans[-fresh_n:] if fresh_n <= len(spans) else spans
        dropped = fresh_n - len(fresh)  # evicted before we got here
        if self.name_prefixes:
            fresh = [s for s in fresh
                     if s.name.startswith(self.name_prefixes)]
        sampled = [s for s in fresh if self.keeps(s.trace_id)]
        dropped += len(fresh) - len(sampled)
        if len(sampled) > self.max_spans:
            dropped += len(sampled) - self.max_spans
            sampled = sampled[-self.max_spans:]
        return sampled, dropped


def inject(payload: Any) -> Any:
    """Publish side: a shallow copy of a traced dict payload with the open
    span as ``parent_span``; anything else passes through untouched."""
    ctx = _CTX.get()
    if (ctx is None or not isinstance(payload, dict)
            or not payload.get("trace_id") or payload.get("parent_span")):
        return payload
    return {**payload, "parent_span": ctx[1]}


def payload_span(name: str, payload: Any, **attrs: Any):
    """Delivery side: a span re-rooted from the envelope's ``trace_id`` /
    ``parent_span``; a no-op for an untraced payload."""
    tid = payload.get("trace_id") if isinstance(payload, dict) else None
    if not tid:
        return contextlib.nullcontext()
    return TRACER.span(name, trace_id=tid,
                       parent_id=payload.get("parent_span", "") or "",
                       **attrs)

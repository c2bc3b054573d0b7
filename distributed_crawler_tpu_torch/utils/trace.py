"""Span tracing: see where every batch's millisecond went.

The core of the reference's `distributed_crawler_tpu/utils/trace.py`:

- :func:`span` — a ``perf_counter`` context manager recording one named,
  attributed span; spans nest through a contextvar, so the bus delivery
  span, the worker's stage spans and the engine's stage spans land in one
  trace without plumbing through call signatures;
- :func:`record` — a retroactive span for a duration measured elsewhere;
- :func:`inject` / :func:`payload_span` — propagation across a bus hop;
- a bounded ring of finished spans (``TRACER.spans()``).

The contextvar is per thread: the worker's feed thread re-roots each batch
from its ``trace_id`` explicitly.  Exporters and the /traces endpoint wait
for a later slice.
"""

from __future__ import annotations

import contextlib
import contextvars
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

DEFAULT_CAPACITY = 2048  # finished spans kept

# (trace_id, span_id) of the innermost open span on this thread/task.
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


class Tracer:
    """Bounded in-process span collector."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=max(1, capacity))

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "",
             parent_id: Optional[str] = None,
             **attrs: Any) -> Iterator[Dict[str, Any]]:
        """Record a named span around the block; yields its attrs dict.

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
        attrs = dict(attrs)
        token = _CTX.set((trace_id, span_id))
        start_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield attrs
        except BaseException:
            attrs.setdefault("error", True)
            raise
        finally:
            _CTX.reset(token)
            self._finish(Span(name, trace_id, span_id, parent_id, start_wall,
                              time.perf_counter() - t0, attrs))

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
        with self._lock:
            self._spans.append(s)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


TRACER = Tracer()

span = TRACER.span
record = TRACER.record


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

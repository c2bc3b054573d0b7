"""In-process metrics: counters, gauges, latency histograms, and the
worker's HTTP endpoint.

The reference's `distributed_crawler_tpu/utils/metrics.py`, with the same
metric names, label semantics, Prometheus text exposition and routes (they
are a contract with dashboards, `tools/perfreport.py`, `tools/
postmortem.py` and the orchestrator's fleet view):

- `MetricsRegistry` and its `Counter`, `Gauge` and `Histogram` families,
  ``.labels(...)`` children, and ``expose()``;
- the late-bound providers behind ``/status``, ``/costs``,
  ``/clusters``, ``/dlq`` (a durable broker's dead-letter queue) and
  ``/shards`` (a partitioned bus client's shard table), registered by
  their owner once it exists;
- `serve_metrics`: ``/healthz``, ``/metrics``, ``/traces``, ``/status``,
  ``/costs``, ``/profile``, ``/clusters``, ``/dlq``, ``/shards``,
  ``/timeseries`` and ``/logs`` (the WARNING+ ring of `utils/
  structlog.py`, served always) on a daemon thread.  A provider route
  with no provider answers 404, as the orchestrator's routes
  (``/dtraces``, ``/alerts``, ``/autoscaler``, ``/tenants``,
  ``/cluster``) always do: no orchestrator runs in the port.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

# Latency buckets in seconds: 1 ms .. 60 s, roughly log-spaced.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _escape_help(help_: str) -> str:
    """Prometheus HELP escaping: a backslash or newline in the help text
    would corrupt the exposition."""
    return help_.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_key(kv: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in kv.items()))


def _label_str(items: LabelKey,
               extra: Optional[Tuple[str, str]] = None) -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in items]
    if extra is not None:
        parts.append(f'{extra[0]}="{_escape_label_value(extra[1])}"')
    return "{" + ",".join(parts) + "}" if parts else ""


class _LabeledMixin:
    """``.labels(bucket="32")``-style children, created once and cached.
    The parent owns the HELP/TYPE header and an always-exposed unlabeled
    series; each label set adds one ``name{k="v"} value`` series."""

    _label_items: LabelKey = ()

    def labels(self, **kv: object):
        if self._label_items:
            raise ValueError(
                f"labels() on an already-labeled child of {self.name}")
        if not kv:
            return self
        key = _label_key(kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                child._label_items = key
                self._children[key] = child
        return child

    def _child_snapshot(self) -> list:
        with self._lock:
            return [c for _, c in sorted(self._children.items())]

    def _read(self) -> float:
        with self._lock:
            return self._value

    def series(self) -> list:
        """[(labels_dict, value)] for the parent and every labeled child
        (Counter/Gauge): the programmatic read heartbeats use."""
        return [(dict(m._label_items), m._read())
                for m in [self] + self._child_snapshot()]

    def _expose_values(self, kind: str) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {kind}"]
        for m in [self] + self._child_snapshot():
            lines.append(f"{self.name}{_label_str(m._label_items)} "
                         f"{m._read()}")
        return "\n".join(lines) + "\n"


class Counter(_LabeledMixin):
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._value = 0.0
        self._lock = threading.Lock()
        self._children: Dict[LabelKey, "Counter"] = {}

    def _make_child(self) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._read()

    def expose(self) -> str:
        return self._expose_values("counter")


class Gauge(_LabeledMixin):
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._value = 0.0
        self._lock = threading.Lock()
        self._children: Dict[LabelKey, "Gauge"] = {}

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        return self._read()

    def expose(self) -> str:
        return self._expose_values("gauge")


class Histogram(_LabeledMixin):
    """Bucketed histogram plus a bounded window of recent observations."""

    def __init__(self, name: str, help_: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 window: int = 4096):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._window: List[float] = []
        self._window_cap = window
        self._lock = threading.Lock()
        self._children: Dict[LabelKey, "Histogram"] = {}

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, self.buckets,
                         self._window_cap)

    def observe(self, value: float) -> None:
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, value)] += 1
            self._sum += value
            self._n += 1
            self._window.append(value)
            if len(self._window) > self._window_cap:
                # Drop the oldest half to amortize the trim.
                self._window = self._window[self._window_cap // 2:]

    def window(self) -> List[float]:
        """The retained observations, oldest first (a copy)."""
        with self._lock:
            return list(self._window)

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def _series_lines(self, items: LabelKey) -> List[str]:
        # One atomic snapshot: a concurrent observe() between the bucket
        # walk and the _count line would expose disagreeing totals.
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        lines = []
        cum = 0
        for bound, c in zip(self.buckets, counts):
            cum += c
            lines.append(f"{self.name}_bucket"
                         f"{_label_str(items, ('le', str(bound)))} {cum}")
        cum += counts[-1]
        lines.append(f"{self.name}_bucket"
                     f"{_label_str(items, ('le', '+Inf'))} {cum}")
        lines.append(f"{self.name}_sum{_label_str(items)} {total}")
        lines.append(f"{self.name}_count{_label_str(items)} {n}")
        return lines

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        for m in [self] + self._child_snapshot():
            lines.extend(m._series_lines(m._label_items))
        return "\n".join(lines) + "\n"


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_, buckets), Histogram)

    def _get_or_make(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name} already registered as "
                                 f"{type(m).__name__}")
            return m

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "".join(m.expose() for m in metrics)


REGISTRY = MetricsRegistry()

# Late-bound JSON providers: the metrics server can start before the
# worker exists, so the worker registers its maps once constructed.
# ``clear_*`` unregisters only a provider that is still the active one,
# so a stopping component never yanks one registered after it.
_providers: Dict[str, object] = {"status": None, "costs": None,
                                 "clusters": None, "dlq": None,
                                 "shards": None}


def _set(kind: str, fn) -> None:
    _providers[kind] = fn


def _clear(kind: str, fn) -> None:
    if _providers[kind] == fn:
        _providers[kind] = None


def set_status_provider(fn) -> None:
    """Register the zero-arg dict provider served at /status (None
    clears)."""
    _set("status", fn)


def clear_status_provider(fn) -> None:
    _clear("status", fn)


def set_costs_provider(fn) -> None:
    """Register the zero-arg dict provider served at /costs (None
    clears)."""
    _set("costs", fn)


def clear_costs_provider(fn) -> None:
    _clear("costs", fn)


def set_clusters_provider(fn) -> None:
    """Register the zero-arg dict provider served at /clusters (None
    clears)."""
    _set("clusters", fn)


def clear_clusters_provider(fn) -> None:
    _clear("clusters", fn)


def set_dlq_provider(fn) -> None:
    """Register the dict provider served at /dlq, called as
    ``fn(topic=..., id=...)``; None clears."""
    _set("dlq", fn)


def clear_dlq_provider(fn) -> None:
    _clear("dlq", fn)


def set_shards_provider(fn) -> None:
    """Register the zero-arg dict provider served at /shards (None
    clears)."""
    _set("shards", fn)


def clear_shards_provider(fn) -> None:
    _clear("shards", fn)


def _snapshot(kind: str):
    fn = _providers[kind]
    if fn is None:
        return None
    try:
        return fn()
    except Exception as e:
        return {"error": str(e)}


def clusters_snapshot():
    """The active /clusters body, or None without a provider: the flight
    recorder puts it in postmortem bundles."""
    return _snapshot("clusters")


def shards_snapshot():
    """The active /shards body, or None without a provider: the flight
    recorder puts it in postmortem bundles (which shard was parked or
    broken when the process went down)."""
    return _snapshot("shards")


def logs_snapshot():
    """The /logs body for postmortem bundles: the last WARNING+ records,
    or None when the ring is empty, so a process that never warned writes
    no ``logs`` section."""
    from . import structlog

    records = structlog.ring_snapshot()
    if not records:
        return None
    return {"records": records}


def _query_limit(query: Dict[str, List[str]]) -> int:
    try:
        return int(query.get("limit", ["0"])[0])
    except (ValueError, TypeError):
        return 0


def _query_float(query: Dict[str, List[str]], key: str) -> float:
    try:
        return float((query.get(key) or ["0"])[0])
    except (ValueError, TypeError):
        return 0.0


def _dlq_body(provider, query: Dict[str, List[str]]) -> bytes:
    topic = (query.get("topic") or [""])[0]
    entry_id = (query.get("id") or [""])[0]
    payload = provider(topic=topic or None, id=entry_id or None)
    return json.dumps(payload, default=str).encode("utf-8")


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY
    providers: Dict[str, object] = {}   # this server's own, over globals

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/")
        query = parse_qs(self.path.partition("?")[2])
        code, ctype = 200, "application/json"
        kind = {"/status": "status", "/costs": "costs",
                "/clusters": "clusters", "/dlq": "dlq",
                "/shards": "shards"}.get(path)
        provider = self.providers.get(kind) or _providers.get(kind) \
            if kind else None
        if path in ("", "/health", "/healthz"):
            body, ctype = b"ok\n", "text/plain"
        elif path == "/metrics":
            body = self.registry.expose().encode("utf-8")
            ctype = "text/plain; version=0.0.4"
        elif path == "/traces":
            # Completed traces (spans grouped by trace_id, newest first);
            # ?limit=N caps the trace count.
            from . import trace

            body = json.dumps(trace.TRACER.export(
                limit=_query_limit(query)), default=str).encode("utf-8")
        elif provider is not None:
            try:
                if kind == "dlq":
                    # ?topic=&id= returns one entry's full payload.
                    body = _dlq_body(provider, query)
                else:
                    body = json.dumps(provider(),
                                      default=str).encode("utf-8")
            except Exception as e:
                # Visible to status-code monitors, one response per
                # request.
                code = 500
                body = json.dumps({"error": str(e)}).encode("utf-8")
        elif path == "/profile":
            # One bounded torch.profiler capture at a time, process-wide;
            # this request's thread blocks for the window.
            from . import profiling

            result = profiling.capture(
                (query.get("seconds") or ["1"])[0])
            code = int(result.pop("code", 200 if result.get("ok") else 500))
            body = json.dumps(result).encode("utf-8")
        elif path == "/logs":
            # The structured-log ring, served always: a process that never
            # warned answers with zero records.  ?limit=N keeps the newest.
            from . import structlog

            try:
                body = json.dumps({"records": structlog.ring_snapshot(
                    limit=_query_limit(query))}, default=str).encode("utf-8")
            except Exception as e:
                code = 500
                body = json.dumps({"error": str(e)}).encode("utf-8")
        elif path == "/timeseries":
            # The process's rolling series; ?series= filters by name or
            # exact key, ?window= downsamples, ?since= bounds history.
            from . import timeseries

            try:
                body = json.dumps(timeseries.STORE.snapshot(
                    series=(query.get("series") or [""])[0] or None,
                    window_s=_query_float(query, "window"),
                    since_s=_query_float(query, "since")),
                    default=str).encode("utf-8")
            except Exception as e:
                code = 500
                body = json.dumps({"error": str(e)}).encode("utf-8")
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence request logging
        pass


def serve_metrics(port: int, registry: MetricsRegistry = REGISTRY,
                  providers: Optional[Dict[str, object]] = None
                  ) -> ThreadingHTTPServer:
    """Serve the routes above on 127.0.0.1 from a daemon thread; returns
    the server (``.shutdown()`` stops it).  Port 0 picks a free port
    (``server.server_address[1]``).  ``providers`` maps a provider
    route's name (``"status"``, ``"costs"``, ...) to this server's own
    provider, so two workers in one process each serve their own maps;
    without one a route uses the provider registered through
    ``set_*_provider``."""
    handler = type("Handler", (_Handler,), {
        "registry": registry, "providers": dict(providers or {})})
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="metrics-http").start()
    return server


@dataclass
class Timer:
    """Context manager observing elapsed seconds into a histogram."""

    histogram: Histogram
    _start: float = field(default=0.0, init=False)

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.histogram.observe(time.perf_counter() - self._start)
        return False

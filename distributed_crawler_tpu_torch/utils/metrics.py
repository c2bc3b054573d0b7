"""In-process metrics registry: counters, gauges, latency histograms.

The registry part of the reference's `distributed_crawler_tpu/utils/
metrics.py`, with the same metric names and label semantics (they are a
contract with dashboards and the load gate).  Text exposition and the HTTP
server wait for a later slice.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(kv: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in kv.items()))


class _LabeledMixin:
    """``.labels(bucket="32")``-style children, created once and cached."""

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
        (Counter/Gauge)."""
        return [(dict(m._label_items), m._read())
                for m in [self] + self._child_snapshot()]


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


class Histogram(_LabeledMixin):
    """Observation count plus a bounded window of recent observations."""

    def __init__(self, name: str, help_: str = "", window: int = 4096):
        self.name, self.help = name, help_
        self._n = 0
        self._window: List[float] = []
        self._window_cap = window
        self._lock = threading.Lock()
        self._children: Dict[LabelKey, "Histogram"] = {}

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, self._window_cap)

    def observe(self, value: float) -> None:
        with self._lock:
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


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._get_or_make(name, lambda: Histogram(name, help_),
                                 Histogram)

    def _get_or_make(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name} already registered as "
                                 f"{type(m).__name__}")
            return m


REGISTRY = MetricsRegistry()

"""Rolling time-series store: the history every gauge lacks.

The reference's `distributed_crawler_tpu/utils/timeseries.py`: a bounded,
O(1)-append ring of ``(wall, value)`` samples per labelled series, local
to the process, with epoch-aligned downsampling, a counter-reset-aware
``increase()``, a least-squares ``slope()``, and the ``/timeseries`` body
(``snapshot()``).  Each worker self-samples its own metrics registry into
the process-global `STORE` once per heartbeat (`RegistrySampler`, through
the shared exposition parser), so its history survives the orchestrator.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .exposition import parse_exposition

logger = logging.getLogger("dct.timeseries")

DEFAULT_MAX_SAMPLES = 512   # samples kept per series
DEFAULT_WINDOW_S = 900.0    # reads ignore samples older than this
DEFAULT_MAX_SERIES = 4096   # distinct labeled series kept


def series_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """Canonical series identity: ``name{k=v,...}`` with sorted labels
    (bare ``name`` when unlabeled) — the ``?series=`` query value."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


@dataclass
class _Series:
    name: str
    labels: Dict[str, str]
    samples: Deque[Tuple[float, float]] = field(default_factory=deque)


class TimeSeriesStore:
    """Thread-safe bounded store of labeled (wall, value) rings."""

    def __init__(self, max_samples: int = DEFAULT_MAX_SAMPLES,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_series: int = DEFAULT_MAX_SERIES,
                 clock=time.time):
        self.max_samples = max(2, int(max_samples))
        self.window_s = float(window_s)
        self.max_series = max(1, int(max_series))
        self.clock = clock
        self._mu = threading.Lock()
        self._series: Dict[str, _Series] = {}
        self._dropped_series = 0
        self._warned_full = False

    def configure(self, max_samples: Optional[int] = None,
                  window_s: Optional[float] = None,
                  max_series: Optional[int] = None) -> None:
        """Resize the rings / retention (CLI flags reconfigure the
        process-global STORE before serving starts; existing series are
        re-bounded in place)."""
        with self._mu:
            if max_samples is not None:
                self.max_samples = max(2, int(max_samples))
                for s in self._series.values():
                    s.samples = deque(s.samples, maxlen=self.max_samples)
            if window_s is not None:
                self.window_s = float(window_s)
            if max_series is not None:
                self.max_series = max(1, int(max_series))

    # -- writes --------------------------------------------------------------
    def add(self, name: str, value: float,
            labels: Optional[Dict[str, str]] = None,
            wall: Optional[float] = None) -> bool:
        """Append one sample; O(1).  Returns False when the series-count
        bound rejected a NEW series (existing series always accept)."""
        key = series_key(name, labels)
        wall = self.clock() if wall is None else float(wall)
        with self._mu:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self._dropped_series += 1
                    if not self._warned_full:
                        self._warned_full = True
                        logger.warning(
                            "time-series store full (%d series); new "
                            "series are dropped — raise "
                            "timeseries_max_samples/max_series or reduce "
                            "label cardinality", self.max_series)
                    return False
                s = _Series(name=name, labels=dict(labels or {}),
                            samples=deque(maxlen=self.max_samples))
                self._series[key] = s
            s.samples.append((wall, float(value)))
        return True

    # -- reads ---------------------------------------------------------------
    def keys(self) -> List[str]:
        with self._mu:
            return sorted(self._series)

    def matching(self, name: str,
                 labels: Optional[Dict[str, str]] = None,
                 since: float = 0.0
                 ) -> List[Tuple[Dict[str, str],
                                 List[Tuple[float, float]]]]:
        """Every series of ``name`` whose labels are a superset of
        ``labels``, as [(labels, [(wall, value), ...])] snapshots —
        evaluation-safe: the lists are copies, so concurrent appends and
        ring evictions cannot corrupt a walk in progress."""
        want = labels or {}
        out = []
        with self._mu:
            for s in self._series.values():
                if s.name != name:
                    continue
                if any(s.labels.get(k) != v for k, v in want.items()):
                    continue
                samples = [p for p in s.samples if p[0] >= since] \
                    if since else list(s.samples)
                out.append((dict(s.labels), samples))
        return out

    def samples(self, name: str,
                labels: Optional[Dict[str, str]] = None,
                since: float = 0.0) -> List[Tuple[float, float]]:
        """One exact series' samples (empty when absent)."""
        key = series_key(name, labels)
        with self._mu:
            s = self._series.get(key)
            if s is None:
                return []
            return [p for p in s.samples if p[0] >= since] \
                if since else list(s.samples)

    def latest(self, name: str,
               labels: Optional[Dict[str, str]] = None
               ) -> Optional[float]:
        key = series_key(name, labels)
        with self._mu:
            s = self._series.get(key)
            return s.samples[-1][1] if s is not None and s.samples else None

    def increase(self, name: str,
                 labels: Optional[Dict[str, str]] = None,
                 window_s: float = 300.0,
                 now: Optional[float] = None) -> float:
        """Counter increase over the trailing window, summed across every
        matching labeled child, reset-aware: a negative step (the counter
        restarted from zero) contributes the NEW value, mirroring the
        FleetView's task-rate fold.  The sample immediately preceding the
        window anchors the first in-window delta, so sparse sampling
        never undercounts."""
        now = self.clock() if now is None else now
        start = now - float(window_s)
        total = 0.0
        for _, samples in self.matching(name, labels):
            prev = None
            for wall, value in samples:
                if wall < start:
                    prev = value
                    continue
                if prev is not None:
                    delta = value - prev
                    total += delta if delta >= 0 else value
                prev = value
        return total

    @staticmethod
    def slope(samples: List[Tuple[float, float]],
              min_samples: int = 2) -> Optional[float]:
        """Least-squares slope in value-units per second, or None when
        the series can't support one (fewer than ``min_samples`` points,
        or zero time spread — a single sample has no slope)."""
        n = len(samples)
        if n < max(2, min_samples):
            return None
        mean_t = sum(p[0] for p in samples) / n
        mean_v = sum(p[1] for p in samples) / n
        var_t = sum((p[0] - mean_t) ** 2 for p in samples)
        if var_t <= 0.0:
            return None
        cov = sum((p[0] - mean_t) * (p[1] - mean_v) for p in samples)
        return cov / var_t

    @staticmethod
    def downsample(samples: List[Tuple[float, float]], bucket_s: float
                   ) -> List[Tuple[float, float, int]]:
        """Epoch-aligned buckets: [(bucket_start, mean, count)].
        Alignment is absolute (floor(wall / bucket) * bucket), so every
        reader asking for the same bucket width sees the same
        boundaries."""
        bucket_s = float(bucket_s)
        if bucket_s <= 0 or not samples:
            return [(w, v, 1) for w, v in samples]
        acc: Dict[float, Tuple[float, int]] = {}
        for wall, value in samples:
            b = (wall // bucket_s) * bucket_s
            total, n = acc.get(b, (0.0, 0))
            acc[b] = (total + value, n + 1)
        return [(b, total / n, n)
                for b, (total, n) in sorted(acc.items())]

    # -- export --------------------------------------------------------------
    def snapshot(self, series: Optional[str] = None,
                 window_s: float = 0.0,
                 since_s: float = 0.0,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/timeseries`` JSON body.  ``series`` filters by metric
        name OR exact series key; ``window_s`` > 0 downsamples into
        aligned buckets; ``since_s`` bounds history (default: the store's
        retention window)."""
        now = self.clock() if now is None else now
        horizon = now - (since_s if since_s > 0 else self.window_s)
        with self._mu:
            picked = []
            for key, s in self._series.items():
                if series and series not in (s.name, key):
                    continue
                picked.append((key, s.name, dict(s.labels),
                               [p for p in s.samples if p[0] >= horizon]))
            dropped = self._dropped_series
        body: Dict[str, Any] = {
            "generated_at": now,
            "window_s": self.window_s,
            "max_samples": self.max_samples,
            "series_count": len(picked),
            "dropped_series": dropped,
            "series": {},
        }
        for key, name, labels, samples in sorted(picked):
            if window_s > 0:
                points = [[round(b, 3), round(mean, 6), n]
                          for b, mean, n in self.downsample(samples,
                                                            window_s)]
            else:
                points = [[round(w, 3), v] for w, v in samples]
            body["series"][key] = {"name": name, "labels": labels,
                                   "samples": points}
        return body

    def reset(self) -> None:
        with self._mu:
            self._series.clear()
            self._dropped_series = 0
            self._warned_full = False


class RegistrySampler:
    """Self-sampling: one process's metrics registry → its own store.

    Each :meth:`sample` parses the registry's exposition through the ONE
    shared parser (`utils/exposition.py:parse_exposition`) and appends
    every sample as a time-series point.  Histogram
    ``_bucket`` children are skipped (per-le cardinality would crowd out
    real series; ``_sum``/``_count`` survive and carry the same story).
    Never raises — sampling telemetry must not take a heartbeat down.
    """

    def __init__(self, registry, store: Optional[TimeSeriesStore] = None,
                 include_prefixes: Tuple[str, ...] = (),
                 exclude_suffixes: Tuple[str, ...] = ("_bucket",)):
        self.registry = registry
        self.store = store if store is not None else STORE
        self.include_prefixes = tuple(include_prefixes)
        self.exclude_suffixes = tuple(exclude_suffixes)

    def sample(self, now: Optional[float] = None) -> int:
        """One self-sampling tick; returns the samples appended."""
        try:
            text = self.registry.expose()
        except Exception as e:
            logger.debug("registry self-sample degraded: %s", e)
            return 0
        added = 0
        wall = self.store.clock() if now is None else now
        for s in parse_exposition(text):
            if self.exclude_suffixes and \
                    s.name.endswith(self.exclude_suffixes):
                continue
            if self.include_prefixes and \
                    not s.name.startswith(self.include_prefixes):
                continue
            if self.store.add(s.name, s.value, s.labels or None,
                              wall=wall):
                added += 1
        return added


# The process-global store: workers self-sample into it and the metrics
# server serves it at /timeseries (the TRACER/RECORDER pattern).
STORE = TimeSeriesStore()
configure = STORE.configure

"""SLO watchdog: declared latency budgets evaluated over the span ring.

The reference's `distributed_crawler_tpu/utils/slo.py`.  Each budget
(``slo_batch_p95_ms``, ``slo_queue_wait_ms``, ``slo_batch_age_ms``,
``slo_asr_batch_p95_ms``) names a set of span names; on every evaluation
tick (the workers' heartbeat loops) the nearest-rank p95 over the spans
finished since the previous tick is held against it.  A breach increments
``slo_breach_total{slo=...}`` (and a ``tenant``-labelled child per tenant
that breached on its own spans), logs a WARNING naming the worst span's
``trace_id``, and records a ``slo_breach`` flight event.  Evaluation is
windowed: a recovered service stops counting.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import flight, trace
from .metrics import REGISTRY, MetricsRegistry

logger = logging.getLogger("dct.slo")

# Span names that measure one unit of work end to end, per worker kind.
# The batch budget reads whichever of these the process emits.
BATCH_SPANS = ("tpu_worker.process", "tpu_worker.coalesce",
               "worker.process", "cluster_worker.process")
QUEUE_WAIT_SPANS = ("tpu_worker.queue_wait", "asr_worker.queue_wait",
                    "cluster_worker.queue_wait")
# Whole-pipeline age of a record batch (creation -> device), recorded by
# the TPU worker from ``RecordBatch.created_at``.  Unlike queue_wait —
# which only sees time inside THIS worker's queue — batch age covers the
# bus/broker leg, so it is the budget that catches a dead worker's
# backlog: frames stranded on the broker while the worker was down come
# back old, even though they clear the local queue instantly.
BATCH_AGE_SPANS = ("tpu_worker.batch_age", "asr_worker.batch_age",
                   "cluster_worker.batch_age")
# The ASR worker's unit of work (an audio-batch group through decode →
# window → bucketed Whisper programs).  A separate budget from the text
# batch one because the latency regimes differ by orders of magnitude
# (seconds of greedy decode vs milliseconds of embed+classify).
ASR_BATCH_SPANS = ("asr_worker.process", "asr_worker.coalesce")


@dataclass(frozen=True)
class SLO:
    """One declared budget: the p95 of ``span_names`` must stay under
    ``budget_ms``."""

    name: str                       # label value in slo_breach_total{slo=}
    span_names: Tuple[str, ...]
    budget_ms: float


def standard_slos(batch_p95_ms: float = 0.0,
                  queue_wait_ms: float = 0.0,
                  batch_age_ms: float = 0.0,
                  asr_batch_p95_ms: float = 0.0) -> List[SLO]:
    """The CLI's budget set; zero/negative budgets are simply absent."""
    out: List[SLO] = []
    if batch_p95_ms > 0:
        out.append(SLO("batch_p95", BATCH_SPANS, batch_p95_ms))
    if queue_wait_ms > 0:
        out.append(SLO("queue_wait", QUEUE_WAIT_SPANS, queue_wait_ms))
    if batch_age_ms > 0:
        out.append(SLO("batch_age", BATCH_AGE_SPANS, batch_age_ms))
    if asr_batch_p95_ms > 0:
        out.append(SLO("asr_batch", ASR_BATCH_SPANS, asr_batch_p95_ms))
    return out


class SLOWatchdog:
    """Windowed budget evaluation over the process tracer's span ring."""

    def __init__(self, slos: List[SLO], tracer: Optional[trace.Tracer] = None,
                 registry: MetricsRegistry = REGISTRY):
        self.slos = list(slos)
        self.tracer = tracer or trace.TRACER
        self._lock = threading.Lock()
        self._last_eval = time.time()
        self._warned_disabled = False
        self._breach_counts: Dict[str, int] = {s.name: 0 for s in self.slos}
        # {(tenant, slo): count} — children of the same counter family,
        # NEVER replacing the aggregate (the tenant-labeled series carry
        # the extra ``tenant`` label; the parent {slo=} series stays the
        # fleet truth existing dashboards and gates read).
        self._tenant_breach_counts: Dict[Tuple[str, str], int] = {}
        self.m_breaches = registry.counter(
            "slo_breach_total",
            "declared latency budgets busted, by SLO name (one per "
            "evaluation tick the breach spans; tenant-labeled children "
            "split the same events by workload)")

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One tick: digest spans completed since the last tick against
        every budget; returns the breach records (also counted, logged,
        and flight-recorded).  Cheap when nothing completed."""
        now = now if now is not None else time.time()
        with self._lock:
            since, self._last_eval = self._last_eval, now
        if not self.slos:
            return []
        if getattr(self.tracer, "capacity", 1) <= 0:
            # Budgets ride the span ring: with recording off they can
            # never be evaluated — say so ONCE instead of staying
            # silently green forever.  Checked per tick (not at
            # construction) because the tracer is reconfigurable.
            if not self._warned_disabled:
                self._warned_disabled = True
                logger.warning(
                    "SLO budgets declared (%s) but span recording is "
                    "disabled (tracer capacity 0); budgets will NOT be "
                    "evaluated", ", ".join(s.name for s in self.slos))
            return []
        self._warned_disabled = False
        spans = [s for s in self.tracer.spans()
                 if (s.start_wall + s.duration_s) > since]
        breaches: List[Dict[str, Any]] = []
        for slo in self.slos:
            matched = [s for s in spans if s.name in slo.span_names]
            if not matched:
                continue
            matched.sort(key=lambda s: s.duration_s)
            n = len(matched)
            # Nearest-rank p95, matching utils/trace.latency_digest.
            p95_span = matched[min(n - 1, max(0, math.ceil(0.95 * n) - 1))]
            p95_ms = p95_span.duration_s * 1000.0
            if p95_ms <= slo.budget_ms:
                continue
            worst = matched[-1]
            self.m_breaches.labels(slo=slo.name).inc()
            with self._lock:
                self._breach_counts[slo.name] = \
                    self._breach_counts.get(slo.name, 0) + 1
            logger.warning(
                "SLO %s busted: p95 %.1fms > budget %.0fms over %d spans "
                "(worst %s %.1fms trace=%s)",
                slo.name, p95_ms, slo.budget_ms, n, worst.name,
                worst.duration_s * 1000.0, worst.trace_id)
            flight.record("slo_breach", slo=slo.name,
                          p95_ms=round(p95_ms, 1),
                          budget_ms=slo.budget_ms, spans=n,
                          worst_span=worst.name,
                          worst_ms=round(worst.duration_s * 1000.0, 1),
                          trace_id=worst.trace_id)
            breaches.append({
                "slo": slo.name, "p95_ms": round(p95_ms, 1),
                "budget_ms": slo.budget_ms, "spans": n,
                "worst_trace_id": worst.trace_id,
            })
        # Per-tenant children: the same spans, split by their ``tenant``
        # attr, each judged against the same budget.  Runs
        # even when the aggregate stayed green — one hot tenant can bust
        # its own p95 inside a healthy fleet p95.
        for slo in self.slos:
            by_tenant: Dict[str, List[Any]] = {}
            for s in spans:
                if s.name not in slo.span_names:
                    continue
                tenant = getattr(s, "attrs", {}).get("tenant")
                if tenant:
                    by_tenant.setdefault(str(tenant), []).append(s)
            for tenant, matched in by_tenant.items():
                matched.sort(key=lambda s: s.duration_s)
                n = len(matched)
                p95_span = matched[min(n - 1,
                                       max(0, math.ceil(0.95 * n) - 1))]
                if p95_span.duration_s * 1000.0 <= slo.budget_ms:
                    continue
                self.m_breaches.labels(slo=slo.name, tenant=tenant).inc()
                with self._lock:
                    key = (tenant, slo.name)
                    self._tenant_breach_counts[key] = \
                        self._tenant_breach_counts.get(key, 0) + 1
        return breaches

    def snapshot(self) -> Dict[str, Any]:
        """Budgets + cumulative breach counts (the /costs ``slo`` map).
        ``tenant_breaches`` nests {tenant: {slo: count}} so heartbeats
        can carry the per-tenant split next to the aggregate."""
        with self._lock:
            counts = dict(self._breach_counts)
            tenant_counts = dict(self._tenant_breach_counts)
        by_tenant: Dict[str, Dict[str, int]] = {}
        for (tenant, slo_name), n in sorted(tenant_counts.items()):
            by_tenant.setdefault(tenant, {})[slo_name] = n
        return {
            "budgets": [{"slo": s.name, "budget_ms": s.budget_ms,
                         "spans": list(s.span_names)} for s in self.slos],
            "breaches": counts,
            "tenant_breaches": by_tenant,
        }

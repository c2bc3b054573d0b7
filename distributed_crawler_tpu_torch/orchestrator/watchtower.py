"""The fleet watchtower: history + rules + alerts over the live fleet.

The port's copy of the reference's `distributed_crawler_tpu/orchestrator/
watchtower.py`.  `FleetView` folds every heartbeat into the current
picture of each worker; the watchtower remembers and judges.  Beside the
fleet view inside the orchestrator it:

- **feeds the rolling time-series store** (`utils/timeseries.STORE`) from
  every accepted heartbeat: queue depth, MFU, per-chip goodput, device
  occupancy, RSS, SLO breach counters and the per-tenant spend and
  breach folds, one ``fleet_*`` series per worker (and per chip, SLO or
  tenant where labeled);
- **self-samples the orchestrator's metrics registry** each tick
  (`RegistrySampler`), and derives ``watchtower_outbox_utilization
  {publisher}`` (depth/capacity) for the near-full rule;
- **evaluates the alert engine** (`utils/alerts.py`) on the
  orchestrator's ticks, at most once per ``EVAL_INTERVAL_S``, publishing
  every firing/resolved transition as an `AlertMessage` on
  ``TOPIC_ALERTS`` and serving the lifecycle state at ``/alerts``;
- holds the tenant ledger (`orchestrator/tenants.py`) behind
  ``/tenants``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ..bus.messages import TOPIC_ALERTS, AlertMessage, StatusMessage
from ..utils.alerts import AlertEngine, AlertRule, default_rules
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.timeseries import STORE, RegistrySampler
from .tenants import TenantBudgetLedger

logger = logging.getLogger("dct.watchtower")

# Seconds between alert evaluations: the orchestrator's default
# ``alert_eval_interval_s`` (the load gate evaluates at its own cadence).
EVAL_INTERVAL_S = 5.0


class Watchtower:
    """History + alerting beside one orchestrator's `FleetView`."""

    def __init__(self, fleet,
                 rules: Optional[List[AlertRule]] = None,
                 registry: MetricsRegistry = REGISTRY,
                 bus=None,
                 eval_interval_s: float = EVAL_INTERVAL_S):
        self.fleet = fleet
        self.eval_interval_s = float(eval_interval_s)
        self.store = STORE
        self.bus = bus
        self.clock = time.time
        self.registry = registry
        self.engine = AlertEngine(
            rules if rules is not None else default_rules(),
            registry=registry, publish=self._publish_transition)
        self._sampler = RegistrySampler(registry, self.store)
        # Per-tenant spend + error-budget view over the fleet folds
        # below (orchestrator/tenants.py); budgets are installed later
        # via ``tenants.configure`` (the CLI's --tenant-budgets).
        self.tenants = TenantBudgetLedger()
        self._mu = threading.Lock()
        self._last_eval = 0.0
        self._ticks = 0

    # -- heartbeat fold ------------------------------------------------------
    def observe_status(self, msg: StatusMessage,
                       wall: Optional[float] = None) -> None:
        """Fold one heartbeat's telemetry into per-worker series.  Called
        by `Orchestrator.handle_status` right after the FleetView fold;
        never raises (history must not break the registry path)."""
        try:
            self._observe(msg, wall)
        except Exception as e:
            logger.debug("watchtower heartbeat fold degraded: %s", e)

    def _observe(self, msg: StatusMessage, wall: Optional[float]) -> None:
        wall = self.clock() if wall is None else wall
        wid = msg.worker_id
        usage = msg.resource_usage or {}
        labels = {"worker": wid}
        queue = usage.get("queue") or {}
        depth = queue.get("depth_time_weighted", queue.get("depth"))
        if depth is None:
            depth = msg.queue_length
        self.store.add("fleet_queue_depth", float(depth), labels,
                       wall=wall)
        rss = usage.get("rss_bytes")
        if isinstance(rss, (int, float)):
            self.store.add("fleet_rss_bytes", float(rss), labels,
                           wall=wall)
        eff = usage.get("efficiency")
        if isinstance(eff, dict):
            for key, series in (("mfu", "fleet_mfu"),
                                ("goodput_tokens_per_s",
                                 "fleet_goodput_tokens_per_s")):
                value = eff.get(key)
                if isinstance(value, (int, float)):
                    self.store.add(series, float(value), labels, wall=wall)
            for chip in (eff.get("per_chip") or []):
                if not isinstance(chip, dict):
                    continue
                goodput = chip.get("goodput_tokens_per_s")
                if isinstance(goodput, (int, float)):
                    self.store.add(
                        "fleet_per_chip_goodput_tokens_per_s",
                        float(goodput),
                        {"worker": wid,
                         "device": str(chip.get("device", "?"))},
                        wall=wall)
        occ = usage.get("occupancy")
        if isinstance(occ, dict):
            for key, series in (
                    ("busy_fraction", "fleet_occupancy_busy"),
                    ("overlap_fraction", "fleet_occupancy_overlap"),
                    ("bubble_share", "fleet_occupancy_bubble_share")):
                value = occ.get(key)
                if isinstance(value, (int, float)):
                    self.store.add(series, float(value), labels, wall=wall)
        breaches = usage.get("slo_breaches")
        if isinstance(breaches, dict):
            # Cumulative per-SLO breach counts from the worker's own
            # watchdog: the series the default burn-rate rules read.
            # Counter resets across worker restarts are absorbed by the
            # store's reset-aware increase().
            for slo, count in breaches.items():
                if isinstance(count, (int, float)):
                    self.store.add("fleet_slo_breach_total", float(count),
                                   {"worker": wid, "slo": str(slo)},
                                   wall=wall)
        # Per-tenant spend + breach folds: the worker's
        # TenantLedger rows and the watchdog's tenant-labeled breach
        # split become fleet series — what /tenants and the error-budget
        # ledger read.  Cumulative counters, so restarts are absorbed by
        # increase() exactly like the aggregate breach fold above.
        tenants = usage.get("tenants")
        if isinstance(tenants, dict):
            for row in (tenants.get("rows") or []):
                if not isinstance(row, dict):
                    continue
                tenant = str(row.get("tenant") or "")
                if not tenant:
                    continue
                tlabels = {"worker": wid, "tenant": tenant}
                for key, series in (
                        ("chip_seconds", "fleet_tenant_chip_seconds_total"),
                        ("flops", "fleet_tenant_flops_total"),
                        ("real_tokens", "fleet_tenant_real_tokens_total"),
                        ("batches", "fleet_tenant_batches_total")):
                    value = row.get(key)
                    if isinstance(value, (int, float)):
                        self.store.add(series, float(value), tlabels,
                                       wall=wall)
                p95 = row.get("queue_wait_p95_s")
                if isinstance(p95, (int, float)):
                    self.store.add("fleet_tenant_queue_wait_p95_seconds",
                                   float(p95), tlabels, wall=wall)
        tenant_breaches = usage.get("tenant_slo_breaches")
        if isinstance(tenant_breaches, dict):
            for tenant, slos in tenant_breaches.items():
                if not isinstance(slos, dict):
                    continue
                for slo, count in slos.items():
                    if isinstance(count, (int, float)):
                        self.store.add(
                            "fleet_tenant_slo_breach_total", float(count),
                            {"worker": wid, "tenant": str(tenant),
                             "slo": str(slo)}, wall=wall)

    # -- the tick ------------------------------------------------------------
    def tick(self, now: Optional[float] = None,
             force: bool = False) -> List[Dict[str, Any]]:
        """One watchtower pass: registry self-sample + alert evaluation.
        Rate-limited to ``eval_interval_s`` (the orchestrator calls this
        from both its distribute and health ticks); ``force=True``
        bypasses the limiter.  Returns the alert transitions this pass
        produced."""
        now = self.clock() if now is None else now
        with self._mu:
            if not force and now - self._last_eval < self.eval_interval_s:
                return []
            self._last_eval = now
            self._ticks += 1
        try:
            # The registry sample captures fleet_stale_workers through
            # its fn-bound gauge.
            self._sampler.sample(now=now)
            self._derive_outbox_utilization(now)
        except Exception as e:
            logger.debug("watchtower sampling degraded: %s", e)
        return self.engine.evaluate(now=now)

    def _derive_outbox_utilization(self, now: float) -> None:
        """``watchtower_outbox_utilization{publisher}`` = depth/capacity
        from the outbox gauges (`bus/outbox.py`) — the ratio the
        near-full rule thresholds on (raw depth would need per-site
        bounds)."""
        depth = self.registry.gauge("bus_outbox_depth")
        capacity = self.registry.gauge("bus_outbox_capacity")
        caps = {tuple(sorted(labels.items())): value
                for labels, value in capacity.series() if labels}
        for labels, value in depth.series():
            if not labels:
                continue
            cap = caps.get(tuple(sorted(labels.items())), 0.0)
            if cap > 0:
                self.store.add("watchtower_outbox_utilization",
                               value / cap, labels, wall=now)

    # -- export --------------------------------------------------------------
    def get_alerts(self) -> Dict[str, Any]:
        """The ``/alerts`` JSON body (registered via
        `utils.metrics.set_alerts_provider`)."""
        body = self.engine.snapshot()
        with self._mu:
            body["watchtower"] = {
                "ticks": self._ticks,
                "eval_interval_s": self.eval_interval_s,
                "series_count": len(self.store.keys()),
            }
        return body

    def get_tenants(self) -> Dict[str, Any]:
        """The ``/tenants`` JSON body (registered via
        `utils.metrics.set_tenants_provider`)."""
        return self.tenants.view()

    def firing(self) -> List[str]:
        return self.engine.firing()

    # -- publish seam --------------------------------------------------------
    def _publish_transition(self, event: Dict[str, Any]) -> None:
        if self.bus is None:
            return
        msg = AlertMessage.new(
            rule=event["rule"], kind=event["kind"],
            series=event["series"], state=event["to"],
            prev_state=event["from"], severity=event["severity"],
            value=event["value"], detail=event.get("detail"),
            at_wall=event["at"])
        # Publish errors are caught by the engine's publish guard — the
        # bus must never break an evaluation pass.
        self.bus.publish(TOPIC_ALERTS, msg.to_dict())

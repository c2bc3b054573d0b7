"""Per-tenant accounting + error-budget ledger: the ``/tenants`` surface.

The port's copy of the reference's `distributed_crawler_tpu/orchestrator/
tenants.py`.  The serving workers attribute chip-seconds, FLOPs and
tokens to tenants (`utils/costmodel.TenantLedger`) and split their SLO
breach counters by tenant (`utils/slo.py`); the watchtower folds both out
of heartbeats into ``fleet_tenant_*`` series.  This ledger judges them:

- **spend rows**: per-tenant chip-seconds / FLOPs / real tokens /
  batches summed across the fleet (latest cumulative value per worker),
  each tenant's share of total spend and its worst queue-wait p95;
- **error budgets**: for every configured ``(tenant, slo)`` budget, the
  windowed breach burn (reset-aware ``TimeSeriesStore.increase``), the
  remaining budget, the burn rate (least-squares slope) and the seconds
  until exhaustion at that rate.

Budgets come from ``observability.tenant_budgets`` (``--tenant-budgets``)
through :func:`budgets_from_config`, which refuses a malformed block.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..bus.messages import DEFAULT_TENANT
from ..utils.timeseries import STORE, TimeSeriesStore

# The spend series the watchtower folds (cumulative counters, one child
# per {worker, tenant}) and the row keys they aggregate into.
_SPEND_SERIES: Tuple[Tuple[str, str], ...] = (
    ("fleet_tenant_chip_seconds_total", "chip_seconds"),
    ("fleet_tenant_flops_total", "flops"),
    ("fleet_tenant_real_tokens_total", "real_tokens"),
    ("fleet_tenant_batches_total", "batches"),
)
_BREACH_SERIES = "fleet_tenant_slo_breach_total"
_QUEUE_WAIT_SERIES = "fleet_tenant_queue_wait_p95_seconds"

DEFAULT_BUDGET_WINDOW_S = 300.0


def budgets_from_config(block: Any) -> Tuple[Dict[str, Dict[str, float]],
                                             float]:
    """Validate a ``tenant_budgets`` block into ``({tenant: {slo:
    allowed_breaches}}, window_s)``.  Loud on malformed input: unknown
    top-level keys, non-dict budgets, non-numeric or negative counts all
    raise ValueError — a misspelled budget must fail the run, not
    silently never be enforced.  ``None``/``{}`` mean "no budgets"."""
    if block is None:
        return {}, DEFAULT_BUDGET_WINDOW_S
    if not isinstance(block, dict):
        raise ValueError(
            f"tenant_budgets must be a mapping, got {type(block).__name__}")
    unknown = set(block) - {"window_s", "budgets"}
    if unknown:
        raise ValueError(
            f"unknown tenant_budgets key(s): {sorted(unknown)} "
            "(expected: window_s, budgets)")
    window_s = block.get("window_s", DEFAULT_BUDGET_WINDOW_S)
    if not isinstance(window_s, (int, float)) or isinstance(window_s, bool) \
            or float(window_s) <= 0:
        raise ValueError(
            f"tenant_budgets.window_s must be a positive number, "
            f"got {window_s!r}")
    budgets_block = block.get("budgets", {})
    if not isinstance(budgets_block, dict):
        raise ValueError("tenant_budgets.budgets must be a mapping of "
                         "tenant -> {slo: allowed_breaches}")
    budgets: Dict[str, Dict[str, float]] = {}
    for tenant, slos in budgets_block.items():
        if not isinstance(tenant, str) or not tenant.strip():
            raise ValueError(
                f"tenant_budgets.budgets key must be a non-empty tenant "
                f"name, got {tenant!r}")
        if not isinstance(slos, dict) or not slos:
            raise ValueError(
                f"tenant_budgets.budgets[{tenant!r}] must be a non-empty "
                "mapping of slo -> allowed_breaches")
        per_slo: Dict[str, float] = {}
        for slo, allowed in slos.items():
            if not isinstance(slo, str) or not slo.strip():
                raise ValueError(
                    f"tenant_budgets.budgets[{tenant!r}] has a non-string "
                    f"SLO key: {slo!r}")
            if not isinstance(allowed, (int, float)) \
                    or isinstance(allowed, bool) or float(allowed) < 0:
                raise ValueError(
                    f"tenant_budgets.budgets[{tenant!r}][{slo!r}] must be "
                    f"a non-negative number, got {allowed!r}")
            per_slo[slo.strip()] = float(allowed)
        budgets[tenant.strip()] = per_slo
    return budgets, float(window_s)


class TenantBudgetLedger:
    """Fleet tenant spend + error-budget view over the time-series store."""

    def __init__(self):
        self.store = STORE
        self.clock = time.time
        self._mu = threading.Lock()
        self._budgets: Dict[str, Dict[str, float]] = {}
        self._window_s = DEFAULT_BUDGET_WINDOW_S

    def configure(self, budgets: Optional[Dict[str, Dict[str, float]]] = None,
                  window_s: Optional[float] = None) -> None:
        """Install validated budgets (`budgets_from_config`): the CLI does
        at startup."""
        with self._mu:
            if budgets is not None:
                self._budgets = {t: dict(s) for t, s in budgets.items()}
            if window_s is not None and float(window_s) > 0:
                self._window_s = float(window_s)

    # -- aggregation over the fleet folds ------------------------------------
    def _spend_rows(self) -> Dict[str, Dict[str, float]]:
        """{tenant: {chip_seconds, flops, ...}} — latest cumulative value
        per {worker, tenant} child, summed across workers."""
        rows: Dict[str, Dict[str, float]] = {}
        for series, key in _SPEND_SERIES:
            for labels, samples in self.store.matching(series):
                tenant = labels.get("tenant")
                if not tenant or not samples:
                    continue
                row = rows.setdefault(tenant, {})
                row[key] = row.get(key, 0.0) + samples[-1][1]
        for labels, samples in self.store.matching(_QUEUE_WAIT_SERIES):
            tenant = labels.get("tenant")
            if not tenant or not samples:
                continue
            row = rows.setdefault(tenant, {})
            # Worst worker's p95 — a fleet mean would hide the one queue
            # a tenant is actually stuck in.
            row["queue_wait_p95_s"] = max(row.get("queue_wait_p95_s", 0.0),
                                          samples[-1][1])
        return rows

    def _burn(self, tenant: str, slo: str, window_s: float,
              now: float) -> Tuple[float, Optional[float]]:
        """(windowed breach increase, burn rate per second) for one
        (tenant, slo) across all workers.  The increase is reset-aware;
        the rate is the summed least-squares slope of each worker's
        cumulative counter over the window (clamped at zero — a counter
        reset's negative slope is not a refund)."""
        labels = {"tenant": tenant, "slo": slo}
        burned = self.store.increase(_BREACH_SERIES, labels,
                                     window_s=window_s, now=now)
        rate = 0.0
        seen = False
        since = now - window_s
        for _, samples in self.store.matching(_BREACH_SERIES, labels,
                                              since=since):
            s = TimeSeriesStore.slope(samples)
            if s is not None:
                seen = True
                rate += max(0.0, s)
        return burned, (rate if seen else None)

    def _observed_breach_pairs(self) -> List[Tuple[str, str]]:
        """Every (tenant, slo) with a breach series, budgeted or not."""
        pairs = set()
        for labels, _ in self.store.matching(_BREACH_SERIES):
            tenant, slo = labels.get("tenant"), labels.get("slo")
            if tenant and slo:
                pairs.add((tenant, slo))
        return sorted(pairs)

    # -- export --------------------------------------------------------------
    def view(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/tenants`` JSON body."""
        now = self.clock() if now is None else now
        with self._mu:
            budgets = {t: dict(s) for t, s in self._budgets.items()}
            window_s = self._window_s
        rows = self._spend_rows()
        totals: Dict[str, float] = {}
        for row in rows.values():
            for _, key in _SPEND_SERIES:
                totals[key] = totals.get(key, 0.0) + row.get(key, 0.0)
        total_chip = totals.get("chip_seconds", 0.0)
        tenants: Dict[str, Dict[str, Any]] = {}
        names = set(rows) | set(budgets) | \
            {t for t, _ in self._observed_breach_pairs()}
        for tenant in sorted(names):
            row = rows.get(tenant, {})
            spend = {key: row.get(key, 0.0) for _, key in _SPEND_SERIES}
            spend["share"] = (spend["chip_seconds"] / total_chip) \
                if total_chip > 0 else 0.0
            entry: Dict[str, Any] = {"spend": spend}
            if "queue_wait_p95_s" in row:
                entry["queue_wait_p95_s"] = row["queue_wait_p95_s"]
            entry["budgets"] = {}
            tenants[tenant] = entry
        # Burn for every observed (tenant, slo) pair; budgeted pairs add
        # remaining + exhaustion even when they never breached.
        pairs = set(self._observed_breach_pairs())
        for tenant, slos in budgets.items():
            for slo in slos:
                pairs.add((tenant, slo))
        for tenant, slo in sorted(pairs):
            burned, rate = self._burn(tenant, slo, window_s, now)
            cell: Dict[str, Any] = {"burned": round(burned, 6)}
            if rate is not None:
                cell["burn_rate_per_s"] = round(rate, 9)
            allowed = budgets.get(tenant, {}).get(slo)
            if allowed is not None:
                remaining = allowed - burned
                cell["budget"] = allowed
                cell["remaining"] = round(remaining, 6)
                cell["exhausted"] = remaining <= 0
                if remaining <= 0:
                    cell["exhaustion_s"] = 0.0
                elif rate:
                    cell["exhaustion_s"] = round(remaining / rate, 3)
            tenants.setdefault(tenant, {"spend": {
                key: 0.0 for _, key in _SPEND_SERIES} | {"share": 0.0},
                "budgets": {}})
            tenants[tenant].setdefault("budgets", {})[slo] = cell
        unattributed = tenants.get(DEFAULT_TENANT, {}) \
            .get("spend", {}).get("share", 0.0)
        return {
            "generated_at": now,
            "window_s": window_s,
            "default_tenant": DEFAULT_TENANT,
            "tenants": tenants,
            "totals": {k: round(v, 9) for k, v in sorted(totals.items())},
            "unattributed_share": round(unattributed, 9),
        }

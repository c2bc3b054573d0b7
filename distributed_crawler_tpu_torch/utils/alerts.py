"""Declarative alert engine: rules over rolling time series.

The port's copy of the reference's `distributed_crawler_tpu/utils/
alerts.py`: declarative rules evaluated on the orchestrator's tick over
the rolling store (`utils/timeseries.py`), with Prometheus-style alert
lifecycles.  The rule grammar, the transitions, the ``/alerts`` body and
the metric names are the reference's.

Three rule kinds:

- ``threshold`` — an aggregate (``last``/``mean``/``min``/``max`` over
  ``window_s``) of the matching series, grouped across labeled children
  (``sum``/``min``/``max``), compared with ``op`` against ``value``;
- ``trend`` — least-squares slope over ``window_s`` (value-units per
  second, summed across children), compared with ``op`` against
  ``slope_per_s``; a series with fewer than ``min_samples`` points (or
  no time spread) has NO slope and the rule stays inactive;
- ``burn_rate`` — multi-window SLO burn rate: the counter's
  increase-rate over a FAST and a SLOW window, each divided by the
  budget rate (``budget`` events per ``budget_window_s``), must BOTH
  exceed ``factor``.  A zero/absent budget means zero tolerance: any
  increase burns at infinite rate.

Lifecycle per rule: ``inactive → pending →(held for_s) firing →(clear
held clear_for_s) resolved``; a resolved alert must re-confirm through
``pending`` for ``for_s`` again before re-firing, and a pending alert
whose condition clears never fires at all.  Every transition is
flight-recorded, counted (``alert_transitions_total{rule,to}``), kept in
a bounded log, and — through the publish seam the watchtower wires —
announced as an `AlertMessage` on ``TOPIC_ALERTS``.  `snapshot()` is the
``/alerts`` body.

The engine reads the process's time-series store and clock; callers
that need a fixed time pass ``now`` to :meth:`AlertEngine.evaluate`.
The default pack's tunables are the reference's defaults, as module
constants: no caller in the port sets them.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

from . import flight
from .metrics import REGISTRY, MetricsRegistry
from .timeseries import STORE

logger = logging.getLogger("dct.alerts")

ALERT_INACTIVE = "inactive"
ALERT_PENDING = "pending"
ALERT_FIRING = "firing"
ALERT_RESOLVED = "resolved"

RULE_KINDS = ("threshold", "trend", "burn_rate")
_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}
_AGGS = ("last", "mean", "min", "max")
_GROUPS = ("sum", "min", "max")

# Transitions kept for /alerts and postmortem bundles.
LOG_CAPACITY = 256

# The default pack's tunables (`default_rules`).
SLO_BUDGET = 10.0                # breaches allowed per budget window
SLO_BUDGET_WINDOW_S = 3600.0
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
BURN_FACTOR = 6.0
FOR_S = 15.0
PER_CHIP_GOODPUT_FLOOR = 0.0     # 0 keeps the collapse rule inert
OUTBOX_UTILIZATION_MAX = 0.8
DLQ_SLOPE_PER_S = 0.0
TREND_WINDOW_S = 300.0

# JSON clamp for infinite burn rates (zero budget + any breach): strict
# JSON has no Infinity, and the /alerts body must stay parseable.
_BURN_CLAMP = 1e9


@dataclass
class AlertRule:
    """One declared rule (the reference's watchtower rule grammar)."""

    name: str
    kind: str                                   # one of RULE_KINDS
    series: str                                 # metric name in the store
    labels: Dict[str, str] = field(default_factory=dict)
    # threshold
    op: str = ">"
    value: float = 0.0
    agg: str = "last"
    window_s: float = 60.0                      # threshold/trend window
    # across matching labeled children (threshold only; trends sum)
    group: str = "sum"
    # trend
    slope_per_s: float = 0.0
    min_samples: int = 3
    # burn_rate
    budget: float = 0.0                         # events per budget window
    budget_window_s: float = 3600.0
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    factor: float = 6.0
    # lifecycle
    for_s: float = 0.0                          # pending must hold this long
    clear_for_s: float = 0.0                    # clear must hold this long
    severity: str = "page"
    description: str = ""

    def validate(self) -> None:
        if not self.name:
            raise ValueError("alert rule name cannot be empty")
        if self.kind not in RULE_KINDS:
            raise ValueError(f"alert rule {self.name}: unknown kind "
                             f"{self.kind!r} (want {'|'.join(RULE_KINDS)})")
        if not self.series:
            raise ValueError(f"alert rule {self.name}: series required")
        if self.op not in _OPS:
            raise ValueError(f"alert rule {self.name}: op must be one of "
                             f"{', '.join(_OPS)}")
        if self.agg not in _AGGS:
            raise ValueError(f"alert rule {self.name}: agg must be one of "
                             f"{', '.join(_AGGS)}")
        if self.group not in _GROUPS:
            raise ValueError(f"alert rule {self.name}: group must be one "
                             f"of {', '.join(_GROUPS)}")
        if self.kind == "burn_rate" and self.fast_window_s <= 0:
            raise ValueError(f"alert rule {self.name}: fast_window_s must "
                             "be positive")
        if self.kind == "burn_rate" and \
                self.slow_window_s < self.fast_window_s:
            raise ValueError(f"alert rule {self.name}: slow_window_s must "
                             "be >= fast_window_s")

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AlertRule":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        unknown = set(d) - known
        if unknown:
            # A typo'd rule key must fail loudly at config time, not
            # silently evaluate a default forever.
            raise ValueError(
                f"alert rule {d.get('name', '?')}: unknown key(s) "
                f"{', '.join(sorted(unknown))}")
        try:
            rule = cls(**{k: v for k, v in d.items()})
        except TypeError as e:
            # Missing required keys raise TypeError from __init__; the
            # config-error contract (cli exit 2, scenario setup error)
            # catches ValueError — keep the promise.
            raise ValueError(
                f"alert rule {d.get('name', '?')}: {e}") from e
        rule.labels = dict(rule.labels or {})
        rule.validate()
        return rule


@dataclass
class _AlertState:
    state: str = ALERT_INACTIVE
    since: float = 0.0            # when the current state was entered
    pending_since: float = 0.0
    clear_since: float = 0.0      # condition-false streak while firing
    fired_at: float = 0.0
    resolved_at: float = 0.0
    fired_count: int = 0
    value: Optional[float] = None
    detail: Dict[str, Any] = field(default_factory=dict)


class AlertEngine:
    """Evaluate rules over a store; own the lifecycles; feed the surfaces."""

    def __init__(self, rules: List[AlertRule],
                 registry: MetricsRegistry = REGISTRY,
                 publish: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.rules = list(rules)
        for r in self.rules:
            r.validate()
        seen = set()
        for r in self.rules:
            if r.name in seen:
                raise ValueError(f"duplicate alert rule name {r.name!r}")
            seen.add(r.name)
        self.store = STORE
        self.clock = time.time
        self.publish = publish
        self._mu = threading.Lock()
        self._states: Dict[str, _AlertState] = {
            r.name: _AlertState() for r in self.rules}
        self._log: Deque = deque(maxlen=LOG_CAPACITY)
        self.m_firing = registry.gauge(
            "alerts_firing", "alert rules currently in the firing state")
        self.m_transitions = registry.counter(
            "alert_transitions_total",
            "alert lifecycle transitions by rule and target state")

    # -- condition evaluation ------------------------------------------------
    def _eval_threshold(self, rule: AlertRule, now: float
                        ) -> "tuple[bool, Optional[float], Dict[str, Any]]":
        since = now - rule.window_s if rule.window_s > 0 else 0.0
        children = self.store.matching(rule.series, rule.labels or None,
                                       since=since)
        per_child: List[float] = []
        for _, samples in children:
            if not samples:
                continue
            vals = [v for _, v in samples]
            if rule.agg == "last":
                per_child.append(vals[-1])
            elif rule.agg == "mean":
                per_child.append(sum(vals) / len(vals))
            elif rule.agg == "min":
                per_child.append(min(vals))
            else:
                per_child.append(max(vals))
        if not per_child:
            return False, None, {"series": 0}  # empty series: inactive
        if rule.group == "sum":
            value = sum(per_child)
        elif rule.group == "min":
            value = min(per_child)
        else:
            value = max(per_child)
        return (_OPS[rule.op](value, rule.value), value,
                {"series": len(per_child), "op": rule.op,
                 "threshold": rule.value})

    def _eval_trend(self, rule: AlertRule, now: float
                    ) -> "tuple[bool, Optional[float], Dict[str, Any]]":
        since = now - rule.window_s if rule.window_s > 0 else 0.0
        children = self.store.matching(rule.series, rule.labels or None,
                                       since=since)
        slopes = [s for s in
                  (self.store.slope(samples, rule.min_samples)
                   for _, samples in children)
                  if s is not None]
        if not slopes:
            # Too few samples for ANY slope (single-sample series
            # included): no judgement, not a breach.
            return False, None, {"series": 0}
        value = sum(slopes)  # fleet trend = summed per-child slopes
        return (_OPS[rule.op](value, rule.slope_per_s), value,
                {"series": len(slopes), "op": rule.op,
                 "slope_per_s": rule.slope_per_s})

    def _eval_burn(self, rule: AlertRule, now: float
                   ) -> "tuple[bool, Optional[float], Dict[str, Any]]":
        budget_rate = (rule.budget / rule.budget_window_s
                       if rule.budget > 0 and rule.budget_window_s > 0
                       else 0.0)

        def burn(window_s: float) -> float:
            rate = self.store.increase(rule.series, rule.labels or None,
                                       window_s=window_s,
                                       now=now) / window_s
            if budget_rate <= 0.0:
                # Zero budget = zero tolerance: any increase is an
                # infinite burn; no increase burns nothing.
                return math.inf if rate > 0 else 0.0
            return rate / budget_rate

        fast = burn(rule.fast_window_s)
        slow = burn(rule.slow_window_s)
        cond = fast >= rule.factor and slow >= rule.factor
        value = min(fast, _BURN_CLAMP)
        return cond, value, {
            "burn_fast": round(min(fast, _BURN_CLAMP), 3),
            "burn_slow": round(min(slow, _BURN_CLAMP), 3),
            "factor": rule.factor, "budget": rule.budget,
            "budget_window_s": rule.budget_window_s,
        }

    # -- lifecycle -----------------------------------------------------------
    def _transition(self, rule: AlertRule, st: _AlertState, to: str,
                    now: float) -> Dict[str, Any]:
        event = {
            "rule": rule.name, "kind": rule.kind, "series": rule.series,
            "from": st.state, "to": to, "at": now,
            "value": st.value if st.value is None
            else round(st.value, 6),
            "detail": dict(st.detail), "severity": rule.severity,
        }
        st.state = to
        st.since = now
        if to == ALERT_FIRING:
            st.fired_at = now
            st.fired_count += 1
        elif to == ALERT_RESOLVED:
            st.resolved_at = now
        self.m_transitions.labels(rule=rule.name, to=to).inc()
        flight.record("alert", rule=rule.name, rule_kind=rule.kind,
                      series=rule.series, prev=event["from"], to=to,
                      value=event["value"], severity=rule.severity)
        logger.log(
            logging.WARNING if to == ALERT_FIRING else logging.INFO,
            "alert %s: %s -> %s (value=%s)", rule.name, event["from"], to,
            event["value"])
        self._log.append(event)
        return event

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation tick over every rule; returns the transitions
        that happened (empty most ticks)."""
        now = self.clock() if now is None else now
        transitions: List[Dict[str, Any]] = []
        with self._mu:
            for rule in self.rules:
                st = self._states[rule.name]
                try:
                    if rule.kind == "threshold":
                        cond, value, detail = self._eval_threshold(rule, now)
                    elif rule.kind == "trend":
                        cond, value, detail = self._eval_trend(rule, now)
                    else:
                        cond, value, detail = self._eval_burn(rule, now)
                except Exception as e:
                    logger.warning("alert rule %s evaluation failed: %s",
                                   rule.name, e)
                    continue
                st.value, st.detail = value, detail
                if cond:
                    st.clear_since = 0.0
                    if st.state in (ALERT_INACTIVE, ALERT_RESOLVED):
                        # Re-fire from resolved goes through pending
                        # again: the for_s confirm IS the flap
                        # suppression.
                        st.pending_since = now
                        transitions.append(self._transition(
                            rule, st, ALERT_PENDING, now))
                        if rule.for_s <= 0:
                            transitions.append(self._transition(
                                rule, st, ALERT_FIRING, now))
                    elif st.state == ALERT_PENDING and \
                            now - st.pending_since >= rule.for_s:
                        transitions.append(self._transition(
                            rule, st, ALERT_FIRING, now))
                else:
                    if st.state == ALERT_PENDING:
                        # Pending that never confirms: back to inactive,
                        # no firing, no publish.
                        transitions.append(self._transition(
                            rule, st, ALERT_INACTIVE, now))
                    elif st.state == ALERT_FIRING:
                        if st.clear_since <= 0.0:
                            st.clear_since = now
                        if now - st.clear_since >= rule.clear_for_s:
                            st.clear_since = 0.0
                            transitions.append(self._transition(
                                rule, st, ALERT_RESOLVED, now))
            self.m_firing.set(float(sum(
                1 for s in self._states.values()
                if s.state == ALERT_FIRING)))
        # Publish OUTSIDE the engine lock: a slow or down broker must
        # stall neither /alerts reads (snapshot takes _mu) nor the next
        # evaluation — only this call.
        if self.publish is not None:
            for event in transitions:
                if event["to"] not in (ALERT_FIRING, ALERT_RESOLVED):
                    continue
                try:
                    self.publish(event)
                except Exception as e:  # the bus must not break evaluation
                    logger.warning("alert publish failed: %s", e)
        return transitions

    # -- export --------------------------------------------------------------
    def firing(self) -> List[str]:
        with self._mu:
            return sorted(name for name, s in self._states.items()
                          if s.state == ALERT_FIRING)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/alerts`` JSON body: per-rule state + the transition log
        (postmortem bundles embed this — the alert history a dead
        process can no longer serve)."""
        now = self.clock()
        with self._mu:
            alerts = []
            for rule in self.rules:
                st = self._states[rule.name]
                alerts.append({
                    "rule": rule.name, "kind": rule.kind,
                    "series": rule.series, "labels": rule.labels,
                    "severity": rule.severity, "state": st.state,
                    "since": st.since, "value": st.value
                    if st.value is None else round(st.value, 6),
                    "detail": dict(st.detail),
                    "fired_count": st.fired_count,
                    "fired_at": st.fired_at or None,
                    "resolved_at": st.resolved_at or None,
                    "for_s": rule.for_s,
                    "description": rule.description,
                })
            log = list(self._log)
        return {
            "generated_at": now,
            "firing": sorted(a["rule"] for a in alerts
                             if a["state"] == ALERT_FIRING),
            "alerts": alerts,
            "log": log,
        }


def default_rules() -> List[AlertRule]:
    """The default rule pack the watchtower installs, the reference's.
    Series names are the watchtower's heartbeat folds plus the registry
    self-sample names."""
    return [
        AlertRule(
            name="queue_wait_burn", kind="burn_rate",
            series="fleet_slo_breach_total", labels={"slo": "queue_wait"},
            budget=SLO_BUDGET, budget_window_s=SLO_BUDGET_WINDOW_S,
            fast_window_s=FAST_WINDOW_S, slow_window_s=SLOW_WINDOW_S,
            factor=BURN_FACTOR, for_s=FOR_S,
            description="queue-wait SLO breaches are burning the error "
                        "budget at a page-worthy rate in BOTH windows"),
        AlertRule(
            name="batch_age_burn", kind="burn_rate",
            series="fleet_slo_breach_total", labels={"slo": "batch_age"},
            budget=SLO_BUDGET, budget_window_s=SLO_BUDGET_WINDOW_S,
            fast_window_s=FAST_WINDOW_S, slow_window_s=SLOW_WINDOW_S,
            factor=BURN_FACTOR, for_s=FOR_S,
            description="whole-pipeline batch age is burning its budget "
                        "(frames stranded on the broker come back old)"),
        AlertRule(
            name="per_chip_goodput_collapse", kind="threshold",
            series="fleet_per_chip_goodput_tokens_per_s",
            op="<", value=PER_CHIP_GOODPUT_FLOOR, agg="mean",
            group="min", window_s=TREND_WINDOW_S, for_s=FOR_S,
            description="the worst mesh chip's goodput fell under the "
                        "floor while aggregate throughput may still look "
                        "fine (the multichip judge, live).  The "
                        "default floor of 0 keeps the rule inert — an "
                        "idle fleet's meters decay to 0 by design, so "
                        "only a site-configured floor can distinguish "
                        "collapse from idleness"),
        AlertRule(
            name="dlq_growth", kind="trend",
            series="bus_dead_letters_total", op=">",
            slope_per_s=DLQ_SLOPE_PER_S, window_s=TREND_WINDOW_S,
            min_samples=3, for_s=FOR_S, severity="ticket",
            description="dead letters are accumulating (positive "
                        "least-squares slope over the window)"),
        AlertRule(
            name="outbox_near_full", kind="threshold",
            series="watchtower_outbox_utilization", op=">=",
            value=OUTBOX_UTILIZATION_MAX, agg="last", group="max",
            for_s=0.0,
            description="a durable publish outbox is near its bound; "
                        "dispatch backpressure (and then OutboxFull) is "
                        "imminent"),
        AlertRule(
            name="stale_worker", kind="threshold",
            series="fleet_stale_workers", op=">", value=0.0, agg="last",
            for_s=0.0,
            description="at least one worker's heartbeat is older than "
                        "the liveness timeout"),
    ]


def rules_from_config(raw: Any) -> List[AlertRule]:
    """Build the rule list from ``observability.alert_rules`` (a list of
    rule dicts — YAML config, a scenario's "alerts" block, or a parsed
    ``--alert-rules`` JSON value).  A configured rule REPLACES the
    same-named default; other defaults survive, so a site tuning one
    budget keeps the rest of the pack."""
    defaults = default_rules()
    if not raw:
        return defaults
    if not isinstance(raw, list):
        raise ValueError("alert_rules must be a list of rule objects")
    configured = [AlertRule.from_dict(dict(d)) for d in raw]
    by_name = {r.name: r for r in defaults}
    for r in configured:
        by_name[r.name] = r
    # Configured-first ordering keeps scenario-declared rules visibly at
    # the top of /alerts; surviving defaults follow in pack order.
    names = [r.name for r in configured] + \
        [r.name for r in defaults if r.name not in
         {c.name for c in configured}]
    return [by_name[n] for n in names]


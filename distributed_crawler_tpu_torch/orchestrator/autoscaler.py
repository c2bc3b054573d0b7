"""The autoscaler: alert-actuated elastic fleet control.

The port's copy of the reference's `distributed_crawler_tpu/orchestrator/
autoscaler.py`.  The watchtower (`orchestrator/watchtower.py`) keeps the
fleet's rolling history, evaluates its rules on the orchestrator's tick
and publishes firing/resolved `AlertMessage`s on ``TOPIC_ALERTS``; this
module is the actuation half: a policy engine that turns those alerts
(and direct reads of the rolling store, for trend anticipation) into
per-pool desired sizes, and drives a `WorkerSupervisor` that spawns and
retires serving workers.

Policy shape (one `PoolPolicy` per worker pool):

- **scale-up** when any of ``scale_up_alerts`` is firing, or when
  ``trend_series`` climbs faster than ``trend_slope_per_s`` (the store
  read, so the fleet can grow before a burn rule confirms);
- **scale-down** only when no scale-up pressure exists and the
  ``headroom_series`` mean has stayed under ``headroom_below`` for a
  full ``stabilization_s`` window;
- **hysteresis everywhere**: per-direction cooldowns
  (``up_cooldown_s``/``down_cooldown_s``), the stabilization window, and
  hard ``min_workers``/``max_workers`` bounds, so a flapping alert
  confirms at most one step per cooldown and never thrashes the fleet.

Every decision is flight-recorded (``autoscale`` events), counted
(``autoscaler_decisions_total{pool,direction}``), gauged
(``autoscaler_desired_workers{pool}`` against
``autoscaler_actual_workers``), written into the rolling store (so
``/timeseries`` carries the fleet's size over time), kept in a bounded
decision log, and served at ``/autoscaler``
(`utils.metrics.set_autoscaler_provider`).

Actuation is pluggable:

- `InProcessSupervisor` builds and retires `TPUWorker`/`ASRWorker`
  instances through per-pool factories; retirement is always a graceful
  drain through the worker's stop path, never ``kill()``, so un-acked
  frames requeue and the fleet loses nothing on the way down;
- `SubprocessSupervisor` spawns ``--mode tpu-worker`` children of this
  package's CLI (``python -m distributed_crawler_tpu_torch``, on the
  card); retirement is SIGTERM (the CLI's graceful path) with a bounded
  escalation to SIGKILL.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

from ..bus.messages import TOPIC_ALERTS
from ..utils import flight
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.timeseries import STORE, TimeSeriesStore

logger = logging.getLogger("dct.autoscaler")

SCALE_UP = "up"
SCALE_DOWN = "down"


@dataclass
class PoolPolicy:
    """Desired-size policy for one worker pool (the reference's
    docs/operations.md "Elastic fleet & autoscaling" knob table)."""

    pool: str
    min_workers: int = 1
    max_workers: int = 4
    scale_up_step: int = 1
    scale_down_step: int = 1
    # Per-direction cooldowns: at most one step per cooldown, each way.
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 60.0
    # Scale-up pressure: any of these watchtower rules firing.
    scale_up_alerts: List[str] = field(default_factory=lambda: [
        "queue_wait_burn", "batch_age_burn"])
    # Trend anticipation (optional): a positive slope threshold on a
    # rolling-store series lets the pool grow before the burn alert's
    # for_s confirms.  Empty series name = off.
    trend_series: str = ""
    trend_slope_per_s: float = 0.0
    trend_window_s: float = 30.0
    # Scale-down headroom: the series' windowed mean must stay below the
    # threshold for stabilization_s, with zero scale-up pressure.
    headroom_series: str = "fleet_queue_depth"
    headroom_below: float = 1.0
    stabilization_s: float = 30.0

    def validate(self) -> None:
        if not self.pool:
            raise ValueError("pool policy needs a pool name")
        if self.min_workers < 0:
            raise ValueError(f"pool {self.pool}: min_workers must be >= 0")
        if self.max_workers < max(1, self.min_workers):
            raise ValueError(
                f"pool {self.pool}: max_workers ({self.max_workers}) must "
                f"be >= min_workers ({self.min_workers}) and >= 1")
        if self.scale_up_step < 1 or self.scale_down_step < 1:
            raise ValueError(f"pool {self.pool}: scale steps must be >= 1")
        if self.up_cooldown_s < 0 or self.down_cooldown_s < 0 \
                or self.stabilization_s < 0:
            raise ValueError(
                f"pool {self.pool}: cooldowns/stabilization must be >= 0")
        if self.trend_series and self.trend_slope_per_s <= 0:
            raise ValueError(
                f"pool {self.pool}: trend_series needs a positive "
                f"trend_slope_per_s")

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PoolPolicy":
        known = set(cls.__dataclass_fields__)
        unknown = set(d) - known
        if unknown:
            # A typo'd knob must fail loudly at config time, not silently
            # run the default policy forever (the AlertRule discipline).
            raise ValueError(
                f"autoscaler pool {d.get('pool', '?')}: unknown key(s) "
                f"{', '.join(sorted(unknown))}")
        try:
            policy = cls(**d)
        except TypeError as e:
            raise ValueError(
                f"autoscaler pool {d.get('pool', '?')}: {e}") from e
        policy.scale_up_alerts = list(policy.scale_up_alerts or [])
        policy.validate()
        return policy


def pools_from_config(raw: Any) -> List[PoolPolicy]:
    """Build the pool-policy list from an ``autoscaler.pools`` config
    value (YAML list / scenario "autoscaler.pools" block / parsed
    ``--autoscaler-pools`` JSON).  Duplicate pool names are rejected."""
    if not raw:
        return []
    if not isinstance(raw, list):
        raise ValueError("autoscaler pools must be a list of pool objects")
    pools = [PoolPolicy.from_dict(dict(d)) for d in raw]
    seen = set()
    for p in pools:
        if p.pool in seen:
            raise ValueError(f"duplicate autoscaler pool {p.pool!r}")
        seen.add(p.pool)
    return pools


@dataclass
class _PoolState:
    desired: int = 0
    last_up_at: float = 0.0
    last_down_at: float = 0.0
    headroom_since: float = 0.0   # wall when headroom began holding; 0=not
    pressure: List[str] = field(default_factory=list)
    # Spawn-churn detection: spawns that "succeed" but whose workers die
    # before the next tick (a subprocess child crashing on a bad flag)
    # reopen the gap every pass — count the consecutive reopenings and
    # back off instead of crash-loop-forking forever.
    spawned_last: bool = False
    churn: int = 0
    backoff_until: float = 0.0


# Consecutive ticks the desired/actual gap may reopen after a spawn
# before actuation backs off (10x the eval interval, min 30 s).
SPAWN_CHURN_LIMIT = 5


class Autoscaler:
    """Alert-driven desired-size control loop over a `WorkerSupervisor`.

    Sources, in priority order: ``alerts_fn`` (the watchtower's
    `get_alerts` — authoritative when wired), and/or typed
    `AlertMessage`s observed on ``TOPIC_ALERTS`` via
    :meth:`observe_alert` (`attach_bus`), so the control plane works
    in-process beside the orchestrator AND as a remote subscriber."""

    def __init__(self, supervisor, pools: List[PoolPolicy],
                 store: Optional[TimeSeriesStore] = None,
                 registry: MetricsRegistry = REGISTRY,
                 clock=time.time,
                 eval_interval_s: float = 5.0,
                 alerts_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 log_capacity: int = 256):
        if not pools:
            raise ValueError("autoscaler needs at least one pool policy")
        for p in pools:
            p.validate()
        self.supervisor = supervisor
        self.pools = {p.pool: p for p in pools}
        if len(self.pools) != len(pools):
            raise ValueError("duplicate autoscaler pool names")
        self.store = store if store is not None else STORE
        self.clock = clock
        self.eval_interval_s = float(eval_interval_s)
        self.alerts_fn = alerts_fn
        self._mu = threading.Lock()
        self._states: Dict[str, _PoolState] = {
            name: _PoolState() for name in self.pools}
        self._firing: Dict[str, float] = {}   # rule -> fired wall (bus-fed)
        self._log: Deque[Dict[str, Any]] = deque(
            maxlen=max(1, log_capacity))
        self._last_eval = 0.0
        self._ticks = 0
        self._decisions = 0
        self._started_at = self.clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.m_decisions = registry.counter(
            "autoscaler_decisions_total",
            "autoscaler scale decisions by pool and direction")
        self.m_desired = registry.gauge(
            "autoscaler_desired_workers",
            "the autoscaler's desired worker count per pool")
        self.m_actual = registry.gauge(
            "autoscaler_actual_workers",
            "live workers the supervisor reports per pool")

    # -- alert intake --------------------------------------------------------
    def attach_bus(self, bus) -> None:
        """Subscribe :meth:`observe_alert` to ``TOPIC_ALERTS`` — the
        remote-control-plane seam (fan-out: the orchestrator's own
        logging sink keeps its subscription too)."""
        bus.subscribe(TOPIC_ALERTS, self.observe_alert)

    def observe_alert(self, payload: Dict[str, Any]) -> None:
        """Fold one `AlertMessage` payload into the firing set; never
        raises into the bus."""
        try:
            rule = payload.get("rule", "")
            state = payload.get("state", "")
            if not rule:
                return
            with self._mu:
                if state == "firing":
                    self._firing[rule] = float(
                        payload.get("at_wall") or self.clock())
                elif state == "resolved":
                    self._firing.pop(rule, None)
        except Exception as e:
            logger.debug("undecodable alert announcement: %s", e)

    def _firing_now(self) -> Dict[str, float]:
        """The current firing set: the watchtower read when wired (it
        also reconciles a missed resolved-frame), else the bus-fed map."""
        if self.alerts_fn is not None:
            try:
                body = self.alerts_fn() or {}
                firing = {}
                for a in body.get("alerts", []):
                    if a.get("state") == "firing":
                        firing[a.get("rule", "")] = float(
                            a.get("fired_at") or 0.0)
                with self._mu:
                    self._firing = dict(firing)
                return firing
            except Exception as e:
                logger.warning("autoscaler alerts read failed: %s", e)
        with self._mu:
            return dict(self._firing)

    # -- signals -------------------------------------------------------------
    def _trend_pressure(self, policy: PoolPolicy, now: float) -> bool:
        if not policy.trend_series:
            return False
        since = now - policy.trend_window_s
        slopes = [s for s in (
            self.store.slope(samples)
            for _, samples in self.store.matching(policy.trend_series,
                                                  since=since))
            if s is not None]
        return bool(slopes) and sum(slopes) >= policy.trend_slope_per_s

    def _headroom_holds(self, policy: PoolPolicy, now: float) -> bool:
        """Windowed mean of the headroom series under the threshold.  An
        empty window (no samples yet) is NOT headroom — an unobserved
        fleet must never scale down on silence."""
        since = now - max(policy.stabilization_s, 1e-9)
        vals = [v for _, samples in
                self.store.matching(policy.headroom_series, since=since)
                for _, v in samples]
        if not vals:
            return False
        return (sum(vals) / len(vals)) < policy.headroom_below

    # -- the tick ------------------------------------------------------------
    def tick(self, now: Optional[float] = None,
             force: bool = False) -> List[Dict[str, Any]]:
        """One control pass over every pool; rate-limited to
        ``eval_interval_s`` (``force=True`` bypasses — deterministic
        tests and the gate's phase boundaries).  Returns the decisions
        this pass produced (empty most ticks)."""
        now = self.clock() if now is None else now
        with self._mu:
            if not force and now - self._last_eval < self.eval_interval_s:
                return []
            self._last_eval = now
            self._ticks += 1
        firing = self._firing_now()
        decisions: List[Dict[str, Any]] = []
        for name, policy in self.pools.items():
            try:
                decision = self._tick_pool(name, policy, firing, now)
            except Exception as e:
                logger.warning("autoscaler pool %s tick failed: %s",
                               name, e)
                continue
            if decision is not None:
                decisions.append(decision)
        return decisions

    def _tick_pool(self, name: str, policy: PoolPolicy,
                   firing: Dict[str, float],
                   now: float) -> Optional[Dict[str, Any]]:
        st = self._states[name]
        actual = int(self.supervisor.actual(name))
        if st.desired <= 0:
            # First sight of the pool: adopt what exists, floored at min
            # (an under-min fleet grows to min on this very tick).
            st.desired = max(policy.min_workers, actual)
        pressure = sorted(r for r in policy.scale_up_alerts if r in firing)
        trend = self._trend_pressure(policy, now)
        if trend:
            pressure.append(f"trend:{policy.trend_series}")
        st.pressure = pressure

        decision = None
        if pressure:
            st.headroom_since = 0.0
            if st.desired < policy.max_workers \
                    and now - st.last_up_at >= policy.up_cooldown_s:
                target = min(policy.max_workers,
                             st.desired + policy.scale_up_step)
                decision = self._decide(name, policy, st, SCALE_UP,
                                        st.desired, target, pressure[0],
                                        actual, now)
                st.last_up_at = now
        else:
            if self._headroom_holds(policy, now):
                if st.headroom_since <= 0.0:
                    st.headroom_since = now
            else:
                st.headroom_since = 0.0
            held = st.headroom_since > 0.0 \
                and now - st.headroom_since >= policy.stabilization_s
            if held and st.desired > policy.min_workers \
                    and now - st.last_down_at >= policy.down_cooldown_s:
                target = max(policy.min_workers,
                             st.desired - policy.scale_down_step)
                decision = self._decide(name, policy, st, SCALE_DOWN,
                                        st.desired, target, "headroom",
                                        actual, now)
                st.last_down_at = now
        self._actuate(name, policy, st, now)
        actual_now = int(self.supervisor.actual(name))
        self.m_desired.labels(pool=name).set(float(st.desired))
        self.m_actual.labels(pool=name).set(float(actual_now))
        self.store.add("autoscaler_desired_workers", float(st.desired),
                       {"pool": name}, wall=now)
        self.store.add("autoscaler_actual_workers", float(actual_now),
                       {"pool": name}, wall=now)
        if decision is not None:
            decision["actual_after"] = actual_now
        return decision

    def _decide(self, name: str, policy: PoolPolicy, st: _PoolState,
                direction: str, from_n: int, to_n: int, reason: str,
                actual: int, now: float) -> Dict[str, Any]:
        st.desired = to_n
        decision = {
            "at": now, "pool": name, "direction": direction,
            "from": from_n, "to": to_n, "reason": reason,
            "alert": reason if not reason.startswith("trend:")
            and reason != "headroom" else None,
            "actual_before": actual,
        }
        with self._mu:
            self._log.append(decision)
            self._decisions += 1
        self.m_decisions.labels(pool=name, direction=direction).inc()
        flight.record("autoscale", pool=name, direction=direction,
                      from_workers=from_n, to_workers=to_n, reason=reason)
        logger.warning(
            "autoscale %s: %s %d -> %d (%s)", name, direction, from_n,
            to_n, reason)
        return decision

    def _actuate(self, name: str, policy: PoolPolicy, st: _PoolState,
                 now: float) -> None:
        """Converge actual toward desired through the supervisor.  An
        actuation failure reverts desired to what actually exists
        (floored at min) so the gap is re-decided, not silently
        presumed closed.  A spawn that "succeeds" but whose worker dies
        before the next tick (a crash-looping subprocess child) reopens
        the gap every pass — after SPAWN_CHURN_LIMIT consecutive
        reopenings actuation backs off for 10x the eval interval
        instead of forking a spawn storm."""
        if now < st.backoff_until:
            return
        gap = st.desired - int(self.supervisor.actual(name))
        if gap > 0 and st.spawned_last:
            st.churn += 1
            if st.churn >= SPAWN_CHURN_LIMIT:
                backoff = max(30.0, 10.0 * self.eval_interval_s)
                st.backoff_until = now + backoff
                st.churn = 0
                st.spawned_last = False
                flight.record("autoscale_error", pool=name,
                              op="spawn_churn",
                              error=f"spawned workers keep dying; "
                                    f"backing off {backoff:.0f}s")
                logger.error(
                    "autoscaler pool %s: spawned workers keep dying "
                    "(%d consecutive reopened gaps); backing off %.0fs "
                    "— check the worker command line/environment",
                    name, SPAWN_CHURN_LIMIT, backoff)
                return
        elif gap <= 0:
            st.churn = 0
        st.spawned_last = False
        guard = policy.max_workers + policy.min_workers + 2
        while int(self.supervisor.actual(name)) < st.desired and guard > 0:
            guard -= 1
            try:
                wid = self.supervisor.spawn(name)
                st.spawned_last = True
                flight.record("autoscale_spawn", pool=name, worker=wid)
            except Exception as e:
                logger.error("autoscaler spawn failed for pool %s: %s",
                             name, e)
                flight.record("autoscale_error", pool=name, op="spawn",
                              error=str(e))
                st.desired = max(policy.min_workers,
                                 int(self.supervisor.actual(name)))
                return
        while int(self.supervisor.actual(name)) > st.desired and guard > 0:
            guard -= 1
            try:
                wid = self.supervisor.retire(name)
                if wid is None:
                    return  # nothing retirable right now; retry next tick
                flight.record("autoscale_retire", pool=name, worker=wid)
            except Exception as e:
                logger.error("autoscaler retire failed for pool %s: %s",
                             name, e)
                flight.record("autoscale_error", pool=name, op="retire",
                              error=str(e))
                st.desired = max(policy.min_workers,
                                 int(self.supervisor.actual(name)))
                return

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Background control loop (the CLI's orchestrator mode); tests
        drive :meth:`tick` inline instead."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dct-autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # the loop must outlive a bad tick
                logger.error("autoscaler tick error: %s", e)
            self._stop.wait(min(1.0, max(0.05, self.eval_interval_s / 2)))

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- export --------------------------------------------------------------
    def decisions(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._log)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/autoscaler`` JSON body (registered via
        `utils.metrics.set_autoscaler_provider`); postmortem bundles
        embed it — "what the autoscaler did before the crash"."""
        now = self.clock()
        pools: Dict[str, Any] = {}
        with self._mu:
            states = {n: (st.desired, st.last_up_at, st.last_down_at,
                          st.headroom_since, list(st.pressure),
                          st.backoff_until)
                      for n, st in self._states.items()}
            log = list(self._log)
            ticks, decisions = self._ticks, self._decisions
        for name, policy in self.pools.items():
            desired, up_at, down_at, headroom_since, pressure, \
                backoff_until = states[name]
            try:
                actual = int(self.supervisor.actual(name))
            except Exception as e:
                logger.debug("supervisor actual(%s) read failed: %s",
                             name, e)
                actual = -1  # the snapshot still serves; -1 says "unknown"
            pools[name] = {
                "desired": max(desired, 0),
                "actual": actual,
                "min": policy.min_workers,
                "max": policy.max_workers,
                "pressure": pressure,
                "headroom_held_s": round(now - headroom_since, 3)
                if headroom_since > 0 else 0.0,
                "actuation_backoff_s": round(max(
                    0.0, backoff_until - now), 3),
                "cooldown": {
                    "up_remaining_s": round(max(
                        0.0, policy.up_cooldown_s - (now - up_at)), 3),
                    "down_remaining_s": round(max(
                        0.0, policy.down_cooldown_s - (now - down_at)), 3),
                },
                "policy": policy.to_dict(),
            }
        return {
            "generated_at": now,
            "uptime_s": round(now - self._started_at, 3),
            "eval_interval_s": self.eval_interval_s,
            "ticks": ticks,
            "decision_count": decisions,
            "pools": pools,
            "decisions": log,
        }


# --- supervisors -------------------------------------------------------------

class InProcessSupervisor:
    """Actuation over in-process worker handles.

    A *handle* is anything exposing ``.name`` and ``.worker`` where the
    worker has ``drain(timeout_s)`` / ``stop(timeout_s)``: a bare
    `TPUWorker`/`ASRWorker` wrapped in :class:`WorkerHandleAdapter`, or
    any handle of that shape.  ``spawn_fn()`` builds AND starts a
    fresh handle.  Retirement is newest-first and always the graceful
    path: drain (un-acked frames requeue to the survivors), then stop —
    never ``kill()``.  ``on_change(pool, live_handles)`` fires after
    every spawn/retire so hosts can re-point process-global provider
    seams (/status, /costs) at a surviving worker."""

    def __init__(self, drain_timeout_s: float = 10.0,
                 on_change: Optional[Callable[[str, List[Any]], None]]
                 = None):
        self.drain_timeout_s = float(drain_timeout_s)
        self.on_change = on_change
        self._mu = threading.Lock()
        self._pools: Dict[str, Dict[str, Any]] = {}
        self.spawned: Dict[str, int] = {}
        self.retired: Dict[str, int] = {}

    def add_pool(self, pool: str, spawn_fn: Callable[[], Any]) -> None:
        with self._mu:
            if pool in self._pools:
                raise ValueError(f"pool {pool!r} already registered")
            self._pools[pool] = {"spawn": spawn_fn, "handles": []}

    def attach(self, pool: str, handle: Any) -> None:
        """A pre-existing (scenario-start) worker joins the pool."""
        with self._mu:
            self._pools[pool]["handles"].append(handle)

    @staticmethod
    def _alive(handle: Any) -> bool:
        return bool(getattr(handle, "alive", True)) \
            and getattr(handle, "worker", None) is not None

    def pools(self) -> List[str]:
        with self._mu:
            return sorted(self._pools)

    def handles(self, pool: Optional[str] = None) -> List[Any]:
        with self._mu:
            if pool is not None:
                return list(self._pools[pool]["handles"])
            return [h for p in self._pools.values()
                    for h in p["handles"]]

    def live(self, pool: Optional[str] = None) -> List[Any]:
        return [h for h in self.handles(pool) if self._alive(h)]

    def actual(self, pool: str) -> int:
        return len(self.live(pool))

    def spawn(self, pool: str) -> str:
        with self._mu:
            spawn_fn = self._pools[pool]["spawn"]
        handle = spawn_fn()
        with self._mu:
            self._pools[pool]["handles"].append(handle)
            self.spawned[pool] = self.spawned.get(pool, 0) + 1
        self._changed(pool)
        return getattr(handle, "name", repr(handle))

    def retire(self, pool: str) -> Optional[str]:
        with self._mu:
            live = [h for h in self._pools[pool]["handles"]
                    if self._alive(h)]
            if not live:
                return None
            handle = live[-1]  # newest-first: the scale-up's own spawns
            self._pools[pool]["handles"].remove(handle)
            self.retired[pool] = self.retired.get(pool, 0) + 1
        worker = getattr(handle, "worker", None)
        try:
            drain = getattr(worker, "drain", None)
            if callable(drain):
                drain(timeout_s=self.drain_timeout_s)
        except Exception as e:
            logger.warning("retire drain of %s failed: %s",
                           getattr(handle, "name", "?"), e)
        # The EXISTING graceful stop path — never kill(): the worker
        # announces worker_stopping, ships its span tail, flushes the
        # provider, and its pull stream teardown requeues whatever the
        # drain above didn't finish.
        stop = getattr(handle, "stop", None) or getattr(worker, "stop")
        stop()
        self._changed(pool)
        return getattr(handle, "name", repr(handle))

    def _changed(self, pool: str) -> None:
        if self.on_change is None:
            return
        try:
            self.on_change(pool, self.live(pool))
        except Exception as e:
            logger.warning("supervisor on_change failed: %s", e)

    def stop_all(self, pool: Optional[str] = None) -> None:
        """Teardown: gracefully stop every live handle (gate/test
        cleanup; retirement bookkeeping is not incremented)."""
        for handle in self.live(pool):
            try:
                stop = getattr(handle, "stop", None) \
                    or getattr(handle.worker, "stop")
                stop()
            except Exception as e:
                logger.warning("supervisor teardown stop failed: %s", e)


class WorkerHandleAdapter:
    """Wrap a bare worker (TPUWorker/ASRWorker) in the handle protocol
    `InProcessSupervisor` expects — hosts that construct workers
    directly still get supervised."""

    def __init__(self, name: str, worker, on_stop=None):
        self.name = name
        self.worker = worker
        self.alive = True
        self._on_stop = on_stop

    def stop(self) -> None:
        self.alive = False
        try:
            self.worker.stop()
        finally:
            if self._on_stop is not None:
                self._on_stop(self)


class SubprocessSupervisor:
    """Actuation over ``--mode tpu-worker`` child processes (`cli.py`).

    ``argv_template`` is the full child command line with
    ``{worker_id}`` placeholders (built by `cli.py` from the orchestrator's
    own bus address + ``autoscaler.worker_args``).  Retirement sends
    SIGTERM — the `_serve_forever` graceful path (drain, stopping
    status, postmortem hooks) — and escalates to SIGKILL only past
    ``term_timeout_s``."""

    def __init__(self, pool_argv: Dict[str, List[str]],
                 term_timeout_s: float = 30.0):
        self.pool_argv = {p: list(argv) for p, argv in pool_argv.items()}
        self.term_timeout_s = float(term_timeout_s)
        self._mu = threading.Lock()
        self._children: Dict[str, List] = {p: [] for p in pool_argv}
        self._seq: Dict[str, int] = {p: 0 for p in pool_argv}

    def pools(self) -> List[str]:
        return sorted(self.pool_argv)

    def _reap_locked(self, pool: str) -> None:
        self._children[pool] = [
            (wid, proc) for wid, proc in self._children[pool]
            if proc.poll() is None]

    def actual(self, pool: str) -> int:
        with self._mu:
            self._reap_locked(pool)
            return len(self._children[pool])

    def children(self, pool: str) -> List[str]:
        with self._mu:
            self._reap_locked(pool)
            return [wid for wid, _ in self._children[pool]]

    def spawn(self, pool: str) -> str:
        with self._mu:
            self._seq[pool] += 1
            wid = f"{pool}-auto-{self._seq[pool]}"
            argv = [a.replace("{worker_id}", wid)
                    for a in self.pool_argv[pool]]
        proc = subprocess.Popen(argv)
        logger.warning("autoscaler spawned worker %s (pid %d): %s",
                       wid, proc.pid, " ".join(argv))
        with self._mu:
            self._children[pool].append((wid, proc))
        return wid

    def retire(self, pool: str) -> Optional[str]:
        with self._mu:
            self._reap_locked(pool)
            if not self._children[pool]:
                return None
            wid, proc = self._children[pool].pop()  # newest-first
        proc.terminate()  # SIGTERM: the graceful _serve_forever path
        try:
            proc.wait(timeout=self.term_timeout_s)
        except subprocess.TimeoutExpired:
            logger.error("worker %s ignored SIGTERM for %.0fs; killing",
                         wid, self.term_timeout_s)
            proc.kill()
            proc.wait(timeout=5.0)
        logger.warning("autoscaler retired worker %s (rc=%s)",
                       wid, proc.returncode)
        return wid

    def stop_all(self) -> None:
        for pool in list(self.pool_argv):
            while self.retire(pool) is not None:
                pass


def default_subprocess_argv(pool: str, bus_address: str,
                            extra_args: Optional[List[str]] = None,
                            python: Optional[str] = None,
                            shard_addresses: Optional[List[str]] = None
                            ) -> List[str]:
    """The child command line for one pool: this package's CLI as a
    ``tpu-worker`` (or ``asr-worker`` for pool names starting with "asr")
    dialing the orchestrator's broker, or, on a partitioned control plane
    (``shard_addresses``), every broker shard: a spawned worker that
    dialed only one shard would never pull the other shards' work
    queues.  ``{worker_id}`` is substituted per spawn."""
    mode = "asr-worker" if pool.startswith("asr") else "tpu-worker"
    if shard_addresses:
        bus_args = ["--bus-shard-addresses", ",".join(shard_addresses),
                    "--bus-shards", str(len(shard_addresses))]
    else:
        bus_args = ["--bus-address", bus_address]
    return [python or sys.executable, "-m", "distributed_crawler_tpu_torch",
            "--mode", mode, "--worker-id", "{worker_id}"] \
        + bus_args + list(extra_args or [])

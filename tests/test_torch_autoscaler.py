"""The port's autoscaler (`distributed_crawler_tpu_torch/orchestrator/
autoscaler.py`), its ``/autoscaler`` surface, the CLI's ``--autoscaler``
and the crawl's date flags, against the reference's on the CPU.

- The cases of the reference's `tests/test_autoscaler.py`
  (`TestPoolPolicyConfig`, `TestAutoscalerPolicy`, `TestInProcessSupervisor`,
  `TestSubprocessSupervisor`, `TestAutoscalerSurface`,
  `TestStoppingAnnouncement`) and `tests/test_bus_partition.py::
  test_autoscaler_children_dial_every_shard`, on the port; the in-process
  supervisor also grows and retires the port's own `TPUWorker`s.
- Parity: the reference's `Autoscaler` and the port's are driven through
  the same fake supervisor, clock, alert sequence and store samples, and
  give equal decision logs, snapshots, metric expositions, store series
  and flight events.  `pools_from_config` and the CLI's pool and broker
  errors are equal by message.
- The date flags: `utils/timeparse.py` against the reference's over a
  table of specs (errors by message); `resolve_config`'s date fields and
  ``max_crawl_duration_s`` for each flag and their precedence (``--time-
  ago`` within a second of "now"); a dated orchestrator crawl's work items
  equal the reference orchestrator's.
- ``--mode orchestrator --autoscaler`` through the port's `main`: the
  children are this CLI's ``tpu-worker`` on the CPU (`default_subprocess_
  argv` pointed at a launcher that calls ``main(argv, device="cpu")``);
  one is spawned to reach ``min_workers``, a second on a firing rule, the
  second retired by SIGTERM once the fleet has headroom, and the first at
  teardown, while the reference's `CrawlWorker` crawls the simulated
  network.
"""

import dataclasses
import glob
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu import cli as jcli  # noqa: E402
from distributed_crawler_tpu.orchestrator import (  # noqa: E402
    autoscaler as jauto,
)
from distributed_crawler_tpu.utils import flight as jflight  # noqa: E402
from distributed_crawler_tpu.utils import metrics as jmet  # noqa: E402
from distributed_crawler_tpu.utils import timeparse as jtime  # noqa: E402
from distributed_crawler_tpu.utils import timeseries as jts  # noqa: E402
from distributed_crawler_tpu_torch import cli as tcli  # noqa: E402
from distributed_crawler_tpu_torch.bus import InMemoryBus  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.bus.codec import RecordBatch  # noqa: E402
from distributed_crawler_tpu_torch.datamodel.post import Post  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.inference import worker as twork  # noqa: E402
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    autoscaler as tauto,
)
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    fleet as tfleet,
)
from distributed_crawler_tpu_torch.utils import flight as tflight  # noqa: E402
from distributed_crawler_tpu_torch.utils import metrics as tmet  # noqa: E402
from distributed_crawler_tpu_torch.utils import timeparse as ttime  # noqa: E402
from distributed_crawler_tpu_torch.utils import timeseries as tts  # noqa: E402
from tests.test_torch_structlog import restored_logging  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"ref": (jauto, jmet, jts, jflight), "port": (tauto, tmet, tts,
                                                       tflight)}


@pytest.fixture(autouse=True)
def _clean():
    with restored_logging():
        for rec in (tflight.RECORDER, jflight.RECORDER):
            rec.reset()
            rec.configure(capacity=256)
        yield


# -- fixtures, as the reference's ---------------------------------------------
class FakeSupervisor:
    """Counts spawns/retires; actual() is the net count."""

    def __init__(self, initial=1, pool="tpu"):
        self.count = {pool: initial}
        self.events = []
        self.fail_spawn = False

    def actual(self, pool):
        return self.count[pool]

    def spawn(self, pool):
        if self.fail_spawn:
            raise RuntimeError("no capacity")
        self.count[pool] += 1
        self.events.append(("spawn", pool))
        return f"{pool}-{self.count[pool]}"

    def retire(self, pool):
        if self.count[pool] <= 0:
            return None
        self.count[pool] -= 1
        self.events.append(("retire", pool))
        return f"{pool}-retired"


class DyingSupervisor(FakeSupervisor):
    """A spawned child dies before the next tick."""

    def spawn(self, pool):
        wid = super().spawn(pool)
        self.count[pool] -= 1
        return wid


class FakeAlerts:
    """A stand-in for the watchtower's get_alerts read."""

    def __init__(self):
        self.firing = []

    def __call__(self):
        return {"alerts": [{"rule": r, "state": "firing",
                            "fired_at": 1.0} for r in self.firing],
                "firing": list(self.firing)}


def default_policy(mod, **kw):
    base = dict(pool="tpu", min_workers=1, max_workers=3,
                up_cooldown_s=5.0, down_cooldown_s=5.0,
                scale_up_alerts=["queue_wait_burn"],
                headroom_series="fleet_queue_depth", headroom_below=2.0,
                stabilization_s=10.0)
    base.update(kw)
    return mod.PoolPolicy(**base)


def make_autoscaler(clock, policy=None, initial=1, alerts=None, store=None,
                    registry=None, supervisor=None, side="port"):
    mod, met, ts, _ = SIDES[side]
    policy = policy or default_policy(mod)
    supervisor = supervisor or FakeSupervisor(initial=initial)
    store = store if store is not None else ts.TimeSeriesStore(clock=clock)
    return mod.Autoscaler(
        supervisor, [policy], store=store,
        registry=registry or met.MetricsRegistry(), clock=clock,
        eval_interval_s=1.0, alerts_fn=alerts), supervisor, store


def feed_headroom(store, clk, value=0.5, span_s=12.0, step_s=1.0):
    t = clk[0] - span_s
    while t <= clk[0]:
        store.add("fleet_queue_depth", value, {"worker": "tpu-1"}, wall=t)
        t += step_s


# -- the pool policy ----------------------------------------------------------
class TestPoolPolicyConfig:
    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError, match="unknown key"):
            tauto.PoolPolicy.from_dict({"pool": "tpu", "max_wrkers": 3})

    @pytest.mark.parametrize("raw,needle", [
        ({"pool": "tpu", "min_workers": 4, "max_workers": 2}, "max_workers"),
        ({"pool": "tpu", "scale_up_step": 0}, "steps"),
        ({"pool": "tpu", "trend_series": "fleet_queue_depth"},
         "trend_slope_per_s"),
    ])
    def test_bounds_validated(self, raw, needle):
        with pytest.raises(ValueError, match=needle):
            tauto.PoolPolicy.from_dict(raw)

    def test_pools_from_config_duplicates(self):
        with pytest.raises(ValueError, match="duplicate"):
            tauto.pools_from_config([{"pool": "tpu"}, {"pool": "tpu"}])

    def test_roundtrip(self):
        p = tauto.PoolPolicy.from_dict({
            "pool": "asr", "min_workers": 2, "max_workers": 5,
            "scale_up_alerts": ["batch_age_burn"]})
        assert tauto.PoolPolicy.from_dict(p.to_dict()) == p
        # The reference reads the port's policy and back.
        assert jauto.PoolPolicy.from_dict(p.to_dict()).to_dict() == \
            p.to_dict()

    def test_defaults_are_the_references(self):
        assert tauto.PoolPolicy(pool="x").to_dict() == \
            jauto.PoolPolicy(pool="x").to_dict()
        assert tauto.SPAWN_CHURN_LIMIT == jauto.SPAWN_CHURN_LIMIT
        assert (tauto.SCALE_UP, tauto.SCALE_DOWN) == (jauto.SCALE_UP,
                                                      jauto.SCALE_DOWN)


POOL_ERRORS = {
    "not_a_list": {"pool": "tpu"},
    "unknown_key": [{"pool": "tpu", "max_wrkers": 3}],
    "max_below_min": [{"pool": "tpu", "min_workers": 4, "max_workers": 2}],
    "max_zero": [{"pool": "tpu", "min_workers": 0, "max_workers": 0}],
    "negative_min": [{"pool": "tpu", "min_workers": -1}],
    "step": [{"pool": "tpu", "scale_down_step": 0}],
    "cooldown": [{"pool": "tpu", "up_cooldown_s": -1}],
    "trend": [{"pool": "tpu", "trend_series": "s"}],
    "no_name": [{"pool": ""}],
    "missing_pool": [{"min_workers": 1}],
    "duplicate": [{"pool": "a"}, {"pool": "a"}],
}


@pytest.mark.parametrize("case", sorted(POOL_ERRORS))
def test_pools_from_config_errors_are_the_references(case):
    msgs = []
    for mod in (tauto, jauto):
        with pytest.raises(ValueError) as e:
            mod.pools_from_config(POOL_ERRORS[case])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the control loop ---------------------------------------------------------
class TestAutoscalerPolicy:
    def test_scale_up_on_firing_alert(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        aut, sup, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        assert aut.tick(force=True) == []
        alerts.firing = ["queue_wait_burn"]
        decisions = aut.tick(force=True)
        assert len(decisions) == 1
        d = decisions[0]
        assert (d["direction"], d["from"], d["to"]) == ("up", 1, 2)
        assert d["reason"] == "queue_wait_burn"
        assert sup.count["tpu"] == 2
        assert d["actual_after"] == 2

    def test_up_cooldown_blocks_consecutive_ups(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        aut, _, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        assert aut.tick(force=True)
        assert aut.tick(force=True) == []
        clk[0] += 5.1
        decisions = aut.tick(force=True)
        assert decisions and decisions[0]["to"] == 3

    def test_max_bound(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        aut, sup, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        for _ in range(6):
            aut.tick(force=True)
            clk[0] += 6.0
        assert sup.count["tpu"] == 3

    def test_unrelated_alert_is_not_pressure(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["dlq_growth"]
        aut, sup, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        assert aut.tick(force=True) == []
        assert sup.count["tpu"] == 1

    def test_scale_down_needs_stabilization(self):
        clk = [1000.0]
        aut, sup, store = make_autoscaler(lambda: clk[0],
                                          alerts=FakeAlerts(), initial=3)
        feed_headroom(store, clk)
        assert aut.tick(force=True) == []
        clk[0] += 5.0
        feed_headroom(store, clk)
        assert aut.tick(force=True) == []
        clk[0] += 5.1
        feed_headroom(store, clk)
        decisions = aut.tick(force=True)
        assert decisions and decisions[0]["direction"] == "down"
        assert decisions[0]["reason"] == "headroom"
        assert sup.count["tpu"] == 2

    def test_down_cooldown_paces_consecutive_downs(self):
        clk = [1000.0]
        aut, sup, store = make_autoscaler(lambda: clk[0],
                                          alerts=FakeAlerts(), initial=3)
        feed_headroom(store, clk)
        aut.tick(force=True)
        clk[0] += 10.1
        feed_headroom(store, clk)
        assert aut.tick(force=True)[0]["direction"] == "down"
        clk[0] += 1.0
        feed_headroom(store, clk)
        assert aut.tick(force=True) == []
        clk[0] += 4.2
        feed_headroom(store, clk)
        assert aut.tick(force=True)[0]["to"] == 1
        clk[0] += 20.0
        feed_headroom(store, clk)
        assert aut.tick(force=True) == []
        assert sup.count["tpu"] == 1

    def test_silence_is_not_headroom(self):
        clk = [1000.0]
        aut, sup, _ = make_autoscaler(lambda: clk[0],
                                      alerts=FakeAlerts(), initial=3)
        for _ in range(5):
            clk[0] += 11.0
            assert aut.tick(force=True) == []
        assert sup.count["tpu"] == 3

    def test_flapping_alert_cannot_thrash(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        aut, sup, store = make_autoscaler(lambda: clk[0], alerts=alerts)
        for i in range(40):
            alerts.firing = ["queue_wait_burn"] if i % 2 == 0 else []
            feed_headroom(store, clk)
            aut.tick(force=True)
            clk[0] += 1.0
        assert not [e for e in sup.events if e[0] == "retire"]
        assert len([e for e in sup.events if e[0] == "spawn"]) <= 2
        assert sup.count["tpu"] <= 3

    def test_trend_anticipation_scales_before_any_alert(self):
        clk = [1000.0]
        policy = tauto.PoolPolicy(
            pool="tpu", min_workers=1, max_workers=3, up_cooldown_s=5.0,
            scale_up_alerts=["queue_wait_burn"],
            trend_series="fleet_queue_depth", trend_slope_per_s=1.0,
            trend_window_s=10.0, stabilization_s=10.0)
        aut, sup, store = make_autoscaler(lambda: clk[0], policy=policy,
                                          alerts=FakeAlerts())
        for i in range(10):
            store.add("fleet_queue_depth", 2.0 * i, {"worker": "tpu-1"},
                      wall=clk[0] - 10.0 + i)
        decisions = aut.tick(force=True)
        assert decisions and decisions[0]["direction"] == "up"
        assert decisions[0]["reason"].startswith("trend:")
        assert sup.count["tpu"] == 2

    def test_under_min_fleet_grows_to_min(self):
        clk = [1000.0]
        policy = tauto.PoolPolicy(pool="tpu", min_workers=2, max_workers=4)
        aut, sup, _ = make_autoscaler(lambda: clk[0], policy=policy,
                                      initial=0, alerts=FakeAlerts())
        assert aut.tick(force=True) == []   # growth to min is no decision
        assert sup.count["tpu"] == 2

    def test_spawn_failure_reverts_desired(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        aut, sup, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        sup.fail_spawn = True
        aut.tick(force=True)
        assert sup.count["tpu"] == 1
        assert aut.snapshot()["pools"]["tpu"]["desired"] == 1
        kinds = [e["kind"] for e in tflight.RECORDER.events()]
        assert "autoscale_error" in kinds

    def test_spawn_churn_backs_off(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        sup = DyingSupervisor(initial=1)
        aut, _, _ = make_autoscaler(lambda: clk[0], alerts=alerts,
                                    supervisor=sup)
        for _ in range(30):
            aut.tick(force=True)
            clk[0] += 1.0
        spawns = sum(1 for e in sup.events if e[0] == "spawn")
        assert spawns <= 36, spawns
        assert any(e.get("op") == "spawn_churn"
                   for e in tflight.RECORDER.events()
                   if e.get("kind") == "autoscale_error")
        assert "actuation_backoff_s" in aut.snapshot()["pools"]["tpu"]
        clk[0] += 60.0
        aut.tick(force=True)
        assert sum(1 for e in sup.events if e[0] == "spawn") > spawns

    def test_eval_interval_rate_limits_unforced_ticks(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        aut, sup, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        aut.tick()
        assert aut.tick() == []
        clk[0] += 1.1
        assert sup.count["tpu"] == 2 or aut.tick()

    def test_bus_seam_observe_alert(self):
        clk = [1000.0]
        aut, _, _ = make_autoscaler(lambda: clk[0], alerts=None)
        aut.observe_alert({"rule": "queue_wait_burn", "state": "firing",
                           "at_wall": clk[0]})
        decisions = aut.tick(force=True)
        assert decisions and decisions[0]["direction"] == "up"
        aut.observe_alert({"rule": "queue_wait_burn", "state": "resolved"})
        clk[0] += 6.0
        assert aut.tick(force=True) == []

    def test_attach_bus_reads_alert_messages(self):
        """`attach_bus` on the port's in-memory bus: a published
        `AlertMessage` is pressure on the next tick."""
        clk = [1000.0]
        aut, sup, _ = make_autoscaler(lambda: clk[0], alerts=None)
        bus = InMemoryBus(sync=True)
        aut.attach_bus(bus)
        bus.publish(tmsg.TOPIC_ALERTS, tmsg.AlertMessage.new(
            "queue_wait_burn", "burn_rate", "fleet_slo_breach_total",
            "firing", prev_state="pending", value=3.0).to_dict())
        assert aut.tick(force=True)[0]["direction"] == "up"
        bus.close()

    def test_metrics_and_store_series(self):
        clk = [1000.0]
        registry = tmet.MetricsRegistry()
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        aut, _, store = make_autoscaler(lambda: clk[0], alerts=alerts,
                                        registry=registry)
        aut.tick(force=True)
        series = {(lbl.get("pool"), lbl.get("direction")): v for lbl, v in
                  registry.counter("autoscaler_decisions_total").series()}
        assert series[("tpu", "up")] == 1.0
        desired = {tuple(sorted(lbl.items())): v for lbl, v in
                   registry.gauge("autoscaler_desired_workers").series()}
        assert desired[(("pool", "tpu"),)] == 2.0
        assert store.latest("autoscaler_actual_workers",
                            {"pool": "tpu"}) == 2.0
        assert store.latest("autoscaler_desired_workers",
                            {"pool": "tpu"}) == 2.0

    def test_snapshot_shape(self):
        clk = [1000.0]
        aut, _, _ = make_autoscaler(lambda: clk[0], alerts=FakeAlerts())
        aut.tick(force=True)
        snap = aut.snapshot()
        assert snap["pools"]["tpu"]["min"] == 1
        assert snap["pools"]["tpu"]["max"] == 3
        assert snap["pools"]["tpu"]["actual"] == 1
        assert "up_remaining_s" in snap["pools"]["tpu"]["cooldown"]
        assert snap["decisions"] == []
        assert snap["ticks"] == 1
        json.dumps(snap)


# -- parity with the reference ------------------------------------------------
def _scenario_up_down(aut, sup, store, alerts, clk):
    aut.tick(force=True)
    alerts.firing = ["queue_wait_burn"]
    for _ in range(3):
        clk[0] += 6.0
        aut.tick(force=True)
    alerts.firing = []
    for _ in range(6):
        clk[0] += 5.0
        feed_headroom(store, clk)
        aut.tick(force=True)


def _scenario_flapping(aut, sup, store, alerts, clk):
    for i in range(40):
        alerts.firing = ["queue_wait_burn"] if i % 2 == 0 else []
        feed_headroom(store, clk)
        aut.tick(force=True)
        clk[0] += 1.0


def _scenario_trend(aut, sup, store, alerts, clk):
    for i in range(10):
        store.add("fleet_queue_depth", 2.0 * i, {"worker": "tpu-1"},
                  wall=clk[0] - 10.0 + i)
    aut.tick(force=True)
    clk[0] += 5.5
    aut.tick(force=True)


def _scenario_churn(aut, sup, store, alerts, clk):
    alerts.firing = ["queue_wait_burn"]
    for _ in range(30):
        aut.tick(force=True)
        clk[0] += 1.0
    clk[0] += 60.0
    aut.tick(force=True)


def _scenario_spawn_failure(aut, sup, store, alerts, clk):
    alerts.firing = ["queue_wait_burn"]
    sup.fail_spawn = True
    aut.tick(force=True)
    sup.fail_spawn = False
    clk[0] += 6.0
    aut.tick(force=True)


def _scenario_unforced(aut, sup, store, alerts, clk):
    alerts.firing = ["queue_wait_burn"]
    for _ in range(12):
        aut.tick()
        clk[0] += 0.4


def _scenario_bus_seam(aut, sup, store, alerts, clk):
    aut.observe_alert({"rule": "queue_wait_burn", "state": "firing",
                       "at_wall": clk[0]})
    aut.observe_alert({"state": "firing"})     # no rule: ignored
    aut.observe_alert(None)                    # undecodable: ignored
    aut.tick(force=True)
    aut.observe_alert({"rule": "queue_wait_burn", "state": "resolved"})
    clk[0] += 6.0
    aut.tick(force=True)


def _scenario_silence(aut, sup, store, alerts, clk):
    for _ in range(5):
        clk[0] += 11.0
        aut.tick(force=True)


SCENARIOS = {
    "up_down": (_scenario_up_down, dict(initial=1), False, True),
    "flapping": (_scenario_flapping, dict(initial=1), False, True),
    "trend": (_scenario_trend, dict(initial=1), True, True),
    "churn": (_scenario_churn, dict(initial=1), False, True),
    "spawn_failure": (_scenario_spawn_failure, dict(initial=1), False, True),
    "unforced": (_scenario_unforced, dict(initial=1), False, True),
    "bus_seam": (_scenario_bus_seam, dict(initial=1), False, False),
    "silence_from_three": (_scenario_silence, dict(initial=3), False, True),
    "grow_to_min": (_scenario_silence, dict(initial=0), False, True),
}


def _drive(side, name):
    fn, kw, trend, wired = SCENARIOS[name]
    mod, met, ts, fl = SIDES[side]
    clk = [1000.0]
    alerts = FakeAlerts()
    sup = (DyingSupervisor if name == "churn" else FakeSupervisor)(**kw)
    policy = default_policy(mod, min_workers=2 if name == "grow_to_min"
                            else 1, **({"trend_series": "fleet_queue_depth",
                                        "trend_slope_per_s": 1.0,
                                        "trend_window_s": 10.0}
                                       if trend else {}))
    registry = met.MetricsRegistry()
    aut, sup, store = make_autoscaler(
        lambda: clk[0], policy=policy, alerts=alerts if wired else None,
        registry=registry, supervisor=sup, side=side)
    fn(aut, sup, store, alerts, clk)
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in fl.RECORDER.events()]
    return {"decisions": aut.decisions(), "snapshot": aut.snapshot(),
            "metrics": registry.expose(), "store": store.snapshot(),
            "flight": events, "supervisor": sup.events}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_matches_the_reference(name):
    port, ref = _drive("port", name), _drive("ref", name)
    for key in port:
        assert port[key] == ref[key], key
    assert port["supervisor"] or name in ("silence_from_three",)


def _cli_resolver(cli, extra):
    args = cli.build_parser().parse_args(
        ["--mode", "orchestrator", "--urls", "a", "--autoscaler", *extra])
    return cli.resolve_config(args, env={})[1]


CLI_ERRORS = {
    "no_broker": [],
    "pools_json": ["--bus-address", "h:1", "--autoscaler-pools", "[{"],
    "pools_file": ["--bus-address", "h:1", "--autoscaler-pools",
                   "@/nonexistent/pools.json"],
    "pools_unknown_key": ["--bus-address", "h:1", "--autoscaler-pools",
                          json.dumps([{"pool": "tpu", "bogus": 1}])],
    "pools_not_a_list": ["--bus-address", "h:1", "--autoscaler-pools",
                         json.dumps({"pool": "tpu"})],
    "shortcut_bounds": ["--bus-address", "h:1", "--autoscaler-min", "3",
                        "--autoscaler-max", "2"],
    "shortcut_cooldown": ["--bus-address", "h:1",
                          "--autoscaler-up-cooldown", "-1"],
}


@pytest.mark.parametrize("case", sorted(CLI_ERRORS))
def test_cli_autoscaler_errors_are_the_references(case):
    extra = CLI_ERRORS[case]
    with pytest.raises(tcli.CliConfigError) as mine:
        tcli._autoscaler_config(_cli_resolver(tcli, extra))
    with pytest.raises(jcli.CliConfigError) as ref:
        jcli._build_autoscaler(_cli_resolver(jcli, extra), None, None)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("extra", [
    [],
    ["--autoscaler-min", "2", "--autoscaler-max", "3",
     "--autoscaler-up-cooldown", "4", "--autoscaler-down-cooldown", "6",
     "--autoscaler-stabilization", "8"],
    ["--autoscaler-pools", json.dumps([
        {"pool": "tpu", "max_workers": 2, "scale_up_alerts": ["deep"]},
        {"pool": "asr", "min_workers": 0}]),
     "--autoscaler-worker-args", "--infer-model tiny --dump-dir '/d/{worker_id}'"],
])
def test_cli_autoscaler_pools_are_the_references(extra):
    """The pools and child command lines the CLI builds: the reference's
    but for the module the child runs."""
    pools, argv = tcli._autoscaler_config(_cli_resolver(
        tcli, ["--bus-address", "h:1", *extra]))
    ref = jcli._build_autoscaler(_cli_resolver(
        jcli, ["--bus-address", "h:1", *extra]),
        type("Orch", (), {"get_alerts": lambda self: {}})(), InMemoryBus())
    assert [p.to_dict() for p in pools] == \
        [p.to_dict() for p in ref.pools.values()]
    ref_argv = {p: [a.replace("distributed_crawler_tpu.cli",
                              "distributed_crawler_tpu_torch") for a in v]
                for p, v in ref.supervisor.pool_argv.items()}
    assert argv == ref_argv


# -- supervisors --------------------------------------------------------------
class _FakeWorker:
    def __init__(self, log, name):
        self.log = log
        self.name = name

    def drain(self, timeout_s=10.0):
        self.log.append(("drain", self.name))
        return True

    def stop(self, timeout_s=10.0):
        self.log.append(("stop", self.name))

    def kill(self):
        self.log.append(("kill", self.name))


ENGINE_CFG = dict(model="tiny", n_labels=3, batch_size=4, buckets=(16, 32))


class TestInProcessSupervisor:
    def _sup(self, log):
        sup = tauto.InProcessSupervisor(drain_timeout_s=1.0)
        seq = [0]

        def spawn():
            seq[0] += 1
            return tauto.WorkerHandleAdapter(f"w{seq[0]}",
                                             _FakeWorker(log, f"w{seq[0]}"))

        sup.add_pool("tpu", spawn)
        return sup

    def test_spawn_retire_drain_then_stop_never_kill(self):
        log = []
        sup = self._sup(log)
        sup.attach("tpu", tauto.WorkerHandleAdapter(
            "w0", _FakeWorker(log, "w0")))
        assert sup.actual("tpu") == 1
        assert sup.spawn("tpu") == "w1"
        assert sup.actual("tpu") == 2
        assert sup.retire("tpu") == "w1"
        assert log.index(("drain", "w1")) < log.index(("stop", "w1"))
        assert not any(op == "kill" for op, _ in log)
        assert sup.actual("tpu") == 1
        assert sup.spawned["tpu"] == 1 and sup.retired["tpu"] == 1

    def test_retire_empty_pool_returns_none(self):
        assert self._sup([]).retire("tpu") is None

    def test_on_change_fires(self):
        log, changes = [], []
        sup = tauto.InProcessSupervisor(
            on_change=lambda pool, live: changes.append((pool, len(live))))
        sup.add_pool("tpu", lambda: tauto.WorkerHandleAdapter(
            "wX", _FakeWorker(log, "wX")))
        sup.spawn("tpu")
        sup.retire("tpu")
        assert changes == [("tpu", 1), ("tpu", 0)]

    def test_dead_handles_not_counted(self):
        sup = self._sup([])
        h = tauto.WorkerHandleAdapter("w0", _FakeWorker([], "w0"))
        sup.attach("tpu", h)
        h.alive = False
        assert sup.actual("tpu") == 0

    def test_stop_all(self):
        log = []
        sup = self._sup(log)
        sup.spawn("tpu")
        sup.spawn("tpu")
        sup.stop_all()
        assert sum(1 for op, _ in log if op == "stop") == 2

    def test_autoscaler_grows_and_retires_port_tpu_workers(self):
        """The port's `TPUWorker` (tiny, on the CPU) as the pool: a firing
        alert starts a second one, headroom drains and stops it, which
        announces its stop; kill() is never called."""
        bus = InMemoryBus(sync=False)
        bus.start()
        beats, killed, results = [], [], []
        bus.subscribe(tmsg.TOPIC_WORKER_STATUS, beats.append)
        bus.subscribe(tmsg.TOPIC_INFERENCE_RESULTS, results.append)
        engine = teng.InferenceEngine(teng.EngineConfig(**ENGINE_CFG),
                                      registry=tmet.MetricsRegistry(),
                                      device="cpu")
        seq = [0]

        def spawn():
            seq[0] += 1
            worker = twork.TPUWorker(
                bus, engine, cfg=twork.TPUWorkerConfig(
                    worker_id=f"tpu-{seq[0]}", heartbeat_s=3600,
                    span_export_interval_s=0),
                registry=tmet.MetricsRegistry())
            worker.kill = lambda: killed.append(worker.cfg.worker_id)
            worker.start()
            return tauto.WorkerHandleAdapter(worker.cfg.worker_id, worker)

        sup = tauto.InProcessSupervisor(drain_timeout_s=5.0)
        sup.add_pool("tpu", spawn)
        clk = [1000.0]
        alerts = FakeAlerts()
        aut, _, store = make_autoscaler(
            lambda: clk[0], policy=default_policy(tauto, max_workers=2),
            alerts=alerts, supervisor=sup)
        try:
            aut.tick(force=True)                       # grow to min
            (first,) = sup.live("tpu")
            bus.publish(tmsg.TOPIC_INFERENCE_BATCHES, RecordBatch.from_posts(
                [Post(post_uid=f"p{i}", channel_name="c",
                      description=f"post {i}") for i in range(3)],
                crawl_id="c1").to_dict())
            deadline = time.monotonic() + 60
            while not results and time.monotonic() < deadline:
                time.sleep(0.02)
            assert results, "the first worker served nothing"
            alerts.firing = ["queue_wait_burn"]
            clk[0] += 1.0
            assert aut.tick(force=True)[0]["direction"] == "up"
            second = sup.live("tpu")[-1]
            assert second.worker.get_status()["is_running"]
            alerts.firing = []
            for _ in range(4):
                clk[0] += 5.0
                feed_headroom(store, clk)
                aut.tick(force=True)
            assert [d["direction"] for d in aut.decisions()] == ["up",
                                                                 "down"]
            assert sup.live("tpu") == [first]
            assert not second.worker.get_status()["is_running"]
            def stops():
                return [b["worker_id"] for b in beats
                        if b["message_type"] == "worker_stopping"]

            deadline = time.monotonic() + 10
            while not stops() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert stops() == [second.name]
        finally:
            sup.stop_all()
            bus.close()
        assert killed == []


class TestSubprocessSupervisor:
    CHILD = ("import signal, sys, time\n"
             "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
             "time.sleep(60)\n")

    def test_spawn_and_graceful_retire(self):
        sup = tauto.SubprocessSupervisor(
            {"tpu": [sys.executable, "-c", self.CHILD]}, term_timeout_s=10.0)
        assert sup.actual("tpu") == 0
        assert sup.spawn("tpu") == "tpu-auto-1"
        assert sup.actual("tpu") == 1
        assert sup.children("tpu") == ["tpu-auto-1"]
        assert sup.retire("tpu") == "tpu-auto-1"
        assert sup.actual("tpu") == 0
        assert sup.retire("tpu") is None

    def test_sigterm_ignored_escalates_to_sigkill(self):
        child = ("import signal, time\n"
                 "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                 "print('ready', flush=True)\n"
                 "time.sleep(60)\n")
        sup = tauto.SubprocessSupervisor(
            {"tpu": [sys.executable, "-c", child]}, term_timeout_s=1.0)
        sup.spawn("tpu")
        time.sleep(1.0)    # past the interpreter's start: SIGTERM ignored
        t0 = time.monotonic()
        assert sup.retire("tpu") == "tpu-auto-1"
        assert time.monotonic() - t0 >= 1.0
        assert sup.actual("tpu") == 0

    def test_worker_id_substitution_and_reap(self, tmp_path):
        out = tmp_path / "ids"
        sup = tauto.SubprocessSupervisor({"tpu": [
            sys.executable, "-c",
            "import sys; open(sys.argv[1], 'a').write(sys.argv[2] + '\\n')",
            str(out), "id={worker_id}"]})
        sup.spawn("tpu")
        sup.spawn("tpu")
        deadline = time.monotonic() + 10.0
        while sup.actual("tpu") and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.actual("tpu") == 0
        assert sorted(out.read_text().split()) == ["id=tpu-auto-1",
                                                   "id=tpu-auto-2"]

    def test_default_argv(self):
        argv = tauto.default_subprocess_argv(
            "tpu", "127.0.0.1:7777", extra_args=["--infer-model", "t"])
        assert argv[:3] == [sys.executable, "-m",
                            "distributed_crawler_tpu_torch"]
        assert argv[3:] == ["--mode", "tpu-worker", "--worker-id",
                            "{worker_id}", "--bus-address", "127.0.0.1:7777",
                            "--infer-model", "t"]
        asr = tauto.default_subprocess_argv("asr", "127.0.0.1:7777")
        assert "asr-worker" in asr
        # The reference's but for the module the child runs.
        for pool in ("tpu", "asr-a"):
            ref = jauto.default_subprocess_argv(pool, "h:1", ["--x"])
            mine = tauto.default_subprocess_argv(pool, "h:1", ["--x"])
            assert ref[2] == "distributed_crawler_tpu.cli"
            assert mine[:2] + mine[3:] == ref[:2] + ref[3:]

    def test_children_dial_every_shard(self):
        argv = tauto.default_subprocess_argv(
            "tpu", "", shard_addresses=["a:1", "b:2", "c:3"])
        joined = " ".join(argv)
        assert "--bus-shard-addresses a:1,b:2,c:3" in joined
        assert "--bus-shards 3" in joined
        assert "--bus-address" not in joined
        assert "--bus-address h:1" in " ".join(
            tauto.default_subprocess_argv("tpu", "h:1"))


# -- /autoscaler and the bundle -----------------------------------------------
def _http(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestAutoscalerSurface:
    def test_http_endpoint(self):
        clk = [1000.0]
        aut, _, _ = make_autoscaler(lambda: clk[0], alerts=FakeAlerts())
        aut.tick(force=True)
        server = tmet.serve_metrics(0, tmet.MetricsRegistry())
        url = f"http://127.0.0.1:{server.server_address[1]}/autoscaler"
        try:
            assert _http(url)[0] == 404
            tmet.set_autoscaler_provider(aut.snapshot)
            code, body = _http(url)
            assert code == 200
            body = json.loads(body)
            assert body["pools"]["tpu"]["actual"] == 1
            assert body["decision_count"] == 0
            assert body == json.loads(json.dumps(aut.snapshot()))
        finally:
            tmet.clear_autoscaler_provider(aut.snapshot)
        try:
            assert _http(url)[0] == 404
        finally:
            server.shutdown()
            server.server_close()

    def test_flight_bundle_embeds_decision_log(self):
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        aut, _, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        aut.tick(force=True)
        assert "autoscaler" not in tflight.RECORDER.bundle("before")
        tmet.set_autoscaler_provider(aut.snapshot)
        try:
            bundle = tflight.RECORDER.bundle("test")
            assert bundle["autoscaler"]["decision_count"] == 1
            assert bundle["autoscaler"]["decisions"][0]["direction"] == "up"
            assert bundle["autoscaler"] == tmet.autoscaler_snapshot()
        finally:
            tmet.clear_autoscaler_provider(aut.snapshot)
        assert tmet.autoscaler_snapshot() is None

    def test_a_failing_provider_is_reported_not_raised(self):
        def broken():
            raise RuntimeError("boom")

        tmet.set_autoscaler_provider(broken)
        try:
            assert tmet.autoscaler_snapshot() == {"error": "boom"}
        finally:
            tmet.clear_autoscaler_provider(broken)

    def test_the_references_tools_render_the_ports_surfaces(self):
        postmortem = pytest.importorskip("tools.postmortem")
        watch = pytest.importorskip("tools.watch")
        clk = [1000.0]
        alerts = FakeAlerts()
        alerts.firing = ["queue_wait_burn"]
        aut, _, _ = make_autoscaler(lambda: clk[0], alerts=alerts)
        aut.tick(force=True)
        snap = aut.snapshot()
        page = watch.render_dashboard({}, {}, {}, now=clk[0],
                                      autoscaler=snap)
        assert "autoscaler pool" in page and "1 -> 2" in page
        digest = postmortem._autoscaler_digest(snap)
        assert any("desired=2" in line for line in digest)
        assert any("up" in line and "1 -> 2" in line for line in digest)
        tmet.set_autoscaler_provider(aut.snapshot)
        try:
            text = postmortem.render_bundle(json.loads(json.dumps(
                tflight.RECORDER.bundle("sigterm"), default=str)))
        finally:
            tmet.clear_autoscaler_provider(aut.snapshot)
        assert "what the autoscaler did before the crash" in text


# -- the stop announcement ----------------------------------------------------
class TestStoppingAnnouncement:
    def _worker(self, bus):
        return twork.TPUWorker(
            bus, teng.InferenceEngine(teng.EngineConfig(**ENGINE_CFG),
                                      registry=tmet.MetricsRegistry(),
                                      device="cpu"),
            provider=None, cfg=twork.TPUWorkerConfig(
                worker_id="tpu-x", span_export_interval_s=0.0,
                heartbeat_s=3600),
            registry=tmet.MetricsRegistry())

    def test_graceful_stop_announces_offline_once(self):
        bus = InMemoryBus(sync=True)
        beats = []
        bus.subscribe(tmsg.TOPIC_WORKER_STATUS, beats.append)
        w = self._worker(bus)
        w.start()
        w.stop()
        stopping = [p for p in beats
                    if p["message_type"] == tmsg.MSG_WORKER_STOPPING]
        assert len(stopping) == 1
        msg = tmsg.StatusMessage.from_dict(stopping[0])
        assert msg.status == tmsg.WORKER_OFFLINE
        assert msg.worker_type == "tpu"
        w.stop()    # a second stop (teardown) announces nothing new
        assert len([p for p in beats if p["message_type"]
                    == tmsg.MSG_WORKER_STOPPING]) == 1
        bus.close()
        # The fleet fold marks it cleanly offline: never stale, however
        # long it stays silent.
        fleet = tfleet.FleetView(registry=tmet.MetricsRegistry())
        for p in beats:
            assert fleet.observe(tmsg.StatusMessage.from_dict(p))
        later = datetime.now(timezone.utc) + timedelta(hours=1)
        assert fleet.stale_count(now=later) == 0
        row = fleet.export(now=later)["workers"]["tpu-x"]
        assert row["status"] == tmsg.WORKER_OFFLINE


# -- the date flags -----------------------------------------------------------
NOW = datetime(2024, 3, 31, 12, 30, tzinfo=timezone.utc)
TIME_AGO = ["30d", "6h", "2w", "1m", "1y", "13m", "0d", "", "5x", "d", "xd",
            " 7d", "2.5d", "25m"]
DATE_BETWEEN = ["2024-01-01,2024-02-01", " 2024-01-01 , 2024-01-01 ",
                "2024-01-01", "2024-13-01,2024-02-01",
                "2024-01-01,2024-02-30", "2024-03-01,2024-02-01",
                "a,b,c"]
DURATION = ["48h", "24h30m", "90s", "500ms", "1.5h", "", "2h 30m", "10",
            "1d", "h", "3m20s5ms"]


def _both(fn_name, *args, **kw):
    out = []
    for mod in (ttime, jtime):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kw)))
        except ValueError as e:
            out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("spec", TIME_AGO)
def test_parse_time_ago_is_the_references(spec):
    mine, ref = _both("parse_time_ago", spec, now=NOW)
    assert mine == ref


@pytest.mark.parametrize("spec", DATE_BETWEEN)
def test_parse_date_between_is_the_references(spec):
    mine, ref = _both("parse_date_between", spec)
    assert mine == ref


@pytest.mark.parametrize("spec", DURATION)
def test_parse_duration_is_the_references(spec):
    mine, ref = _both("parse_duration", spec)
    assert mine == ref


DATE_FIELDS = ("min_post_date", "post_recency", "date_between_min",
               "date_between_max", "max_crawl_duration_s")
DATE_CASES = {
    "min_post_date": ["--min-post-date", "2024-02-29"],
    "time_ago": ["--time-ago", "3w"],
    "date_between": ["--date-between", "2024-01-01,2024-02-01"],
    "time_ago_over_min_post_date": ["--time-ago", "2m", "--min-post-date",
                                    "2024-01-01"],
    "date_between_over_all": ["--date-between", "2023-05-01,2023-06-01",
                              "--time-ago", "6h", "--min-post-date",
                              "2024-01-01"],
    "duration": ["--max-crawl-duration", "24h30m"],
    "duration_and_window": ["--max-crawl-duration", "90s", "--time-ago",
                            "1y"],
    "none": [],
}
# --time-ago is relative to each package's "now": the two resolves run
# within this of each other.
NOW_TOL = timedelta(seconds=1)


def _resolve(cli, argv, env=None):
    return cli.resolve_config(cli.build_parser().parse_args(argv),
                              env=env if env is not None else {})


def _same_dates(mine, ref):
    for name in DATE_FIELDS:
        a, b = getattr(mine, name), getattr(ref, name)
        if name == "post_recency" and a is not None and b is not None:
            assert abs(a - b) <= NOW_TOL, name
        else:
            assert a == b, name


@pytest.mark.parametrize("case", sorted(DATE_CASES))
def test_date_flags_resolve_as_the_references(case):
    argv = ["--mode", "orchestrator", "--urls", "a", *DATE_CASES[case]]
    t0 = datetime.now(timezone.utc)
    (mine, _), (ref, _) = (_resolve(c, argv) for c in (tcli, jcli))
    _same_dates(mine, ref)
    if "time_ago" in case and "date_between" not in case:
        want = jtime.parse_time_ago(DATE_CASES[case][1], now=t0)
        assert abs(mine.post_recency - want) <= NOW_TOL


def test_date_flags_from_env_and_config_file(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("crawler:\n  minpostdate: '2024-01-05'\n"
                    "  maxcrawlduration: 2h\n")
    env = {"CRAWLER_CRAWLER_DATEBETWEEN": "2022-01-01,2022-12-31"}
    argv = ["--mode", "orchestrator", "--urls", "a", "--config", str(path)]
    (mine, _), (ref, _) = (_resolve(c, argv, dict(env)) for c in (tcli,
                                                                  jcli))
    _same_dates(mine, ref)
    assert mine.date_between_min == datetime(2022, 1, 1, tzinfo=timezone.utc)
    assert mine.max_crawl_duration_s == 7200.0


@pytest.mark.parametrize("flag,value", [
    ("--time-ago", "3q"), ("--date-between", "2024-01-01"),
    ("--min-post-date", "2024/01/01"), ("--max-crawl-duration", "two"),
])
def test_a_bad_date_flag_exits_2_as_the_reference(capsys, flag, value):
    errs = []
    for cli in (tcli, jcli):
        argv = ["--mode", "orchestrator", "--urls", "a", flag, value]
        assert cli.main(argv, env={}) == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1]


@pytest.mark.parametrize("duration", ["1h", None])
def test_orchestrator_warns_that_it_ignores_max_crawl_duration(capsys,
                                                               duration):
    """Orchestrator mode reads no ``max_crawl_duration_s`` (the reference's
    does not either): the port says so when the flag is set. A bad alert
    rule then stops both CLIs before the broker starts, with exit 2."""
    argv = ["--mode", "orchestrator", "--urls", "a", "--alert-rules", "{",
            *(["--max-crawl-duration", duration] if duration else [])]
    assert tcli.main(argv, env={}) == 2
    err = capsys.readouterr().err
    assert ("--max-crawl-duration is ignored in orchestrator mode"
            in err) == (duration is not None)
    assert jcli.main(argv, env={}) == 2


@pytest.mark.parametrize("case", ["min_post_date", "date_between",
                                  "time_ago", "duration_and_window"])
def test_dated_crawl_work_items_are_the_references(tmp_path, case):
    """Both orchestrators, each with its CLI's resolved config, dispatch
    the same seeds: the work items' dicts are equal but for ids and
    times."""
    from tests.test_torch_orchestrator import PKGS, capture, make_sm

    argv = ["--mode", "orchestrator", "--urls", "chana,chanb",
            "--skip-media", "--max-depth", "2", "--crawl-id", "c1",
            *DATE_CASES[case]]
    items = {}
    for side, cli in (("port", tcli), ("ref", jcli)):
        P = PKGS[side]
        cfg, _ = _resolve(cli, argv)
        bus = P.bus.InMemoryBus()
        sent = capture(P, bus)
        orch = P.orch.Orchestrator(
            "c1", cfg, bus, make_sm(P, tmp_path / side / "s"),
            journal=P.jour.CrawlJournal(str(tmp_path / side / "j")))
        orch.start(["chana", "chanb"], background=False)
        orch.distribute_work()
        orch.kill()
        items[side] = [P.msg.WorkQueueMessage.from_dict(f).work_item
                       for f in sent]
    assert len(items["port"]) == len(items["ref"]) == 2

    def plain(item):
        d = dataclasses.asdict(item.config)
        return {"url": item.url, "depth": item.depth,
                "platform": item.platform, "crawl_id": item.crawl_id,
                "config": d}

    for mine, ref in zip(sorted(items["port"], key=lambda i: i.url),
                         sorted(items["ref"], key=lambda i: i.url)):
        a, b = plain(mine), plain(ref)
        ra, rb = a["config"].pop("post_recency"), \
            b["config"].pop("post_recency")
        assert a == b
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert abs(ra - rb) <= NOW_TOL
        # The wire form carries the window as the reference's does.
        wire = tmsg.WorkQueueMessage.new(mine, tmsg.PRIORITY_HIGH,
                                         60).to_dict()
        keys = {k for k in ("min_post_date", "post_recency",
                            "date_between_min", "date_between_max")
                if wire["work_item"]["config"].get(k)}
        want = {k for k in ("min_post_date", "post_recency",
                            "date_between_min", "date_between_max")
                if getattr(ref.config, k) is not None}
        assert keys == want


# -- --mode orchestrator --autoscaler -----------------------------------------
LAUNCHER = ("import sys; from distributed_crawler_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
CPU_RULE = {"name": "deep", "kind": "threshold",
            "series": "fleet_worker_queue_length", "op": ">", "value": 2}
# Samples of the rule's series land once per watchtower pass (5 s): a
# window of 6 s always holds one.
CPU_POOL = {"pool": "tpu", "min_workers": 1, "max_workers": 2,
            "scale_up_alerts": ["deep"], "up_cooldown_s": 1.0,
            "down_cooldown_s": 1.0, "stabilization_s": 6.0,
            "headroom_series": "fleet_worker_queue_length",
            "headroom_below": 1.0}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _json_route(url):
    try:
        code, body = _http(url)
    except OSError:
        return None
    return json.loads(body) if code == 200 else None


def _until(pred, what, timeout_s=120.0, alive=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert alive is None or alive(), f"the orchestrator ended: {what}"
        value = pred()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"{what}: not within {timeout_s} s")


def test_orchestrator_autoscaler_grows_and_retires_cpu_children(
        tmp_path, monkeypatch):
    pytest.importorskip("grpc")
    from distributed_crawler_tpu.bus.grpc_bus import RemoteBus
    from distributed_crawler_tpu.clients import SimNetwork
    from distributed_crawler_tpu.crawl import runner as crawl_runner
    from tests.test_crawl_engine import text_msg
    from tests.test_torch_orchestrator import _ref_worker, install_pool

    real = tauto.default_subprocess_argv

    def cpu_argv(*a, **kw):
        argv = real(*a, **kw)
        assert argv[1:3] == ["-m", "distributed_crawler_tpu_torch"]
        return [argv[0], "-c", LAUNCHER, *argv[3:]]

    monkeypatch.setattr(tauto, "default_subprocess_argv", cpu_argv)
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("CRAWLER_INFERENCE_BUCKET_SIZES", "16,32")
    net = SimNetwork()
    net.add_channel("chana", messages=[
        text_msg("hello t.me/chanb", date=1700000000, view_count=5),
    ], member_count=100)
    net.add_channel("chanb", messages=[
        text_msg("plain message", date=1700000100, view_count=3),
    ], member_count=200)
    install_pool(net)
    address = f"127.0.0.1:{_free_port()}"
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    store, dump = tmp_path / "store", tmp_path / "dump"
    argv = ["--mode", "orchestrator", "--urls", "chana", "--bus-address",
            address, "--metrics-port", str(port), "--storage-root",
            str(store), "--crawl-id", "c14", "--skip-media", "--max-depth",
            "2", "--alert-rules", json.dumps([CPU_RULE]), "--autoscaler",
            "--autoscaler-eval-interval", "0.5", "--autoscaler-pools",
            json.dumps([CPU_POOL]), "--autoscaler-worker-args",
            f"--infer-model tiny --infer-batch-size 4 --telemetry-interval 1 "
            f"--storage-root {store} --dump-dir {dump}/{{worker_id}}"]
    rc = []
    orch = threading.Thread(target=lambda: rc.append(tcli.main(argv)),
                            daemon=True)
    orch.start()
    remote = worker = None
    seen = {}

    def row(wid):
        body = _json_route(url + "/cluster") or {}
        return body.get("workers", {}).get(wid)

    def beat(queue, message_type="heartbeat", status="active"):
        msg = tmsg.StatusMessage.new("fake-tpu", message_type, status,
                                     worker_type="tpu")
        msg.queue_length = queue
        remote.publish(tmsg.TOPIC_WORKER_STATUS, msg.to_dict())

    try:
        _until(lambda: _json_route(url + "/autoscaler"), "/autoscaler",
               alive=orch.is_alive)
        remote = RemoteBus(address)
        _until(lambda: row("tpu-auto-1"), "tpu-auto-1's heartbeat",
               alive=orch.is_alive)
        # A tpu worker that reports a deep queue: the rule fires and the
        # pool grows.
        for _ in range(3):
            beat(5)
        up = _until(lambda: [d for d in (_json_route(url + "/autoscaler")
                                         or {}).get("decisions", [])
                             if d["direction"] == "up"],
                    "the up decision", alive=orch.is_alive)
        _until(lambda: row("tpu-auto-2"), "tpu-auto-2's heartbeat",
               alive=orch.is_alive)
        beat(0, "worker_stopping", "offline")
        body = _until(lambda: (lambda b: b if b and [
            d["direction"] for d in b["decisions"]] == ["up", "down"]
            and b["pools"]["tpu"]["actual"] == 1 else None)(
                _json_route(url + "/autoscaler")),
            "the down decision and the retirement", alive=orch.is_alive)
        seen["autoscaler"] = body
        seen["retired"] = _until(
            lambda: (lambda r: r if r and r["status"] == "offline"
                     else None)(row("tpu-auto-2")),
            "tpu-auto-2 offline on /cluster", alive=orch.is_alive)
        seen["metrics"] = _http(url + "/metrics")[1].decode()
        worker = _ref_worker(remote, tmp_path)
        worker.start(background=False)
        orch.join(timeout=120)
        assert not orch.is_alive()
    finally:
        if worker is not None:
            worker.stop()
        if remote is not None:
            remote.close()
        crawl_runner.shutdown_connection_pool()
        orch.join(timeout=60)
    assert rc == [0]
    pool = seen["autoscaler"]["pools"]["tpu"]
    assert (pool["desired"], pool["actual"]) == (1, 1)
    ups, downs = seen["autoscaler"]["decisions"]
    assert (ups["from"], ups["to"], ups["reason"]) == (1, 2, "deep")
    assert (downs["from"], downs["to"], downs["reason"]) == (2, 1,
                                                              "headroom")
    assert up[0]["actual_after"] == 2
    assert seen["retired"]["worker_type"] == "tpu"
    for direction in ("up", "down"):
        assert (f'autoscaler_decisions_total{{direction="{direction}",'
                f'pool="tpu"}} 1.0') in seen["metrics"]
    # Each child wrote its bundle on SIGTERM: the retirement and the
    # teardown both took the graceful path.
    for wid in ("tpu-auto-1", "tpu-auto-2"):
        (bundle,) = glob.glob(str(dump / wid / "postmortem_*_sigterm.json"))
        with open(bundle, encoding="utf-8") as f:
            assert json.load(f)["config"]["worker_id"] == wid
    with open(store / "c14" / "state.json", encoding="utf-8") as f:
        layers = json.load(f)["layers"]
    assert [[(p["url"], p["status"]) for p in layer["pages"]]
            for layer in layers] == [[("chana", "fetched")],
                                     [("chanb", "fetched")]]

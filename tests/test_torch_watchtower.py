"""The port's watchtower, alert engine and tenant ledger
(`distributed_crawler_tpu_torch/orchestrator/watchtower.py`,
`utils/alerts.py`, `orchestrator/tenants.py`) against the reference's, on
the CPU.

Both packages get the same samples, heartbeats and evaluation times and
must give the same alert transitions, published `AlertMessage`s, flight
events, ``/alerts`` and ``/tenants`` bodies and fleet series — the cases of
the reference's `tests/test_watchtower.py` (`TestAlertEngine`,
`TestWatchtower`, `TestLiveSurfaces`) and `tests/test_tenant_attribution.py`
(`TestBudgetLedger`, `TestTenantsAndLogsEndpoints`).  The reference is
given an injected clock and its own store; the port reads the process's
store (reset per case) and takes its times as ``now``/``wall`` arguments,
which every case passes.  Wall times (``generated_at``, flight ``ts``) are
dropped; everything else is compared exactly.
"""

import json
import urllib.error
import urllib.request
from datetime import timedelta

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu.bus import messages as jmsg  # noqa: E402
from distributed_crawler_tpu.orchestrator import fleet as jfleet  # noqa: E402
from distributed_crawler_tpu.orchestrator import tenants as jten  # noqa: E402
from distributed_crawler_tpu.orchestrator import (  # noqa: E402
    watchtower as jwt,
)
from distributed_crawler_tpu.utils import alerts as jalerts  # noqa: E402
from distributed_crawler_tpu.utils import flight as jflight  # noqa: E402
from distributed_crawler_tpu.utils import metrics as jmet  # noqa: E402
from distributed_crawler_tpu.utils import timeseries as jts  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    fleet as tfleet,
)
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    tenants as tten,
)
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    watchtower as twt,
)
from distributed_crawler_tpu_torch.utils import alerts as talerts  # noqa: E402
from distributed_crawler_tpu_torch.utils import flight as tflight  # noqa: E402
from distributed_crawler_tpu_torch.utils import metrics as tmet  # noqa: E402
from distributed_crawler_tpu_torch.utils import timeseries as tts  # noqa: E402

T0 = 1000.0


class Clock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _fresh_stores():
    tts.STORE.reset()
    jts.STORE.reset()
    tflight.RECORDER.reset()
    jflight.RECORDER.reset()
    yield
    tts.STORE.reset()
    jts.STORE.reset()


def _drop_walls(obj):
    if isinstance(obj, dict):
        return {k: _drop_walls(v) for k, v in obj.items()
                if k not in ("generated_at", "ts", "timestamp", "trace_id")}
    if isinstance(obj, (list, tuple)):
        return [_drop_walls(v) for v in obj]
    return obj


# -- the alert engine ---------------------------------------------------------------
def _rule(mod, **kw):
    return mod.AlertRule(**kw)


SCRIPTS = {
    # name: (rule kwargs list, ops); ops are ("add", series, value, wall)
    # and ("eval", now).
    "empty_series_stays_inactive": (
        [dict(name="t", kind="threshold", series="missing", op=">",
              value=0.0)],
        [("eval", T0)]),
    "single_sample_trend_has_no_slope": (
        [dict(name="tr", kind="trend", series="s", op=">", slope_per_s=0.0,
              window_s=60, min_samples=2)],
        [("add", "s", 5.0, T0 - 1), ("eval", T0), ("add", "s", 9.0, T0),
         ("eval", T0)]),
    "burn_rate_zero_budget_fires_on_any_breach": (
        [dict(name="b", kind="burn_rate", series="c", budget=0.0,
              fast_window_s=5.0, slow_window_s=10.0, factor=1.0)],
        [("add", "c", 0.0, T0 - 1), ("eval", T0), ("add", "c", 1.0, T0),
         ("eval", T0)]),
    "burn_rate_needs_both_windows": (
        [dict(name="b", kind="burn_rate", series="c", budget=10.0,
              budget_window_s=100.0, fast_window_s=10.0,
              slow_window_s=100.0, factor=2.0)],
        [("add", "c", 0.0, 905.0), ("add", "c", 3.0, 998.0),
         ("eval", T0)]),
    "pending_that_never_confirms_returns_inactive": (
        [dict(name="t", kind="threshold", series="g", op=">", value=5.0,
              agg="last", for_s=10.0)],
        [("add", "g", 9.0, T0), ("eval", T0), ("add", "g", 1.0, T0 + 5),
         ("eval", T0 + 5)]),
    "for_s_confirms_then_fires": (
        [dict(name="t", kind="threshold", series="g", op=">", value=5.0,
              for_s=10.0)],
        [("add", "g", 9.0, T0), ("eval", T0), ("add", "g", 9.0, T0 + 9),
         ("eval", T0 + 9), ("add", "g", 9.0, T0 + 10), ("eval", T0 + 10)]),
    "flap_suppression_resolved_must_reconfirm_for_s": (
        [dict(name="t", kind="threshold", series="g", op=">", value=5.0,
              agg="last", window_s=0.0, for_s=10.0)],
        [("add", "g", 9.0, T0), ("eval", T0), ("add", "g", 9.0, T0 + 10),
         ("eval", T0 + 10), ("add", "g", 1.0, T0 + 11), ("eval", T0 + 11),
         ("add", "g", 9.0, T0 + 12), ("eval", T0 + 12),
         ("add", "g", 9.0, T0 + 22), ("eval", T0 + 22)]),
    "clear_for_s_holds_resolution": (
        [dict(name="t", kind="threshold", series="g", op=">", value=5.0,
              clear_for_s=10.0)],
        [("add", "g", 9.0, T0), ("eval", T0), ("add", "g", 1.0, T0 + 1),
         ("eval", T0 + 1), ("add", "g", 1.0, T0 + 11), ("eval", T0 + 11)]),
    "transitions_publish_and_flight": (
        [dict(name="t", kind="threshold", series="g", op=">", value=0.0)],
        [("add", "g", 1.0, T0), ("eval", T0), ("add", "g", -1.0, T0 + 1),
         ("eval", T0 + 1)]),
    "trend_and_groups_over_labeled_children": (
        [dict(name="tr", kind="trend", series="d", op=">", slope_per_s=0.5,
              window_s=30, min_samples=3),
         dict(name="mx", kind="threshold", series="d", op=">=", value=7.0,
              agg="max", group="max", window_s=30),
         dict(name="mn", kind="threshold", series="d", op="<", value=2.0,
              agg="mean", group="min", labels={"w": "a"})],
        [("add", "d", 1.0, T0, {"w": "a"}), ("add", "d", 3.0, T0 + 2,
                                             {"w": "a"}),
         ("add", "d", 6.0, T0 + 4, {"w": "a"}),
         ("add", "d", 2.0, T0, {"w": "b"}), ("add", "d", 8.0, T0 + 4,
                                             {"w": "b"}),
         ("eval", T0 + 4), ("add", "d", 0.0, T0 + 40, {"w": "a"}),
         ("eval", T0 + 40)]),
}


def _run_script(pkg, rules, ops):
    if pkg == "ref":
        clock = Clock()
        store = jts.TimeSeriesStore(clock=clock)
        published = []
        eng = jalerts.AlertEngine(
            [_rule(jalerts, **r) for r in rules], store=store,
            registry=jmet.MetricsRegistry(), clock=clock,
            publish=published.append)
        rec = jflight.RECORDER
    else:
        store = tts.STORE
        published = []
        eng = talerts.AlertEngine(
            [_rule(talerts, **r) for r in rules],
            registry=tmet.MetricsRegistry(), publish=published.append)
        rec = tflight.RECORDER
    rec.reset()
    transitions = []
    for op in ops:
        if op[0] == "add":
            labels = op[4] if len(op) > 4 else None
            store.add(op[1], op[2], labels, wall=op[3])
        else:
            if pkg == "ref":
                clock.t = op[1]
            transitions.append(eng.evaluate(now=op[1]))
    snap = eng.snapshot()
    json.dumps(snap)   # JSON-safe, infinite burns clamped
    flights = [e for e in rec.events() if e["kind"] == "alert"]
    return _drop_walls(dict(transitions=transitions, published=published,
                            snapshot=snap, firing=eng.firing(),
                            flight=flights))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_alert_engine_matches_the_reference(name):
    rules, ops = SCRIPTS[name]
    ref = _run_script("ref", rules, ops)
    port = _run_script("port", rules, ops)
    assert port == ref
    assert ref["transitions"] != [] or name == "empty_series_stays_inactive" \
        or name == "burn_rate_needs_both_windows"


def test_engine_validation_is_the_references():
    for mod, met in ((jalerts, jmet), (talerts, tmet)):
        with pytest.raises(ValueError, match="duplicate"):
            mod.AlertEngine(
                [mod.AlertRule(name="x", kind="threshold", series="s"),
                 mod.AlertRule(name="x", kind="threshold", series="s")],
                registry=met.MetricsRegistry())
    bad = [dict(name="x", kind="nope", series="s"),
           dict(name="x", kind="threshold", series=""),
           dict(name="x", kind="threshold", series="s", op="=="),
           dict(name="x", kind="threshold", series="s", agg="p99"),
           dict(name="x", kind="threshold", series="s", group="avg"),
           dict(name="x", kind="burn_rate", series="s", fast_window_s=0),
           dict(name="x", kind="burn_rate", series="s", fast_window_s=10,
                slow_window_s=5),
           dict(name="x", kind="threshold", series="s", bogus=1),
           dict(kind="threshold", series="s")]
    for d in bad:
        msgs = []
        for mod in (jalerts, talerts):
            with pytest.raises(ValueError) as e:
                mod.rules_from_config([d])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_rule_packs_are_the_references():
    def dicts(rules):
        out = [r.to_dict() for r in rules]
        for d in out:   # one description names an internal milestone
            d.pop("description")
        return out

    assert dicts(talerts.default_rules()) == dicts(jalerts.default_rules())
    raw = [{"name": "queue_wait_burn", "kind": "burn_rate",
            "series": "fleet_slo_breach_total",
            "labels": {"slo": "queue_wait"}, "budget": 0,
            "fast_window_s": 1.0, "slow_window_s": 2.0, "factor": 1.0},
           {"name": "deep_queue", "kind": "threshold",
            "series": "fleet_queue_depth", "op": ">", "value": 2}]
    assert dicts(talerts.rules_from_config(raw)) == \
        dicts(jalerts.rules_from_config(raw))
    assert [r.name for r in talerts.rules_from_config(raw)][:3] == [
        "queue_wait_burn", "deep_queue", "batch_age_burn"]
    assert dicts(talerts.rules_from_config(None)) == \
        dicts(jalerts.default_rules())


# -- the watchtower ---------------------------------------------------------------
USAGE = {
    "rss_bytes": 1 << 20,
    "queue": {"depth": 3, "depth_time_weighted": 2.5},
    "efficiency": {"mfu": 0.25, "goodput_tokens_per_s": 900.0,
                   "per_chip": [{"device": "cuda:0",
                                 "goodput_tokens_per_s": 450.0}]},
    "occupancy": {"busy_fraction": 0.5, "overlap_fraction": 0.1,
                  "bubble_share": 0.2},
    "slo_breaches": {"queue_wait": 2},
    "tenants": {"rows": [
        {"tenant": "default", "chip_seconds": 1.5, "flops": 2e9,
         "real_tokens": 300, "batches": 2, "queue_wait_p95_s": 0.02},
        {"tenant": "bulk", "chip_seconds": 0.5, "flops": 1e9,
         "real_tokens": 100, "batches": 1}]},
    "tenant_slo_breaches": {"bulk": {"batch_age": 1}},
}


def _hb(mod, wid="tpu-1", usage=None, queue=0, ts=None):
    msg = mod.StatusMessage.new(wid, "heartbeat", "idle", worker_type="tpu")
    msg.queue_length = queue
    msg.resource_usage = usage or {}
    if ts is not None:
        msg.timestamp = ts
    return msg


def _watchtower(pkg, rules, bus=None, reg=None):
    """Both packages' watchtower over a real FleetView on a fresh
    registry; the reference's on its own store and clock."""
    if pkg == "ref":
        clock = Clock()
        reg = reg or jmet.MetricsRegistry()
        store = jts.TimeSeriesStore(clock=clock)
        fleet = jfleet.FleetView(registry=reg)
        wt = jwt.Watchtower(fleet, rules=rules, store=store, registry=reg,
                            bus=bus, clock=clock,
                            eval_interval_s=twt.EVAL_INTERVAL_S)
        return wt, store, clock, jmsg
    reg = reg or tmet.MetricsRegistry()
    fleet = tfleet.FleetView(registry=reg)
    wt = twt.Watchtower(fleet, rules=rules, registry=reg, bus=bus)
    return wt, tts.STORE, None, tmsg


def _fold_and_tick(pkg):
    published = []

    class Bus:
        def publish(self, topic, payload):
            published.append((topic, payload.to_dict()
                              if hasattr(payload, "to_dict") else payload))

    mod = jalerts if pkg == "ref" else talerts
    rules = [mod.AlertRule(name="qw", kind="burn_rate",
                           series="fleet_slo_breach_total",
                           labels={"slo": "queue_wait"}, budget=0.0,
                           fast_window_s=5.0, slow_window_s=10.0,
                           factor=1.0),
             mod.AlertRule(name="deep", kind="threshold",
                           series="fleet_queue_depth", op=">", value=2.0)]
    wt, store, clock, msgs = _watchtower(pkg, rules, bus=Bus())
    ticks = []
    for i, (usage, now) in enumerate((
            ({"slo_breaches": {"queue_wait": 0}, "queue": {"depth": 1}},
             T0),
            (USAGE, T0 + 1),
            ({"slo_breaches": {"queue_wait": 3}, "queue": {"depth": 0}},
             T0 + 3),
            ({"slo_breaches": {"queue_wait": 3}, "queue": {"depth": 0}},
             T0 + 20))):
        if clock is not None:
            clock.t = now
        wt.observe_status(_hb(msgs, usage=usage), wall=now)
        # Rate limit: a tick inside eval_interval_s of the last does not
        # evaluate; force does.
        ticks.append((wt.tick(now=now), wt.tick(now=now + 1),
                      wt.tick(now=now + 1, force=True)))
    body = wt.get_alerts()
    body["watchtower"].pop("series_count")
    fleet_series = {k: [v for _, v in store.matching(
        k.split("{")[0], dict(p.split("=") for p in
                              k[k.index("{") + 1:-1].replace('"', "")
                              .split(",")) if "{" in k else None)[0][1]]
        for k in store.keys() if k.startswith("fleet_")}
    return _drop_walls(dict(ticks=ticks, published=published, body=body,
                            firing=wt.firing(), series=fleet_series))


def test_watchtower_folds_ticks_and_publishes_as_the_reference():
    ref = _fold_and_tick("ref")
    port = _fold_and_tick("port")
    assert port == ref
    assert [(t, m["rule"], m["state"]) for t, m in ref["published"]] == [
        (jmsg.TOPIC_ALERTS, "qw", "firing"),
        (jmsg.TOPIC_ALERTS, "deep", "firing"),
        (jmsg.TOPIC_ALERTS, "deep", "resolved"),
        (jmsg.TOPIC_ALERTS, "qw", "resolved")]
    assert ref["firing"] == []
    assert ref["series"]["fleet_queue_depth{worker=tpu-1}"] == [
        1.0, 2.5, 0.0, 0.0]


def test_outbox_utilization_derived_from_gauges():
    out = {}
    for pkg, met, alerts in (("ref", jmet, jalerts), ("port", tmet,
                                                       talerts)):
        reg = met.MetricsRegistry()
        reg.gauge("bus_outbox_depth").labels(publisher="orch").set(90.0)
        reg.gauge("bus_outbox_capacity").labels(publisher="orch").set(100.0)
        rules = [alerts.AlertRule(
            name="outbox_near_full", kind="threshold",
            series="watchtower_outbox_utilization", op=">=", value=0.8,
            agg="last", group="max")]
        wt, store, _, _ = _watchtower(pkg, rules, reg=reg)
        wt.tick(now=T0, force=True)
        out[pkg] = (store.latest("watchtower_outbox_utilization",
                                 {"publisher": "orch"}), wt.firing())
    assert out["port"] == out["ref"]
    assert out["port"] == (pytest.approx(0.9), ["outbox_near_full"])


def test_out_of_order_heartbeat_not_folded(tmp_path):
    """The orchestrator folds only heartbeats its fleet view accepted: a
    redelivered older beat's lower breach count never reaches the store."""
    from distributed_crawler_tpu_torch.config.crawler import CrawlerConfig
    from distributed_crawler_tpu_torch.orchestrator import (
        CrawlJournal,
        Orchestrator,
    )

    orch = Orchestrator("c1", CrawlerConfig(crawl_id="c1"), None, None,
                        journal=CrawlJournal(str(tmp_path / "journal")),
                        alert_rules=[])
    t0 = tmsg.codec.utcnow()
    orch.handle_status(_hb(tmsg, usage={"slo_breaches": {"queue_wait": 5}},
                           ts=t0))
    orch.handle_status(_hb(tmsg, usage={"slo_breaches": {"queue_wait": 3}},
                           ts=t0 - timedelta(seconds=10)))
    samples = tts.STORE.samples("fleet_slo_breach_total",
                                {"worker": "tpu-1", "slo": "queue_wait"})
    assert [v for _, v in samples] == [5.0]
    assert orch.fleet.export()["workers"]["tpu-1"][
        "stale_heartbeats_dropped"] == 1


# -- the tenant ledger ----------------------------------------------------------------
def test_budgets_from_config_is_the_references():
    good = [None, {}, {"window_s": 60, "budgets": {
        "interactive": {"queue_wait": 5, "batch_p95": 2}}}]
    for block in good:
        assert tten.budgets_from_config(block) == \
            jten.budgets_from_config(block)
    bad = [[1, 2], {"budgetz": {}}, {"window_s": 0}, {"window_s": True},
           {"budgets": {"interactive": {}}},
           {"budgets": {"interactive": {"queue_wait": -1}}},
           {"budgets": {"": {"queue_wait": 1}}}, {"budgets": []},
           {"budgets": {"t": {3: 1}}}]
    for block in bad:
        msgs = []
        for mod in (jten, tten):
            with pytest.raises(ValueError) as e:
                mod.budgets_from_config(block)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _seed_spend(store):
    """Two workers' spend, a breach counter that RESETS mid-window, and a
    steadily rising one (`TestBudgetLedger._seeded_ledger`)."""
    for worker, chips in (("tpu-1", 6.0), ("tpu-2", 2.0)):
        store.add("fleet_tenant_chip_seconds_total", chips,
                  {"worker": worker, "tenant": "interactive"}, wall=990.0)
    store.add("fleet_tenant_chip_seconds_total", 2.0,
              {"worker": "tpu-1", "tenant": "bulk-reembed"}, wall=990.0)
    for worker, p95 in (("tpu-1", 0.04), ("tpu-2", 0.09)):
        store.add("fleet_tenant_queue_wait_p95_seconds", p95,
                  {"worker": worker, "tenant": "interactive"}, wall=990.0)
    for wall, v in ((930.0, 5.0), (950.0, 8.0), (970.0, 2.0),
                    (990.0, 4.0)):
        store.add("fleet_tenant_slo_breach_total", v,
                  {"worker": "tpu-1", "tenant": "interactive",
                   "slo": "queue_wait"}, wall=wall)
    for wall, v in ((930.0, 0.0), (950.0, 1.0), (970.0, 3.0),
                    (990.0, 5.0)):
        store.add("fleet_tenant_slo_breach_total", v,
                  {"worker": "tpu-1", "tenant": "bulk-reembed",
                   "slo": "batch_age"}, wall=wall)


def _views(budget_sets, seed=True):
    out = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            store = jts.TimeSeriesStore(clock=lambda: T0)
            ledger = jten.TenantBudgetLedger(store=store, clock=lambda: T0)
        else:
            store = tts.STORE
            ledger = tten.TenantBudgetLedger()
        if seed:
            _seed_spend(store)
        views = []
        for budgets, window in budget_sets:
            ledger.configure(budgets=budgets, window_s=window)
            views.append(ledger.view(now=T0))
        out[pkg] = _drop_walls(views)
    return out


def test_tenant_views_match_the_reference():
    out = _views([({"interactive": {"queue_wait": 10},
                    "bulk-reembed": {"batch_age": 20}}, 60.0),
                  ({"interactive": {"queue_wait": 6}}, None)])
    assert out["port"] == out["ref"]
    first, second = out["port"]
    inter = first["tenants"]["interactive"]
    assert inter["spend"]["share"] == pytest.approx(0.8)
    assert inter["budgets"]["queue_wait"]["burned"] == pytest.approx(7.0)
    assert "exhaustion_s" not in inter["budgets"]["queue_wait"]
    assert first["tenants"]["bulk-reembed"]["budgets"]["batch_age"][
        "exhaustion_s"] == pytest.approx(150.0, rel=0.05)
    cell = second["tenants"]["interactive"]["budgets"]["queue_wait"]
    assert cell["exhausted"] is True and cell["exhaustion_s"] == 0.0


def test_budget_only_tenant_appears_with_zero_spend():
    out = _views([({"interactive": {"queue_wait": 5}}, None)], seed=False)
    assert out["port"] == out["ref"]
    cell = out["port"][0]["tenants"]["interactive"]["budgets"]["queue_wait"]
    assert cell == {"burned": 0.0, "budget": 5.0, "remaining": 5.0,
                    "exhausted": False}


def test_tenant_folds_from_heartbeats_match_the_reference():
    """Heartbeat tenant rows -> ``fleet_tenant_*`` series -> /tenants."""
    out = {}
    for pkg in ("ref", "port"):
        wt, _, clock, msgs = _watchtower(pkg, [])
        for i, scale in enumerate((1.0, 2.0)):
            usage = json.loads(json.dumps(USAGE))
            for row in usage["tenants"]["rows"]:
                row["chip_seconds"] *= scale
            usage["tenant_slo_breaches"]["bulk"]["batch_age"] = 1 + 2 * i
            wt.observe_status(_hb(msgs, usage=usage), wall=T0 + 10 * i)
        wt.tenants.configure(budgets={"bulk": {"batch_age": 1}},
                             window_s=60.0)
        out[pkg] = _drop_walls(wt.tenants.view(now=T0 + 10))
    assert out["port"] == out["ref"]
    assert out["port"]["tenants"]["default"]["spend"]["chip_seconds"] == 3.0
    assert out["port"]["tenants"]["bulk"]["budgets"]["batch_age"][
        "exhausted"] is True


# -- the routes and the bundle -----------------------------------------------------------
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_alerts_tenants_cluster_dtraces_routes_and_bundle(tmp_path):
    """Served with a provider, 404 without; ``/dtraces`` passes
    ``?limit``; a postmortem bundle embeds all three orchestrator
    sections."""
    server = tmet.serve_metrics(0, tmet.MetricsRegistry())
    url = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = {"alerts": lambda: {"firing": ["x"]},
              "tenants": lambda: {"tenants": {}},
              "cluster": lambda: {"workers": {}}}
    seen_limit = []

    def dtraces(limit=0):
        seen_limit.append(limit)
        return {"traces": []}

    try:
        for route in ("/alerts", "/tenants", "/cluster", "/dtraces",
                      "/autoscaler"):
            assert _get(url + route)[0] == 404
        tmet.set_alerts_provider(bodies["alerts"])
        tmet.set_tenants_provider(bodies["tenants"])
        tmet.set_cluster_provider(bodies["cluster"])
        tmet.set_dtraces_provider(dtraces)
        for name, fn in bodies.items():
            code, body = _get(f"{url}/{name}")
            assert code == 200 and json.loads(body) == fn()
        code, body = _get(url + "/dtraces?limit=3")
        assert code == 200 and seen_limit == [3]
        assert _get(url + "/autoscaler")[0] == 404
        tflight.configure(dump_dir=str(tmp_path))
        bundle = tflight.RECORDER.bundle("test")
        assert bundle["alerts"] == {"firing": ["x"]}
        assert bundle["tenants"] == {"tenants": {}}
        assert bundle["dtraces"] == {"traces": []}
    finally:
        tmet.clear_alerts_provider(bodies["alerts"])
        tmet.clear_tenants_provider(bodies["tenants"])
        tmet.clear_cluster_provider(bodies["cluster"])
        tmet.clear_dtraces_provider(dtraces)
        tflight.configure(dump_dir="")
        server.shutdown()
        server.server_close()
    assert tflight.RECORDER.bundle("after").keys().isdisjoint(
        {"alerts", "tenants", "dtraces"})


def test_gauge_helpers_are_the_references():
    """`set_fn` reads at scrape time and `remove_labels` drops a child,
    in the same exposition as the reference's."""
    out = []
    for met in (jmet, tmet):
        reg = met.MetricsRegistry()
        g = reg.gauge("fleet_stale_workers", "h")
        box = [2]
        g.set_fn(lambda: box[0])
        q = reg.gauge("fleet_worker_queue_length", "q")
        q.labels(worker_id="a").set(1)
        q.labels(worker_id="b").set(2)
        q.remove_labels(worker_id="a")
        first = reg.expose()
        box[0] = 5
        out.append((first, reg.expose(), g.value))
    assert out[0] == out[1]
    assert out[1][2] == 5.0

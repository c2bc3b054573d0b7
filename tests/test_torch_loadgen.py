"""The port's load and chaos gate (`distributed_crawler_tpu_torch/loadgen/`)
held against the reference's (`distributed_crawler_tpu/loadgen/`) on the
CPU, without running traffic:

- the generator: for every checked-in scenario's load block (and
  ``audio_load`` block) the plans, each planned batch's JSON (records,
  tenant, crawl id) and the materialized WAV bytes are equal, not close;
  rate profiles and their validation errors are equal; a flight bundle
  written by either package replays to the same workload in both;
- chaos: ``parse_timeline`` is equal for every scenario, and each parse
  error carries the reference's message;
- the gate keys: ``validate_gate_config`` accepts and rejects the inputs
  of the reference's `TestGateConfigValidation`, `TestGateValidation`,
  `TestGateTenantKeyValidation` and `TestClusterScenarios` with the same
  messages;
- the scenario files are byte-equal, and the entry point's ``--list``,
  ``--smoke`` and unknown-scenario error print what ``tools/loadtest.py``
  prints; a ``parallel`` block gets the error verdict naming what is not
  ported;
- the crawl leg: `_seed_sim_network` builds the reference's network for a
  seed, and the four scenarios with a ``crawl`` block (``steady-state``,
  ``kill-orchestrator``, ``partitioned-steady``, ``flood-wait-storm``)
  pass through the port's gate with ``device="cpu"``.  These four run
  traffic: the crawl's rate limiter waits in real time (a search every
  10 s per connection), so ``flood-wait-storm``'s retried crawl takes
  about 80 s on its own.

The other end-to-end runs are in `tests/test_torch_loadgen_*.py`.
"""

import json
import os
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu import loadgen as jlg  # noqa: E402
from distributed_crawler_tpu.loadgen import chaos as jchaos  # noqa: E402
from distributed_crawler_tpu.loadgen import generator as jgen  # noqa: E402
from distributed_crawler_tpu.utils import flight as jflight  # noqa: E402
from distributed_crawler_tpu_torch import loadgen as tlg  # noqa: E402
from distributed_crawler_tpu_torch.loadgen import (  # noqa: E402
    __main__ as tmain,
)
from distributed_crawler_tpu_torch.loadgen import chaos as tchaos  # noqa: E402
from distributed_crawler_tpu_torch.loadgen import (  # noqa: E402
    generator as tgen,
)
from distributed_crawler_tpu_torch.utils import flight as tflight  # noqa: E402

SCENARIOS = jlg.scenario_names()
TEXT = [n for n in SCENARIOS
        if jlg.load_scenario(n).get("kind", "text") != "asr"]
ASR = [n for n in SCENARIOS
       if jlg.load_scenario(n).get("kind") == "asr"]
PKGS = {"ref": (jlg, jgen, jflight), "port": (tlg, tgen, tflight)}


def _batch_json(batch) -> str:
    """A batch's JSON without the per-build ids and birth time."""
    d = batch.to_dict()
    for key in ("batch_id", "created_at", "trace_id"):
        d.pop(key)
    return json.dumps(d, sort_keys=True)


def _raises(fn):
    """The exception's (type name, message), or None when ``fn`` passes."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    return None


# -- the scenario files -------------------------------------------------------
def test_scenario_names_are_the_references():
    assert tlg.scenario_names() == SCENARIOS
    assert len(SCENARIOS) == 18


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_file_is_byte_equal(name):
    ref = Path(jlg.gate.SCENARIO_DIR) / f"{name}.json"
    port = Path(tlg.gate.SCENARIO_DIR) / f"{name}.json"
    assert port.read_bytes() == ref.read_bytes()
    assert tlg.load_scenario(name) == jlg.load_scenario(name)


# -- the generator ------------------------------------------------------------
@pytest.mark.parametrize("name", TEXT)
def test_plan_and_batch_bytes_equal(name):
    load = jlg.load_scenario(name).get("load", {})
    jw = jgen.SyntheticWorkload(jgen.LoadGenConfig(**load))
    tw = tgen.SyntheticWorkload(tgen.LoadGenConfig(**load))
    jplan, tplan = jw.plan(), tw.plan()
    assert [(p.index, p.offset_s, p.tenant,
             [(r.platform, r.words) for r in p.records]) for p in tplan] \
        == [(p.index, p.offset_s, p.tenant,
             [(r.platform, r.words) for r in p.records]) for p in jplan]
    assert len(tplan) > 0
    for jp, tp in zip(jplan, tplan):
        assert _batch_json(tw.build_batch(tp)) == \
            _batch_json(jw.build_batch(jp))
    # Tenant stamps of ad-hoc slots (the gate's tail batches).
    assert [tw.tenant_for(10_000 + i) for i in range(8)] == \
        [jw.tenant_for(10_000 + i) for i in range(8)]


@pytest.mark.parametrize("name", ASR)
def test_audio_workload_wav_bytes_equal(name, tmp_path):
    block = jlg.load_scenario(name)["audio_load"]
    jw = jgen.AudioWorkload(jgen.AudioLoadConfig(**block),
                            str(tmp_path / "ref"))
    tw = tgen.AudioWorkload(tgen.AudioLoadConfig(**block),
                            str(tmp_path / "port"))
    assert repr(tw.plan()) == repr(jw.plan()).replace(
        str(tmp_path / "ref"), str(tmp_path / "port"))
    assert tw.materialize() == jw.materialize()
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names and sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "ref" / n).read_bytes()


@pytest.mark.parametrize("cfg", [
    {"rate_profile": [[1.0]]},
    {"rate_profile": [[2.0, 5], [1.0, 9]]},
    {"rate_profile": [[1.0, 0]]},
    {"arrival": "ramp", "rate_profile": [[1.0, 5]]},
    {"arrival": "burst"},
    {"duration_s": 0},
    {"rate_batches_per_s": 0},
    {"platform_mix": {"tiktok": 1.0}},
    {"platform_mix": {}},
    {"tenants": {"a": -1}},
    {"rate_profile": [[1.0, 5], [2.0, 50]]},
])
def test_load_config_validation_is_the_references(cfg):
    assert _raises(lambda: tgen.LoadGenConfig(**cfg).validate()) == \
        _raises(lambda: jgen.LoadGenConfig(**cfg).validate())


def test_rate_profile_lookup_and_step_plan_equal():
    cfg = dict(seed=5, duration_s=6.0, rate_batches_per_s=4.0,
               rate_profile=[[2.0, 40.0], [4.0, 4.0]], records_per_batch=2)
    jc, tc = jgen.LoadGenConfig(**cfg), tgen.LoadGenConfig(**cfg)
    for t in (0.0, 1.99, 2.0, 3.9, 4.0, 5.5):
        assert tc.rate_at(t) == jc.rate_at(t)
    plan = tgen.SyntheticWorkload(tc).plan()
    assert [p.offset_s for p in plan] == \
        [p.offset_s for p in jgen.SyntheticWorkload(jc).plan()]
    in_step = sum(1 for p in plan if 2.0 <= p.offset_s < 4.0)
    assert in_step > 3 * (len(plan) - in_step)


def test_zipf_text_equal():
    for seed in range(20):
        for words in (0, 1, 7, 80):
            assert tgen.zipf_text(seed, words) == jgen.zipf_text(seed, words)


class _Sink:
    def publish(self, topic, payload):
        pass


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_bundle_replays_to_the_same_workload(writer, tmp_path):
    """A bundle written by either package's recorder replays to the same
    plan and totals through both packages' `workload_from_bundle`."""
    lg, gen, fl = PKGS[writer]
    fl.RECORDER.configure(capacity=1024)
    fl.RECORDER.reset()
    stats = gen.SyntheticWorkload(gen.LoadGenConfig(
        seed=21, duration_s=0.4, rate_batches_per_s=25,
        records_per_batch=3, tenants={"a": 1.0, "b": 2.0})).run(_Sink())
    path = fl.RECORDER.dump(f"replay_{writer}", dump_dir=str(tmp_path))
    assert path is not None and stats.batches > 3
    jw, tw = jlg.workload_from_bundle(path), tlg.workload_from_bundle(path)
    assert tw.totals() == jw.totals()
    assert tw.totals()["batches"] == stats.batches
    assert repr(tw.plan()) == repr(jw.plan())
    assert [_batch_json(tw.build_batch(p)) for p in tw.plan()] == \
        [_batch_json(jw.build_batch(p)) for p in jw.plan()]


# -- chaos --------------------------------------------------------------------
@pytest.mark.parametrize("name", SCENARIOS)
def test_timeline_parse_equal(name):
    lines = jlg.load_scenario(name).get("chaos", [])
    assert repr(tchaos.parse_timeline(lines)) == \
        repr(jchaos.parse_timeline(lines))


@pytest.mark.parametrize("line", [
    "at=2s explode tpu-1", "from=1s..2s kill tpu-1", "at=2s delay bus 10ms",
    "sometime kill tpu-1", "from=2s..1s drop bus",
    "from=1s..2s delay tpu-1 10ms", "at=2s poison bus", "at=2s kill",
    "at=2s kill tpu-1 extra", "from=1s..2s delay bus", "kill",
    "at=2s down orchestrator", "at=1s flood network", "at=2m kill tpu-1",
    "at=3s stall tpu-1 1.5s", "from=1.2s..2.4s down orchestrator",
    "at=1s flood network 2s",
])
def test_fault_parse_and_errors_equal(line):
    assert _raises(lambda: tchaos.parse_fault(line)) == \
        _raises(lambda: jchaos.parse_fault(line))
    if _raises(lambda: jchaos.parse_fault(line)) is None:
        assert repr(tchaos.parse_fault(line)) == \
            repr(jchaos.parse_fault(line))


def test_chaos_engine_release_ends_a_wedge():
    """The port's addition: ``release`` unparks a thread in a wedge."""
    import threading
    import time

    class Inner:
        def run_tokenized(self, token_lists, pack=False):
            return ["ok"]

    eng = tchaos.ChaosEngine(Inner())
    eng.block_for(30.0)
    out = []
    t = threading.Thread(target=lambda: out.append(eng.run_tokenized([[1]])))
    t.start()
    time.sleep(0.05)
    assert not out
    eng.release()
    t.join(timeout=5)
    assert out == [["ok"]]


def test_chaos_engines_over_one_engine_launch_one_at_a_time():
    """The port's addition: proxies sharing a ``device_lock`` (the gate's
    elastic fleet over its one engine) never run the engine at once; a
    wedge blocks before the lock, so it does not stall the others."""
    import threading
    import time

    class Inner:
        def __init__(self):
            self.active = self.peak = 0
            self.mu = threading.Lock()

        def run_tokenized(self, token_lists, pack=False):
            with self.mu:
                self.active += 1
                self.peak = max(self.peak, self.active)
            time.sleep(0.01)
            with self.mu:
                self.active -= 1
            return [{}] * len(token_lists)

    inner, lock = Inner(), threading.Lock()
    engines = [tchaos.ChaosEngine(inner, device_lock=lock) for _ in range(3)]
    engines[0].block_for(30.0)          # a wedged worker
    threads = [threading.Thread(target=lambda e=e: [
        e.run_tokenized([[1]]) for _ in range(5)]) for e in engines[1:]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert inner.peak == 1
    engines[0].release()


# -- the gate keys ------------------------------------------------------------
MIX = {"interactive": 3.0, "bulk-reembed": 1.0}
SHARDS = {"name": "t", "bus": "grpc", "bus_shards": {"count": 3}}


def _cluster(**edit):
    sc = jlg.load_scenario("cluster-steady")
    for block, kv in edit.items():
        sc[block].update(kv)
    return sc


GATE_CASES = [
    # TestGateConfigValidation (tests/test_autoscaler.py)
    {"name": "x", "gate": {"max_lsot": 0}},
    {"name": "x", "gate": {}, "autoscaler": {"poolz": []}},
    {"name": "x", "gate": {}, "autoscaler": {"pools": []}},
    {"name": "x", "kind": "asr", "gate": {},
     "autoscaler": {"pools": [{"pool": "asr"}]}},
    {"name": "x", "gate": {"require_scale_event": [
        {"direction": "up", "during": "recovey"}]}},
    {"name": "x", "gate": {"require_scale_event": [
        {"direction": "sideways"}]}},
    {"name": "x", "gate": {"require_scale_event": ["sideways"]}},
    {"name": "x", "gate": {"require_scale_event": [{"poll": "tpu"}]}},
    {"name": "x", "gate": {"fault_window": [2.0]}},
    {"name": "x", "gate": {"fault_window": [3.0, 2.0]}},
    {"name": "x", "gate": {"require_scale_event": [
        "up", {"pool": "tpu", "direction": "down", "during": "recovery"}],
        "fault_window": [1.0, 2.5]}},
    {"name": "x", "gate": {"forbid_lock_cycles": True}},
    {"name": "x", "gate": {"forbid_lock_cyclez": True}},
    # TestGateValidation (tests/test_bus_partition.py)
    {**SHARDS, "gate": {}, "bus_shards": {"count": 3,
                                          "spool_dir": "/shared"}},
    {**SHARDS, "gate": {}, "bus": "inmemory"},
    {**SHARDS, "gate": {}, "bus_shards": {"count": 1}},
    {**SHARDS, "gate": {}, "kind": "cluster"},
    {"name": "t", "bus": "grpc", "gate": {"max_shard_skew": 2.0}},
    {**SHARDS, "gate": {"bus_shard_generations": {"bus-0": 1}}},
    {**SHARDS, "gate": {"bus_shard_generations":
                        {"bus-0": 1, "bus-1": 2, "bus-2": 1}}},
    # TestGateTenantKeyValidation (tests/test_tenant_attribution.py)
    {"name": "x", "gate": {"require_tenants": ["interactive"]}},
    {"name": "x", "gate": {"forbid_tenant_breach":
                           {"interactive": ["queue_wait"]}}},
    {"name": "x", "load": {"tenants": MIX},
     "gate": {"require_tenants": ["interactivy"]}},
    {"name": "x", "load": {"tenants": MIX},
     "gate": {"forbid_tenant_breach": {"nobody": ["queue_wait"]}}},
    {"name": "x", "load": {"tenants": MIX},
     "gate": {"require_tenant_breach": ["interactive"]}},
    {"name": "x", "load": {"tenants": MIX},
     "gate": {"require_tenant_breach": {"interactive": []}}},
    {"name": "x", "load": {"tenants": MIX},
     "gate": {"max_unattributed_share": 1.5}},
    {"name": "x", "load": {"tenants": MIX},
     "gate": {"max_unattributed_share": True}},
    {"name": "x", "load": {"tenants": MIX},
     "gate": {"require_tenant_conservation": 2.0}},
    {"name": "x", "gate": {}, "load": {"tenants": {"a": -1}}},
    {"name": "x", "gate": {}, "tenant_budgets": {"budgetz": {}}},
    {"name": "x", "gate": {}, "alerts": [{"name": "r", "kind": "nope"}]},
    # TestClusterScenarios (tests/test_cluster_serve.py)
    _cluster(gate={"definitely_not_a_key": 1}),
    _cluster(gate={"min_device_busy_fraction": 0.5}),
    _cluster(worker={"publish_embeddings": False}),
    _cluster(worker={"write_embeddings": False}),
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_validate_gate_config_is_the_references(case):
    sc = GATE_CASES[case]
    assert _raises(lambda: tlg.validate_gate_config(json.loads(
        json.dumps(sc)))) == _raises(lambda: jlg.validate_gate_config(sc))


def test_gate_key_sets_are_the_references():
    for key in ("_GATE_KEYS_SHARED", "_GATE_KEYS_TEXT", "_GATE_KEYS_ASR",
                "_GATE_KEYS_CLUSTER", "_WORKER_KEYS",
                "_CLUSTER_WORKER_KEYS", "_LOAD_KEYS"):
        assert getattr(tlg.gate, key) == getattr(jlg.gate, key), key


def test_merge_overrides_is_the_references():
    base = {"load": {"seed": 1, "rate_batches_per_s": 5},
            "gate": {"max_lost": 0}}
    over = {"load": {"seed": 9}, "chaos": ["at=1s kill tpu-1"]}
    assert tlg.gate.merge_overrides(base, over) == \
        jlg.gate.merge_overrides(base, over)
    assert base["load"]["seed"] == 1


def test_unknown_scenario_error_is_the_references():
    assert _raises(lambda: tlg.load_scenario("no-such")) == \
        _raises(lambda: jlg.load_scenario("no-such"))


@pytest.mark.parametrize("sc,match", [
    ({"name": "x", "bus": "inmemory", "chaos": ["at=1s kill tpu-1"],
      "load": {"duration_s": 0.1}}, "grpc"),
    ({"name": "x", "bus": "carrier-pigeon", "gate": {}}, "inmemory|grpc"),
    ({"name": "x", "bus": "grpc", "chaos": ["from=1s..2s down bus"],
      "gate": {}}, "bus_durability"),
])
def test_setup_errors_raise(sc, match):
    """Config errors raise from `run_scenario`; the runner judges only
    runs it could set up."""
    with pytest.raises(ValueError, match=match):
        tlg.run_scenario(sc, device="cpu")


# -- the entry point ----------------------------------------------------------
def _run(main, argv, capsys, **kw):
    rc = main(argv, **kw)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--list"], ["--smoke"],
                                  ["--scenario", "no-such"]])
def test_entry_point_prints_what_loadtest_prints(argv, capsys):
    from tools import loadtest

    rc_ref, out_ref = _run(loadtest.main, argv, capsys)
    rc, out = _run(tmain.main, argv, capsys)
    assert (rc, out) == (rc_ref, out_ref)
    last = out.strip().splitlines()[-1]
    if argv != ["--list"]:
        json.loads(last)


@pytest.mark.parametrize("name,needle", [
    ("multichip-steady", "multi-device serving is not ported yet"),
])
def test_unported_blocks_get_the_error_verdict(name, needle, capsys):
    rc, out = _run(tmain.main, ["--scenario", name], capsys, device="cpu")
    verdict = json.loads(out.strip().splitlines()[-1])
    assert rc == 1
    assert verdict["status"] == "error" and verdict["scenario"] == name
    assert needle in verdict["error"]


def test_no_card_is_an_error_verdict(capsys):
    """Without ``device="cpu"`` the gate asks for the card, and a missing
    card is the error verdict, never a CPU run."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc, out = _run(tmain.main, ["--scenario", "kill-worker", "--device"],
                   capsys)
    verdict = json.loads(out.strip().splitlines()[-1])
    assert rc == 1 and verdict["status"] == "error"
    assert "no CUDA device" in verdict["error"]


def test_parse_mix_and_gate_are_the_references(tmp_path):
    from tools import loadtest

    for text in ("telegram=0.8,youtube=0.2", "telegram"):
        assert _raises(lambda: tmain._parse_mix(text)) == \
            _raises(lambda: loadtest._parse_mix(text))
    assert tmain._parse_mix("telegram=0.8,youtube=0.2") == \
        {"telegram": 0.8, "youtube": 0.2}
    gate_file = tmp_path / "gate.json"
    gate_file.write_text('{"batch_p95_ms": 9}')
    for text in ('{"max_lost": 1}', f"@{gate_file}", "[1]"):
        assert _raises(lambda: tmain._parse_gate(text)) == \
            _raises(lambda: loadtest._parse_gate(text))


@pytest.mark.parametrize("argv,yaml", [
    (["--config", "{cfg}"],
     "loadgen:\n  scenario: backend-wedge\n  seed: 123\n"
     "  rate_batches_per_s: 7\n"
     '  platform_mix: "telegram=0.6,youtube=0.4"\n'
     "  gate: '{\"max_lost\": 2}'\n"),
    (["--config", "{cfg}", "--scenario", "steady-state", "--seed", "9"],
     "loadgen:\n  scenario: backend-wedge\n  seed: 123\n"),
    (["--config", "{cfg}"],
     "loadgen:\n  seed: 0\n  duration_s: 0\n"
     '  arrival: ""\n  rate_batches_per_s: 0\n'
     '  platform_mix: ""\n  gate: ""\n'),
    (["--duration", "2.5", "--arrival", "ramp", "--rate", "3"], ""),
])
def test_resolve_is_the_references(argv, yaml, tmp_path):
    """Flags > config file > scenario values, through the same
    precedence chain as ``tools/loadtest.py``'s `_resolve`."""
    pytest.importorskip("yaml")
    from tools import loadtest

    cfg = tmp_path / "conf.yaml"
    cfg.write_text(yaml)
    argv = [a.replace("{cfg}", str(cfg)) for a in argv]
    assert tmain._resolve(tmain.build_parser().parse_args(argv)) == \
        loadtest._resolve(loadtest.build_parser().parse_args(argv))


def test_parser_flags_are_the_references():
    from tools import loadtest

    def flags(p):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices)
                for a in p._actions}

    assert flags(tmain.build_parser()) == flags(loadtest.build_parser())


# -- the crawl leg ------------------------------------------------------------
def _network(gate_mod, crawl_cfg, seed):
    net, names = gate_mod._seed_sim_network(crawl_cfg, seed)
    return names, [
        (ch.username, ch.chat_id, ch.supergroup_id, ch.title,
         ch.member_count,
         [(m.id, m.chat_id, m.date, m.view_count, m.content)
          for m in ch.messages])
        for ch in net.channels.values()]


@pytest.mark.parametrize("seed", [11, 31, 37, 0])
def test_seed_sim_network_is_the_references(seed):
    """The crawl leg's network for a seed: the same channels, ids and
    messages in both packages, for every checked-in ``crawl`` block."""
    blocks = [jlg.load_scenario(n)["crawl"] for n in SCENARIOS
              if jlg.load_scenario(n).get("crawl")]
    assert len(blocks) == 4
    for block in blocks + [{}]:
        assert _network(tlg.gate, block, seed) \
            == _network(jlg.gate, block, seed)


CRAWL_LEG = ("steady-state", "kill-orchestrator", "partitioned-steady",
             "flood-wait-storm")


@pytest.mark.parametrize("name", CRAWL_LEG)
def test_crawl_leg_scenario_passes_through_the_port(name):
    """Each crawl-leg scenario through the port's gate on the CPU: the
    port's `SimNetwork`, pool, runner and `CrawlWorker` feed the text
    worker through the `InferenceBridge`; ``pass`` with nothing lost or
    duplicated.  ``steady-state``: traces spanning two processes, no
    scale event; ``kill-orchestrator``: the reference's
    `test_kill_orchestrator_scenario_resumes_from_journal`;
    ``partitioned-steady``: three shards, each on its first generation,
    every page fetched once; ``flood-wait-storm``: the storm flight-
    recorded and the crawl completed."""
    verdict = tlg.run_scenario(tlg.load_scenario(name), device="cpu")
    assert verdict["status"] == "pass", json.dumps(verdict["checks"])
    assert verdict["lost"] == 0 and verdict["duplicates"] == 0
    checks = verdict["checks"]
    orch = verdict["orchestrator"]
    if name == "steady-state":
        assert checks["dtrace_processes"]["ok"]
        assert verdict["dtraces"]["multi_process"] >= 1
        assert verdict["autoscaler"]["decisions"] == 0
        assert checks["scale_events"]["value"] == 0
    elif name == "kill-orchestrator":
        assert orch["generations"] == 2 and orch["resumed"]
        assert orch["pages_by_status"] == {"fetched": 2}
        assert orch["completed_items"] == 2
        assert checks["orch_pages_lost"]["ok"]
        assert checks["orch_result_duplicates"]["ok"]
        assert checks["flight_orch_kill"]["ok"]
        assert checks["flight_orch_resume"]["ok"]
        assert verdict["tail_breaches"] == {}
        budget = checks["tail_queue_wait_p95_ms"]
        assert budget["ok"] and budget["value"] <= budget["budget"]
    elif name == "partitioned-steady":
        assert verdict["bus_shards"]["count"] == 3
        assert sum(verdict["bus_shards"]["routed_batches"].values()) > 0
        assert verdict["bus_shards"]["generations"] == \
            {"bus-0": 1, "bus-1": 1, "bus-2": 1}
        assert checks["flight_frontier_shards"]["ok"]
        assert orch["pages_by_status"] == {"fetched": 3}
        assert orch["completed_items"] == 3
    else:
        assert checks["flight_flood_wait_storm"]["ok"]
        assert checks["scale_events"]["value"] == 0
        assert orch["pages_by_status"] == {"fetched": 2}
        assert orch["completed_items"] == 2

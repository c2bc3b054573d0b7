"""The port's text gate end to end on the CPU, at the ``tiny`` model: the
counterparts of the reference's `TestGateE2E` runs (`tests/test_loadgen.py`)
through `distributed_crawler_tpu_torch.loadgen.run_scenario` with
``device="cpu"``, and one package's scenario after the other's in one
process.

Each verdict has the reference's keys and check names (as the
reference's runner gives them for the same scenario) and passes.  Every
wait inside a run is bounded by the scenario's ``drain_timeout_s`` and the
gate's own settle budgets.
"""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("grpc")

from distributed_crawler_tpu import loadgen as jlg  # noqa: E402
from distributed_crawler_tpu_torch import loadgen as tlg  # noqa: E402
from distributed_crawler_tpu_torch.utils import flight  # noqa: E402

# The text runner's verdict keys, as the reference's gives them.
TEXT_KEYS = {
    "alerts", "autoscaler", "bus", "bus_broker", "bus_durable",
    "bus_generations", "bus_sharded", "bus_shards", "chaos_events",
    "checks", "cluster_workers", "dtraces", "duplicates", "duration_s",
    "expected_records", "fault_breaches", "fault_window_s",
    "goodput_posts_per_s", "lockwitness", "lost", "mesh", "occupancy",
    "orchestrator", "per_chip", "processed_records", "published",
    "scenario", "status", "tail_batch_age_p95_ms", "tail_batch_p95_ms",
    "tail_breaches", "tail_queue_wait_p95_ms", "tenants",
    "worker_generations"}

KILL_WORKER_CHECKS = {
    "alert_batch_age_burn", "alert_queue_wait_burn",
    "alert_quiet_stale_worker", "alerts_resolved", "breach_batch_age",
    "bus_unrouted", "drained", "duplicates", "endpoint_alerts",
    "endpoint_cluster", "endpoint_costs", "endpoint_dtraces",
    "endpoint_metrics", "endpoint_tenants", "endpoint_timeseries",
    "flight_alert", "flight_chaos", "flight_worker_kill",
    "goodput_posts_per_s", "lock_cycles", "lost", "tail_batch_p95_ms",
    "tail_no_breach_batch_age", "tail_queue_wait_p95_ms",
    "timeseries_series"}


def _passes(verdict, checks):
    assert verdict["status"] == "pass", json.dumps(verdict["checks"])
    assert set(verdict) - {"lost_sample"} == TEXT_KEYS
    assert set(verdict["checks"]) == checks
    assert verdict["lost"] == 0 and verdict["duplicates"] == 0


def test_kill_worker_scenario_breach_and_recovery():
    """The worker is killed mid-stream on the gRPC bus and restarted under
    load: zero lost or duplicated items, a batch_age breach in the fault
    window, none in the tail, both burn alerts fired and resolved, and no
    lock-order cycle in the port's witness."""
    verdict = tlg.run_scenario(tlg.load_scenario("kill-worker"),
                               device="cpu")
    _passes(verdict, KILL_WORKER_CHECKS)
    assert verdict["fault_breaches"].get("batch_age", 0) > 0
    assert verdict["tail_breaches"] == {}
    assert verdict["worker_generations"] == 2
    budget = verdict["checks"]["tail_queue_wait_p95_ms"]
    assert budget["ok"] and budget["value"] <= budget["budget"]
    witness = verdict["lockwitness"]
    assert witness["new_cycles"] == 0
    assert witness["instrumented_sites"] > 0 and witness["acquisitions"] > 0


def _tiny(name, seed, gate):
    return {
        "name": name, "bus": "inmemory",
        "engine": {"model": "tiny", "n_labels": 2, "batch_size": 4,
                   "buckets": [32]},
        "worker": {"worker_id": "tpu-1", "heartbeat_s": 0.5,
                   "write_embeddings": False, "stall_warn_s": 0},
        "load": {"seed": seed, "duration_s": 0.5,
                 "rate_batches_per_s": 12, "records_per_batch": 2},
        "tail": {"batches": 1, "gap_s": 0.02},
        "gate": gate,
    }


def test_envelope_failure_yields_fail_verdict():
    """An impossible envelope fails the named check but still returns a
    full verdict (the gate judges, it does not crash)."""
    sc = _tiny("tiny-fail", 1, {"max_lost": 0,
                                "goodput_min_posts_per_s": 10_000_000})
    verdict = tlg.run_scenario(sc, device="cpu")
    assert verdict["status"] == "fail"
    assert set(verdict) == TEXT_KEYS
    assert not verdict["checks"]["goodput_posts_per_s"]["ok"]
    assert verdict["checks"]["lost"]["ok"]
    assert verdict["lost"] == 0


def test_replay_through_gate_loses_nothing(tmp_path):
    """A recorded run's bundle replayed through `run_scenario` reconciles
    clean and offers the identical workload."""
    flight.RECORDER.reset()
    sc = _tiny("tiny-replay", 3, {"max_lost": 0, "max_duplicates": 0})
    first = tlg.run_scenario(sc, device="cpu")
    assert first["status"] == "pass", first["checks"]
    path = flight.RECORDER.dump("loadgen_gate_replay",
                                dump_dir=str(tmp_path))
    replay = tlg.workload_from_bundle(path)
    assert replay.totals()["batches"] == first["published"]["batches"]
    second = tlg.run_scenario(sc, workload=replay, device="cpu")
    assert second["status"] == "pass", second["checks"]
    assert second["lost"] == 0 and second["duplicates"] == 0
    assert second["published"]["batches"] == first["published"]["batches"]
    assert second["published"]["words"] == first["published"]["words"]


def _shared_state_scenario():
    """A short gRPC run that touches every process-global the gate owns:
    the span and flight rings, the time-series store, the alert rules and
    the status/costs/cluster/alerts/tenants providers, and the lock-order
    witness."""
    sc = _tiny("shared-state", 5, {
        "max_lost": 0, "max_duplicates": 0, "forbid_lock_cycles": True,
        "min_timeseries_series": 5, "require_flight": ["loadgen_batch"]})
    sc["bus"] = "grpc"
    sc["alert_eval_interval_s"] = 0.05
    return sc


@pytest.mark.parametrize("order", [("ref", "port"), ("port", "ref")])
def test_packages_run_one_after_the_other(order):
    """The reference's gate and the port's in one process, in either
    order: each touches only its own package's globals, so both pass."""
    runners = {"ref": lambda sc: jlg.run_scenario(sc),
               "port": lambda sc: tlg.run_scenario(sc, device="cpu")}
    verdicts = {}
    for pkg in order:
        verdicts[pkg] = runners[pkg](_shared_state_scenario())
    for pkg, verdict in verdicts.items():
        assert verdict["status"] == "pass", (pkg, verdict["checks"])
        assert verdict["lockwitness"]["new_cycles"] == 0
    assert set(verdicts["port"]["checks"]) == set(verdicts["ref"]["checks"])

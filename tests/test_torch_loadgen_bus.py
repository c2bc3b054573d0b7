"""The port's text gate end to end on the CPU at the ``tiny`` model, over
the durable and partitioned bus and the tenant ledger: the counterparts of
the reference's ``kill-broker`` (`tests/test_bus_durability.py`),
``kill-broker-shard`` (`tests/test_bus_partition.py`) and
``tenant-mix-steady`` (`tests/test_tenant_attribution.py`) runs.

Each verdict has the reference's keys and check names for the scenario
and passes.  Every wait inside a run is bounded by the scenario's
``drain_timeout_s`` and the gate's settle budgets.
"""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("grpc")

from distributed_crawler_tpu_torch import loadgen as tlg  # noqa: E402

# The check names the reference's runner gives each scenario.
CHECKS = {
    "kill-broker": {
        "breach_batch_age", "bus_unrouted", "drained", "duplicates",
        "endpoint_alerts", "endpoint_cluster", "endpoint_costs",
        "endpoint_dlq", "endpoint_dtraces", "endpoint_metrics",
        "endpoint_tenants", "endpoint_timeseries", "flight_bus_kill",
        "flight_bus_resume", "flight_chaos", "goodput_posts_per_s", "lost",
        "tail_batch_p95_ms", "tail_no_breach_queue_wait",
        "tail_queue_wait_p95_ms"},
    "kill-broker-shard": {
        "breach_batch_age", "bus_shard_generations", "bus_unrouted",
        "drained", "duplicates", "endpoint_alerts", "endpoint_cluster",
        "endpoint_costs", "endpoint_dlq", "endpoint_dtraces",
        "endpoint_metrics", "endpoint_shards", "endpoint_tenants",
        "endpoint_timeseries", "flight_bus_kill", "flight_bus_resume",
        "flight_chaos", "goodput_posts_per_s", "lost", "shard_skew",
        "tail_batch_p95_ms", "tail_no_breach_queue_wait",
        "tail_queue_wait_p95_ms"},
    "tenant-mix-steady": {
        "alert_quiet_queue_wait_burn", "alert_quiet_stale_worker",
        "alerts_resolved", "bus_unrouted", "drained", "duplicates",
        "endpoint_alerts", "endpoint_cluster", "endpoint_costs",
        "endpoint_dtraces", "endpoint_metrics", "endpoint_tenants",
        "endpoint_timeseries", "flight_loadgen_batch",
        "goodput_posts_per_s", "lost", "tail_batch_p95_ms",
        "tail_queue_wait_p95_ms", "tenant_conservation",
        "tenant_no_breach_interactive_queue_wait",
        "tenant_visible_bulk-reembed", "tenant_visible_interactive",
        "timeseries_series", "unattributed_share"},
}


def _run(name):
    verdict = tlg.run_scenario(tlg.load_scenario(name), device="cpu")
    assert verdict["status"] == "pass", json.dumps(verdict["checks"])
    assert set(verdict["checks"]) == CHECKS[name]
    assert verdict["lost"] == 0 and verdict["duplicates"] == 0
    return verdict


def test_kill_broker_scenario_zero_loss_across_generations():
    """The broker is hard-killed mid-load and restarted over the same
    spool dir and port: zero loss across the generation boundary, the
    outboxes drained, a batch_age breach in the outage, a clean tail."""
    verdict = _run("kill-broker")
    assert verdict["bus_generations"] == 2
    assert verdict["bus_broker"]["durable"]
    assert verdict["bus_broker"]["outbox_depth_end"] == 0
    assert verdict["fault_breaches"].get("batch_age", 0) > 0
    assert verdict["tail_breaches"] == {}


def test_kill_broker_shard_scenario_restarts_one_shard():
    verdict = _run("kill-broker-shard")
    assert verdict["bus_shards"]["generations"] == \
        {"bus-0": 1, "bus-1": 2, "bus-2": 1}
    assert sum(verdict["bus_shards"]["routed_batches"].values()) > 0


def test_tenant_mix_steady_scenario_attributes_and_conserves():
    """Two tenants share one worker: both visible on /tenants, the ledger
    conserved against /costs, nothing unattributed, no interactive
    queue-wait breach."""
    verdict = _run("tenant-mix-steady")
    spend = verdict["tenants"]["spend"]
    mix = ("interactive", "bulk-reembed")
    assert all(spend[t]["chip_seconds"] > 0 for t in mix)
    assert sum(spend[t]["share"] for t in mix) == pytest.approx(1.0,
                                                                 abs=1e-6)
    assert spend["interactive"]["share"] > spend["bulk-reembed"]["share"]
    assert verdict["tenants"]["unattributed_share"] == 0.0

"""The port's elastic-fleet gate end to end on the CPU at the ``tiny``
model: the counterpart of the reference's `TestFlashCrowdE2E`
(`tests/test_autoscaler.py`).  The gate's in-process autoscaler spawns
the port's `TPUWorker`s through `InProcessSupervisor` under a 10x Poisson
step and retires them after it.

What the run waits on, and the deadlines this test gives it so that it
holds on a loaded host (six test processes on eight cores):

- the single worker must hold the scenario's forcing queue-wait SLO
  (``slo_queue_wait_ms`` 40) through the 2 s baseline, so that the burn
  alert, and the scale-up it triggers, land inside the declared fault
  window (2.0-4.5 s).  A CPU-starved worker misses 40 ms at the baseline
  rate, the alert fires and the fleet reaches its ceiling before the
  step, and no up decision is left for the window.  The test gives that
  forcing deadline 150 ms: the step still breaches it within half a
  second (its queue waits grow to seconds), the baseline does not;
- after the step the fleet must converge (pools back at their floor,
  nothing firing) within ``max_time_to_converge_s`` (30).  Scale-down
  needs the workers' queue-depth series under 2.0, and that series is a
  60 s time-weighted mean: on a loaded host the step's backlog keeps it
  up until the backlog's samples leave the window, about a minute
  after the first scale-up.  The test gives convergence 90 s.

Every other gate check of the scenario stays as it is.
"""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("grpc")

from distributed_crawler_tpu_torch import loadgen as tlg  # noqa: E402

FLASH_CROWD_CHECKS = {
    "alert_queue_wait_burn", "alert_quiet_stale_worker", "alerts_resolved",
    "bus_unrouted", "drained", "duplicates", "endpoint_alerts",
    "endpoint_autoscaler", "endpoint_cluster", "endpoint_costs",
    "endpoint_dtraces", "endpoint_metrics", "endpoint_tenants",
    "endpoint_timeseries", "flight_alert", "flight_autoscale",
    "flight_autoscale_retire", "flight_autoscale_spawn",
    "flight_loadgen_batch", "goodput_posts_per_s", "lost", "max_fleet_size",
    "min_fleet_size", "no_scale_down_in_fault",
    "scale_event_tpu_down_recovery", "scale_event_tpu_up_fault",
    "tail_batch_p95_ms", "tail_queue_wait_p95_ms", "time_to_converge_s",
    "timeseries_series"}

# The deadlines a loaded host holds (module docstring).
LOADED_HOST = {"worker": {"slo_queue_wait_ms": 150},
               "gate": {"max_time_to_converge_s": 90}}


def test_flash_crowd_scenario_passes():
    """The step breaches queue-wait, the burn alert fires, the autoscaler
    spawns workers inside the fault window, the fleet drains the surge,
    the alert resolves and the pool returns to its floor, with zero lost
    or duplicated items across the dynamic fleet."""
    verdict = tlg.run_scenario(tlg.load_scenario("flash-crowd"),
                               overrides=LOADED_HOST, device="cpu")
    assert verdict["status"] == "pass", json.dumps(verdict, indent=2)
    assert set(verdict["checks"]) == FLASH_CROWD_CHECKS
    fleet = verdict["autoscaler"]
    assert fleet["fleet_sizes"]["max"] >= 2
    assert fleet["fleet_sizes"]["final"] == 1
    assert fleet["converge_s"] is not None
    assert sum(fleet["spawned"].values()) >= 1
    assert sum(fleet["retired"].values()) >= 1
    assert verdict["alerts"]["fired"].get("queue_wait_burn")
    assert verdict["lost"] == 0 and verdict["duplicates"] == 0

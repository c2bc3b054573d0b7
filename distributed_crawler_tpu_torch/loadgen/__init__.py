"""Synthetic load, chaos injection, and the SLO regression gate.

The port's copy of the reference's `distributed_crawler_tpu/loadgen/`,
driving the port's own serving stack (its `InferenceEngine` on the card,
or on the CPU when the caller asks):

- `generator`: a fully-seeded synthetic workload source (Zipf post
  lengths, telegram/youtube platform mix, open-loop Poisson or
  closed-loop ramp arrivals) injected through the real bus, plus replay
  of flight-recorder bundles so every postmortem becomes a reproducible
  test case;
- `chaos`: a scenario-driven fault injector (kill/stall/wedge a worker,
  delay/drop/poison bus deliveries) expressed as declarative timelines,
  every fault flight-recorded and announced on ``TOPIC_CHAOS``;
- `gate`: runs a named scenario end-to-end in-process, scrapes
  `/metrics`, `/costs`, and `/cluster` at the end, and asserts a
  declared envelope (p95 budgets, breach-and-recovery, zero
  lost/duplicated items, goodput floor), emitting ONE parseable JSON
  verdict line — the bench.py contract.

Entry point: ``python -m distributed_crawler_tpu_torch.loadgen --scenario
kill-worker``.  Scenario files live under `loadgen/scenarios/`, a copy of
the reference's; the format is documented in docs/operations.md "Load
testing & chaos".  A ``crawl`` block runs the simulated crawl leg
through the port's `CrawlWorker`; a ``parallel`` block (the serving mesh)
is refused: it is not ported.
"""

from .chaos import ChaosBus, ChaosController, Fault, parse_timeline
from .exposition import metric_samples, moving_samples, parse_exposition
from .generator import (
    AudioLoadConfig,
    AudioWorkload,
    LoadGenConfig,
    ReplayWorkload,
    SyntheticWorkload,
    workload_from_bundle,
)
from .gate import (
    load_scenario,
    run_asr_scenario,
    run_cluster_scenario,
    run_scenario,
    scenario_names,
    validate_gate_config,
)

__all__ = [
    "AudioLoadConfig",
    "AudioWorkload",
    "LoadGenConfig",
    "SyntheticWorkload",
    "ReplayWorkload",
    "workload_from_bundle",
    "Fault",
    "parse_timeline",
    "parse_exposition",
    "metric_samples",
    "moving_samples",
    "ChaosController",
    "ChaosBus",
    "load_scenario",
    "run_scenario",
    "run_asr_scenario",
    "run_cluster_scenario",
    "scenario_names",
    "validate_gate_config",
]

"""The SLO regression gate: run a scenario end-to-end, judge the system.

The port's copy of the reference's `distributed_crawler_tpu/loadgen/
gate.py`, over the port's own stack: the engine, the ASR pipeline and
every worker are built on the card (``device=None``) or on the CPU
(``device="cpu"``, as the tests ask).  A ``crawl`` block runs the
simulated crawl leg on the port's own modules: a seeded `SimNetwork`, a
pool of `SimTelegramClient`s, the channel crawl runner and a `CrawlWorker`
whose posts reach the text worker through an `InferenceBridge`.  One
deliberate difference: the reference gives the crawl's state managers an
in-memory SQL graph store (``SqlConfig(url=":memory:")``); the port's
`CompositeStateManager` has none, and channel sampling never reaches it
(ROADMAP Queue 3).  A ``parallel`` block (the serving mesh) is refused
with a NotImplementedError that names what is not ported; the entry
point turns it into the error verdict.

A *scenario* is a JSON file (see `loadgen/scenarios/`) naming the
workload, the bus transport, the chaos timeline, and the envelope the
run must stay inside.  :func:`run_scenario` assembles the REAL stack in
one process — orchestrator (fleet fold, watchtower and tenant ledger),
a serving worker on a real `InferenceEngine`, the generator, and the
chaos controller — drives it through three phases
(baseline → load+chaos → recovery tail), scrapes ``/metrics``,
``/costs``, and ``/cluster`` over real HTTP at the end, and returns a
verdict dict asserting:

- **zero lost / duplicated items**: every post_uid the chaos bus let
  through must appear exactly once in the writeback sink (dropped and
  poisoned batches are excluded by the ledger);
- **breach-and-recovery**: the SLOs named in ``gate.require_breach``
  must have fired during the fault window, and those in
  ``gate.forbid_tail_breach`` must NOT fire in the recovery tail;
- **tail latency**: queue-wait / batch p95 over tail-phase spans under
  the declared budgets;
- **goodput**: records through the device per active second above the
  configured floor.

``python -m distributed_crawler_tpu_torch.loadgen`` wraps this in the
bench.py contract: ONE parseable JSON verdict line, whatever happens.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import tempfile
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional

from ..bus.messages import (
    TOPIC_ALERTS,
    TOPIC_CHAOS,
    TOPIC_CLUSTERS,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_INFERENCE_RESULTS,
    TOPIC_MEDIA_BATCHES,
)
from ..utils import flight, timeseries, trace
from ..utils.alerts import rules_from_config
from ..utils.slo import (
    ASR_BATCH_SPANS,
    BATCH_AGE_SPANS,
    BATCH_SPANS,
    QUEUE_WAIT_SPANS,
)
from .chaos import (
    ChaosASRPipeline,
    ChaosBus,
    ChaosController,
    ChaosEngine,
    parse_timeline,
)
from .generator import (
    AudioLoadConfig,
    AudioWorkload,
    LoadGenConfig,
    PlannedBatch,
    PlannedRecord,
    SyntheticWorkload,
    zipf_text,
)

logger = logging.getLogger("dct.loadgen.gate")

SCENARIO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "scenarios")

# TPUWorkerConfig fields a scenario's "worker" block may set.
_WORKER_KEYS = ("worker_id", "heartbeat_s", "queue_capacity",
                "coalesce_batches", "pack", "stall_warn_s", "stall_exit_s",
                "slo_batch_p95_ms", "slo_queue_wait_ms", "slo_batch_age_ms",
                "write_embeddings", "publish_embeddings",
                "span_export_interval_s",
                "span_export_max_spans", "span_sample_rate")
# ClusterWorkerConfig fields a cluster scenario's "cluster_worker" block
# may set (`cluster/worker.py`).
_CLUSTER_WORKER_KEYS = ("worker_id", "heartbeat_s", "queue_capacity",
                        "coalesce_batches", "k", "buckets", "spherical",
                        "seed", "checkpoint_every_batches",
                        "min_cluster_fraction", "channel_map_size",
                        "slo_batch_p95_ms", "slo_queue_wait_ms",
                        "slo_batch_age_ms", "span_export_interval_s",
                        "span_export_max_spans", "span_sample_rate")
_LOAD_KEYS = ("seed", "duration_s", "arrival", "rate_batches_per_s",
              "rate_profile", "ramp_from", "ramp_to", "ramp_batches",
              "records_per_batch", "zipf_a", "max_words", "platform_mix",
              "crawl_id", "tenants")

# Every gate-envelope key either runner reads.  `validate_gate_config`
# rejects anything else LOUDLY — a typo'd gate key would otherwise turn
# an assertion into a silent no-op forever (the entry point's --smoke
# runs this over EVERY checked-in scenario so new pack files can't
# bit-rot).
_GATE_KEYS_SHARED = frozenset({
    "max_lost", "max_duplicates", "require_breach", "forbid_tail_breach",
    "queue_wait_p95_ms", "require_flight",
    "min_device_busy_fraction", "min_overlap_fraction", "max_bubble_share",
    "min_dtrace_processes", "max_clock_skew_ms",
    # Runtime lock-order witness (utils/lockwitness.py): the run must
    # add zero held→acquired cycles to the process lock-order graph.
    "forbid_lock_cycles",
})
_GATE_KEYS_TEXT = _GATE_KEYS_SHARED | {
    "batch_p95_ms", "goodput_min_posts_per_s", "orchestrator_reconcile",
    "require_per_chip_devices", "min_per_chip_goodput_tokens_per_s",
    "require_alert", "forbid_alert", "max_firing_after_recovery_s",
    "min_timeseries_series", "max_unrouted",
    # The elastic-fleet envelope (`orchestrator/autoscaler.py`).
    "require_scale_event", "max_scale_events", "min_fleet_size",
    "max_fleet_size", "max_time_to_converge_s",
    "forbid_scale_down_in_fault", "fault_window",
    # The partitioned-bus envelope (`bus/partition.py`; needs a
    # "bus_shards" block — validate_gate_config enforces the pairing).
    "max_shard_skew", "bus_shard_generations",
    # The tenant-attribution envelope (`orchestrator/tenants.py`; the
    # tenant-naming keys need a "load.tenants" mix —
    # validate_gate_config enforces the pairing).
    "require_tenants", "max_unattributed_share",
    "require_tenant_breach", "forbid_tenant_breach",
    "require_tenant_conservation",
}
_GATE_KEYS_ASR = _GATE_KEYS_SHARED | {
    "max_transcript_errors", "reentry_required", "asr_batch_p95_ms",
    "goodput_min_media_per_s", "require_whisper_costs",
}
# The cluster runner has no DeviceTimeline (the k-means engine records
# cost/efficiency, not occupancy), so the occupancy keys are REMOVED
# rather than inherited: accepting a key the runner never evaluates
# would violate the 'every gate key is read' contract this validator
# exists to enforce.
_GATE_KEYS_CLUSTER = (_GATE_KEYS_SHARED - {
    "min_device_busy_fraction", "min_overlap_fraction",
    "max_bubble_share"}) | {
    # The embedding→assignment ledger + centroid-model envelope
    # (`run_cluster_scenario`).
    "min_clusters_nonempty", "max_inertia_growth", "require_cluster_costs",
    "goodput_min_vectors_per_s", "require_resume", "min_timeseries_series",
}


_SCALE_DIRECTIONS = ("up", "down")
_SCALE_PHASES = ("fault", "recovery", "any")


def _lockwitness_begin(gate_cfg: Dict[str, Any]) -> Optional[int]:
    """Witness-on-chaos-run seam.  ``forbid_lock_cycles``
    turns the runtime lock-order witness on for this run — installing
    the creation-site interposition if the process hasn't already (every
    lock the scenario's workers/orchestrator/bus create from here on is
    graphed) — and snapshots the cycle count so the verdict judges only
    cycles witnessed DURING the scenario.  Returns that snapshot, or
    None when the key is absent (zero overhead: nothing is patched)."""
    if not gate_cfg.get("forbid_lock_cycles"):
        return None
    from ..utils import lockwitness
    lockwitness.install()
    return lockwitness.WITNESS.cycle_count()


def _lockwitness_checks(check, cycles_before: Optional[int]
                        ) -> Optional[Dict[str, Any]]:
    """Verdict half of the witness seam: the ``lock_cycles`` gate key
    plus the summary block for the verdict JSON.  No-op (returns None)
    when _lockwitness_begin declined to arm."""
    if cycles_before is None:
        return None
    from ..utils import lockwitness
    rep = lockwitness.WITNESS.report()
    new_cycles = int(rep["cycle_count"]) - cycles_before
    check("lock_cycles", new_cycles == 0, new_cycles,
          "0 new lock-order cycles (lockwitness)")
    out_path = os.environ.get("CRAWLINT_LOCKWITNESS_OUT", "")
    if out_path:
        # Full witness dump (stacks included) for
        # `tools/analyze --lock-report`; the verdict keeps the summary.
        lockwitness.WITNESS.dump(out_path)
    return {
        "new_cycles": new_cycles,
        "cycles": rep["cycle_count"],
        "cycle_sites": [c["sites"] for c in rep["cycles"]],
        "instrumented_sites": rep["instrumented_sites"],
        "acquisitions": rep["acquisitions"],
        "edges": rep["edge_count"],
        "blocking_under_lock": rep["blocking_count"],
        "hold_budget_breaches": rep["breach_count"],
    }


def validate_gate_config(scenario: Dict[str, Any]) -> None:
    """Reject unknown gate keys (and, transitively, malformed "alerts" /
    "autoscaler" blocks and scale-event specs) at config time.  Called
    by both runners and by the entry point's ``--smoke`` over every
    checked-in scenario."""
    name = scenario.get("name", "?")
    gate_cfg = scenario.get("gate", {}) or {}
    kind = scenario.get("kind")
    known = _GATE_KEYS_ASR if kind == "asr" \
        else _GATE_KEYS_CLUSTER if kind == "cluster" \
        else _GATE_KEYS_TEXT
    unknown = set(gate_cfg) - known
    if unknown:
        raise ValueError(
            f"scenario {name!r}: unknown gate "
            f"key(s) {', '.join(sorted(unknown))}")
    # Value-shape checks for the structured elastic-fleet keys: a typo'd
    # "during" phase would otherwise silently widen the assertion to
    # "any" — the exact silent-no-op failure mode key validation exists
    # to prevent.
    for spec in gate_cfg.get("require_scale_event", []):
        if isinstance(spec, str):
            if spec not in _SCALE_DIRECTIONS:
                raise ValueError(
                    f"scenario {name!r}: require_scale_event entry "
                    f"{spec!r} must be one of {_SCALE_DIRECTIONS}")
            continue
        if not isinstance(spec, dict):
            raise ValueError(
                f"scenario {name!r}: require_scale_event entries must "
                f"be 'up'/'down' or objects, got {spec!r}")
        bad = set(spec) - {"pool", "direction", "during"}
        if bad:
            raise ValueError(
                f"scenario {name!r}: unknown require_scale_event "
                f"key(s) {', '.join(sorted(bad))}")
        if spec.get("direction", "up") not in _SCALE_DIRECTIONS:
            raise ValueError(
                f"scenario {name!r}: require_scale_event direction "
                f"must be one of {_SCALE_DIRECTIONS}")
        if spec.get("during", "any") not in _SCALE_PHASES:
            raise ValueError(
                f"scenario {name!r}: require_scale_event during must "
                f"be one of {_SCALE_PHASES}")
    window = gate_cfg.get("fault_window")
    if window is not None:
        if (not isinstance(window, (list, tuple)) or len(window) != 2
                or not all(isinstance(v, (int, float)) for v in window)
                or float(window[1]) <= float(window[0])):
            raise ValueError(
                f"scenario {name!r}: gate fault_window must be "
                f"[start_s, end_s] with end > start, got {window!r}")
    # Partitioned control plane (`bus/partition.py`): a "bus_shards"
    # block runs N broker shards behind a PartitionedBus.  Unknown keys
    # are rejected — in particular there is deliberately NO way to name
    # a (shared) spool directory here: per-shard spool + outbox dirs are
    # always derived distinct (one shared WAL across shards would
    # cross-contaminate crash recovery, the loud-validation rule).
    shards_cfg = scenario.get("bus_shards") or {}
    if shards_cfg:
        if kind in ("asr", "cluster"):
            raise ValueError(
                f"scenario {name!r}: \"bus_shards\" blocks are not "
                f"supported on kind={kind} scenarios (only the text gate "
                f"has partitioned-bus wiring)")
        bad = set(shards_cfg) - {"count", "replicas"}
        if bad:
            raise ValueError(
                f"scenario {name!r}: unknown bus_shards key(s) "
                f"{', '.join(sorted(bad))} (per-shard spool/outbox dirs "
                f"are always derived — they cannot be shared)")
        count = int(shards_cfg.get("count", 0))
        if not 2 <= count <= 16:
            raise ValueError(
                f"scenario {name!r}: bus_shards.count must be 2..16, "
                f"got {shards_cfg.get('count')!r}")
        if scenario.get("bus") != "grpc":
            raise ValueError(
                f"scenario {name!r}: a bus_shards block needs "
                f"bus='grpc' (each shard is its own GrpcBusServer)")
    else:
        for key in ("max_shard_skew", "bus_shard_generations"):
            if key in gate_cfg:
                raise ValueError(
                    f"scenario {name!r}: gate key {key!r} needs a "
                    f"\"bus_shards\" block (it would otherwise be a "
                    f"silent no-op)")
    if gate_cfg.get("bus_shard_generations") is not None:
        from ..bus.partition import default_shard_ids

        gens = gate_cfg["bus_shard_generations"]
        count = int(shards_cfg.get("count", 0))
        expected_ids = set(default_shard_ids(count))
        if not isinstance(gens, dict) or set(gens) != expected_ids \
                or not all(isinstance(v, int) and v >= 1
                           for v in gens.values()):
            raise ValueError(
                f"scenario {name!r}: bus_shard_generations must map "
                f"EVERY shard id ({', '.join(sorted(expected_ids))}) to "
                f"an int generation >= 1, got {gens!r}")
    # Tenant attribution: the "load.tenants" traffic mix, the
    # "tenant_budgets" block, and the tenant gate keys all validate
    # loudly here — a typo'd tenant name would otherwise assert against
    # a workload that never existed.
    load_block = scenario.get("load", {}) or {}
    tenant_mix = load_block.get("tenants") or {}
    if tenant_mix:
        if not isinstance(tenant_mix, dict):
            raise ValueError(
                f"scenario {name!r}: load.tenants must be a mapping of "
                f"tenant name -> positive weight, got {tenant_mix!r}")
        for t, w in tenant_mix.items():
            if not isinstance(t, str) or not t.strip():
                raise ValueError(
                    f"scenario {name!r}: load.tenants has a non-string/"
                    f"empty tenant name: {t!r}")
            if not isinstance(w, (int, float)) or isinstance(w, bool) \
                    or float(w) <= 0:
                raise ValueError(
                    f"scenario {name!r}: load.tenants[{t!r}] must be a "
                    f"positive weight, got {w!r}")
    from ..bus.messages import DEFAULT_TENANT
    from ..orchestrator.tenants import budgets_from_config

    try:
        budgets_from_config(scenario.get("tenant_budgets"))
    except ValueError as e:
        raise ValueError(f"scenario {name!r}: {e}")
    known_tenants = set(tenant_mix) | {DEFAULT_TENANT}
    req_tenants = gate_cfg.get("require_tenants", [])
    if not isinstance(req_tenants, (list, tuple)):
        raise ValueError(
            f"scenario {name!r}: gate require_tenants must be a list of "
            f"tenant names, got {req_tenants!r}")
    for key in ("require_tenants", "require_tenant_breach",
                "forbid_tenant_breach"):
        if key in gate_cfg and not tenant_mix:
            raise ValueError(
                f"scenario {name!r}: gate key {key!r} needs a "
                f"\"load.tenants\" traffic mix (it would otherwise "
                f"assert against tenants no workload carries)")
    for t in req_tenants:
        if t not in known_tenants:
            raise ValueError(
                f"scenario {name!r}: require_tenants names {t!r}, which "
                f"is not in load.tenants ({sorted(known_tenants)})")
    for key in ("require_tenant_breach", "forbid_tenant_breach"):
        spec = gate_cfg.get(key)
        if spec is None:
            continue
        if not isinstance(spec, dict):
            raise ValueError(
                f"scenario {name!r}: gate {key} must be a mapping of "
                f"tenant -> [slo, ...], got {spec!r}")
        for t, slos in spec.items():
            if t not in known_tenants:
                raise ValueError(
                    f"scenario {name!r}: {key} names tenant {t!r}, which "
                    f"is not in load.tenants ({sorted(known_tenants)})")
            if not isinstance(slos, (list, tuple)) or not slos \
                    or not all(isinstance(s, str) and s for s in slos):
                raise ValueError(
                    f"scenario {name!r}: {key}[{t!r}] must be a "
                    f"non-empty list of SLO names, got {slos!r}")
    share_cap = gate_cfg.get("max_unattributed_share")
    if share_cap is not None and (
            not isinstance(share_cap, (int, float))
            or isinstance(share_cap, bool)
            or not 0 <= float(share_cap) <= 1):
        raise ValueError(
            f"scenario {name!r}: gate max_unattributed_share must be a "
            f"number in [0, 1], got {share_cap!r}")
    conserve = gate_cfg.get("require_tenant_conservation")
    if conserve is not None and conserve is not True and (
            not isinstance(conserve, (int, float))
            or isinstance(conserve, bool) or not 0 < float(conserve) <= 1):
        raise ValueError(
            f"scenario {name!r}: gate require_tenant_conservation must "
            f"be true or a relative tolerance in (0, 1], got {conserve!r}")
    # The blocks the gate consumes alongside the envelope: parse them
    # through their own loud validators.
    rules_from_config(scenario.get("alerts"))
    autoscaler_cfg = scenario.get("autoscaler") or {}
    if autoscaler_cfg:
        from ..orchestrator.autoscaler import pools_from_config

        if scenario.get("kind") in ("asr", "cluster"):
            # Accept-and-ignore would break the loud-validation rule:
            # only the text runner has elastic-fleet wiring.
            raise ValueError(
                f"scenario {name!r}: \"autoscaler\" blocks are not "
                f"supported on kind={scenario['kind']} scenarios (only "
                f"the text gate has elastic-fleet wiring)")
        extra = set(autoscaler_cfg) - {"pools", "eval_interval_s"}
        if extra:
            raise ValueError(
                f"scenario {name!r}: unknown "
                f"autoscaler key(s) {', '.join(sorted(extra))}")
        pools = pools_from_config(autoscaler_cfg.get("pools"))
        if not pools:
            raise ValueError(
                f"scenario {name!r}: an "
                f"\"autoscaler\" block needs a non-empty pools list")
    if kind == "cluster":
        # The loud half of the publish_embeddings satellite: a cluster
        # scenario whose TPU worker strips embeddings from the result
        # stream (or the writeback the ledger reconciles) would starve
        # the clustering stage silently — reject at config time.
        worker_cfg = scenario.get("worker", {}) or {}
        if worker_cfg.get("publish_embeddings") is False:
            raise ValueError(
                f"scenario {name!r}: clustering is enabled but the "
                f"worker block sets publish_embeddings=false — the "
                f"cluster worker consumes embedding-carrying result "
                f"batches on TOPIC_INFERENCE_RESULTS")
        if worker_cfg.get("write_embeddings") is False:
            raise ValueError(
                f"scenario {name!r}: cluster scenarios need "
                f"write_embeddings=true — the embedding→assignment "
                f"ledger reconciles the inference writeback against the "
                f"assignment writeback")


def scenario_names() -> List[str]:
    """Checked-in scenario names (without .json)."""
    if not os.path.isdir(SCENARIO_DIR):
        return []
    return sorted(f[:-5] for f in os.listdir(SCENARIO_DIR)
                  if f.endswith(".json"))


def load_scenario(name_or_path: str) -> Dict[str, Any]:
    """Resolve a scenario by checked-in name or filesystem path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(SCENARIO_DIR, f"{name_or_path}.json")
    if not os.path.exists(path):
        raise ValueError(
            f"unknown scenario {name_or_path!r}; checked-in scenarios: "
            f"{', '.join(scenario_names()) or '(none)'}")
    with open(path, "r", encoding="utf-8") as f:
        scenario = json.load(f)
    scenario.setdefault("name", os.path.basename(path)[:-5])
    return scenario


def merge_overrides(scenario: Dict[str, Any],
                    overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Deep-merge ``overrides`` into a copy of ``scenario`` (dicts merge
    recursively, everything else replaces)."""
    out = json.loads(json.dumps(scenario))  # deep copy, JSON-safe

    def _merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                _merge(dst[k], v)
            else:
                dst[k] = v

    if overrides:
        _merge(out, overrides)
    return out


def _p95_ms(spans, names, since_wall: float) -> Optional[float]:
    vals = sorted(s.duration_s * 1000.0 for s in spans
                  if s.name in names
                  and (s.start_wall + s.duration_s) >= since_wall)
    if not vals:
        return None
    n = len(vals)
    return vals[min(n - 1, max(0, math.ceil(0.95 * n) - 1))]


def _breach_counts(registry) -> Dict[str, float]:
    """slo_breach_total children by label value, from the run registry.

    Exact label-set match: tenant-labeled children ({slo, tenant}) live
    on the same counter family and must not clobber the aggregate
    per-SLO parents here."""
    counter = registry.counter("slo_breach_total")
    out: Dict[str, float] = {}
    for labels, value in counter.series():
        if set(labels) == {"slo"}:
            out[labels["slo"]] = value
    return out


def _tenant_breach_counts(registry) -> Dict[str, float]:
    """Per-tenant slo_breach_total children, keyed ``"{tenant}:{slo}"``."""
    counter = registry.counter("slo_breach_total")
    out: Dict[str, float] = {}
    for labels, value in counter.series():
        if set(labels) == {"slo", "tenant"}:
            out[f"{labels['tenant']}:{labels['slo']}"] = value
    return out


def _delta(after: Dict[str, float],
           before: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0)
            for k, v in after.items() if v - before.get(k, 0.0) > 0}


def _occupancy_checks(check, gate_cfg: Dict[str, Any],
                      costs_body: Optional[Dict[str, Any]]
                      ) -> Dict[str, Any]:
    """Device-occupancy envelope over the /costs ``occupancy`` map
    (`utils/occupancy.py`): busy-fraction floor, host/device-overlap
    floor, bubble-share cap — the regression surface the upcoming
    continuous-batching feed will be judged against."""
    occ = (costs_body or {}).get("occupancy") or {}
    if gate_cfg.get("min_device_busy_fraction") is not None:
        floor = float(gate_cfg["min_device_busy_fraction"])
        val = occ.get("busy_fraction")
        check("device_busy_fraction", val is not None and val >= floor,
              val, f">= {floor}")
    if gate_cfg.get("min_overlap_fraction") is not None:
        floor = float(gate_cfg["min_overlap_fraction"])
        val = occ.get("overlap_fraction")
        check("overlap_fraction", val is not None and val >= floor,
              val, f">= {floor}")
    if gate_cfg.get("max_bubble_share") is not None:
        cap = float(gate_cfg["max_bubble_share"])
        val = occ.get("bubble_share")
        check("bubble_share", val is not None and val <= cap,
              val, f"<= {cap}")
    return occ


def _per_chip_checks(check, gate_cfg: Dict[str, Any],
                     costs_body: Optional[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Per-chip efficiency envelope over the /costs ``efficiency.per_chip``
    rows (`utils/costmodel.EfficiencyMeter`): every mesh device must be
    present, and every device's goodput must clear the floor — the check
    that forbids per-chip collapse (a feed whose padded rows starve the
    high data shards, or a mesh that silently fell back to one device,
    fails here while aggregate goodput still looks fine)."""
    eff = (costs_body or {}).get("efficiency") or {}
    per_chip = eff.get("per_chip") or []
    if gate_cfg.get("require_per_chip_devices") is not None:
        need = int(gate_cfg["require_per_chip_devices"])
        check("per_chip_devices", len(per_chip) >= need, len(per_chip),
              f">= {need} per-chip efficiency rows")
    if gate_cfg.get("min_per_chip_goodput_tokens_per_s") is not None:
        floor = float(gate_cfg["min_per_chip_goodput_tokens_per_s"])
        worst = min((c.get("goodput_tokens_per_s") or 0.0
                     for c in per_chip), default=0.0)
        check("per_chip_goodput_tokens_per_s",
              bool(per_chip) and worst >= floor, round(worst, 2),
              f">= {floor} on EVERY chip")
    return per_chip


def _dtrace_checks(check, gate_cfg: Dict[str, Any],
                   dtraces_body: Optional[Dict[str, Any]]
                   ) -> Dict[str, Any]:
    """Distributed-trace envelope over the /dtraces body: at least one
    assembled trace spanning enough processes, and every exporting
    worker's estimated clock offset inside tolerance."""
    body = dtraces_body or {}
    traces = body.get("traces") or []
    multi = sum(1 for t in traces if len(t.get("processes") or []) >= 2)
    if gate_cfg.get("min_dtrace_processes") is not None:
        need = int(gate_cfg["min_dtrace_processes"])
        best = max((len(t.get("processes") or []) for t in traces),
                   default=0)
        check("dtrace_processes", best >= need, best,
              f">= {need} processes in one assembled trace")
    if gate_cfg.get("max_clock_skew_ms") is not None:
        cap = float(gate_cfg["max_clock_skew_ms"])
        offsets = [abs(float(st.get("applied_offset_s") or 0.0)) * 1000.0
                   for st in (body.get("workers") or {}).values()]
        worst = max(offsets, default=0.0)
        check("clock_skew_ms", worst <= cap, round(worst, 3), f"<= {cap}")
    return {"assembled": len(traces), "multi_process": multi}


def _autoscaler_checks(check, gate_cfg: Dict[str, Any],
                       snapshot: Optional[Dict[str, Any]],
                       decisions: List[Dict[str, Any]],
                       fleet_size_0: int,
                       fault_wall: "tuple[float, float]",
                       converge_s: Optional[float]) -> Dict[str, Any]:
    """The elastic-fleet envelope over the /autoscaler body + the
    decision log (`orchestrator/autoscaler.py`):

    - ``require_scale_event``: each entry — ``"up"``/``"down"`` or
      ``{"pool":..., "direction":..., "during": "fault"|"recovery"|
      "any"}`` — must match at least one recorded decision (``fault`` =
      wall-stamped inside the load+chaos window, ``recovery`` = after);
    - ``max_scale_events``: total decision cap (0 pins the autoscaler
      QUIET — the steady-state assertion);
    - ``min_fleet_size`` / ``max_fleet_size``: bounds on the actual
      worker count over the run, from the decision log's
      actual_before/after, the start/end sizes, AND the autoscaler's
      per-tick ``autoscaler_actual_workers`` samples in the rolling
      store (which also see dips a chaos kill causes between
      decisions);
    - ``forbid_scale_down_in_fault``: no down decision inside the fault
      window (a fleet must never shrink INTO a breach);
    - ``max_time_to_converge_s``: first scale-up decision → pools back
      at their floor with zero alerts firing.

    The fault window defaults to the whole load+chaos phase; a
    ``fault_window: [start_s, end_s]`` gate key (offsets from load
    start) narrows it to the actual surge/wedge — without it, a
    flash-crowd whose spike subsides mid-phase would see its perfectly
    legitimate post-spike scale-down land "in fault" on a slow host.
    """
    body = snapshot or {}
    pools = body.get("pools") or {}
    fault_t0, fault_t1 = fault_wall
    declared = gate_cfg.get("fault_window")
    if declared:
        start_s, end_s = float(declared[0]), float(declared[1])
        if end_s <= start_s:
            raise ValueError("gate fault_window must be [start_s, end_s] "
                             "with end > start")
        fault_t0, fault_t1 = fault_t0 + start_s, fault_wall[0] + end_s

    def _during(d: Dict[str, Any], phase: str) -> bool:
        if phase == "fault":
            return fault_t0 <= d["at"] <= fault_t1
        if phase == "recovery":
            return d["at"] > fault_t1
        return True

    for spec in gate_cfg.get("require_scale_event", []):
        if isinstance(spec, str):
            spec = {"direction": spec}
        direction = spec.get("direction", "up")
        pool = spec.get("pool")
        during = spec.get("during", "any")
        matches = [d for d in decisions
                   if d["direction"] == direction
                   and (pool is None or d["pool"] == pool)
                   and _during(d, during)]
        check(f"scale_event_{pool or 'any'}_{direction}_{during}",
              bool(matches), len(matches),
              f">= 1 {direction} decision ({during} window)")
    if gate_cfg.get("max_scale_events") is not None:
        cap = int(gate_cfg["max_scale_events"])
        check("scale_events", len(decisions) <= cap, len(decisions),
              f"<= {cap} decisions")
    sizes = [fleet_size_0]
    for d in decisions:
        sizes.append(int(d.get("actual_before", fleet_size_0)))
        if d.get("actual_after") is not None:
            sizes.append(int(d["actual_after"]))
    sizes.extend(int(p.get("actual", 0)) for p in pools.values())
    # Per-tick actual-size samples (the autoscaler writes them into the
    # run's rolling store every accepted tick): these see a chaos kill's
    # dip even when no decision brackets it.  Pool-labeled children
    # only — the registry self-sample also mirrors the bare gauge
    # PARENT (value 0, no children yet) into the store, which is not a
    # fleet size.
    sizes.extend(
        int(v) for labels, samples in
        timeseries.STORE.matching("autoscaler_actual_workers")
        if labels.get("pool") for _, v in samples)
    if gate_cfg.get("min_fleet_size") is not None:
        floor = int(gate_cfg["min_fleet_size"])
        check("min_fleet_size", min(sizes) >= floor, min(sizes),
              f">= {floor} workers at all times")
    if gate_cfg.get("max_fleet_size") is not None:
        cap = int(gate_cfg["max_fleet_size"])
        check("max_fleet_size", max(sizes) <= cap, max(sizes),
              f"<= {cap} workers at all times")
    if gate_cfg.get("forbid_scale_down_in_fault"):
        downs = [d for d in decisions if d["direction"] == "down"
                 and _during(d, "fault")]
        check("no_scale_down_in_fault", not downs, len(downs),
              "0 down decisions inside the fault window")
    if gate_cfg.get("max_time_to_converge_s") is not None:
        budget = float(gate_cfg["max_time_to_converge_s"])
        check("time_to_converge_s",
              converge_s is not None and converge_s <= budget,
              round(converge_s, 2) if converge_s is not None
              else "never",
              f"<= {budget}s from first scale-up to floor+quiet")
    return {
        "decisions": len(decisions),
        "fleet_sizes": {"min": min(sizes), "max": max(sizes),
                        "final": sizes[-1] if sizes else 0},
        "converge_s": round(converge_s, 2)
        if converge_s is not None else None,
        "pools": {name: {k: p.get(k)
                         for k in ("desired", "actual", "min", "max")}
                  for name, p in pools.items()},
    }


class BusHandle:
    """The chaos controller's view of the broker itself (``down bus``):
    kill / restart with process-death semantics.  ``kill`` hard-stops the
    live `GrpcBusServer` and drops ALL its RAM state (queues, in-flight
    ledgers, local dispatch); ``restart`` builds a FRESH server over the
    SAME spool directory and the SAME bound port, so the clients that
    already hold the address reconnect and recovery comes from the WAL
    spool alone (`bus/spool.py`).  Local subscriptions and pull-topic
    registrations are replayed onto each generation, the way a restarted
    broker host re-registers its in-process consumers at boot.

    The handle doubles as the host-side bus facade: ``publish`` raises
    while the broker is down (exactly what a durable publisher's outbox
    expects — it buffers and retries), and the read-side helpers
    (``pending_count``/``drain``/``flush_local``) answer for the live
    generation or degrade gracefully."""

    def __init__(self, make_server):
        self._make = make_server   # (address | None) -> un-started server
        self.server = None
        self.address: Optional[str] = None
        self.generation = 0
        self._subs: List[tuple] = []
        self._pull: List[str] = []

    def start(self) -> None:
        server = self._make(self.address)
        if self.address is not None and not server.bound_port:
            raise RuntimeError(
                f"bus restart could not rebind {self.address}")
        for topic in self._pull:
            server.enable_pull(topic)
        for topic, handler in self._subs:
            server.subscribe(topic, handler)
        server.start()
        self.address = f"127.0.0.1:{server.bound_port}"
        self.server = server
        self.generation += 1

    def kill(self) -> None:
        server, self.server = self.server, None
        if server is not None:
            server.kill()

    def restart(self) -> None:
        self.kill()  # no-op if the timeline already killed this generation
        self.start()

    # -- the bus facade ----------------------------------------------------
    def publish(self, topic: str, payload) -> None:
        server = self.server
        if server is None:
            raise RuntimeError("bus is down")
        server.publish(topic, payload)

    def subscribe(self, topic: str, handler) -> None:
        self._subs.append((topic, handler))
        server = self.server
        if server is not None:
            server.subscribe(topic, handler)

    def enable_pull(self, topic: str) -> None:
        if topic not in self._pull:
            self._pull.append(topic)
        server = self.server
        if server is not None:
            server.enable_pull(topic)

    def pending_count(self, topic: str) -> int:
        server = self.server
        return server.pending_count(topic) if server is not None else 0

    def flush_local(self, timeout_s: float = 5.0) -> bool:
        server = self.server
        return server.flush_local(timeout_s) if server is not None else True

    def drain(self, timeout_s: float = 30.0, poll_s: float = 0.2) -> bool:
        server = self.server
        if server is None:
            return True
        return server.drain(timeout_s=timeout_s, poll_s=poll_s)

    def dlq_snapshot(self, topic=None, id=None):
        server = self.server
        if server is None:
            return {"enabled": False, "topics": {}, "bus_down": True}
        return server.dlq_snapshot(topic=topic, id=id)

    def close(self) -> None:
        server = self.server
        if server is not None:
            server.close()


class OrchestratorHandle:
    """The chaos controller's view of the coordinator itself: ``kill`` /
    ``restart`` with process-death semantics.  Each generation is a FRESH
    `Orchestrator` over a FRESH state-manager instance (same storage
    root) plus the SAME journal directory — recovery must run from
    durable state (journal + persisted snapshot) alone, exactly like a
    restarted process.  The dead generation's in-process bus
    subscriptions become no-ops (`Orchestrator.kill`), the analog of a
    dead process's subscriptions vanishing with it."""

    def __init__(self, make_orch, seeds, drive: bool = True):
        self._make = make_orch
        self.seeds = list(seeds)
        self.drive = drive
        self.orch = None
        self.generation = 0

    def start(self) -> None:
        self.orch = self._make()
        self.orch.start(self.seeds, background=False)
        self.generation += 1

    def kill(self) -> None:
        o, self.orch = self.orch, None
        if o is not None:
            o.kill()

    def restart(self) -> None:
        # A standalone `restart orchestrator` line must not leave two
        # live generations double-handling the crawl: retire the old one
        # first (no-op if a kill already ran).
        self.kill()
        self.start()

    def tick(self) -> None:
        """One distribution pass on the live generation (no-op while the
        orchestrator is dead — the load keeps flowing without it).  The
        watchtower ticks EVEN on non-driving gates (no crawl leg means
        distribute_work never runs, but alert evaluation must still ride
        the gate loop — a fast burn window evaluated only at phase
        boundaries would slide past its own breach)."""
        o = self.orch
        if o is None:
            return
        self.watchtower_tick()
        if not self.drive or not o.is_running:
            return
        try:
            o.distribute_work()
        except Exception as e:
            logger.warning("orchestrator tick error: %s", e)

    def check_worker_health(self) -> None:
        o = self.orch
        if o is not None and o.is_running:
            o.check_worker_health()

    def get_cluster(self):
        o = self.orch
        if o is None:
            return {"workers": {}, "orchestrator": {"down": True}}
        return o.get_cluster()

    def get_dtraces(self, limit: int = 0):
        """The live generation's assembled distributed traces (a dead
        orchestrator's /dtraces is as gone as its process would be)."""
        o = self.orch
        if o is None:
            return {"traces": [], "workers": {}, "orchestrator_down": True}
        return o.get_dtraces(limit=limit)

    def get_alerts(self):
        """The live generation's /alerts body (a dead orchestrator's
        watchtower is as gone as its process would be)."""
        o = self.orch
        if o is None:
            return {"alerts": [], "firing": [], "log": [],
                    "orchestrator_down": True}
        return o.get_alerts()

    def get_tenants(self):
        """The live generation's /tenants body (a dead orchestrator's
        budget ledger is as gone as its process would be)."""
        o = self.orch
        if o is None:
            return {"tenants": {}, "totals": {}, "orchestrator_down": True}
        return o.get_tenants()

    def watchtower_tick(self, force: bool = False):
        """One watchtower pass on the live generation (no-op while
        dead)."""
        o = self.orch
        if o is None:
            return []
        try:
            return o.watchtower.tick(force=force)
        except Exception as e:
            logger.warning("watchtower tick error: %s", e)
            return []

    def all_pages(self) -> list:
        """Every page across every depth of the live generation's state
        manager (the orchestrator-side reconciliation read)."""
        o = self.orch
        if o is None:
            return []
        try:
            max_depth = o.sm.get_max_depth()
        except Exception as e:
            logger.warning("page reconciliation read failed: %s", e)
            return []
        pages = []
        for depth in range(max_depth + 1):
            try:
                pages.extend(o.sm.get_layer_by_depth(depth))
            except Exception as e:
                logger.warning("layer %d read failed: %s", depth, e)
        return pages

    def stop(self) -> None:
        o = self.orch
        if o is not None:
            o.stop()


class _ServingWorkerHandle:
    """The chaos controller's view of a serving worker (TPU text or
    ASR): kill / restart / stall, with the current live instance behind
    one name.  Each start gets a FRESH bus connection (gRPC: its own
    pull stream, so kill's stream teardown requeues un-acked frames
    server-side, exactly like a crashed process).

    ``kill`` is idempotent per generation, and ``restart`` retires the
    live generation FIRST (the OrchestratorHandle discipline): a bare
    `restart <worker>` timeline line must not leave two generations
    competing for frames.  The killed generation stays referenced until
    the next start so post-kill reads (drain, status) still resolve.
    """

    def __init__(self, name: str, make_bus, provider,
                 registry):
        self.name = name
        self._make_bus = make_bus
        self._provider = provider
        self._registry = registry
        self.worker = None
        self.bus = None
        self.generation = 0
        self._dead = True  # no live generation until start()

    @property
    def alive(self) -> bool:
        """Is there a live generation behind this handle — the liveness
        read the autoscaler's `InProcessSupervisor` counts
        (`supervisor.actual`)."""
        return not self._dead and self.worker is not None

    def _make_worker(self, bus):
        raise NotImplementedError

    def start(self) -> None:
        from ..utils.metrics import set_costs_provider, set_status_provider

        self.bus = self._make_bus()
        self.worker = self._make_worker(self.bus)
        self.worker.start()
        # The port's workers serve /status and /costs on their own
        # metrics port; the gate's one server reads the process-wide
        # providers, so the handle registers them (last start wins).
        set_status_provider(self.worker.get_status)
        set_costs_provider(self.worker.get_costs)
        self.generation += 1
        self._dead = False

    def kill(self) -> None:
        if self.worker is None or self._dead:
            return
        self._dead = True
        self.worker.kill()
        # SIGKILL fidelity: a durable outbox must NOT gracefully flush a
        # killed worker's buffered publishes — they stay in the outbox
        # WAL for the next generation to re-send (the reload path the
        # gate is supposed to exercise).
        outbox = getattr(self.bus, "outbox", None)
        if outbox is not None:
            outbox.close(drain_s=0.0)
        shard_outboxes = getattr(self.bus, "shard_outboxes", None)
        if callable(shard_outboxes):
            # Partitioned bus: same SIGKILL fidelity per shard outbox.
            for ob in shard_outboxes():
                ob.close(drain_s=0.0)
        close = getattr(self.bus, "close", None)
        if callable(close):
            close()  # gRPC: tear the pull stream; un-acked frames requeue

    def restart(self) -> None:
        self.kill()  # no-op if a kill already ran this generation
        self.start()

    def stall(self, seconds: float) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        # Unconditional, even for a killed generation: kill() leaves the
        # process-global status/costs providers registered on purpose
        # (a dead process's endpoints vanish, they don't deregister),
        # but the gate's teardown must not leak them into the next run
        # in this process — stop() clears them.
        if self.worker is not None:
            from ..utils.metrics import (
                clear_costs_provider,
                clear_status_provider,
            )

            self.worker.stop(timeout_s=5.0)
            clear_status_provider(self.worker.get_status)
            clear_costs_provider(self.worker.get_costs)
        close = getattr(self.bus, "close", None)
        if callable(close):
            try:
                close()
            except Exception as e:
                logger.warning("handle bus close error: %s", e)


class WorkerHandle(_ServingWorkerHandle):
    """`_ServingWorkerHandle` over the text `TPUWorker`; stall blocks
    the `ChaosEngine`'s device calls mid-step."""

    def __init__(self, name: str, make_bus, engine: ChaosEngine,
                 provider, worker_cfg_kw: Dict[str, Any], registry):
        from ..inference.worker import TPUWorkerConfig

        super().__init__(name, make_bus, provider, registry)
        self._engine = engine
        self._cfg = TPUWorkerConfig(worker_id=name, **worker_cfg_kw)

    def _make_worker(self, bus):
        from ..inference.worker import TPUWorker

        return TPUWorker(bus, self._engine, provider=self._provider,
                         cfg=self._cfg, registry=self._registry)

    def stall(self, seconds: float) -> None:
        self._engine.block_for(seconds)


class _SimNetworkHandle:
    """The chaos controller's view of the simulated Telegram backend:
    ``flood`` injects a burst of FLOOD_WAIT errors (with real
    ``retry_after_s`` hints) into the hot crawl methods, so an
    ``at=1s flood network 1s`` timeline line reproduces the crawler's
    defining failure mode: the resilience layer's server-directed backoff
    (`utils/resilience.py`) must ride it out with zero loss."""

    # FLOOD_WAITs injected per flood line: the history page reads take
    # the brunt (the per-page hot path), the chat resolve a glancing
    # hit.  Two queued history faults = one fetch exhausts its retry
    # budget (FETCH_ATTEMPTS, 2) and fails over to an orchestrator page
    # retry, and every retried call pays the proactive rate-limiter
    # wait again, which is why flood scenarios budget a generous
    # drain_timeout_s.
    BURST = (("GetChatHistory", 2), ("SearchPublicChat", 1))

    def __init__(self, net):
        self.net = net

    def flood(self, retry_after_s: float) -> None:
        seconds = max(1, int(round(retry_after_s)))
        for method, count in self.BURST:
            self.net.inject_flood_wait(method, seconds, count=count)
        flight.record("flood_wait_storm", retry_after_s=seconds,
                      methods=[m for m, _ in self.BURST])


def _teardown(label: str, fn) -> None:
    """Per-step teardown isolation for the gates' finally blocks: one
    failing close (e.g. a killed worker's RemoteBus) must not leak the
    remaining servers/threads into the next run in this process — and
    must never mask the verdict."""
    try:
        fn()
    except Exception as e:
        logger.warning("loadgen teardown (%s) error: %s", label, e)


def _scrape(port: int, path: str, as_json: bool):
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5).read()
        return json.loads(body) if as_json else body.decode("utf-8")
    except Exception as e:
        logger.warning("scrape of %s failed: %s", path, e)
        return None


def _written_uids(provider, crawl_ids: List[str],
                  storage_prefix: str = "inference") -> Dict[str, int]:
    """post_uid -> occurrence count across every batch writeback file of
    the given crawl ids (the id-reconciliation read side)."""
    from ..inference.worker import iter_results

    counts: Dict[str, int] = {}
    for crawl_id in crawl_ids:
        for row in iter_results(provider, crawl_id, storage_prefix):
            uid = row.get("post_uid", "")
            if uid:
                counts[uid] = counts.get(uid, 0) + 1
    return counts


def _seed_sim_network(crawl_cfg: Dict[str, Any], seed: int):
    """A deterministic SimNetwork for the crawl leg: ``channels``
    channels of ``posts_per_channel`` Zipf-length messages (the
    reference's network for the same seed)."""
    import random as _random

    from ..clients import SimNetwork
    from ..clients.telegram import TLMessage

    rng = _random.Random(seed)
    net = SimNetwork()
    names = []
    for c in range(int(crawl_cfg.get("channels", 2))):
        name = f"loadchan{c}"
        msgs = []
        for i in range(int(crawl_cfg.get("posts_per_channel", 4))):
            u = max(1e-9, 1.0 - rng.random())
            words = max(1, min(80, int(u ** (-1.0 / 0.6))))
            msgs.append(TLMessage(
                content={"@type": "messageText",
                         "text": {"text": zipf_text(c * 100 + i, words),
                                  "entities": []}},
                date=1700000000 + i, view_count=rng.randrange(1000)))
        net.add_channel(name, messages=msgs, member_count=500)
        names.append(name)
    return net, names


def _refuse_unported(scenario: Dict[str, Any]) -> None:
    """The block whose code path the port does not have yet."""
    name = scenario.get("name", "?")
    if scenario.get("parallel"):
        raise NotImplementedError(
            f"scenario {name!r}: multi-device serving is not ported yet "
            f"(the \"parallel\" block builds a serving mesh)")


def _release_device(engines, device) -> None:
    """Teardown: unpark every wedged chaos proxy, then wait for the
    card's queued work, so no CUDA call of this run is still in flight
    when the next run (or its warm-up) starts."""
    for e in engines:
        release = getattr(e, "release", None)
        if callable(release):
            release()
    dev = getattr(device, "type", device)
    if dev == "cuda":
        import torch

        torch.cuda.synchronize()


def run_scenario(scenario: Dict[str, Any],
                 overrides: Optional[Dict[str, Any]] = None,
                 workload=None, device=None) -> Dict[str, Any]:
    """Run one scenario end-to-end in-process; returns the verdict dict.

    ``workload`` overrides the synthetic generator (replay mode passes a
    `ReplayWorkload` built by `generator.workload_from_bundle`).
    Raises only on setup/config errors; a run that finishes always
    returns a verdict (status "pass" or "fail" per the envelope).

    Scenarios with ``"kind": "asr"`` run the media/ASR serving stack
    instead of the text one (`run_asr_scenario`); ``"kind": "cluster"``
    runs the streaming clustering stack (`run_cluster_scenario`).
    ``device`` is where the engine runs: None (the card) or ``"cpu"``.
    """
    if scenario.get("kind") == "asr":
        if workload is not None:
            raise ValueError("--replay is not supported for ASR scenarios")
        return run_asr_scenario(scenario, overrides=overrides,
                                device=device)
    if scenario.get("kind") == "cluster":
        if workload is not None:
            raise ValueError(
                "--replay is not supported for cluster scenarios")
        return run_cluster_scenario(scenario, overrides=overrides,
                                    device=device)
    from ..bus.inmemory import InMemoryBus
    from ..bus.outbox import OutboxBus, OutboxConfig
    from ..config.crawler import CrawlerConfig
    from ..inference.engine import EngineConfig, InferenceEngine
    from ..orchestrator import CrawlJournal, Orchestrator
    from ..orchestrator.orchestrator import OrchestratorConfig
    from ..state import CompositeStateManager, StateConfig
    from ..state.providers import InMemoryStorageProvider
    from ..utils.metrics import (
        MetricsRegistry,
        clear_alerts_provider,
        clear_autoscaler_provider,
        clear_cluster_provider,
        clear_dlq_provider,
        clear_dtraces_provider,
        clear_shards_provider,
        clear_tenants_provider,
        serve_metrics,
        set_alerts_provider,
        set_autoscaler_provider,
        set_cluster_provider,
        set_costs_provider,
        set_dlq_provider,
        set_dtraces_provider,
        set_shards_provider,
        set_status_provider,
        set_tenants_provider,
    )
    from ..orchestrator.tenants import budgets_from_config

    scenario = merge_overrides(scenario, overrides)
    validate_gate_config(scenario)
    _refuse_unported(scenario)
    name = scenario.get("name", "unnamed")
    bus_kind = scenario.get("bus", "inmemory")
    if bus_kind not in ("inmemory", "grpc"):
        raise ValueError(f"scenario bus must be inmemory|grpc, "
                         f"got {bus_kind!r}")
    timeline = parse_timeline(scenario.get("chaos", []))
    if bus_kind != "grpc" and any(f.action in ("kill", "restart", "down")
                                  for f in timeline):
        raise ValueError(
            "kill/restart faults need bus='grpc' (the in-memory bus has "
            "no competing-consumer requeue, so a killed worker's frames "
            "would be lost by construction)")
    # Elastic-fleet block (`orchestrator/autoscaler.py`): the gate
    # supervises exactly ONE pool — the TPU worker stack under test.
    from ..orchestrator.autoscaler import (
        Autoscaler,
        InProcessSupervisor,
        pools_from_config,
    )

    autoscaler_cfg = scenario.get("autoscaler") or {}
    pool_policies = pools_from_config(autoscaler_cfg.get("pools"))
    if autoscaler_cfg and len(pool_policies) != 1:
        raise ValueError("the loadgen gate supervises exactly one "
                         "autoscaler pool (the TPU worker stack)")
    if pool_policies and pool_policies[0].max_workers > 1 \
            and bus_kind != "grpc":
        raise ValueError(
            "an autoscaler pool with max_workers > 1 needs bus='grpc' "
            "(the in-memory bus fans out — two workers would double-"
            "process every batch)")

    load_cfg = LoadGenConfig(**{k: v
                                for k, v in scenario.get("load", {}).items()
                                if k in _LOAD_KEYS})
    if workload is None:
        workload = SyntheticWorkload(load_cfg)
    worker_kw = {k: v for k, v in scenario.get("worker", {}).items()
                 if k in _WORKER_KEYS}
    worker_name = worker_kw.pop("worker_id", "tpu-1")
    gate_cfg = scenario.get("gate", {})
    witness_cycles0 = _lockwitness_begin(gate_cfg)
    drain_timeout_s = float(scenario.get("drain_timeout_s", 30.0))

    # Process-wide observability: the gate owns the span ring and the
    # flight ring for the duration of the run (the run IS the test).
    trace.configure(capacity=int(scenario.get("trace_buffer", 8192)))
    flight.configure(capacity=int(scenario.get("flight_buffer", 4096)))
    # Only events recorded by THIS run count toward require_flight (an
    # embedding process may carry unrelated history in the ring).  A
    # marker event — not a ring index — survives the bounded deque's
    # evictions: if even the marker was evicted, the ring rolled over
    # entirely within this run and every surviving event is ours.
    run_mark = f"run-{time.monotonic_ns()}"
    flight.record("loadgen_run_start", mark=run_mark)
    # The rolling time-series store is process-global (workers
    # self-sample into it, the watchtower folds into it): a previous
    # run's series inside the burn/trend windows would pre-fire this
    # run's alerts, so the gate owns the store like it owns the rings.
    timeseries.STORE.reset()
    registry = MetricsRegistry()

    t_run0 = time.monotonic()
    base_engine = InferenceEngine(
        EngineConfig(**scenario.get("engine", {"model": "tiny"})),
        registry=registry, device=device)
    # One launching thread at a time on the card (`ChaosEngine`); on the
    # CPU the fleet's forwards run in parallel, as the reference's do.
    device_lock = threading.Lock() \
        if base_engine.device.type == "cuda" else None
    engine = ChaosEngine(base_engine, device_lock=device_lock)
    chaos_engines = [engine]
    provider = InMemoryStorageProvider()
    tmpdir = tempfile.mkdtemp(prefix="dct-loadgen-")

    server = None
    inner_bus = None
    orch_handle = None
    crawl_worker = None
    pool_installed = False
    handle = None
    supervisor = None
    autoscaler = None
    autoscaler_provider = None
    http_server = None
    controller = None
    cluster_provider = None
    dtraces_provider = None
    alerts_provider = None
    tenants_provider = None
    dlq_provider = None
    local_outbox = None
    # Tenant budgets: parsed once, configured onto EVERY
    # orchestrator generation inside _make_orch — a kill/restart chaos
    # line rebuilds a fresh Orchestrator, and the budget ledger must
    # survive it the way a redeployed coordinator re-reads its config.
    tenant_budgets, budget_window_s = budgets_from_config(
        scenario.get("tenant_budgets"))
    # Bus durability (docs/operations.md "Bus durability & dead letters"):
    # a "bus_durability" block gives the broker a WAL spool and routes
    # every publisher (generator, orchestrator, worker) through a durable
    # outbox, which is what lets a `down bus` timeline line pass the
    # zero-loss envelope.
    durable_cfg = scenario.get("bus_durability") or {}
    durable = bool(durable_cfg) and bus_kind == "grpc"
    # Partitioned control plane (`bus/partition.py`): a "bus_shards"
    # block replaces the single broker with N GrpcBusServer shards
    # (chaos targets "bus-0".."bus-<n-1>") behind a PartitionedBus.
    shards_cfg = scenario.get("bus_shards") or {}
    n_shards = int(shards_cfg.get("count", 0)) if shards_cfg else 0
    sharded = n_shards > 1
    shards_provider = None

    def _is_bus_target(t: str) -> bool:
        return t == "bus" or (t.startswith("bus-") and t[4:].isdigit())

    if any(_is_bus_target(f.target)
           and f.action in ("kill", "restart", "down")
           for f in timeline) and not durable:
        # Without a spool + outboxes, the generator's first publish into
        # the dead broker raises and the run would report phantom "lost
        # items" instead of a clear config error.
        raise ValueError(
            "a kill/restart/down bus timeline line requires a "
            "\"bus_durability\" block (broker spool + publisher "
            "outboxes) on a grpc scenario")
    verdict: Dict[str, Any] = {"scenario": name, "bus": bus_kind,
                               "bus_durable": durable,
                               "bus_sharded": sharded}
    try:
        # --- bus fabric ---------------------------------------------------
        if bus_kind == "grpc":
            from ..bus.grpc_bus import GrpcBusServer, RemoteBus

            outbox_frames = int(durable_cfg.get("outbox_max_frames", 512))

            def _make_server_for(spool):
                def _make(bind_addr):
                    return GrpcBusServer(
                        bind_addr or "127.0.0.1:0", spool_dir=spool,
                        ack_timeout_s=float(
                            durable_cfg.get("ack_timeout_s", 300.0)),
                        max_attempts=int(
                            durable_cfg.get("max_attempts", 5)),
                        registry=registry)
                return _make

            if sharded:
                # Partitioned control plane: N broker shards, each a
                # stock GrpcBusServer behind its OWN BusHandle (chaos
                # target "bus-<i>") over its OWN spool dir — the broker's
                # kill/resume semantics apply per shard unchanged.  The
                # PartitionedBus routes pull frames by post_uid/work-
                # item key, broadcasts fan-out topics, and parks a dead
                # shard's frames in that shard's outbox (never a
                # re-hash).
                from ..bus import partition

                shard_ids = partition.default_shard_ids(n_shards)
                ring = partition.ShardMap(
                    shard_ids,
                    replicas=int(shards_cfg.get("replicas", 64)))
                spool_dirs = partition.shard_spool_dirs(
                    os.path.join(tmpdir, "bus-spool"), shard_ids) \
                    if durable else {sid: None for sid in shard_ids}
                shard_handles: Dict[str, BusHandle] = {}
                for sid in shard_ids:
                    h = BusHandle(_make_server_for(spool_dirs[sid]))
                    h.enable_pull(TOPIC_INFERENCE_BATCHES)
                    h.start()
                    shard_handles[sid] = h
                addresses = {sid: h.address
                             for sid, h in shard_handles.items()}

                def _shard_outbox_cfg(role: str):
                    # Per-shard spill WALs on durable runs (derived
                    # distinct, validated by the PartitionedBus);
                    # memory-only parking otherwise.
                    def _cfg(sid: str) -> OutboxConfig:
                        return OutboxConfig(
                            dir=os.path.join(tmpdir, "outbox", role, sid)
                            if durable else "",
                            max_frames=outbox_frames,
                            breaker_recovery_s=0.25)
                    return _cfg

                server = partition.PartitionedBus(
                    shard_handles, ring,
                    outbox=_shard_outbox_cfg("local"),
                    name="local", registry=registry)
                # Idempotent re-registration: the handles were pull-
                # enabled before construction (frames queue from the
                # first publish), but the PartitionedBus must also KNOW
                # the topic so /shards reports per-shard queue depths.
                server.enable_pull(TOPIC_INFERENCE_BATCHES)
                local_bus = server

                def _worker_pbus(wname: str):
                    # Each worker dials EVERY shard (competing consumer
                    # on each shard's queue) with its own per-shard
                    # outboxes — two workers sharing one spill WAL
                    # would corrupt each other's reload.
                    eps = {sid: RemoteBus(addresses[sid],
                                          registry=registry)
                           for sid in shard_ids}
                    return partition.PartitionedBus(
                        eps, ring,
                        outbox=_shard_outbox_cfg(f"worker-{wname}"),
                        name=f"worker-{wname}", registry=registry)

                make_worker_bus = lambda: _worker_pbus(  # noqa: E731
                    worker_name)
                make_worker_bus_for = _worker_pbus
                if durable:
                    dlq_provider = server.dlq_snapshot
                    set_dlq_provider(dlq_provider)
                shards_provider = server.snapshot
                set_shards_provider(shards_provider)
            else:
                spool_dir = os.path.join(tmpdir, "bus-spool") \
                    if durable else None
                server = BusHandle(_make_server_for(spool_dir))
                server.enable_pull(TOPIC_INFERENCE_BATCHES)
                server.start()
                addr = server.address
                if durable:
                    def _outbox_cfg(sub: str) -> OutboxConfig:
                        return OutboxConfig(
                            dir=os.path.join(tmpdir, "outbox", sub),
                            max_frames=outbox_frames,
                            breaker_recovery_s=0.25)

                    # Orchestrator + generator side: local publishes
                    # buffer through the outbox while the broker is
                    # down.
                    local_bus = OutboxBus(server, _outbox_cfg("local"),
                                          name="local",
                                          registry=registry,
                                          close_inner=False)
                    local_outbox = local_bus
                    worker_outbox = _outbox_cfg("worker")
                    make_worker_bus = lambda: RemoteBus(  # noqa: E731
                        addr, outbox=worker_outbox, registry=registry)
                    # Dynamic (autoscaler-spawned) workers each get
                    # their OWN outbox dir: two live workers sharing
                    # one spill WAL would corrupt each other's reload.
                    make_worker_bus_for = \
                        lambda wname: RemoteBus(  # noqa: E731
                            addr, outbox=_outbox_cfg(f"worker-{wname}"),
                            registry=registry)
                    dlq_provider = server.dlq_snapshot
                    set_dlq_provider(dlq_provider)
                else:
                    local_bus = server  # orchestrator + generator side
                    make_worker_bus = lambda: RemoteBus(addr)  # noqa: E731
                    make_worker_bus_for = \
                        lambda wname: RemoteBus(addr)  # noqa: E731
        else:
            inner_bus = InMemoryBus(sync=True)
            local_bus = inner_bus
            make_worker_bus = lambda: inner_bus  # noqa: E731
            make_worker_bus_for = lambda wname: inner_bus  # noqa: E731
        chaos_bus = ChaosBus(local_bus)
        # Register every fan-out topic this run publishes on: the worker's
        # result announcements and the controller's chaos announcements
        # would otherwise count as unrouted (`bus_dropped_no_route_total`
        # — the silent-drop fix), and the gate's own envelope asserts
        # that counter stays at zero.  (Reconciliation reads the
        # writeback sink, not these streams, so no-op sinks suffice.)
        local_bus.subscribe(TOPIC_INFERENCE_RESULTS, lambda payload: None)
        local_bus.subscribe(TOPIC_CHAOS, lambda payload: None)

        # --- orchestrator (fleet fold + /cluster; real code path) ---------
        def _sm(sub: str):
            return CompositeStateManager(StateConfig(
                crawl_id=scenario.get("crawl_id", "c1"),
                crawl_execution_id="e1",
                storage_root=os.path.join(tmpdir, sub)))

        crawl_leg = scenario.get("crawl")
        crawler_cfg = CrawlerConfig(
            crawl_id=scenario.get("crawl_id", "c1"), platform="telegram",
            skip_media_download=True, sampling_method="channel")
        seeds: List[str] = []
        if crawl_leg:
            from ..clients import SimTelegramClient
            from ..clients.pool import ConnectionPool
            from ..crawl import runner as crawl_runner

            net, seeds = _seed_sim_network(crawl_leg, load_cfg.seed)
            crawl_runner.shutdown_connection_pool()
            crawl_runner.init_connection_pool(ConnectionPool.for_testing(
                {"conn0": SimTelegramClient(net, conn_id="conn0")}))
            pool_installed = True
        # Watchtower rules: a scenario "alerts" block (a list of rule
        # dicts) REPLACES same-named defaults and keeps the rest of the
        # pack — chaos scenarios shrink the burn windows to their own
        # timescale.  The evaluation limiter drops to gate cadence.
        alert_rules = rules_from_config(scenario.get("alerts"))

        def _make_orch():
            # Fresh Orchestrator + fresh state-manager instance over the
            # SAME storage root and journal dir: a restart resumes from
            # durable state only (the kill-orchestrator closure).
            orch = Orchestrator(
                crawler_cfg.crawl_id, crawler_cfg, local_bus, _sm("orch"),
                ocfg=OrchestratorConfig(
                    worker_timeout_s=float(scenario.get("worker_timeout_s",
                                                        10.0)),
                    alert_eval_interval_s=float(
                        scenario.get("alert_eval_interval_s", 0.05))),
                journal=CrawlJournal(os.path.join(tmpdir, "orch-journal")),
                registry=registry, alert_rules=alert_rules)
            orch.watchtower.tenants.configure(budgets=tenant_budgets,
                                              window_s=budget_window_s)
            return orch

        # Without a crawl leg the orchestrator folds the fleet, runs the
        # watchtower and the tenant ledger, and distributes no work.
        orch_handle = OrchestratorHandle(_make_orch, seeds,
                                         drive=bool(crawl_leg))
        orch_handle.start()
        cluster_provider = orch_handle.get_cluster
        set_cluster_provider(cluster_provider)
        dtraces_provider = orch_handle.get_dtraces
        set_dtraces_provider(dtraces_provider)
        alerts_provider = orch_handle.get_alerts
        set_alerts_provider(alerts_provider)
        tenants_provider = orch_handle.get_tenants
        set_tenants_provider(tenants_provider)
        # Alert announcements are fan-out on TOPIC_ALERTS; collect them
        # so the envelope can assert the publish path works (and so the
        # topic is routed — the unrouted counter stays zero).
        alert_msgs: List[Dict[str, Any]] = []
        local_bus.subscribe(TOPIC_ALERTS,
                            lambda payload: alert_msgs.append(payload))

        if crawl_leg:
            from ..inference.bridge import InferenceBridge
            from ..worker import CrawlWorker, WorkerConfig

            bridge = InferenceBridge(
                _sm("crawl"), chaos_bus, crawl_id=crawler_cfg.crawl_id,
                batch_size=int(crawl_leg.get("batch_size", 4)),
                deadline_s=0.05)
            crawl_worker = CrawlWorker(
                "crawl-1", crawler_cfg, local_bus, bridge,
                wcfg=WorkerConfig(worker_id="crawl-1", heartbeat_s=0.5))
            crawl_worker.start()

        # --- TPU worker ----------------------------------------------------
        handle = WorkerHandle(worker_name, make_worker_bus, engine,
                              provider, worker_kw, registry)
        handle.start()
        handle.worker.warmup()  # compile outside the measured phases

        http_server = serve_metrics(0, registry)
        port = http_server.server_address[1]

        targets = {worker_name: handle, "orchestrator": orch_handle}
        if bus_kind == "grpc" and sharded:
            # `down bus-<i>` kills ONE shard's generation; restart
            # rebuilds it over the same spool dir + port while the other
            # shards keep flowing (the kill-broker-shard closure).
            targets.update(shard_handles)
        elif bus_kind == "grpc":
            # `down bus` / `kill bus` timeline lines hard-stop the broker
            # generation; restart rebuilds over the same spool dir + port.
            targets["bus"] = server
        if crawl_worker is not None:
            targets["crawl-1"] = crawl_worker
        if crawl_leg:
            # `flood network <retry_after>` lines reach the sim backend.
            targets["network"] = _SimNetworkHandle(net)
        controller = ChaosController(timeline, targets=targets,
                                     bus=chaos_bus, publish_bus=local_bus,
                                     dynamic_targets=bool(pool_policies))

        # --- elastic fleet (scenario "autoscaler" block) -------------------
        # The supervisor owns EVERY worker handle (the scenario-start one
        # included) so drains, SLO tick fan-out, chaos-target bookkeeping
        # and teardown see one fleet, fixed or elastic.
        pool_name = pool_policies[0].pool if pool_policies else "tpu"
        spawn_seq = [0]

        def _fleet_changed(pool: str, live_handles) -> None:
            # A retire clears the retired worker's /status + /costs
            # registrations; re-point the process-global seams at a
            # survivor so the verdict's endpoint scrapes stay live.
            if live_handles:
                w = live_handles[0].worker
                set_status_provider(w.get_status)
                set_costs_provider(w.get_costs)

        supervisor = InProcessSupervisor(
            drain_timeout_s=min(10.0, drain_timeout_s),
            on_change=_fleet_changed)

        def _spawn_worker():
            spawn_seq[0] += 1
            wname = f"{worker_name}-as{spawn_seq[0]}"
            # Each spawn gets its OWN chaos wrapper over the one warmed
            # engine: compiled programs are shared (no mid-run compiles)
            # but a `wedge tpu-1` brownout pins only tpu-1 — the spawned
            # workers stay healthy, the way a new host would.
            spawned_engine = ChaosEngine(base_engine,
                                         device_lock=device_lock)
            chaos_engines.append(spawned_engine)
            h = WorkerHandle(wname, lambda: make_worker_bus_for(wname),
                             spawned_engine, provider,
                             dict(worker_kw), registry)
            h.start()  # shares the warmed engine: no fresh compiles
            # The mid-run spawned worker is a first-class citizen: a
            # valid chaos target, and its heartbeats/writebacks join the
            # same fleet fold + reconciliation every fixed worker uses.
            controller.register_target(wname, h)
            return h

        supervisor.add_pool(pool_name, _spawn_worker)
        supervisor.attach(pool_name, handle)
        autoscaler = None
        if pool_policies:
            autoscaler = Autoscaler(
                supervisor, pool_policies, store=timeseries.STORE,
                registry=registry,
                eval_interval_s=float(
                    autoscaler_cfg.get("eval_interval_s", 0.1)),
                alerts_fn=orch_handle.get_alerts)
            # Exercise the remote-control-plane seam too: firing/resolved
            # AlertMessages on TOPIC_ALERTS reach observe_alert.
            autoscaler.attach_bus(local_bus)
            autoscaler_provider = autoscaler.snapshot
            set_autoscaler_provider(autoscaler_provider)

        def _fleet_tick(force: bool = False) -> None:
            if autoscaler is not None:
                autoscaler.tick(force=force)

        def _fleet_workers():
            workers = [h.worker for h in supervisor.live(pool_name)]
            # A chaos-killed fleet (no live handles) still reports the
            # primary so post-kill reads (drain returns, SLO ticks)
            # resolve the way the single-worker gate always did.
            return workers or ([handle.worker]
                               if handle.worker is not None else [])

        def _fleet_drain(timeout_s: float) -> bool:
            return all(w.drain(timeout_s=timeout_s)
                       for w in _fleet_workers())

        def _fleet_evaluate_slos() -> None:
            for w in _fleet_workers():
                w.evaluate_slos()

        # --- phase A: baseline (flush the SLO window) ----------------------
        _fleet_evaluate_slos()
        breaches_0 = _breach_counts(registry)
        tenant_breaches_0 = _tenant_breach_counts(registry)
        fleet_size_0 = supervisor.actual(pool_name)
        # Per-rule fired-count baseline: require_alert judges the DELTA
        # over the load+chaos phase, so an alert carried over from
        # another source can never pass the chaos assertion vacuously.
        alerts_0 = {a.get("rule"): a.get("fired_count", 0)
                    for a in orch_handle.get_alerts().get("alerts", [])}

        # --- phase B: load + chaos ----------------------------------------
        logger.info("loadgen %s: load phase starting (%s arrivals)",
                    name, load_cfg.arrival)
        t_b0 = time.monotonic()
        t_b0_wall = time.time()
        stop = threading.Event()
        stats_box: Dict[str, Any] = {}

        def _pending() -> int:
            n = 0
            for w in _fleet_workers():
                status = w.get_status()
                n += int(status.get("queue_depth", 0)) \
                    + int(status.get("inflight", 0))
            if server is not None:
                n += server.pending_count(TOPIC_INFERENCE_BATCHES)
            if local_outbox is not None:
                # Buffered-but-unflushed publishes are pending work too
                # (closed-loop arrivals must not overrun a down broker).
                n += local_outbox.outbox.depth()
            depth_fn = getattr(server, "outbox_depth", None)
            if callable(depth_fn):
                # Sharded: frames parked for a dead shard in its
                # per-shard outbox are pending work the brokers can't
                # see yet.
                n += depth_fn()
            return n

        def _flush_outboxes(timeout_s: float) -> None:
            """Drain every durable outbox before reading broker pending
            counts — a buffered publish is invisible to pending_count
            until the flusher lands it."""
            if local_outbox is not None:
                local_outbox.outbox.drain(timeout_s=timeout_s)
            drain_shards = getattr(server, "drain_outboxes", None)
            if callable(drain_shards):
                drain_shards(timeout_s)
            for h in supervisor.handles(pool_name):
                worker_bus_outbox = getattr(h.bus, "outbox", None)
                if worker_bus_outbox is not None:
                    worker_bus_outbox.drain(timeout_s=timeout_s)
                worker_drain = getattr(h.bus, "drain_outboxes", None)
                if callable(worker_drain):
                    worker_drain(timeout_s)

        def _gen():
            stats_box["stats"] = workload.run(
                chaos_bus, stop=stop, pending_fn=_pending)

        gen_thread = threading.Thread(target=_gen, daemon=True,
                                      name="dct-loadgen")
        controller.start()
        gen_thread.start()
        while gen_thread.is_alive():
            orch_handle.tick()
            _fleet_tick()
            time.sleep(0.02)
        gen_thread.join()
        # Let the timeline finish (e.g. a restart scheduled after the
        # last arrival) before draining; orchestrator ticks keep running
        # so a resumed generation can finish requeued work.
        deadline = time.monotonic() + drain_timeout_s
        while not controller.done() and time.monotonic() < deadline:
            orch_handle.tick()
            _fleet_tick()
            time.sleep(0.02)
        controller.stop()
        if crawl_leg:
            # Drive the (possibly restarted) orchestrator until the crawl
            # itself completes, resumed in-flight pages included.
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                orch_handle.tick()
                _fleet_tick()
                o = orch_handle.orch
                if o is not None and o.crawl_completed:
                    break
                time.sleep(0.02)
        _flush_outboxes(drain_timeout_s)
        if server is not None:
            server.drain(timeout_s=drain_timeout_s)
        drained = _fleet_drain(drain_timeout_s)
        _fleet_evaluate_slos()
        orch_handle.check_worker_health()
        breaches_fault = _delta(_breach_counts(registry), breaches_0)
        tenant_breaches_fault = _delta(_tenant_breach_counts(registry),
                                       tenant_breaches_0)
        # Close the fault window on the ALERT surface deterministically:
        # breach counts reach the watchtower on worker heartbeats, so
        # settle (bounded) until every require_alert rule has fired
        # rather than racing the last beat.
        require_alert = list(gate_cfg.get("require_alert", []))
        if require_alert:
            settle = time.monotonic() + min(5.0, drain_timeout_s)
            while time.monotonic() < settle:
                orch_handle.watchtower_tick(force=True)
                fired_now = {
                    a["rule"]
                    for a in orch_handle.get_alerts().get("alerts", [])
                    if a.get("fired_count", 0)
                    > alerts_0.get(a.get("rule"), 0)}
                if all(r in fired_now for r in require_alert):
                    break
                time.sleep(0.05)
        else:
            orch_handle.watchtower_tick(force=True)
        alerts_fault = orch_handle.get_alerts()
        t_b1 = time.monotonic()
        t_b1_wall = time.time()  # fault-window close on the WALL clock
        # (scale decisions are wall-stamped; the during="fault" checks
        # and forbid_scale_down_in_fault judge against this window)

        # --- phase C: recovery tail ---------------------------------------
        tail_cfg = scenario.get("tail", {})
        tail_n = int(tail_cfg.get("batches", 8))
        tail_gap = float(tail_cfg.get("gap_s", 0.05))
        tail_records = int(tail_cfg.get("records_per_batch",
                                        load_cfg.records_per_batch))
        t_tail_wall = time.time()
        breaches_mid = _breach_counts(registry)
        base = workload if hasattr(workload, "build_batch") else \
            SyntheticWorkload(load_cfg)
        for i in range(tail_n):
            pb = PlannedBatch(10_000 + i, None, tuple(
                PlannedRecord("telegram", 10)
                for _ in range(tail_records)))
            chaos_bus.publish(TOPIC_INFERENCE_BATCHES,
                              base.build_batch(pb).to_dict())
            time.sleep(tail_gap)
        _flush_outboxes(drain_timeout_s)
        if server is not None:
            server.drain(timeout_s=drain_timeout_s)
        tail_drained = _fleet_drain(drain_timeout_s)
        _fleet_evaluate_slos()
        breaches_tail = _delta(_breach_counts(registry), breaches_mid)
        # Alert recovery: chaos-fired alerts must RESOLVE once the fault
        # is gone — tick (bounded by max_firing_after_recovery_s) until
        # nothing is firing.  Burn-rate rules resolve when their slow
        # window slides past the last breach sample, so the budget is
        # part of the scenario's envelope, not a fudge factor.
        resolve_budget_s = float(
            gate_cfg.get("max_firing_after_recovery_s", 0.0))
        t_resolve0 = time.monotonic()
        orch_handle.watchtower_tick(force=True)
        while orch_handle.get_alerts().get("firing") and \
                time.monotonic() - t_resolve0 < resolve_budget_s:
            time.sleep(0.05)
            orch_handle.watchtower_tick(force=True)
            _fleet_tick(force=True)
        resolve_wait_s = time.monotonic() - t_resolve0
        # Fleet convergence: with an autoscaler in the loop the run is
        # not over until the pool has scaled BACK DOWN to its floor with
        # nothing firing — headroom must hold a full stabilization
        # window and each step pays its down-cooldown, so this settle is
        # part of the scenario's envelope (max_time_to_converge_s), not
        # slack.  Convergence time is measured from the FIRST scale-up
        # decision (wall clock, like the decisions themselves).
        converge_s = None
        if autoscaler is not None:
            first_up_wall = min(
                (d["at"] for d in autoscaler.decisions()
                 if d["direction"] == "up"), default=None)

            def _fleet_converged() -> bool:
                snap = autoscaler.snapshot()
                pools_ok = all(
                    p["actual"] == p["min"] and p["desired"] == p["min"]
                    for p in snap["pools"].values())
                return pools_ok \
                    and not orch_handle.get_alerts().get("firing")

            converge_budget_s = float(
                gate_cfg.get("max_time_to_converge_s", 0.0)) or 10.0
            t_converge0 = time.monotonic()
            while time.monotonic() - t_converge0 < converge_budget_s:
                orch_handle.watchtower_tick(force=True)
                _fleet_tick(force=True)
                if _fleet_converged():
                    break
                time.sleep(0.05)
            # Re-read AFTER the settle: a late-confirming alert can
            # produce its first scale-up inside the loop above, and that
            # decision must start the convergence clock — not be waved
            # through as "nothing ever scaled".
            first_up_wall = min(
                (d["at"] for d in autoscaler.decisions()
                 if d["direction"] == "up"), default=first_up_wall)
            if first_up_wall is None:
                converge_s = 0.0  # nothing ever scaled: trivially there
            elif _fleet_converged():
                converge_s = time.time() - first_up_wall
        t_end = time.monotonic()

        # --- measurement ---------------------------------------------------
        # Flush the span tail deterministically before reading /dtraces:
        # the workers' interval-driven exports may not have fired since
        # the last batch landed.
        for w in _fleet_workers():
            export_fn = getattr(w, "export_spans", None)
            if callable(export_fn):
                export_fn()
        spans = trace.TRACER.spans()
        tail_queue_p95 = _p95_ms(spans, QUEUE_WAIT_SPANS, t_tail_wall)
        tail_batch_p95 = _p95_ms(spans, BATCH_SPANS, t_tail_wall)
        tail_age_p95 = _p95_ms(spans, BATCH_AGE_SPANS, t_tail_wall)

        # Tenant-surface settle: per-tenant spend reaches the watchtower
        # on worker HEARTBEATS, so settle (bounded) until every tenant
        # the gate asserts on shows attributed chip-seconds on /tenants
        # rather than racing the last beat.
        require_tenants = list(gate_cfg.get("require_tenants", []))
        tenant_keys = set(require_tenants) \
            | set(gate_cfg.get("require_tenant_breach") or {}) \
            | set(gate_cfg.get("forbid_tenant_breach") or {})
        if tenant_keys:
            settle = time.monotonic() + min(5.0, drain_timeout_s)
            while time.monotonic() < settle:
                orch_handle.watchtower_tick(force=True)
                rows = orch_handle.get_tenants().get("tenants", {})
                if all(rows.get(t, {}).get("spend", {})
                       .get("chip_seconds", 0.0) > 0
                       for t in tenant_keys):
                    break
                time.sleep(0.05)

        endpoints = {
            "metrics": _scrape(port, "/metrics", as_json=False),
            "costs": _scrape(port, "/costs", as_json=True),
            "cluster": _scrape(port, "/cluster", as_json=True),
            "dtraces": _scrape(port, "/dtraces", as_json=True),
            "alerts": _scrape(port, "/alerts", as_json=True),
            "tenants": _scrape(port, "/tenants", as_json=True),
            "timeseries": _scrape(port, "/timeseries", as_json=True),
        }
        if durable:
            endpoints["dlq"] = _scrape(port, "/dlq", as_json=True)
        if sharded:
            endpoints["shards"] = _scrape(port, "/shards", as_json=True)
        if autoscaler is not None:
            endpoints["autoscaler"] = _scrape(port, "/autoscaler",
                                              as_json=True)

        expected = chaos_bus.expected_uids()
        crawl_ids = {load_cfg.crawl_id, crawler_cfg.crawl_id}
        wcfg = getattr(workload, "cfg", None)
        if wcfg is not None:
            # Replay workloads write back under THEIR crawl_id, not the
            # scenario's — reconcile over both or every replayed item
            # counts as lost.
            crawl_ids.add(wcfg.crawl_id)
        written = _written_uids(provider, sorted(crawl_ids))
        expected_set = set(expected)
        lost = [u for u in expected if u not in written]
        duplicates = [u for u, c in written.items() if c > 1]
        processed = sum(min(c, 1) for u, c in written.items()
                        if u in expected_set)
        active_s = max(1e-6, t_end - t_b0)
        goodput = processed / active_s

        # --- the envelope --------------------------------------------------
        checks: Dict[str, Dict[str, Any]] = {}

        def check(key: str, ok: bool, value, budget) -> None:
            checks[key] = {"ok": bool(ok), "value": value, "budget": budget}

        check("drained", drained and tail_drained,
              {"fault": drained, "tail": tail_drained}, True)
        check("lost", len(lost) <= int(gate_cfg.get("max_lost", 0)),
              len(lost), int(gate_cfg.get("max_lost", 0)))
        check("duplicates",
              len(duplicates) <= int(gate_cfg.get("max_duplicates", 0)),
              len(duplicates), int(gate_cfg.get("max_duplicates", 0)))
        for slo in gate_cfg.get("require_breach", []):
            check(f"breach_{slo}", breaches_fault.get(slo, 0) > 0,
                  breaches_fault.get(slo, 0), "> 0 during fault window")
        for slo in gate_cfg.get("forbid_tail_breach", []):
            check(f"tail_no_breach_{slo}",
                  breaches_tail.get(slo, 0) == 0,
                  breaches_tail.get(slo, 0), "0 in recovery tail")
        # Tenant-attribution envelope: the /tenants surface
        # must show each asserted tenant's spend, the unattributed share
        # must stay under its cap, per-tenant breach children must move
        # (or not) independently of the aggregates, and the per-tenant
        # ledger rows must CONSERVE — sum back to the fleet totals.
        tenants_body = endpoints.get("tenants") \
            if isinstance(endpoints.get("tenants"), dict) else {}
        tenant_rows = tenants_body.get("tenants", {})
        for t in require_tenants:
            spend = tenant_rows.get(t, {}).get("spend", {})
            check(f"tenant_visible_{t}",
                  spend.get("chip_seconds", 0.0) > 0,
                  spend.get("chip_seconds", 0.0),
                  "> 0 chip-seconds attributed")
        if gate_cfg.get("max_unattributed_share") is not None:
            cap = float(gate_cfg["max_unattributed_share"])
            share = tenants_body.get("unattributed_share")
            check("unattributed_share",
                  share is not None and float(share) <= cap + 1e-9,
                  share, cap)
        for t, slos in (gate_cfg.get("require_tenant_breach")
                        or {}).items():
            for slo in slos:
                n = tenant_breaches_fault.get(f"{t}:{slo}", 0)
                check(f"tenant_breach_{t}_{slo}", n > 0, n,
                      "> 0 during fault window")
        tenant_breaches_run = _delta(_tenant_breach_counts(registry),
                                     tenant_breaches_0)
        for t, slos in (gate_cfg.get("forbid_tenant_breach")
                        or {}).items():
            for slo in slos:
                n = tenant_breaches_run.get(f"{t}:{slo}", 0)
                check(f"tenant_no_breach_{t}_{slo}", n == 0, n,
                      "0 over the whole run")
        conserve_cfg = gate_cfg.get("require_tenant_conservation")
        if conserve_cfg:
            tol = 0.01 if conserve_cfg is True else float(conserve_cfg)
            costs_body = endpoints.get("costs") \
                if isinstance(endpoints.get("costs"), dict) else {}
            ledger = costs_body.get("tenants") or {}
            rows = ledger.get("rows", [])
            totals = ledger.get("totals", {})
            worst = 0.0
            for key in ("chip_seconds", "flops", "real_tokens"):
                total = float(totals.get(key, 0.0))
                if total <= 0:
                    continue
                attributed = sum(float(r.get(key, 0.0)) for r in rows)
                worst = max(worst, abs(attributed - total) / total)
            check("tenant_conservation", bool(rows) and worst <= tol,
                  round(worst, 6), tol)
        if gate_cfg.get("queue_wait_p95_ms") is not None:
            budget = float(gate_cfg["queue_wait_p95_ms"])
            check("tail_queue_wait_p95_ms",
                  tail_queue_p95 is not None and tail_queue_p95 <= budget,
                  round(tail_queue_p95, 2) if tail_queue_p95 is not None
                  else None, budget)
        if gate_cfg.get("batch_p95_ms") is not None:
            budget = float(gate_cfg["batch_p95_ms"])
            check("tail_batch_p95_ms",
                  tail_batch_p95 is not None and tail_batch_p95 <= budget,
                  round(tail_batch_p95, 2) if tail_batch_p95 is not None
                  else None, budget)
        if gate_cfg.get("goodput_min_posts_per_s") is not None:
            floor = float(gate_cfg["goodput_min_posts_per_s"])
            check("goodput_posts_per_s", goodput >= floor,
                  round(goodput, 2), f">= {floor}")
        orch_detail: Dict[str, Any] = {"generations": orch_handle.generation}
        if gate_cfg.get("orchestrator_reconcile"):
            from ..state.datamodels import (
                PAGE_FETCHED,
                PAGE_PROCESSING,
                PAGE_UNFETCHED,
            )

            o = orch_handle.orch
            all_pages = orch_handle.all_pages()
            by_status: Dict[str, int] = {}
            for p in all_pages:
                by_status[p.status] = by_status.get(p.status, 0) + 1
            # Lost = pages whose work vanished (never reached a terminal
            # state); duplicated = success results applied more than once
            # for one page (completed_items would outrun fetched pages —
            # the idempotence set must keep them equal across restarts).
            stuck = [p.url for p in all_pages
                     if p.status in (PAGE_UNFETCHED, PAGE_PROCESSING)]
            fetched = by_status.get(PAGE_FETCHED, 0)
            completed = o.completed_items if o is not None else -1
            check("orch_crawl_completed",
                  o is not None and o.crawl_completed,
                  bool(o is not None and o.crawl_completed), True)
            check("orch_pages_lost", not stuck, len(stuck), 0)
            check("orch_result_duplicates", completed == fetched,
                  {"completed_items": completed, "fetched_pages": fetched},
                  "completed_items == fetched pages")
            orch_detail.update({
                "resumed": bool(o is not None and o.resumed),
                "pages_by_status": by_status,
                "completed_items": completed,
            })
        occupancy = _occupancy_checks(check, gate_cfg, endpoints["costs"])
        per_chip = _per_chip_checks(check, gate_cfg, endpoints["costs"])
        dtrace_summary = _dtrace_checks(check, gate_cfg,
                                        endpoints["dtraces"])
        fleet_summary = None
        if autoscaler is not None:
            fleet_summary = _autoscaler_checks(
                check, gate_cfg,
                endpoints.get("autoscaler") or autoscaler.snapshot(),
                autoscaler.decisions(), fleet_size_0,
                (t_b0_wall, t_b1_wall), converge_s)
            fleet_summary["spawned"] = dict(supervisor.spawned)
            fleet_summary["retired"] = dict(supervisor.retired)
        # Alert envelope: require_alert rules must have fired DURING the
        # fault window (the post-drain snapshot) and be resolved by
        # verdict time; forbid_alert rules must never have fired; with a
        # recovery budget declared, nothing may still be firing.
        alerts_body = endpoints["alerts"] or orch_handle.get_alerts()
        by_rule = {a.get("rule"): a
                   for a in alerts_body.get("alerts", [])}
        fired_fault = {
            a.get("rule"):
                a.get("fired_count", 0) - alerts_0.get(a.get("rule"), 0)
            for a in alerts_fault.get("alerts", [])}
        for rule_name in require_alert:
            final = by_rule.get(rule_name, {})
            check(f"alert_{rule_name}",
                  fired_fault.get(rule_name, 0) > 0
                  and final.get("state") == "resolved",
                  {"fired_in_fault_window": fired_fault.get(rule_name, 0),
                   "state_at_verdict": final.get("state")},
                  "fired during the fault window AND resolved by verdict")
        for rule_name in gate_cfg.get("forbid_alert", []):
            fired = by_rule.get(rule_name, {}).get("fired_count", 0)
            check(f"alert_quiet_{rule_name}", fired == 0, fired,
                  "never fired")
        if gate_cfg.get("max_firing_after_recovery_s") is not None:
            still = alerts_body.get("firing", [])
            check("alerts_resolved", not still,
                  {"firing": still,
                   "resolve_wait_s": round(resolve_wait_s, 2)},
                  f"zero firing within {resolve_budget_s}s of recovery")
        if gate_cfg.get("min_timeseries_series") is not None:
            need = int(gate_cfg["min_timeseries_series"])
            have = (endpoints["timeseries"] or {}).get("series_count", 0)
            check("timeseries_series", have >= need, have,
                  f">= {need} live series at /timeseries")
        # Unrouted-message accounting (the silent-drop fix): every topic
        # this run publishes on is registered before load starts, so the
        # counter must stay at zero — a nonzero value means a frame hit a
        # topic with no handler and no pull queue.
        unrouted_total = sum(
            v for _, v in registry.counter(
                "bus_dropped_no_route_total").series())
        check("bus_unrouted", unrouted_total
              <= int(gate_cfg.get("max_unrouted", 0)),
              unrouted_total, int(gate_cfg.get("max_unrouted", 0)))
        shard_summary = None
        if sharded:
            generations = {sid: h.generation
                           for sid, h in shard_handles.items()}
            routed = server.routed_counts(TOPIC_INFERENCE_BATCHES)
            total_routed = sum(routed.values())
            shard_summary = {
                "count": n_shards,
                "generations": generations,
                "routed_batches": routed,
                "outbox_depth_end": server.outbox_depth(),
            }
            if gate_cfg.get("max_shard_skew") is not None:
                # Routing skew over the record-batch topic: the busiest
                # shard's share vs the uniform ideal.  A skew at the cap
                # means the ring (or the workload's key space) is
                # funneling the stream back into one broker — the
                # single-queue ceiling this subsystem exists to remove.
                cap = float(gate_cfg["max_shard_skew"])
                ideal = total_routed / max(1, n_shards)
                skew = (max(routed.values()) / ideal) if total_routed \
                    else None
                shard_summary["skew"] = round(skew, 3) \
                    if skew is not None else None
                check("shard_skew", skew is not None and skew <= cap,
                      shard_summary["skew"],
                      f"<= {cap} (busiest shard vs uniform share)")
            if gate_cfg.get("bus_shard_generations") is not None:
                want = {sid: int(g) for sid, g in
                        gate_cfg["bus_shard_generations"].items()}
                # "bus_resume on the restarted shard only": the killed
                # shard must be on generation 2, the survivors still on
                # their first — a surviving shard that restarted (or a
                # killed one that didn't come back) fails here.
                check("bus_shard_generations", generations == want,
                      generations, want)
        bus_detail: Dict[str, Any] = {
            "generations": (max(shard_summary["generations"].values())
                            if sharded else server.generation)
            if bus_kind == "grpc" else 1,
            "durable": durable,
        }
        if shard_summary is not None:
            bus_detail["shards"] = shard_summary
        if durable:
            bus_detail["dead_letters"] = sum(
                v for _, v in registry.counter(
                    "bus_dead_letters_total").series())
            bus_detail["redeliveries"] = sum(
                v for _, v in registry.counter(
                    "bus_redeliveries_total").series())
            bus_detail["outbox_depth_end"] = \
                server.outbox_depth() if sharded \
                else local_outbox.outbox.depth()
        if gate_cfg.get("require_flight"):
            events = flight.RECORDER.events()
            start = 0
            for i in range(len(events) - 1, -1, -1):
                if events[i].get("kind") == "loadgen_run_start" \
                        and events[i].get("mark") == run_mark:
                    start = i
                    break
            kinds = {e.get("kind") for e in events[start:]}
            for kind in gate_cfg["require_flight"]:
                check(f"flight_{kind}", kind in kinds, kind in kinds, True)
        endpoint_keys = ["metrics", "costs", "cluster", "dtraces",
                         "alerts", "tenants", "timeseries"]
        if durable:
            endpoint_keys.append("dlq")
        if sharded:
            endpoint_keys.append("shards")
        if autoscaler is not None:
            endpoint_keys.append("autoscaler")
        for key in endpoint_keys:
            check(f"endpoint_{key}", endpoints[key] is not None,
                  endpoints[key] is not None, True)
        lockwitness_summary = _lockwitness_checks(check, witness_cycles0)

        stats = stats_box.get("stats")
        verdict.update({
            "status": "pass" if all(c["ok"] for c in checks.values())
            else "fail",
            "duration_s": round(time.monotonic() - t_run0, 2),
            "published": {
                **(stats.to_dict() if stats is not None else {}),
                "dropped_batches": len(chaos_bus.dropped),
                "poisoned_batches": len(chaos_bus.poisoned),
            },
            "lockwitness": lockwitness_summary,
            "expected_records": len(expected),
            "processed_records": processed,
            "lost": len(lost),
            "duplicates": len(duplicates),
            "goodput_posts_per_s": round(goodput, 2),
            "fault_breaches": breaches_fault,
            "tail_breaches": breaches_tail,
            "tail_queue_wait_p95_ms": round(tail_queue_p95, 2)
            if tail_queue_p95 is not None else None,
            "tail_batch_p95_ms": round(tail_batch_p95, 2)
            if tail_batch_p95 is not None else None,
            "tail_batch_age_p95_ms": round(tail_age_p95, 2)
            if tail_age_p95 is not None else None,
            "fault_window_s": round(t_b1 - t_b0, 2),
            "chaos_events": len(controller.events),
            "worker_generations": handle.generation,
            "autoscaler": fleet_summary,
            "bus_generations": bus_detail["generations"],
            "bus_broker": bus_detail,
            "bus_shards": shard_summary,
            "orchestrator": orch_detail,
            "cluster_workers": sorted(
                (endpoints["cluster"] or {}).get("workers", {})),
            "alerts": {
                "fired": {a.get("rule"): a.get("fired_count")
                          for a in alerts_body.get("alerts", [])
                          if a.get("fired_count")},
                "firing_at_verdict": alerts_body.get("firing", []),
                "resolve_wait_s": round(resolve_wait_s, 2),
                "messages": len(alert_msgs),
                "timeseries_series": (endpoints["timeseries"] or {})
                .get("series_count", 0),
            },
            "tenants": {
                "spend": {
                    t: row.get("spend", {})
                    for t, row in tenant_rows.items()},
                "unattributed_share":
                    tenants_body.get("unattributed_share"),
                "fault_breaches": tenant_breaches_fault,
                "run_breaches": tenant_breaches_run,
            } if tenant_rows else None,
            "occupancy": occupancy,
            "mesh": None,
            "per_chip": per_chip,
            "dtraces": dtrace_summary,
            "checks": checks,
        })
        if lost[:5]:
            verdict["lost_sample"] = lost[:5]
        return verdict
    finally:
        if controller is not None:
            _teardown("controller", controller.stop)
        _teardown("chaos-release",
                  lambda: _release_device(chaos_engines, device))
        if supervisor is not None:
            # The whole fleet, dynamic spawns included (retired handles
            # already left the pool at retire time).  Dead (chaos-killed)
            # handles are stopped too: stop() after kill() clears the
            # process-global provider seams the kill deliberately left.
            for h in supervisor.handles():
                _teardown(h.name, h.stop)
        elif handle is not None:
            _teardown("tpu-worker", handle.stop)
        if crawl_worker is not None:
            _teardown("crawl-worker", crawl_worker.stop)
        if orch_handle is not None:
            _teardown("orchestrator", orch_handle.stop)
        if cluster_provider is not None:
            _teardown("cluster-provider",
                      lambda: clear_cluster_provider(cluster_provider))
        if dtraces_provider is not None:
            _teardown("dtraces-provider",
                      lambda: clear_dtraces_provider(dtraces_provider))
        if alerts_provider is not None:
            _teardown("alerts-provider",
                      lambda: clear_alerts_provider(alerts_provider))
        if tenants_provider is not None:
            _teardown("tenants-provider",
                      lambda: clear_tenants_provider(tenants_provider))
        if autoscaler_provider is not None:
            _teardown("autoscaler-provider",
                      lambda: clear_autoscaler_provider(
                          autoscaler_provider))
        if dlq_provider is not None:
            _teardown("dlq-provider",
                      lambda: clear_dlq_provider(dlq_provider))
        if shards_provider is not None:
            _teardown("shards-provider",
                      lambda: clear_shards_provider(shards_provider))
        if http_server is not None:
            _teardown("http-server", http_server.shutdown)
        if pool_installed:
            from ..crawl import runner as crawl_runner

            _teardown("connection-pool",
                      crawl_runner.shutdown_connection_pool)
        if local_outbox is not None:
            # close_inner=False: stops the outbox flusher only — the
            # broker handle is torn down on its own line below.
            _teardown("local-outbox", local_outbox.close)
        if inner_bus is not None:
            _teardown("inmemory-bus", inner_bus.close)
        if server is not None:
            _teardown("grpc-bus", server.close)
        _teardown("device", lambda: _release_device((), device))
        shutil.rmtree(tmpdir, ignore_errors=True)


# --- the ASR serving gate (`media/`; scenarios with "kind": "asr") ----------

class _NullSM:
    """Minimal StateManager stand-in for the gate's bridges: the runs
    reconcile over the worker writeback sinks, not the crawl store."""

    def store_post(self, channel_id, post):
        pass

    def close(self):
        pass


class ASRWorkerHandle(_ServingWorkerHandle):
    """`_ServingWorkerHandle` over the `ASRWorker`; stall blocks the
    `ChaosASRPipeline`'s device calls mid-step."""

    def __init__(self, name: str, make_bus, pipeline, provider,
                 worker_cfg_kw: Dict[str, Any], registry):
        from ..media.worker import ASRWorkerConfig

        super().__init__(name, make_bus, provider, registry)
        self._pipeline = pipeline
        self._cfg = ASRWorkerConfig(worker_id=name, **worker_cfg_kw)

    def _make_worker(self, bus):
        from ..media.worker import ASRWorker

        return ASRWorker(bus, self._pipeline, provider=self._provider,
                         cfg=self._cfg, registry=self._registry)

    def stall(self, seconds: float) -> None:
        self._pipeline.block_for(seconds)


def _build_asr_pipeline(asr_cfg: Dict[str, Any], registry, device=None):
    """A tiny-Whisper `ASRPipeline` on random params (throughput and
    correctness of the serving machinery do not depend on weight
    values; real checkpoints belong to deployments, not gates).  The
    weights are drawn from a ``torch.Generator`` seeded with the "asr"
    block's ``seed``, not from JAX's PRNG, so they are not the
    reference's numbers."""
    import torch

    from ..inference.asr import ASRPipeline
    from ..models.whisper import WHISPER_TEST, Whisper

    model = Whisper(WHISPER_TEST)
    generator = torch.Generator().manual_seed(int(asr_cfg.get("seed", 0)))
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:      # LayerNorm scales
                p.fill_(1.0)
            else:
                p.copy_(torch.empty(p.shape).normal_(
                    0.0, 0.02, generator=generator))
    return ASRPipeline(
        model,
        batch_size=int(asr_cfg.get("batch_size", 4)),
        max_len=int(asr_cfg.get("max_len", 6)),
        window_buckets=asr_cfg.get("window_buckets"),
        registry=registry, device=device)


def run_asr_scenario(scenario: Dict[str, Any],
                     overrides: Optional[Dict[str, Any]] = None,
                     device=None) -> Dict[str, Any]:
    """Run one ASR scenario end-to-end in-process; returns the verdict.

    The assembled stack: synthetic audio workload (seeded durations →
    generated WAVs) → ChaosBus → ``TOPIC_MEDIA_BATCHES`` → `ASRWorker`
    on a tiny-Whisper `ASRPipeline` → transcripts on
    ``TOPIC_TRANSCRIPTS`` → `TranscriptReentry` through an
    `InferenceBridge` → a real text `TPUWorker` embedding the re-entered
    posts.  The envelope adds two media-specific checks to the usual
    ones: every expected media id written exactly once (across worker
    kills), and `/costs` reporting Whisper (path="asr") program rows
    with nonzero MFU/goodput.
    """
    import os as _os
    import wave as _wave

    from ..bus.inmemory import InMemoryBus
    from ..bus.messages import TOPIC_SPANS, SpanBatchMessage
    from ..inference.bridge import InferenceBridge
    from ..inference.engine import EngineConfig, InferenceEngine
    from ..inference.worker import TPUWorker, TPUWorkerConfig, iter_results
    from ..media.bridge import TranscriptReentry
    from ..media.worker import iter_transcripts
    from ..orchestrator.tracecollect import TraceCollector
    from ..state.providers import InMemoryStorageProvider
    from ..utils.metrics import (
        MetricsRegistry,
        clear_dtraces_provider,
        serve_metrics,
        set_dtraces_provider,
    )

    scenario = merge_overrides(scenario, overrides)
    validate_gate_config(scenario)
    _refuse_unported(scenario)
    name = scenario.get("name", "unnamed-asr")
    bus_kind = scenario.get("bus", "inmemory")
    if bus_kind not in ("inmemory", "grpc"):
        raise ValueError(f"scenario bus must be inmemory|grpc, "
                         f"got {bus_kind!r}")
    timeline = parse_timeline(scenario.get("chaos", []))
    if bus_kind != "grpc" and any(f.action in ("kill", "restart", "down")
                                  for f in timeline):
        raise ValueError(
            "kill/restart faults need bus='grpc' (the in-memory bus has "
            "no competing-consumer requeue, so a killed worker's frames "
            "would be lost by construction)")

    from dataclasses import fields as _dc_fields

    audio_keys = {f.name for f in _dc_fields(AudioLoadConfig)}
    audio_raw = dict(scenario.get("audio_load", {}))
    # CLI overrides arrive under "load" (the shared loadtest flag
    # surface); fold the keys both configs share into the audio config.
    for key in ("seed", "duration_s", "rate_batches_per_s"):
        if key in scenario.get("load", {}):
            audio_raw[key] = scenario["load"][key]
    audio_cfg = AudioLoadConfig(**{k: v for k, v in audio_raw.items()
                                   if k in audio_keys})
    worker_kw = {k: v for k, v in scenario.get("worker", {}).items()
                 if k in ("worker_id", "heartbeat_s", "queue_capacity",
                          "coalesce_batches", "write_tokens",
                          "slo_asr_batch_p95_ms", "slo_queue_wait_ms",
                          "slo_batch_age_ms", "span_export_interval_s",
                          "span_export_max_spans", "span_sample_rate")}
    worker_name = worker_kw.pop("worker_id", "asr-1")
    gate_cfg = scenario.get("gate", {})
    witness_cycles0 = _lockwitness_begin(gate_cfg)
    drain_timeout_s = float(scenario.get("drain_timeout_s", 30.0))

    trace.configure(capacity=int(scenario.get("trace_buffer", 8192)))
    flight.configure(capacity=int(scenario.get("flight_buffer", 4096)))
    run_mark = f"run-{time.monotonic_ns()}"
    flight.record("loadgen_run_start", mark=run_mark)
    # The gate owns the process-global rolling store for the run, like
    # the rings (the ASR workers self-sample into it too).
    timeseries.STORE.reset()
    registry = MetricsRegistry()

    t_run0 = time.monotonic()
    tmpdir = tempfile.mkdtemp(prefix="dct-loadgen-asr-")
    pipeline = ChaosASRPipeline(
        _build_asr_pipeline(scenario.get("asr", {}), registry, device))
    provider = InMemoryStorageProvider()

    server = None
    inner_bus = None
    handle = None
    tpu_worker = None
    ibridge = None
    http_server = None
    controller = None
    dtraces_provider = None
    verdict: Dict[str, Any] = {"scenario": name, "bus": bus_kind,
                               "kind": "asr"}
    try:
        # --- bus fabric ---------------------------------------------------
        if bus_kind == "grpc":
            from ..bus.grpc_bus import GrpcBusServer, RemoteBus

            server = GrpcBusServer("127.0.0.1:0")
            server.enable_pull(TOPIC_MEDIA_BATCHES)
            server.start()
            addr = f"127.0.0.1:{server.bound_port}"
            local_bus = server
            make_worker_bus = lambda: RemoteBus(addr)  # noqa: E731
        else:
            inner_bus = InMemoryBus(sync=True)
            local_bus = inner_bus
            make_worker_bus = lambda: inner_bus  # noqa: E731
        chaos_bus = ChaosBus(local_bus)

        # --- trace collection (no orchestrator in the ASR stack, so the
        # gate hosts the collector itself, subscribed like one would) ----
        collector = TraceCollector()
        local_bus.subscribe(
            TOPIC_SPANS,
            lambda payload, ack=None:
            collector.observe(SpanBatchMessage.from_dict(payload)))
        dtraces_provider = collector.export
        set_dtraces_provider(dtraces_provider)

        # --- re-entry leg: transcripts -> embeddings (real text path) -----
        # Started BEFORE the ASR worker so the ASR worker's /costs
        # provider registration wins (last registration serves).
        reentry_crawl = scenario.get("reentry_crawl_id", "asr-reentry")
        engine = InferenceEngine(
            EngineConfig(**scenario.get("engine", {"model": "tiny"})),
            registry=registry, device=device)
        tpu_worker = TPUWorker(
            local_bus, engine, provider=provider,
            cfg=TPUWorkerConfig(worker_id="tpu-reentry", heartbeat_s=5.0,
                                stall_warn_s=0.0,
                                span_export_interval_s=1.0),
            registry=registry)
        tpu_worker.start()
        ibridge = InferenceBridge(_NullSM(), local_bus,
                                  crawl_id=reentry_crawl,
                                  batch_size=4, deadline_s=0.05)
        reentry = TranscriptReentry(ibridge, local_bus)

        # --- ASR worker ----------------------------------------------------
        handle = ASRWorkerHandle(worker_name, make_worker_bus, pipeline,
                                 provider, worker_kw, registry)
        handle.start()
        handle.worker.warmup()  # compile every bucket outside the phases

        http_server = serve_metrics(0, registry)
        port = http_server.server_address[1]

        controller = ChaosController(timeline,
                                     targets={worker_name: handle},
                                     bus=chaos_bus, publish_bus=local_bus)

        workload = AudioWorkload(audio_cfg,
                                 _os.path.join(tmpdir, "media"))
        n_wavs = workload.materialize()
        logger.info("loadgen %s: %d synthetic wavs materialized",
                    name, n_wavs)

        # --- phase A: baseline (flush the SLO window) ----------------------
        handle.worker.evaluate_slos()
        breaches_0 = _breach_counts(registry)

        # --- phase B: load + chaos ----------------------------------------
        t_b0 = time.monotonic()
        stop = threading.Event()
        stats_box: Dict[str, Any] = {}

        def _gen():
            stats_box["stats"] = workload.run(chaos_bus, stop=stop)

        gen_thread = threading.Thread(target=_gen, daemon=True,
                                      name="dct-loadgen-asr")
        controller.start()
        gen_thread.start()
        gen_thread.join()
        deadline = time.monotonic() + drain_timeout_s
        while not controller.done() and time.monotonic() < deadline:
            time.sleep(0.02)
        controller.stop()
        if server is not None:
            server.drain(timeout_s=drain_timeout_s)
        drained = handle.worker.drain(timeout_s=drain_timeout_s)
        handle.worker.evaluate_slos()
        breaches_fault = _delta(_breach_counts(registry), breaches_0)
        t_b1 = time.monotonic()

        # --- phase C: recovery tail ---------------------------------------
        tail_cfg = scenario.get("tail", {})
        tail_n = int(tail_cfg.get("batches", 4))
        tail_gap = float(tail_cfg.get("gap_s", 0.1))
        tail_refs = int(tail_cfg.get("refs_per_batch", 2))
        tail_wav = _os.path.join(tmpdir, "media", "tail.wav")
        with _wave.open(tail_wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(audio_cfg.sample_rate)
            w.writeframes(b"\x00\x00" * int(audio_cfg.sample_rate
                                            * audio_cfg.min_audio_s))
        t_tail_wall = time.time()
        breaches_mid = _breach_counts(registry)
        from ..bus.messages import AudioBatchMessage, AudioRef

        for i in range(tail_n):
            refs = [AudioRef(media_id=f"tail{audio_cfg.seed}-{i}-{j}",
                             path=tail_wav, channel_name="tailchan")
                    for j in range(tail_refs)]
            chaos_bus.publish(
                TOPIC_MEDIA_BATCHES,
                AudioBatchMessage.new(
                    refs, crawl_id=audio_cfg.crawl_id).to_dict())
            time.sleep(tail_gap)
        if server is not None:
            server.drain(timeout_s=drain_timeout_s)
        tail_drained = handle.worker.drain(timeout_s=drain_timeout_s)
        handle.worker.evaluate_slos()
        breaches_tail = _delta(_breach_counts(registry), breaches_mid)

        # Let the re-entry leg finish embedding what the tail produced.
        # Transcripts hop through an async dispatch (bus delivery ->
        # reentry -> bridge accumulator -> record batch -> TPU worker),
        # so settle until the embedded set stops growing: every media id
        # written by the ASR worker must surface as media:<id> in the
        # inference writeback before measurement reads it.
        settle_deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < settle_deadline:
            ibridge.flush()
            tpu_worker.drain(timeout_s=drain_timeout_s)
            written_now = {row.get("media_id", "")
                           for row in iter_transcripts(
                               provider, audio_cfg.crawl_id)
                           if not row.get("error")}
            embedded_now = {row.get("post_uid", "")
                            for row in iter_results(provider,
                                                    reentry_crawl)}
            if all(f"media:{m}" in embedded_now for m in written_now):
                break
            time.sleep(0.1)
        t_end = time.monotonic()

        # --- measurement ---------------------------------------------------
        # Flush both serving workers' span tails so /dtraces assembly is
        # deterministic, not a race with the interval exporters.
        for w in (handle.worker, tpu_worker):
            export_fn = getattr(w, "export_spans", None)
            if callable(export_fn):
                export_fn()
        spans = trace.TRACER.spans()
        tail_queue_p95 = _p95_ms(spans, QUEUE_WAIT_SPANS, t_tail_wall)
        tail_asr_p95 = _p95_ms(spans, ASR_BATCH_SPANS, t_tail_wall)
        tail_age_p95 = _p95_ms(spans, BATCH_AGE_SPANS, t_tail_wall)

        endpoints = {
            "metrics": _scrape(port, "/metrics", as_json=False),
            "costs": _scrape(port, "/costs", as_json=True),
            "dtraces": _scrape(port, "/dtraces", as_json=True),
        }

        expected = chaos_bus.expected_uids()
        expected_set = set(expected)
        written: Dict[str, int] = {}
        written_ok: set = set()  # non-error rows: the re-entry candidates
        error_rows = 0
        for row in iter_transcripts(provider, audio_cfg.crawl_id):
            mid = row.get("media_id", "")
            if mid:
                written[mid] = written.get(mid, 0) + 1
            if row.get("error"):
                error_rows += 1
            elif mid:
                written_ok.add(mid)
        lost = [m for m in expected if m not in written]
        duplicates = [m for m, c in written.items() if c > 1]
        processed = sum(min(c, 1) for m, c in written.items()
                        if m in expected_set)
        reentered_uids = {row.get("post_uid", "")
                          for row in iter_results(provider, reentry_crawl)}
        # Error transcripts are never re-entered by design
        # (TranscriptReentry skips them), so only successful rows count
        # toward the re-entry requirement — a decode failure within
        # max_transcript_errors must not fail the reentered check too.
        missing_reentry = [m for m in expected
                           if m in written_ok
                           and f"media:{m}" not in reentered_uids]
        active_s = max(1e-6, t_end - t_b0)
        goodput = processed / active_s

        # --- the envelope --------------------------------------------------
        checks: Dict[str, Dict[str, Any]] = {}

        def check(key: str, ok: bool, value, budget) -> None:
            checks[key] = {"ok": bool(ok), "value": value, "budget": budget}

        check("drained", drained and tail_drained,
              {"fault": drained, "tail": tail_drained}, True)
        check("lost", len(lost) <= int(gate_cfg.get("max_lost", 0)),
              len(lost), int(gate_cfg.get("max_lost", 0)))
        check("duplicates",
              len(duplicates) <= int(gate_cfg.get("max_duplicates", 0)),
              len(duplicates), int(gate_cfg.get("max_duplicates", 0)))
        check("transcript_errors",
              error_rows <= int(gate_cfg.get("max_transcript_errors", 0)),
              error_rows, int(gate_cfg.get("max_transcript_errors", 0)))
        if gate_cfg.get("reentry_required", True):
            check("reentered", not missing_reentry, len(missing_reentry),
                  "every written media id embedded (media:<id> in the "
                  "inference writeback)")
        for slo in gate_cfg.get("require_breach", []):
            check(f"breach_{slo}", breaches_fault.get(slo, 0) > 0,
                  breaches_fault.get(slo, 0), "> 0 during fault window")
        for slo in gate_cfg.get("forbid_tail_breach", []):
            check(f"tail_no_breach_{slo}",
                  breaches_tail.get(slo, 0) == 0,
                  breaches_tail.get(slo, 0), "0 in recovery tail")
        if gate_cfg.get("asr_batch_p95_ms") is not None:
            budget = float(gate_cfg["asr_batch_p95_ms"])
            check("tail_asr_batch_p95_ms",
                  tail_asr_p95 is not None and tail_asr_p95 <= budget,
                  round(tail_asr_p95, 2) if tail_asr_p95 is not None
                  else None, budget)
        if gate_cfg.get("queue_wait_p95_ms") is not None:
            budget = float(gate_cfg["queue_wait_p95_ms"])
            check("tail_queue_wait_p95_ms",
                  tail_queue_p95 is not None and tail_queue_p95 <= budget,
                  round(tail_queue_p95, 2) if tail_queue_p95 is not None
                  else None, budget)
        if gate_cfg.get("goodput_min_media_per_s") is not None:
            floor = float(gate_cfg["goodput_min_media_per_s"])
            check("goodput_media_per_s", goodput >= floor,
                  round(goodput, 2), f">= {floor}")
        if gate_cfg.get("require_whisper_costs", True):
            costs_body = endpoints["costs"] or {}
            rows = [c for c in costs_body.get("costs", [])
                    if c.get("path") == "asr"
                    and (c.get("flops") or 0) > 0]
            eff = costs_body.get("efficiency") or {}
            ok = bool(rows) and (eff.get("mfu") or 0) > 0 \
                and (eff.get("goodput_tokens_per_s") or 0) > 0
            check("whisper_costs", ok,
                  {"asr_rows": len(rows), "mfu": eff.get("mfu"),
                   "goodput": eff.get("goodput_tokens_per_s")},
                  "path=asr rows with nonzero flops + nonzero MFU/goodput")
        occupancy = _occupancy_checks(check, gate_cfg, endpoints["costs"])
        dtrace_summary = _dtrace_checks(check, gate_cfg,
                                        endpoints["dtraces"])
        if gate_cfg.get("require_flight"):
            events = flight.RECORDER.events()
            start = 0
            for i in range(len(events) - 1, -1, -1):
                if events[i].get("kind") == "loadgen_run_start" \
                        and events[i].get("mark") == run_mark:
                    start = i
                    break
            kinds = {e.get("kind") for e in events[start:]}
            for kind in gate_cfg["require_flight"]:
                check(f"flight_{kind}", kind in kinds, kind in kinds, True)
        for key in ("metrics", "costs", "dtraces"):
            check(f"endpoint_{key}", endpoints[key] is not None,
                  endpoints[key] is not None, True)
        lockwitness_summary = _lockwitness_checks(check, witness_cycles0)

        stats = stats_box.get("stats")
        verdict.update({
            "status": "pass" if all(c["ok"] for c in checks.values())
            else "fail",
            "duration_s": round(time.monotonic() - t_run0, 2),
            "published": {
                **(stats.to_dict() if stats is not None else {}),
                "dropped_batches": len(chaos_bus.dropped),
                "poisoned_batches": len(chaos_bus.poisoned),
            },
            "lockwitness": lockwitness_summary,
            "expected_media": len(expected),
            "processed_media": processed,
            "lost": len(lost),
            "duplicates": len(duplicates),
            "transcript_errors": error_rows,
            "reentered_posts": reentry.posts_reentered,
            "goodput_media_per_s": round(goodput, 2),
            "fault_breaches": breaches_fault,
            "tail_breaches": breaches_tail,
            "tail_asr_batch_p95_ms": round(tail_asr_p95, 2)
            if tail_asr_p95 is not None else None,
            "tail_queue_wait_p95_ms": round(tail_queue_p95, 2)
            if tail_queue_p95 is not None else None,
            "tail_batch_age_p95_ms": round(tail_age_p95, 2)
            if tail_age_p95 is not None else None,
            "fault_window_s": round(t_b1 - t_b0, 2),
            "chaos_events": len(controller.events),
            "worker_generations": handle.generation,
            "occupancy": occupancy,
            "dtraces": dtrace_summary,
            "checks": checks,
        })
        if lost[:5]:
            verdict["lost_sample"] = lost[:5]
        return verdict
    finally:
        if controller is not None:
            _teardown("controller", controller.stop)
        _teardown("chaos-release",
                  lambda: _release_device((pipeline,), device))
        if handle is not None:
            _teardown("asr-worker", handle.stop)
        if tpu_worker is not None:
            _teardown("tpu-reentry", lambda: tpu_worker.stop(timeout_s=5.0))
        if ibridge is not None:
            _teardown("reentry-bridge", ibridge.close)
        if dtraces_provider is not None:
            _teardown("dtraces-provider",
                      lambda: clear_dtraces_provider(dtraces_provider))
        if http_server is not None:
            _teardown("http-server", http_server.shutdown)
        if inner_bus is not None:
            _teardown("inmemory-bus", inner_bus.close)
        if server is not None:
            _teardown("grpc-bus", server.close)
        _teardown("device", lambda: _release_device((), device))
        shutil.rmtree(tmpdir, ignore_errors=True)


# --- the clustering gate (`cluster/`; scenarios with "kind": "cluster") ------

class ClusterWorkerHandle(_ServingWorkerHandle):
    """`_ServingWorkerHandle` over the `ClusterWorker`.

    Every generation constructs a FRESH `ClusterWorker` (and with it a
    fresh `ClusterEngine` — empty centroid memory) over the SAME storage
    provider: recovery must come from the atomic checkpoint alone,
    exactly like a restarted process.  A restart that continues with
    ``resumed_from_step > 0`` (instead of re-seeding) is the
    kill-cluster-worker scenario's centerpiece."""

    def __init__(self, name: str, make_bus, provider,
                 worker_cfg_kw: Dict[str, Any], registry, device=None):
        super().__init__(name, make_bus, provider, registry)
        self._cfg_kw = dict(worker_cfg_kw)
        self._device = device

    def _make_worker(self, bus):
        from ..cluster.worker import ClusterWorker, ClusterWorkerConfig

        kw = dict(self._cfg_kw)
        if "buckets" in kw:
            kw["buckets"] = tuple(int(b) for b in kw["buckets"])
        return ClusterWorker(bus, provider=self._provider,
                             cfg=ClusterWorkerConfig(worker_id=self.name,
                                                     **kw),
                             registry=self._registry, device=self._device)

    def stall(self, seconds: float) -> None:
        raise NotImplementedError(
            "stall is not supported for cluster workers (use kill/restart)")


def run_cluster_scenario(scenario: Dict[str, Any],
                         overrides: Optional[Dict[str, Any]] = None,
                         device=None) -> Dict[str, Any]:
    """Run one clustering scenario end-to-end in-process; returns the
    verdict.

    The assembled stack: synthetic text workload → ChaosBus →
    ``TOPIC_INFERENCE_BATCHES`` → a real text `TPUWorker` (publishing
    embedding-carrying result batches) → ``TOPIC_INFERENCE_RESULTS``
    (pull-enabled on gRPC, so a killed cluster worker's un-acked frames
    requeue) → `ClusterWorker` on a fresh `ClusterEngine` → idempotent
    assignment writeback + atomic centroid checkpoints + `/clusters`.

    The envelope adds the cluster-specific checks to the usual ones:

    - **embedding→assignment ledger**: every post_uid the TPU worker
      embedded (its writeback) must appear exactly once in the cluster
      worker's assignment writeback — zero lost, zero duplicated, across
      worker kills;
    - ``min_clusters_nonempty`` / ``max_inertia_growth`` over the
      `/clusters` body (centroid health);
    - ``require_cluster_costs`` (default on): `/costs` must carry
      ``path="cluster"`` program rows with nonzero FLOPs and nonzero
      rolling MFU/goodput;
    - ``require_resume``: the (restarted) cluster worker must have
      resumed from a checkpoint — ``resumed`` true with
      ``resume_step > 0``, i.e. centroids continued, never re-seeded.
    """
    from ..bus.inmemory import InMemoryBus
    from ..bus.messages import TOPIC_SPANS, SpanBatchMessage
    from ..cluster.worker import iter_assignments
    from ..inference.engine import EngineConfig, InferenceEngine
    from ..orchestrator.tracecollect import TraceCollector
    from ..state.providers import InMemoryStorageProvider
    from ..utils.metrics import (
        MetricsRegistry,
        clear_dtraces_provider,
        serve_metrics,
        set_dtraces_provider,
    )

    scenario = merge_overrides(scenario, overrides)
    validate_gate_config(scenario)
    _refuse_unported(scenario)
    name = scenario.get("name", "unnamed-cluster")
    bus_kind = scenario.get("bus", "inmemory")
    if bus_kind not in ("inmemory", "grpc"):
        raise ValueError(f"scenario bus must be inmemory|grpc, "
                         f"got {bus_kind!r}")
    timeline = parse_timeline(scenario.get("chaos", []))
    if bus_kind != "grpc" and any(f.action in ("kill", "restart", "down")
                                  for f in timeline):
        raise ValueError(
            "kill/restart faults need bus='grpc' (the in-memory bus has "
            "no competing-consumer requeue, so a killed worker's frames "
            "would be lost by construction)")

    load_cfg = LoadGenConfig(**{k: v
                                for k, v in scenario.get("load", {}).items()
                                if k in _LOAD_KEYS})
    workload = SyntheticWorkload(load_cfg)
    worker_kw = {k: v for k, v in scenario.get("worker", {}).items()
                 if k in _WORKER_KEYS}
    tpu_name = worker_kw.pop("worker_id", "tpu-1")
    cluster_kw = {k: v
                  for k, v in scenario.get("cluster_worker", {}).items()
                  if k in _CLUSTER_WORKER_KEYS}
    cluster_name = cluster_kw.pop("worker_id", "cluster-1")
    gate_cfg = scenario.get("gate", {})
    witness_cycles0 = _lockwitness_begin(gate_cfg)
    drain_timeout_s = float(scenario.get("drain_timeout_s", 30.0))

    trace.configure(capacity=int(scenario.get("trace_buffer", 8192)))
    flight.configure(capacity=int(scenario.get("flight_buffer", 4096)))
    run_mark = f"run-{time.monotonic_ns()}"
    flight.record("loadgen_run_start", mark=run_mark)
    timeseries.STORE.reset()
    registry = MetricsRegistry()

    t_run0 = time.monotonic()
    base_engine = InferenceEngine(
        EngineConfig(**scenario.get("engine", {"model": "tiny"})),
        registry=registry, device=device)
    engine = ChaosEngine(base_engine)
    provider = InMemoryStorageProvider()

    server = None
    inner_bus = None
    tpu_handle = None
    cluster_handle = None
    http_server = None
    controller = None
    dtraces_provider = None
    verdict: Dict[str, Any] = {"scenario": name, "bus": bus_kind,
                               "kind": "cluster"}
    try:
        # --- bus fabric ---------------------------------------------------
        if bus_kind == "grpc":
            from ..bus.grpc_bus import GrpcBusServer, RemoteBus

            server = GrpcBusServer("127.0.0.1:0")
            server.enable_pull(TOPIC_INFERENCE_BATCHES)
            # The clustering feed is a pull topic too: a killed cluster
            # worker's un-acked result frames must requeue server-side,
            # exactly like the inference topic for the TPU worker.
            server.enable_pull(TOPIC_INFERENCE_RESULTS)
            server.start()
            addr = f"127.0.0.1:{server.bound_port}"
            local_bus = server
            make_worker_bus = lambda: RemoteBus(addr)  # noqa: E731
        else:
            inner_bus = InMemoryBus(sync=True)
            local_bus = inner_bus
            make_worker_bus = lambda: inner_bus  # noqa: E731
        chaos_bus = ChaosBus(local_bus)
        # Route the run's fan-out topics (the unrouted-counter
        # discipline): chaos announcements and the cluster worker's
        # periodic ClusterUpdateMessages.
        local_bus.subscribe(TOPIC_CHAOS, lambda payload: None)
        cluster_updates: List[Dict[str, Any]] = []
        local_bus.subscribe(TOPIC_CLUSTERS,
                            lambda payload: cluster_updates.append(payload))

        # --- trace collection (no orchestrator here; the gate hosts the
        # collector, subscribed the way one would) ------------------------
        collector = TraceCollector()
        local_bus.subscribe(
            TOPIC_SPANS,
            lambda payload, ack=None:
            collector.observe(SpanBatchMessage.from_dict(payload)))
        dtraces_provider = collector.export
        set_dtraces_provider(dtraces_provider)

        # --- TPU worker (the embedding publisher) -------------------------
        # Started BEFORE the cluster worker so the cluster worker's
        # /status + /costs provider registrations win (last wins) and
        # the verdict's /costs scrape reads the path="cluster" rows.
        tpu_handle = WorkerHandle(tpu_name, make_worker_bus, engine,
                                  provider, worker_kw, registry)
        tpu_handle.start()
        tpu_handle.worker.warmup()  # compile outside the measured phases

        # --- cluster worker -----------------------------------------------
        cluster_handle = ClusterWorkerHandle(cluster_name, make_worker_bus,
                                             provider, cluster_kw, registry,
                                             device=device)
        cluster_handle.start()

        http_server = serve_metrics(0, registry)
        port = http_server.server_address[1]

        controller = ChaosController(
            timeline,
            targets={tpu_name: tpu_handle, cluster_name: cluster_handle},
            bus=chaos_bus, publish_bus=local_bus)

        def _pending() -> int:
            n = 0
            for h in (tpu_handle, cluster_handle):
                w = h.worker
                if w is None:
                    continue
                status = w.get_status()
                n += int(status.get("queue_depth", 0)) \
                    + int(status.get("inflight", 0))
            if server is not None:
                n += server.pending_count(TOPIC_INFERENCE_BATCHES)
                n += server.pending_count(TOPIC_INFERENCE_RESULTS)
            return n

        def _drain_stack(timeout_s: float) -> bool:
            """Embeddings flow two hops: drain broker → TPU worker →
            broker again (its published result frames) → cluster
            worker.  Killed generations resolve True (their pending
            frames requeue to the next generation)."""
            if server is not None:
                server.drain(timeout_s=timeout_s)
            ok = True
            if tpu_handle.worker is not None:
                ok &= tpu_handle.worker.drain(timeout_s=timeout_s)
            if server is not None:
                server.drain(timeout_s=timeout_s)
            if cluster_handle.alive and cluster_handle.worker is not None:
                ok &= cluster_handle.worker.drain(timeout_s=timeout_s)
            return ok

        def _evaluate_slos() -> None:
            for h in (tpu_handle, cluster_handle):
                if h.worker is not None:
                    h.worker.evaluate_slos()

        def _embedded_uids() -> Dict[str, int]:
            return _written_uids(provider, [load_cfg.crawl_id])

        def _assigned_uids() -> Dict[str, int]:
            counts: Dict[str, int] = {}
            for row in iter_assignments(provider, load_cfg.crawl_id):
                uid = row.get("post_uid", "")
                if uid:
                    counts[uid] = counts.get(uid, 0) + 1
            return counts

        def _settle_assignments(timeout_s: float) -> None:
            """Wait (bounded) until every embedded uid has an
            assignment — the second hop is async behind the first."""
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                _drain_stack(min(5.0, timeout_s))
                embedded = set(_embedded_uids())
                assigned = set(_assigned_uids())
                if embedded and embedded <= assigned:
                    return
                if not embedded and not assigned:
                    time.sleep(0.05)
                    continue
                time.sleep(0.05)

        # --- phase A: baseline (flush the SLO window) ----------------------
        _evaluate_slos()
        breaches_0 = _breach_counts(registry)

        # --- phase B: load + chaos ----------------------------------------
        logger.info("loadgen %s: cluster load phase starting", name)
        t_b0 = time.monotonic()
        stop = threading.Event()
        stats_box: Dict[str, Any] = {}

        def _gen():
            stats_box["stats"] = workload.run(
                chaos_bus, stop=stop, pending_fn=_pending)

        gen_thread = threading.Thread(target=_gen, daemon=True,
                                      name="dct-loadgen-cluster")
        controller.start()
        gen_thread.start()
        gen_thread.join()
        deadline = time.monotonic() + drain_timeout_s
        while not controller.done() and time.monotonic() < deadline:
            time.sleep(0.02)
        controller.stop()
        drained = _drain_stack(drain_timeout_s)
        _settle_assignments(drain_timeout_s)
        _evaluate_slos()
        breaches_fault = _delta(_breach_counts(registry), breaches_0)
        t_b1 = time.monotonic()

        # --- phase C: recovery tail ---------------------------------------
        tail_cfg = scenario.get("tail", {})
        tail_n = int(tail_cfg.get("batches", 6))
        tail_gap = float(tail_cfg.get("gap_s", 0.05))
        tail_records = int(tail_cfg.get("records_per_batch",
                                        load_cfg.records_per_batch))
        t_tail_wall = time.time()
        breaches_mid = _breach_counts(registry)
        for i in range(tail_n):
            pb = PlannedBatch(10_000 + i, None, tuple(
                PlannedRecord("telegram", 10)
                for _ in range(tail_records)))
            chaos_bus.publish(TOPIC_INFERENCE_BATCHES,
                              workload.build_batch(pb).to_dict())
            time.sleep(tail_gap)
        tail_drained = _drain_stack(drain_timeout_s)
        _settle_assignments(drain_timeout_s)
        _evaluate_slos()
        breaches_tail = _delta(_breach_counts(registry), breaches_mid)
        t_end = time.monotonic()

        # --- measurement ---------------------------------------------------
        for h in (tpu_handle, cluster_handle):
            if h.worker is not None:
                export_fn = getattr(h.worker, "export_spans", None)
                if callable(export_fn):
                    export_fn()
        spans = trace.TRACER.spans()
        tail_queue_p95 = _p95_ms(spans, QUEUE_WAIT_SPANS, t_tail_wall)
        tail_batch_p95 = _p95_ms(spans, BATCH_SPANS, t_tail_wall)
        tail_age_p95 = _p95_ms(spans, BATCH_AGE_SPANS, t_tail_wall)

        endpoints = {
            "metrics": _scrape(port, "/metrics", as_json=False),
            "costs": _scrape(port, "/costs", as_json=True),
            "clusters": _scrape(port, "/clusters", as_json=True),
            "dtraces": _scrape(port, "/dtraces", as_json=True),
            "timeseries": _scrape(port, "/timeseries", as_json=True),
        }

        # --- the embedding→assignment ledger -------------------------------
        expected = chaos_bus.expected_uids()
        expected_set = set(expected)
        embedded = _embedded_uids()
        assigned = _assigned_uids()
        lost = [u for u in expected if u not in embedded]
        duplicates = [u for u, c in embedded.items() if c > 1]
        # The clustering hop's own ledger: every embedding the TPU
        # worker wrote must be assigned exactly once — across kills.
        embedded_once = [u for u in embedded if u in expected_set]
        cluster_lost = [u for u in embedded_once if u not in assigned]
        cluster_dups = [u for u, c in assigned.items() if c > 1]
        processed = sum(min(c, 1) for u, c in assigned.items()
                        if u in expected_set)
        active_s = max(1e-6, t_end - t_b0)
        goodput = processed / active_s

        # --- the envelope --------------------------------------------------
        checks: Dict[str, Dict[str, Any]] = {}

        def check(key: str, ok: bool, value, budget) -> None:
            checks[key] = {"ok": bool(ok), "value": value, "budget": budget}

        check("drained", drained and tail_drained,
              {"fault": drained, "tail": tail_drained}, True)
        check("lost", len(lost) <= int(gate_cfg.get("max_lost", 0)),
              len(lost), int(gate_cfg.get("max_lost", 0)))
        check("duplicates",
              len(duplicates) <= int(gate_cfg.get("max_duplicates", 0)),
              len(duplicates), int(gate_cfg.get("max_duplicates", 0)))
        check("cluster_lost", not cluster_lost, len(cluster_lost),
              "every embedded uid assigned exactly once")
        check("cluster_duplicates", not cluster_dups, len(cluster_dups), 0)
        for slo in gate_cfg.get("require_breach", []):
            check(f"breach_{slo}", breaches_fault.get(slo, 0) > 0,
                  breaches_fault.get(slo, 0), "> 0 during fault window")
        for slo in gate_cfg.get("forbid_tail_breach", []):
            check(f"tail_no_breach_{slo}",
                  breaches_tail.get(slo, 0) == 0,
                  breaches_tail.get(slo, 0), "0 in recovery tail")
        if gate_cfg.get("queue_wait_p95_ms") is not None:
            budget = float(gate_cfg["queue_wait_p95_ms"])
            check("tail_queue_wait_p95_ms",
                  tail_queue_p95 is not None and tail_queue_p95 <= budget,
                  round(tail_queue_p95, 2) if tail_queue_p95 is not None
                  else None, budget)
        if gate_cfg.get("goodput_min_vectors_per_s") is not None:
            floor = float(gate_cfg["goodput_min_vectors_per_s"])
            check("goodput_vectors_per_s", goodput >= floor,
                  round(goodput, 2), f">= {floor}")
        # --- centroid-model health over /clusters --------------------------
        clusters_body = endpoints["clusters"] or {}
        nonempty = int(clusters_body.get("nonempty") or 0)
        need_nonempty = int(gate_cfg.get("min_clusters_nonempty", 1))
        check("clusters_nonempty", nonempty >= need_nonempty, nonempty,
              f">= {need_nonempty}")
        inertia_hist = [float(v) for v in
                        (clusters_body.get("inertia") or [])]
        inertia_growth = None
        if gate_cfg.get("max_inertia_growth") is not None:
            cap = float(gate_cfg["max_inertia_growth"])
            if len(inertia_hist) >= 12:
                # Skip the seeding warmup (first quarter): right after
                # k-means++ the centroids sit ON the first mini-batch's
                # points, so those steps' inertia is artificially near
                # zero and ANY stream would measure as growth.  The
                # baseline is the post-warmup quarter; the judged value
                # the final quarter — online k-means must organize (or
                # hold), not drift.
                q = max(2, len(inertia_hist) // 4)
                early = sum(inertia_hist[q:2 * q]) / q
                late = sum(inertia_hist[-q:]) / q
                if early > 0:
                    inertia_growth = late / early
            # Too-short history (or a zero baseline window) cannot judge
            # a trend — the nonempty/ledger checks carry those runs.
            check("inertia_growth",
                  inertia_growth is None or inertia_growth <= cap,
                  round(inertia_growth, 4)
                  if inertia_growth is not None else "n/a",
                  f"late/post-warmup mean <= {cap}")
        if gate_cfg.get("require_resume"):
            resumed = bool(clusters_body.get("resumed"))
            resume_step = clusters_body.get("resume_step")
            check("cluster_resumed",
                  resumed and (resume_step or 0) > 0,
                  {"resumed": resumed, "resume_step": resume_step},
                  "restarted worker resumed checkpoint (no re-seed)")
        if gate_cfg.get("require_cluster_costs", True):
            costs_body = endpoints["costs"] or {}
            rows = [c for c in costs_body.get("costs", [])
                    if c.get("path") == "cluster"
                    and (c.get("flops") or 0) > 0]
            eff = costs_body.get("efficiency") or {}
            ok = bool(rows) and (eff.get("mfu") or 0) > 0 \
                and (eff.get("goodput_tokens_per_s") or 0) > 0
            check("cluster_costs", ok,
                  {"cluster_rows": len(rows), "mfu": eff.get("mfu"),
                   "goodput": eff.get("goodput_tokens_per_s")},
                  "path=cluster rows with nonzero flops + nonzero "
                  "MFU/goodput")
        dtrace_summary = _dtrace_checks(check, gate_cfg,
                                        endpoints["dtraces"])
        if gate_cfg.get("min_timeseries_series") is not None:
            need = int(gate_cfg["min_timeseries_series"])
            have = (endpoints["timeseries"] or {}).get("series_count", 0)
            check("timeseries_series", have >= need, have,
                  f">= {need} live series at /timeseries")
        if gate_cfg.get("require_flight"):
            events = flight.RECORDER.events()
            start = 0
            for i in range(len(events) - 1, -1, -1):
                if events[i].get("kind") == "loadgen_run_start" \
                        and events[i].get("mark") == run_mark:
                    start = i
                    break
            kinds = {e.get("kind") for e in events[start:]}
            for kind in gate_cfg["require_flight"]:
                check(f"flight_{kind}", kind in kinds, kind in kinds, True)
        for key in ("metrics", "costs", "clusters", "dtraces",
                    "timeseries"):
            check(f"endpoint_{key}", endpoints[key] is not None,
                  endpoints[key] is not None, True)
        lockwitness_summary = _lockwitness_checks(check, witness_cycles0)

        stats = stats_box.get("stats")
        verdict.update({
            "status": "pass" if all(c["ok"] for c in checks.values())
            else "fail",
            "duration_s": round(time.monotonic() - t_run0, 2),
            "published": {
                **(stats.to_dict() if stats is not None else {}),
                "dropped_batches": len(chaos_bus.dropped),
                "poisoned_batches": len(chaos_bus.poisoned),
            },
            "lockwitness": lockwitness_summary,
            "expected_records": len(expected),
            "embedded_records": sum(min(c, 1) for u, c in embedded.items()
                                    if u in expected_set),
            "assigned_records": processed,
            "lost": len(lost),
            "duplicates": len(duplicates),
            "cluster_lost": len(cluster_lost),
            "cluster_duplicates": len(cluster_dups),
            "goodput_vectors_per_s": round(goodput, 2),
            "fault_breaches": breaches_fault,
            "tail_breaches": breaches_tail,
            "tail_queue_wait_p95_ms": round(tail_queue_p95, 2)
            if tail_queue_p95 is not None else None,
            "tail_batch_p95_ms": round(tail_batch_p95, 2)
            if tail_batch_p95 is not None else None,
            "tail_batch_age_p95_ms": round(tail_age_p95, 2)
            if tail_age_p95 is not None else None,
            "fault_window_s": round(t_b1 - t_b0, 2),
            "chaos_events": len(controller.events),
            "worker_generations": cluster_handle.generation,
            "cluster_updates": len(cluster_updates),
            "clusters": {
                "k": clusters_body.get("k"),
                "nonempty": nonempty,
                "step": clusters_body.get("step"),
                "vectors": clusters_body.get("vectors"),
                "inertia_per_vector":
                    clusters_body.get("inertia_per_vector"),
                "inertia_growth": round(inertia_growth, 4)
                if inertia_growth is not None else None,
                "resumed": clusters_body.get("resumed"),
                "resume_step": clusters_body.get("resume_step"),
                "underpopulated": clusters_body.get("underpopulated"),
            },
            "dtraces": dtrace_summary,
            "checks": checks,
        })
        if lost[:5]:
            verdict["lost_sample"] = lost[:5]
        if cluster_lost[:5]:
            verdict["cluster_lost_sample"] = cluster_lost[:5]
        return verdict
    finally:
        if controller is not None:
            _teardown("controller", controller.stop)
        _teardown("chaos-release",
                  lambda: _release_device((engine,), device))
        if cluster_handle is not None:
            _teardown("cluster-worker", cluster_handle.stop)
        if tpu_handle is not None:
            _teardown("tpu-worker", tpu_handle.stop)
        if dtraces_provider is not None:
            _teardown("dtraces-provider",
                      lambda: clear_dtraces_provider(dtraces_provider))
        if http_server is not None:
            _teardown("http-server", http_server.shutdown)
        if inner_bus is not None:
            _teardown("inmemory-bus", inner_bus.close)
        if server is not None:
            _teardown("grpc-bus", server.close)
        _teardown("device", lambda: _release_device((), device))

"""The port's command line: the device modes of the reference's CLI.

    python -m distributed_crawler_tpu_torch.cli --mode tpu-worker ...

The reference's `distributed_crawler_tpu/cli.py`, for the modes that run
on the card and the broker between processes:

- ``tpu-worker``: embed+classify RecordBatches from the bus (`TPUWorker`);
- ``asr-worker``: transcribe AudioBatchMessages (`ASRWorker`); with
  ``--infer`` each transcript re-enters the text path as a post
  (`media/bridge.TranscriptReentry` through `inference/bridge.
  InferenceBridge`), stored in the crawl's ``posts.jsonl`` and published
  on ``tpu-inference-batches`` for a ``tpu-worker``;
- ``cluster-worker``: online k-means over the result stream
  (`ClusterWorker`);
- ``transcribe``: Whisper over a tree of ``.wav`` files, one JSONL row per
  file; with ``--infer --bus-address`` the transcripts are also published
  as one RecordBatch of posts;
- ``cluster``: k-means `fit` over embedding rows, or text rows embedded on
  the fly;
- ``train-head``: fine-tune the classifier (head, LoRA or full scope) on
  a crawl's posts and labels into a port checkpoint, which ``tpu-worker
  --head-checkpoint`` serves;
- ``bus``: a dedicated gRPC broker; with ``--bus-spool-dir`` it journals
  every pull-topic frame, resumes after a crash and keeps a dead-letter
  queue, served at ``/dlq``;
- ``orchestrator``: the crawl's coordinator (`orchestrator/`): it hosts
  the broker, dispatches a BFS crawl from ``--urls``/``--url-file`` to the
  crawl workers, pauses while the serving workers' backlog is over
  ``--infer-backpressure-high``, recovers from its journal after a crash,
  and serves ``/status``, ``/cluster``, ``/dtraces``, ``/alerts`` and
  ``/tenants``; with ``--autoscaler`` it grows and shrinks a fleet of
  ``tpu-worker`` children of this CLI from the watchtower's alerts
  (`orchestrator/autoscaler.py`), served at ``/autoscaler``.  The date
  flags (``--min-post-date``, ``--time-ago``, ``--date-between``) reach
  every work item it dispatches. ``--max-crawl-duration`` resolves into
  the config as the reference's does, but this mode ignores it, as the
  reference's does (it warns when the flag is set);
- ``launch --validate-only`` (or a bare ``--validate-only``): the tandem
  crawl's validator pod (`modes/validate.py`) over the graph store on
  ``<storage-root>/graph.sqlite``, until SIGTERM (exit 130).  Without
  ``--validate-only``, ``launch`` exits 2 before any set-up: its random
  walk needs a pool from the native client (ROADMAP Queue 1 part D), its
  other samplings the crawl modes (part C).

With ``--bus-spool-dir``, a worker's publishes go through a durable
outbox under ``<spool-dir>/outbox/<worker-id>``, so a broker outage
buffers them; with ``--bus-shard-addresses`` a worker's bus is a
partitioned bus over the listed broker shards, served at ``/shards``.
With ``--object-store`` (``memory://``, ``file://``, ``s3://``,
``azure://``) the workers' results, transcripts and checkpoints go to an
object store (`state/objectstore.py`) instead of ``--storage-root``.

The flags, their ``CRAWLER_*`` environment variables and the YAML config
keys are the reference's, resolved through the same precedence (flags >
env > config file > defaults; `config/precedence.py`).  The crawler's
modes other than the orchestrator and the validator (the crawl workers,
standalone crawls, jobs and the Telegram gateway) run from the
reference's CLI; here they exit 2 and say so.  A serving mesh and multi-process serving are not ported yet: they exit 2
with a message that names where they wait in ROADMAP.md, never silently
ignored.

The engines run on the card.  ``main(..., device="cpu")`` is for
in-process callers (the tests); it is not a flag.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time
from typing import Callable, List, Optional

from .config.crawler import CrawlerConfig, generate_crawl_id
from .config.precedence import ConfigResolver
from .config.sampling import SamplingValidationInput, validate_sampling_method
from .utils.structlog import setup_logging

logger = logging.getLogger("dct.cli")

VERSION = "distributed_crawler_tpu_torch v0.1.0"
DEVICE_MODES = ("tpu-worker", "asr-worker", "cluster-worker", "transcribe",
                "cluster", "train-head", "bus", "orchestrator", "launch")
# The reference CLI's other modes: the crawler's half.
CRAWLER_MODES = ("standalone", "worker", "job", "job-submit", "dc-gateway",
                 "gen-code")
_WORKER_MODES = ("tpu-worker", "asr-worker", "cluster-worker")


def build_parser() -> argparse.ArgumentParser:
    """The device modes' flags, each as the reference declares it.
    Defaults are None so the resolver can tell "set" from "default"."""
    p = argparse.ArgumentParser(
        prog="dct-torch",
        description="distributed_crawler_tpu_torch: the crawler's device "
                    "modes (inference, ASR, clustering, the bus) on one "
                    "NVIDIA card")
    a = p.add_argument
    a("--config", default=None, help="config file (default: ./config.yaml)")
    a("--log-level", default=None, help="trace|debug|info|warn|error")
    a("--log-json", action="store_const", const=True, default=None)
    a("--mode", default=None,
      help="tpu-worker | asr-worker | cluster-worker | transcribe | "
           "cluster | train-head | bus | orchestrator | launch (the "
           "crawler's other modes run from distributed_crawler_tpu.cli)")
    a("--worker-id", default=None, help="worker identifier (worker modes)")
    # The crawl's settings, carried to the crawl workers in every work
    # item the orchestrator dispatches.
    a("--concurrency", type=int, default=None)
    a("--timeout", type=int, default=None, help="HTTP timeout seconds")
    a("--sample-size", type=int, default=None)
    a("--min-users", type=int, default=None)
    a("--max-comments", type=int, default=None)
    a("--max-depth", type=int, default=None)
    a("--max-posts", type=int, default=None)
    a("--max-pages", type=int, default=None)
    a("--min-post-date", default=None, help="YYYY-MM-DD")
    a("--time-ago", default=None, help="e.g. 30d, 6h, 2w, 1m, 1y")
    a("--max-crawl-duration", default=None, help="e.g. 48h, 24h30m")
    a("--date-between", default=None, help="YYYY-MM-DD,YYYY-MM-DD")
    a("--skip-media", action="store_const", const=True, default=None)
    a("--youtube-api-key", default=None)
    a("--sampling", default=None,
      help="channel | random | random-walk | snowball")
    a("--seed-size", type=int, default=None)
    a("--walkback-rate", type=int, default=None)
    a("--min-channel-videos", type=int, default=None)
    # The tandem crawl and its validator pod.
    a("--tandem-crawl", action="store_const", const=True, default=None)
    a("--validate-only", action="store_const", const=True, default=None)
    a("--validator-request-rate", type=float, default=None)
    a("--validator-request-jitter-ms", type=int, default=None)
    a("--validator-claim-batch-size", type=int, default=None)
    a("--validator-timeout", default=None, help="e.g. 30m")
    a("--validator-base-url", default=None,
      help="validation endpoint base (default https://t.me); point at a "
           "mirror/forward proxy")
    a("--validator-transport", default=None,
      help="t.me transport: urllib | chrome (native Chrome-shaped TLS)")
    a("--urls", default=None, help="comma-separated URLs to crawl")
    a("--url-file", default=None, help="file with one URL per line")
    a("--storage-root", default=None)
    a("--crawl-id", default=None)
    a("--crawl-label", default=None)
    a("--platform", default=None, help="telegram | youtube")
    a("--object-store", default=None,
      help="object store for the workers' results (memory:// | "
           "file:///path | s3://bucket/prefix | azure://account/container; "
           "empty = under --storage-root)")
    a("--bus-address", default=None,
      help="gRPC bus address, e.g. 127.0.0.1:50551 (needs grpcio; empty "
           "= in-process bus)")
    a("--bus-spool-dir", default=None,
      help="broker WAL spool directory: the hosted GrpcBusServer journals "
           "every pull-topic frame and dead letters here, so a restarted "
           "broker resumes where the dead one stopped; it also routes this "
           "process's publishes through a durable outbox (empty = RAM-only "
           "bus)")
    a("--bus-outbox-max-frames", type=int, default=None,
      help="bound on publishes buffered in the durable outbox while the "
           "broker is unreachable (default 1024)")
    a("--bus-shard-addresses", default=None,
      help="comma-separated gRPC addresses of the bus broker shards (one "
           "`--mode bus` process per address, each with its own "
           "--bus-spool-dir); pull-topic frames are routed by key across "
           "them and fan-out topics broadcast; a dead shard's frames park "
           "in that shard's outbox until it returns")
    a("--bus-shards", type=int, default=None,
      help="expected shard count, validated against "
           "--bus-shard-addresses")
    a("--bus-ack-timeout-s", type=float, default=None,
      help="seconds a pulled frame may stay unacked before the broker "
           "requeues it (default 300)")
    a("--bus-max-attempts", type=int, default=None,
      help="delivery attempts per frame before it is dead-lettered "
           "(default 5)")
    a("--metrics-port", type=int, default=None,
      help="serve /metrics, /healthz, /status, /costs, /logs ... on this "
           "port (0 = off)")
    a("--profiler-port", type=int, default=None,
      help="kept for the reference's configuration; torch has no "
           "attachable trace server, so a port only logs a warning")
    a("--trace-buffer", type=int, default=None,
      help="completed spans kept for /traces (0 disables; default 2048)")
    a("--slow-trace-ms", type=float, default=None,
      help="log any span slower than this many ms (0 = off)")
    a("--dump-dir", default=None,
      help="write postmortem bundles here on SIGTERM, unhandled exception "
           "or fatal signal; empty = no dumps")
    a("--flight-buffer", type=int, default=None,
      help="flight-recorder events kept for postmortem bundles "
           "(0 disables; default 512)")
    a("--telemetry-interval", type=float, default=None,
      help="seconds between heartbeats in the worker modes (default 30; "
           "clamped to 1-90)")
    a("--slo-batch-p95-ms", type=float, default=None,
      help="SLO budget on the per-batch processing p95 in ms (0 = off)")
    a("--slo-queue-wait-ms", type=float, default=None,
      help="SLO budget on the queue-wait p95 in ms (0 = off)")
    a("--slo-batch-age-ms", type=float, default=None,
      help="SLO budget on the batch-age p95 in ms (0 = off)")
    a("--profile-on-slow-ms", type=float, default=None,
      help="capture a bounded torch.profiler trace into --dump-dir when a "
           "device batch exceeds this many ms (0 = off)")
    a("--span-export-interval", type=float, default=None,
      help="seconds between span exports on the spans topic (0 = off; "
           "default 15)")
    a("--span-export-max-spans", type=int, default=None,
      help="max spans per export batch (default 512)")
    a("--span-sample-rate", type=float, default=None,
      help="fraction of traces whose spans are exported (default 1.0)")
    a("--timeseries-window", type=float, default=None,
      help="rolling time-series retention in seconds (default 900)")
    a("--timeseries-max-samples", type=int, default=None,
      help="samples kept per time series (default 512)")
    a("--alert-rules", default=None,
      help="watchtower alert rules: inline JSON list or @path/to/"
           "rules.json; each entry replaces the same-named rule of the "
           "default pack (queue_wait_burn, batch_age_burn, "
           "per_chip_goodput_collapse, dlq_growth, outbox_near_full, "
           "stale_worker)")
    a("--tenant", default=None, help="tenant label (empty = 'default')")
    a("--tenant-budgets", default=None,
      help="per-tenant error budgets: inline JSON or @path/to/"
           "budgets.json with {window_s, budgets: {tenant: {slo: "
           "allowed_breaches}}}, reported at the orchestrator's /tenants")
    # The elastic fleet (orchestrator mode): an alert-actuated autoscaler
    # that spawns and retires `--mode tpu-worker` children of this CLI on
    # the watchtower's firing alerts, flight-recorded and served at
    # /autoscaler.
    a("--autoscaler", action="store_const", const=True, default=None,
      help="run the elastic-fleet autoscaler beside the orchestrator: "
           "firing watchtower alerts scale a pool of tpu-worker child "
           "processes up, sustained headroom scales it back down "
           "(requires --bus-address so children can dial the broker)")
    a("--autoscaler-pools", default=None,
      help="full pool-policy list: inline JSON list or @path/to/"
           "pools.json (fields: pool, min_workers, max_workers, "
           "scale_up_alerts, up/down_cooldown_s, stabilization_s, "
           "trend_series/trend_slope_per_s, headroom_series/"
           "headroom_below); overrides the single-pool knobs below")
    a("--autoscaler-min", type=int, default=None,
      help="single-pool shortcut: minimum tpu-worker children "
           "(default 1)")
    a("--autoscaler-max", type=int, default=None,
      help="single-pool shortcut: maximum tpu-worker children "
           "(default 4)")
    a("--autoscaler-up-cooldown", type=float, default=None,
      help="seconds between scale-up steps (default 30)")
    a("--autoscaler-down-cooldown", type=float, default=None,
      help="seconds between scale-down steps (default 60)")
    a("--autoscaler-stabilization", type=float, default=None,
      help="seconds of sustained headroom required before any "
           "scale-down (default 30)")
    a("--autoscaler-eval-interval", type=float, default=None,
      help="seconds between autoscaler control passes (default 5)")
    a("--autoscaler-worker-args", default=None,
      help="extra CLI args appended to every spawned tpu-worker child, "
           'e.g. "--infer-model xlmr --metrics-port 0" (the bus address '
           "and a generated --worker-id are supplied automatically)")
    # The load gate (`python -m distributed_crawler_tpu_torch.loadgen`):
    # no mode reads these; they resolve through the same precedence chain
    # so a config file's `loadgen:` block pins a site's gate defaults.
    a("--loadgen-scenario", default=None,
      help="loadgen scenario: checked-in name (steady-state, "
           "kill-worker, backend-wedge) or a JSON scenario file path")
    a("--loadgen-seed", type=int, default=None,
      help="loadgen workload seed (same seed -> identical batch shapes "
           "and arrival schedule)")
    a("--loadgen-duration-s", type=float, default=None,
      help="loadgen load-phase duration in seconds")
    a("--loadgen-arrival", default=None, choices=["poisson", "ramp"],
      help="loadgen arrival process: open-loop poisson or closed-loop "
           "concurrency ramp")
    a("--loadgen-rate", type=float, default=None,
      help="loadgen offered load in batches/s (poisson arrivals)")
    a("--loadgen-platform-mix", default=None,
      help='loadgen platform weights, e.g. "telegram=0.8,youtube=0.2"')
    a("--loadgen-gate", default=None,
      help="loadgen gate-envelope overrides: inline JSON object or "
           "@path/to/gate.json (merged over the scenario's gate block)")
    a("--bus-serve", action="store_const", const=True, default=None,
      help="also host the gRPC broker at --bus-address (worker modes)")
    a("--infer", action="store_const", const=True, default=None,
      help="asr-worker and transcribe: transcripts re-enter the text "
           "path as posts on tpu-inference-batches")
    a("--infer-model", default=None, help="model registry key")
    a("--infer-backpressure-high", type=int, default=None,
      help="orchestrator pauses crawl distribution when live TPU workers' "
           "summed queue depth crosses this (0 = valve off; default 64)")
    a("--infer-backpressure-low", type=int, default=None,
      help="distribution resumes once the backlog drains below this "
           "(default 32)")
    a("--journal-dir", default=None,
      help="orchestrator crash-recovery journal directory (default: "
           "<dump-dir>/orch-journal/<crawl-id> when --dump-dir is set, "
           "else <storage-root>/<crawl-id>/orch-journal); an existing "
           "journal or persisted crawl is RESUMED, not re-seeded")
    a("--fresh", action="store_const", const=True, default=None,
      help="discard any existing crawl state + journal and re-seed")
    a("--asr-pretrained-dir", default=None,
      help="local HF Whisper checkpoint dir")
    a("--transcribe-input", default=None,
      help="dir scanned recursively for .wav media, or a single file")
    a("--transcribe-output", default=None,
      help="transcripts JSONL path (default <input>/transcripts.jsonl)")
    a("--asr-batch-size", type=int, default=None,
      help="waveform batch per device dispatch (default 8)")
    a("--asr-window-buckets", default=None,
      help="comma-separated window-count buckets of the ASR pipeline "
           "(default: powers of two up to --asr-batch-size)")
    a("--asr-max-windows-per-file", type=int, default=None,
      help="cap on 30 s windows taken from one file (0 = unbounded)")
    a("--slo-asr-batch-p95-ms", type=float, default=None,
      help="SLO budget on the ASR worker's per-group p95 in ms (0 = off)")
    a("--infer-batch-size", type=int, default=None)
    a("--mesh-data", type=int, default=None,
      help="data-parallel mesh axis (multi-card serving is not ported)")
    a("--mesh-seq", type=int, default=None,
      help="sequence-parallel mesh axis (not ported)")
    a("--mesh-tensor", type=int, default=None,
      help="tensor-parallel mesh axis (not ported)")
    a("--mesh-devices", type=int, default=None,
      help="devices the serving mesh spans (0 = one card, the only "
           "layout ported)")
    a("--infer-attention", default=None,
      help="attention dispatch: auto | flash (both the kernel on the "
           "card) | xla (the plain version: CPU only)")
    a("--infer-moe-dispatch", default=None, choices=["dense", "capacity"],
      help="Switch-MoE dispatch for MoE checkpoints")
    a("--infer-param-dtype", default=None,
      help="cast float params at engine startup (e.g. bfloat16)")
    a("--infer-quantize", default=None,
      help="quantize the projection GEMMs ('int8' | 'int8_static')")
    # Classifier fine-tune (mode=train-head): crawl JSONL + labels -> a
    # port checkpoint the engine reloads via --head-checkpoint.
    a("--train-posts", default=None,
      help="crawl posts JSONL (train-head mode)")
    a("--train-lora-rank", type=int, default=None,
      help="0 (default) fine-tunes only the classifier head on the frozen "
           "encoder; >0 additionally trains rank-N LoRA adapters on the "
           "projection GEMMs and saves the merged float checkpoint")
    a("--train-scope", default=None, choices=["head", "lora", "full"],
      help="what to train: head (frozen-encoder features, default), "
           "lora (rank from --train-lora-rank), or full (every encoder "
           "weight: AdamW+warmup+clipping, MoE aux loss, "
           "--train-grad-accum microbatching)")
    a("--train-grad-accum", type=int, default=None,
      help="gradient-accumulation microbatch count for --train-scope "
           "full (1 = off)")
    a("--train-state-dir", default=None,
      help="--train-scope full: checkpoint params+optimizer state per "
           "epoch here and RESUME from the newest epoch on restart")
    a("--train-labels", default=None,
      help='labels JSONL: {"post_uid": ..., "label": int|str} per line')
    a("--head-checkpoint", default=None,
      help="classifier checkpoint dir (written by train-head, read by "
           "tpu-worker)")
    a("--train-epochs", type=int, default=None)
    a("--train-lr", type=float, default=None)
    a("--cluster-input", default=None,
      help="JSONL rows with an 'embedding' field or text fields "
           "(embedded on the fly)")
    a("--cluster-k", type=int, default=None)
    a("--cluster-iters", type=int, default=None)
    a("--cluster-output", default=None, help="output JSON path")
    a("--cluster-serve", action="store_const", const=True, default=None,
      help="declare a clustering stage: a serving broker pull-enables the "
           "result topic, and --no-publish-embeddings is refused")
    a("--cluster-buckets", nargs="+", type=int, default=None,
      help="row-count buckets of the k-means mini-batch step "
           "(default 64 256)")
    a("--cluster-checkpoint-every", type=int, default=None,
      help="checkpoint centroids every N committed batches (default 8)")
    a("--cluster-min-fraction", type=float, default=None,
      help="under-populated below this fraction of the uniform share "
           "(default 0.5)")
    a("--no-publish-embeddings", dest="publish_embeddings",
      action="store_const", const=False, default=None,
      help="strip embeddings from published result batches")
    a("--generate-code", action="store_true",
      help="the Telegram auth bootstrap (the crawler's half)")
    a("--version", action="store_true")
    return p


# flag dest -> dotted config key, as the reference maps them.
_KEY_MAP = {
    "log_level": "logging.level",
    "log_json": "logging.json",
    "mode": "distributed.mode",
    "worker_id": "distributed.worker_id",
    "concurrency": "crawler.concurrency",
    "timeout": "crawler.timeout",
    "sample_size": "crawler.samplesize",
    "min_users": "crawler.minusers",
    "max_comments": "crawler.maxcomments",
    "max_depth": "crawler.maxdepth",
    "max_posts": "crawler.maxposts",
    "max_pages": "crawler.maxpages",
    "min_post_date": "crawler.minpostdate",
    "time_ago": "crawler.timeago",
    "max_crawl_duration": "crawler.maxcrawlduration",
    "date_between": "crawler.datebetween",
    "skip_media": "crawler.skipmedia",
    "youtube_api_key": "youtube.api_key",
    "sampling": "crawler.sampling",
    "seed_size": "crawler.seedsize",
    "walkback_rate": "crawler.walkback_rate",
    "min_channel_videos": "crawler.min_channel_videos",
    "tandem_crawl": "crawler.tandem_crawl",
    "validate_only": "crawler.validate_only",
    "validator_request_rate": "crawler.validator_request_rate",
    "validator_request_jitter_ms": "crawler.validator_request_jitter_ms",
    "validator_claim_batch_size": "crawler.validator_claim_batch_size",
    "validator_timeout": "crawler.validator_timeout",
    "validator_transport": "crawler.validator_transport",
    "validator_base_url": "crawler.validator_base_url",
    "urls": "crawler.urls",
    "url_file": "crawler.url_file",
    "alert_rules": "observability.alert_rules",
    "tenant_budgets": "observability.tenant_budgets",
    "autoscaler": "autoscaler.enabled",
    "autoscaler_pools": "autoscaler.pools",
    "autoscaler_min": "autoscaler.min_workers",
    "autoscaler_max": "autoscaler.max_workers",
    "autoscaler_up_cooldown": "autoscaler.up_cooldown_s",
    "autoscaler_down_cooldown": "autoscaler.down_cooldown_s",
    "autoscaler_stabilization": "autoscaler.stabilization_s",
    "autoscaler_eval_interval": "autoscaler.eval_interval_s",
    "autoscaler_worker_args": "autoscaler.worker_args",
    "loadgen_scenario": "loadgen.scenario",
    "loadgen_seed": "loadgen.seed",
    "loadgen_duration_s": "loadgen.duration_s",
    "loadgen_arrival": "loadgen.arrival",
    "loadgen_rate": "loadgen.rate_batches_per_s",
    "loadgen_platform_mix": "loadgen.platform_mix",
    "loadgen_gate": "loadgen.gate",
    "infer_backpressure_high": "distributed.inference_backpressure_high",
    "infer_backpressure_low": "distributed.inference_backpressure_low",
    "journal_dir": "orchestrator.journal_dir",
    "fresh": "orchestrator.fresh",
    "storage_root": "storage.root",
    "crawl_id": "crawler.crawlid",
    "crawl_label": "crawler.crawllabel",
    "platform": "crawler.platform",
    "object_store": "crawler.object_store_url",
    "bus_address": "distributed.bus_address",
    "bus_serve": "distributed.bus_serve",
    "bus_spool_dir": "bus.spool_dir",
    "bus_shards": "bus.shards",
    "bus_shard_addresses": "bus.shard_addresses",
    "bus_outbox_max_frames": "bus.outbox_max_frames",
    "bus_ack_timeout_s": "bus.ack_timeout_s",
    "bus_max_attempts": "bus.max_attempts",
    "metrics_port": "observability.metrics_port",
    "profiler_port": "observability.profiler_port",
    "trace_buffer": "observability.trace_buffer",
    "slow_trace_ms": "observability.slow_trace_ms",
    "dump_dir": "observability.dump_dir",
    "flight_buffer": "observability.flight_buffer",
    "telemetry_interval": "observability.telemetry_interval_s",
    "slo_batch_p95_ms": "observability.slo_batch_p95_ms",
    "slo_queue_wait_ms": "observability.slo_queue_wait_ms",
    "slo_batch_age_ms": "observability.slo_batch_age_ms",
    "profile_on_slow_ms": "observability.profile_on_slow_ms",
    "span_export_interval": "observability.span_export_interval_s",
    "span_export_max_spans": "observability.span_export_max_spans",
    "span_sample_rate": "observability.span_sample_rate",
    "timeseries_window": "observability.timeseries_window_s",
    "timeseries_max_samples": "observability.timeseries_max_samples",
    "tenant": "crawler.tenant",
    "infer": "inference.enabled",
    "infer_model": "inference.model",
    "infer_batch_size": "inference.batch_size",
    "mesh_data": "parallel.data",
    "mesh_seq": "parallel.seq",
    "mesh_tensor": "parallel.tensor",
    "mesh_devices": "parallel.devices",
    "infer_attention": "inference.attention",
    "infer_moe_dispatch": "inference.moe_dispatch",
    "infer_param_dtype": "inference.param_dtype",
    "infer_quantize": "inference.quantize",
    "asr_pretrained_dir": "inference.asr_pretrained_dir",
    "transcribe_input": "transcribe.input",
    "transcribe_output": "transcribe.output",
    "asr_batch_size": "inference.asr_batch_size",
    "asr_window_buckets": "media.window_buckets",
    "asr_max_windows_per_file": "media.max_windows_per_file",
    "slo_asr_batch_p95_ms": "observability.slo_asr_batch_p95_ms",
    "train_posts": "train.posts_file",
    "train_labels": "train.labels_file",
    "train_lora_rank": "train.lora_rank",
    "train_scope": "train.scope",
    "train_grad_accum": "train.grad_accum_steps",
    "train_state_dir": "train.state_dir",
    "head_checkpoint": "train.checkpoint_dir",
    "train_epochs": "train.epochs",
    "train_lr": "train.learning_rate",
    "cluster_input": "cluster.input_file",
    "cluster_k": "cluster.k",
    "cluster_iters": "cluster.iters",
    "cluster_output": "cluster.output_file",
    "cluster_serve": "cluster.enabled",
    "cluster_buckets": "cluster.buckets",
    "cluster_checkpoint_every": "cluster.checkpoint_every_batches",
    "cluster_min_fraction": "cluster.min_cluster_fraction",
    "publish_embeddings": "inference.publish_embeddings",
}


class CliConfigError(ValueError):
    """A user-fixable configuration error raised by a mode runner; main()
    reports it as ``error: ...`` with exit code 2 instead of a traceback.
    Distinct from ValueError so real programming errors deep in the
    serving stack keep their tracebacks."""


def resolve_config(args: argparse.Namespace,
                   env=None) -> "tuple[CrawlerConfig, ConfigResolver]":
    """Apply the precedence chain and build the device modes' half of the
    reference's `CrawlerConfig`."""
    flags = {key: getattr(args, dest) for dest, key in _KEY_MAP.items()}
    r = ConfigResolver(flags=flags, env=env, config_file=args.config)

    cfg = CrawlerConfig()
    cfg.concurrency = r.get_int("crawler.concurrency", 1)
    cfg.timeout = r.get_int("crawler.timeout", 30)
    cfg.sample_size = r.get_int("crawler.samplesize", 0)
    cfg.min_users = r.get_int("crawler.minusers", 100)
    cfg.max_comments = r.get_int("crawler.maxcomments", -1)
    cfg.max_depth = r.get_int("crawler.maxdepth", -1)
    cfg.max_posts = r.get_int("crawler.maxposts", -1)
    cfg.max_pages = r.get_int("crawler.maxpages", 108000)
    cfg.skip_media_download = r.get_bool("crawler.skipmedia", False)
    cfg.youtube_api_key = r.get_str("youtube.api_key")
    cfg.sampling_method = r.get_str("crawler.sampling", "channel")
    cfg.seed_size = r.get_int("crawler.seedsize", 0)
    cfg.walkback_rate = r.get_int("crawler.walkback_rate", 15)
    cfg.min_channel_videos = r.get_int("crawler.min_channel_videos", 10)
    cfg.tandem_crawl = r.get_bool("crawler.tandem_crawl", False)
    cfg.validate_only = r.get_bool("crawler.validate_only", False)
    cfg.validator_request_rate = r.get_float(
        "crawler.validator_request_rate", 6.0)
    cfg.validator_request_jitter_ms = r.get_int(
        "crawler.validator_request_jitter_ms", 200)
    cfg.validator_claim_batch_size = r.get_int(
        "crawler.validator_claim_batch_size", 10)
    cfg.validator_transport = r.get_str(
        "crawler.validator_transport", "urllib")
    cfg.validator_base_url = r.get_str(
        "crawler.validator_base_url", "https://t.me")
    cfg.storage_root = r.get_str("storage.root", "/tmp/crawl")
    cfg.crawl_id = r.get_str("crawler.crawlid") or generate_crawl_id()
    cfg.crawl_label = r.get_str("crawler.crawllabel")
    cfg.tenant = r.get_str("crawler.tenant")
    cfg.platform = r.get_str("crawler.platform", "telegram")
    cfg.object_store_url = r.get_str("crawler.object_store_url", "")
    inf = cfg.inference
    inf.enabled = r.get_bool("inference.enabled", False)
    model = r.get_str("inference.model")
    if model:
        inf.embed_model = model
    batch = r.get_int("inference.batch_size", 0)
    if batch:
        inf.batch_size = batch
    buckets = r.get_list("inference.bucket_sizes")
    if buckets:
        inf.bucket_sizes = [int(b) for b in buckets]
    inf.mesh_data = r.get_int("parallel.data", 0)
    inf.mesh_seq = r.get_int("parallel.seq", 1)
    inf.mesh_tensor = r.get_int("parallel.tensor", 1)
    inf.mesh_devices = r.get_int("parallel.devices", 0)
    inf.param_dtype = r.get_str("inference.param_dtype", "")
    inf.quantize = r.get_str("inference.quantize", "")
    inf.attention = r.get_str("inference.attention", "")
    inf.moe_dispatch = r.get_str("inference.moe_dispatch", "")
    inf.pretrained_dir = r.get_str("inference.pretrained_dir",
                                   inf.pretrained_dir)
    inf.asr_pretrained_dir = r.get_str("inference.asr_pretrained_dir",
                                       inf.asr_pretrained_dir)
    media = cfg.media
    media.enabled = r.get_bool("media.enabled", False)
    media.batch_size = r.get_int("media.batch_size", media.batch_size)
    media.batch_deadline_ms = r.get_int("media.batch_deadline_ms",
                                        media.batch_deadline_ms)
    media.window_buckets = [int(b) for b in
                            r.get_list("media.window_buckets")]
    media.max_windows_per_file = r.get_int("media.max_windows_per_file",
                                           media.max_windows_per_file)
    media.coalesce_batches = r.get_int("media.coalesce_batches",
                                       media.coalesce_batches)
    _resolve_dates(cfg, r)
    return cfg, r


def _resolve_dates(cfg: CrawlerConfig, r: ConfigResolver) -> None:
    """The crawl's date window and duration, as the reference resolves
    them: date-between wins over time-ago, which wins over min-post-date.
    A malformed value raises ValueError (exit 2)."""
    from .utils.timeparse import (
        parse_date_between,
        parse_duration,
        parse_time_ago,
    )

    date_between = r.get_str("crawler.datebetween")
    time_ago = r.get_str("crawler.timeago")
    min_post_date = r.get_str("crawler.minpostdate")
    if date_between:
        cfg.date_between_min, cfg.date_between_max = \
            parse_date_between(date_between)
    elif time_ago:
        cfg.post_recency = parse_time_ago(time_ago)
    elif min_post_date:
        from datetime import datetime, timezone

        cfg.min_post_date = datetime.strptime(
            min_post_date, "%Y-%m-%d").replace(tzinfo=timezone.utc)
    duration = r.get_str("crawler.maxcrawlduration")
    if duration:
        cfg.max_crawl_duration_s = parse_duration(duration)
    vtimeout = r.get_str("crawler.validator_timeout")
    if vtimeout:
        cfg.validator_timeout_s = parse_duration(vtimeout)


def main(argv: Optional[List[str]] = None, env=None,
         device=None) -> int:
    """Run one mode; returns the process exit code.  ``device`` is for
    in-process callers (``"cpu"`` in the tests); None is the card."""
    args = build_parser().parse_args(argv)
    if args.version:
        print(VERSION)
        return 0
    if args.generate_code:
        args.mode = "gen-code"
    try:
        cfg, r = resolve_config(args, env=env)
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    mode = r.get_str("distributed.mode", "")
    if cfg.validate_only and mode in ("", "standalone", "launch"):
        # The validator pod is a branch of the launch router: a bare
        # --validate-only runs it, not a crawl of no URLs.
        mode = "launch"
    if mode not in DEVICE_MODES:
        print(f"error: {_not_a_device_mode(mode)}", file=sys.stderr)
        return 2
    if mode == "launch" and not cfg.validate_only:
        print(f"error: {_launch_waits(cfg)}", file=sys.stderr)
        return 2
    setup_logging(r.get_str("logging.level", "info"),
                  json_output=r.get_bool("logging.json", False))
    from .utils import flight, profiling, timeseries, trace

    trace.configure(
        capacity=r.get_int("observability.trace_buffer", 2048),
        slow_span_s=r.get_float("observability.slow_trace_ms", 0.0) / 1000.0)
    # Flight recorder: ring size and config fingerprint always; the crash
    # hooks arm only with a dump dir.
    flight.configure(
        capacity=r.get_int("observability.flight_buffer", 512),
        fingerprint={"mode": mode,
                     "worker_id": r.get_str("distributed.worker_id"),
                     "platform": cfg.platform,
                     "crawl_id": cfg.crawl_id,
                     "bus_address": r.get_str("distributed.bus_address")})
    dump_dir = r.get_str("observability.dump_dir", "")
    if dump_dir:
        flight.install(dump_dir)
    timeseries.configure(
        max_samples=r.get_int("observability.timeseries_max_samples", 512),
        window_s=r.get_float("observability.timeseries_window_s", 900.0))
    # /profile captures land next to the postmortem bundles.
    profiling.configure(dump_dir=dump_dir)
    # The serving workers' own start() owns the metrics port; the other
    # modes serve it here.
    if mode not in _WORKER_MODES:
        metrics_port = r.get_int("observability.metrics_port", 0)
        if metrics_port:
            from .utils.metrics import serve_metrics

            serve_metrics(metrics_port)
        profiler_port = r.get_int("observability.profiler_port", 0)
        if profiler_port:
            profiling.start_profiler_server(profiler_port)
    logger.info("starting", extra={"mode": mode, "platform": cfg.platform})
    try:
        if mode == "tpu-worker":
            _run_tpu_worker(cfg, r, device=device)
        elif mode == "asr-worker":
            _run_asr_worker(cfg, r, device=device)
        elif mode == "cluster-worker":
            _run_cluster_worker(cfg, r, device=device)
        elif mode == "transcribe":
            return _run_transcribe(cfg, r, device=device)
        elif mode == "cluster":
            return _run_cluster(cfg, r, device=device)
        elif mode == "train-head":
            return _run_train_head(cfg, r, device=device)
        elif mode == "orchestrator":
            _run_orchestrator(collect_urls(r), cfg, r)
        elif mode == "launch":
            _run_launch(collect_urls(r), cfg)
        else:
            return _run_bus(r)
    except CliConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        logger.info("interrupted, shutting down")
        return 130
    return 0


def _not_a_device_mode(mode: str) -> str:
    if mode in CRAWLER_MODES or not mode:
        return (f"--mode {mode or 'standalone'} runs from "
                f"distributed_crawler_tpu.cli (the JAX package's CLI); "
                f"this CLI runs the modes {', '.join(DEVICE_MODES)}")
    return f"unknown execution mode: {mode}"


def _launch_waits(cfg: CrawlerConfig) -> str:
    """Why ``--mode launch`` without ``--validate-only`` exits 2: the
    crawl has no pool to crawl with until the native client, and the
    other samplings run in the crawl modes."""
    if cfg.sampling_method == "random-walk":
        return ("--mode launch runs a random walk on a connection pool from "
                "the native Telegram client (clients/native.py), which the "
                "port has not ported yet (ROADMAP Queue 1 part D); "
                "--validate-only runs the validator pod")
    return (f"--mode launch with {cfg.sampling_method} sampling runs in the "
            f"crawl modes, which the port has not ported yet (ROADMAP "
            f"Queue 1 part C); --validate-only runs the validator pod")


def _run_launch(urls: List[str], cfg: CrawlerConfig) -> None:
    """mode=launch with --validate-only: the validator pod over the
    factory's manager on ``<storage-root>/graph.sqlite``, until SIGTERM
    or ^C (exit 130)."""
    from .modes.common import create_state_manager, determine_crawl_id
    from .modes.runner import launch

    exec_id, _ = determine_crawl_id(create_state_manager(cfg), cfg)
    sm = create_state_manager(cfg, exec_id)
    with _sigterm_as_interrupt():
        launch(urls, cfg, sm=sm)


def _heartbeat_interval(r: ConfigResolver) -> float:
    """The heartbeat period, clamped to 1-90 s: heartbeats are the
    liveness signal, and a period past the orchestrator's 300 s timeout
    would flap healthy workers offline."""
    interval = r.get_float("observability.telemetry_interval_s", 30.0)
    clamped = min(max(interval, 1.0), 90.0)
    if clamped != interval:
        logger.warning(
            "telemetry interval %.0fs clamped to %.0fs (heartbeats are "
            "the liveness signal; the orchestrator offlines workers "
            "silent past worker_timeout_s)", interval, clamped)
    return clamped


@contextlib.contextmanager
def _sigterm_as_interrupt():
    """SIGTERM becomes KeyboardInterrupt inside the block, so a
    supervisor's stop takes the same graceful path as ^C; with a dump dir
    the flight recorder writes its postmortem bundle first (the teardown
    may hang).  Off the main thread the handler cannot be installed, and
    the block runs without it."""
    import signal

    from .utils import flight

    def _term(_sig, _frm):
        flight.dump("sigterm")  # no-op without a dump dir
        raise KeyboardInterrupt

    prev = None
    installed = False
    try:
        prev = signal.signal(signal.SIGTERM, _term)
        installed = True  # prev may be None: restore keys on installation
    except ValueError:
        pass  # not the main thread
    try:
        yield
    finally:
        if installed:
            try:
                signal.signal(signal.SIGTERM,
                              prev if prev is not None else signal.SIG_DFL)
            except ValueError:
                pass


def _serve_forever(poll_s: float = 1.0,
                   running: Optional[Callable[[], bool]] = None) -> None:
    """Block the main thread while a service's threads run; ``running``
    ends the loop when it turns False.  SIGTERM is ^C meanwhile
    (`_sigterm_as_interrupt`)."""
    with _sigterm_as_interrupt():
        while running is None or running():
            time.sleep(poll_s)


# -- what waits -------------------------------------------------------------

def _refuse_mesh(cfg: CrawlerConfig) -> None:
    """The serving mesh flags, validated as the reference validates them:
    at their defaults serving is one card, the only layout the port has;
    any other layout waits for ROADMAP item 9."""
    inf = cfg.inference
    data, seq, tensor, devices = (inf.mesh_data, inf.mesh_seq,
                                  inf.mesh_tensor, inf.mesh_devices)
    if devices < -1:
        raise CliConfigError(
            f"--mesh-devices must be -1 (all), 0 (off) or a positive "
            f"count, got {devices}")
    if data < 0:
        raise CliConfigError(f"--mesh-data must be >= 0 (0 = auto), "
                             f"got {data}")
    for name, v in (("--mesh-seq", seq), ("--mesh-tensor", tensor)):
        if v < 1:
            raise CliConfigError(f"{name} must be >= 1, got {v}")
    if (data, seq, tensor, devices) != (0, 1, 1, 0):
        raise CliConfigError(
            f"a serving mesh (--mesh-data {data}, --mesh-seq {seq}, "
            f"--mesh-tensor {tensor}, --mesh-devices {devices}) waits for "
            f"ROADMAP item 9 (parallel/ on torch.distributed); the port "
            f"serves on one card with every mesh flag at its default")


def _refuse_multihost() -> None:
    """``DCT_COORDINATOR`` / ``DCT_NUM_PROCESSES`` / ``DCT_PROCESS_ID``
    ask for a multi-process run, which waits for ROADMAP item 9."""
    env = os.environ
    coordinator = env.get("DCT_COORDINATOR", "").strip()
    processes = env.get("DCT_NUM_PROCESSES", "").strip() or "1"
    process_id = env.get("DCT_PROCESS_ID", "").strip() or "0"
    if coordinator or processes != "1" or process_id != "0":
        raise CliConfigError(
            f"multi-process serving (DCT_COORDINATOR={coordinator!r}, "
            f"DCT_NUM_PROCESSES={processes}, DCT_PROCESS_ID={process_id}) "
            f"waits for ROADMAP item 9 (parallel/ on torch.distributed); "
            f"unset them to serve on one card")


def _make_provider(cfg: CrawlerConfig):
    """The workers' results sink: the object store with
    ``--object-store``, else JSONL under the storage root.  A URL the
    store refuses (a scheme without a client, missing credentials) is a
    configuration error: exit 2 before any engine is built."""
    if cfg.object_store_url:
        from .state.objectstore import (
            ObjectStorageProvider,
            make_object_client,
        )

        try:
            return ObjectStorageProvider(
                make_object_client(cfg.object_store_url))
        except ValueError as e:
            raise CliConfigError(str(e)) from None
    from .state.providers import LocalStorageProvider

    return LocalStorageProvider(cfg.storage_root)


# -- the bus ----------------------------------------------------------------

def _bus_outbox_config(r: ConfigResolver, who: str):
    """The durable-outbox config for one publisher, or None when bus
    durability is off (``bus.spool_dir`` empty).  The spill WAL lands under
    ``<spool-dir>/outbox/<who>``: a path per publisher, so co-hosted
    publishers never share a WAL."""
    spool_dir = r.get_str("bus.spool_dir", "")
    if not spool_dir:
        return None
    from .bus.outbox import OutboxConfig

    return OutboxConfig(
        dir=os.path.join(spool_dir, "outbox", who or "client"),
        max_frames=r.get_int("bus.outbox_max_frames", 1024))


def _parse_shard_addresses(r: ConfigResolver) -> List[str]:
    """The shard list from ``bus.shard_addresses`` (a comma string from
    --bus-shard-addresses, or a YAML list).  A declared ``bus.shards``
    must match it (a truncated list would silently re-deal the hash ring),
    and duplicate addresses are refused (two shards sharing one broker and
    its WAL spool would cross-contaminate crash recovery)."""
    raw = r.get("bus.shard_addresses")
    if isinstance(raw, str):
        addrs = [a.strip() for a in raw.split(",") if a.strip()]
    elif isinstance(raw, (list, tuple)):
        addrs = [str(a).strip() for a in raw if str(a).strip()]
    else:
        addrs = []
    declared = r.get_int("bus.shards", 0)
    if declared > 1 and not addrs:
        raise CliConfigError(
            "--bus-shards needs --bus-shard-addresses (one gRPC address "
            "per broker shard)")
    if not addrs:
        return []
    if declared and declared != len(addrs):
        raise CliConfigError(
            f"--bus-shards={declared} but --bus-shard-addresses names "
            f"{len(addrs)} shard(s) — a mismatched list would re-deal "
            f"the consistent-hash ring; fix one of them")
    if len(set(addrs)) != len(addrs):
        raise CliConfigError(
            f"duplicate addresses in --bus-shard-addresses {addrs!r}: "
            f"two shards sharing one broker (and its WAL spool) would "
            f"cross-contaminate each other's crash recovery")
    return addrs


def _require_grpc() -> None:
    try:
        import grpc  # noqa: F401
    except ImportError:
        raise CliConfigError(
            "--bus-address needs the grpcio package ('import grpc' "
            "failed); install grpcio, or run without --bus-address on the "
            "in-process bus") from None


def _make_bus(r: ConfigResolver, serve: bool = False):
    """No ``--bus-address``: the in-process bus.  With one: a hosted
    `GrpcBusServer` (``serve``) with the work topics pull-enabled, or a
    `RemoteBus` client.  With ``bus.spool_dir`` the broker journals its
    pull topics and dead letters, and a client's publishes ride a durable
    outbox.  With ``bus.shard_addresses`` the client is a `PartitionedBus`
    over every shard (a process serves one shard at most) and serves the
    ``/shards`` table."""
    shard_addrs = _parse_shard_addresses(r)
    if shard_addrs and serve:
        raise CliConfigError(
            "--bus-serve (and --mode bus) host ONE broker shard per "
            "process: run one --mode bus process per shard address, each "
            "with its OWN --bus-spool-dir, and point clients at "
            "--bus-shard-addresses")
    if shard_addrs and r.get_str("distributed.bus_address"):
        raise CliConfigError(
            "--bus-address and --bus-shard-addresses are mutually "
            "exclusive: pass the single broker OR the shard list, "
            "not both")
    who = r.get_str("distributed.worker_id") \
        or r.get_str("distributed.mode") or "client"
    if shard_addrs:
        return _make_partitioned_bus(r, shard_addrs, who)
    address = r.get_str("distributed.bus_address")
    if not address:
        if r.get_str("bus.spool_dir", ""):
            # Only the gRPC broker journals; say so rather than let the
            # operator believe frames survive a restart.
            logger.warning(
                "bus.spool_dir is set but distributed.bus_address is "
                "empty: the in-process bus has no spool/outbox/DLQ — "
                "bus durability is INACTIVE")
        from .bus.inmemory import InMemoryBus

        bus = InMemoryBus(sync=False)
        bus.start()
        return bus
    _require_grpc()
    if not serve:
        from .bus.grpc_bus import RemoteBus

        return RemoteBus(address, outbox=_bus_outbox_config(r, who))
    from .bus.grpc_bus import GrpcBusServer
    from .bus.messages import (
        TOPIC_INFERENCE_BATCHES,
        TOPIC_INFERENCE_RESULTS,
        TOPIC_JOBS,
        TOPIC_MEDIA_BATCHES,
        TOPIC_WORK_QUEUE,
    )

    server = GrpcBusServer(
        address, ack_timeout_s=r.get_float("bus.ack_timeout_s", 300.0),
        max_attempts=r.get_int("bus.max_attempts", 5),
        spool_dir=r.get_str("bus.spool_dir", "") or None)
    # Pull (competing-consumer) topics are enabled up front so frames
    # published before the first consumer are queued, not dropped.
    # Fan-out topics stay local dispatch.
    for topic in (TOPIC_WORK_QUEUE, TOPIC_INFERENCE_BATCHES,
                  TOPIC_MEDIA_BATCHES, TOPIC_JOBS):
        server.enable_pull(topic)
    if r.get_bool("cluster.enabled", False) \
            or r.get_str("distributed.mode", "") == "cluster-worker":
        # A clustering stage is attached: the result stream becomes a pull
        # topic, so a dead cluster worker's unacked frames requeue.
        server.enable_pull(TOPIC_INFERENCE_RESULTS)
    server.start()
    return server


def _make_partitioned_bus(r: ConfigResolver, shard_addrs: List[str],
                          who: str):
    """A `PartitionedBus` of `RemoteBus` clients, one per shard, with a
    durable outbox per shard under ``<spool-dir>/outbox/<who>/<shard>``
    when bus durability is on; its table is served at ``/shards``."""
    import dataclasses

    _require_grpc()
    from .bus.grpc_bus import RemoteBus
    from .bus.partition import PartitionedBus, ShardMap, default_shard_ids
    from .utils.metrics import set_shards_provider

    sids = default_shard_ids(len(shard_addrs))
    base = _bus_outbox_config(r, who)
    shard_outbox = None
    if base is not None:
        def shard_outbox(sid):
            return dataclasses.replace(base, dir=os.path.join(base.dir, sid))
    logger.info("partitioned bus: %d shard(s) %s (durable outboxes: %s)",
                len(shard_addrs), shard_addrs,
                "on" if base is not None else "off")
    bus = PartitionedBus({sid: RemoteBus(addr)
                          for sid, addr in zip(sids, shard_addrs)},
                         ShardMap(sids), outbox=shard_outbox, name=who)
    set_shards_provider(bus.snapshot)
    return bus


def _make_serving_bus(r: ConfigResolver) -> "_ServingBus":
    """Broker + loopback consumer for a ``--bus-serve`` process; the
    consumer goes through `_make_bus` too, so it gets the durable outbox
    when bus durability is on."""
    server = _make_bus(r, serve=True)
    return _ServingBus(server, _make_bus(r))


class _ServingBus:
    """A `GrpcBusServer` plus a loopback `RemoteBus`: one process hosts the
    broker and consumes from it.  The bus calls go to the client; close()
    closes the client, then the server."""

    def __init__(self, server, client):
        self._server = server
        self._client = client

    def publish(self, topic, payload):
        self._client.publish(topic, payload)

    def subscribe(self, topic, handler):
        self._client.subscribe(topic, handler)

    def close(self):
        try:
            self._client.close()
        finally:
            self._server.close()


def _worker_bus(r: ConfigResolver):
    serve = r.get_bool("distributed.bus_serve", False)
    return _make_serving_bus(r) if serve else _make_bus(r)


def _check_serve_address(r: ConfigResolver) -> None:
    # Before any engine is built: a missing address fails in milliseconds.
    if r.get_bool("distributed.bus_serve", False) \
            and not r.get_str("distributed.bus_address"):
        raise CliConfigError("--bus-serve requires --bus-address")


# -- engines and workers ----------------------------------------------------

def _engine_config(cfg: CrawlerConfig, r: ConfigResolver,
                   n_labels: Optional[int] = None,
                   with_checkpoint: bool = False, cast_params: bool = True):
    """The `EngineConfig` of the device modes: ``cast_params=False``
    (train-head) ignores ``inference.param_dtype``, ``quantize``,
    ``attention`` and ``moe_dispatch``, so the trainer starts from, and
    saves, full-precision weights even when the same config serves bf16
    or int8."""
    from .inference.engine import EngineConfig

    inf = cfg.inference
    kw = dict(
        model=inf.embed_model.replace("-", "_"),
        batch_size=inf.batch_size,
        buckets=tuple(inf.bucket_sizes),
        pretrained_dir=inf.pretrained_dir or None)
    if cast_params:
        kw.update(param_dtype=inf.param_dtype or None,
                  quantize=inf.quantize or None,
                  attention=inf.attention or None,
                  moe_dispatch=inf.moe_dispatch or None)
    if n_labels is not None:
        kw["n_labels"] = n_labels
    if with_checkpoint:
        kw["checkpoint_dir"] = r.get_str("train.checkpoint_dir") or None
    return EngineConfig(**kw)


def _train_weights(cfg: CrawlerConfig, r: ConfigResolver, n_labels: int,
                   device=None):
    """train-head's starting point, ``(encoder config, f32 params,
    tokenizer, device)``: the engine's weights in f32, without building
    its model (the trainer builds its own, plain-attention where it
    differentiates)."""
    from .inference.engine import training_weights

    return training_weights(_engine_config(cfg, r, n_labels=n_labels,
                                           cast_params=False),
                            device=device)


def _make_engine(cfg: CrawlerConfig, r: ConfigResolver,
                 n_labels: Optional[int] = None,
                 with_checkpoint: bool = False, with_mesh: bool = False,
                 device=None):
    """One engine-wiring path for tpu-worker and cluster."""
    from .inference.engine import InferenceEngine

    if with_mesh:
        _refuse_mesh(cfg)
    inf = cfg.inference
    try:
        return InferenceEngine(
            _engine_config(cfg, r, n_labels, with_checkpoint),
            device=device)
    except ValueError as e:
        if inf.attention != "xla":
            raise
        raise CliConfigError(
            f"--infer-attention xla: {e} (a deliberate difference from "
            f"the reference, ROADMAP Queue 3); serve with '' or "
            f"'flash'") from None


def _build_tpu_worker(cfg: CrawlerConfig, r: ConfigResolver, device=None):
    """The text worker: engine, results sink, then the bus."""
    from .inference.worker import TPUWorker, TPUWorkerConfig

    _check_serve_address(r)
    if r.get_bool("cluster.enabled", False) \
            and not r.get_bool("inference.publish_embeddings", True):
        raise CliConfigError(
            "--cluster-serve (cluster.enabled) requires embedding-"
            "carrying result batches; drop --no-publish-embeddings")
    provider = _make_provider(cfg)
    engine = _make_engine(cfg, r, with_checkpoint=True, with_mesh=True,
                          device=device)
    bus = _worker_bus(r)
    return TPUWorker(bus, engine, provider=provider, cfg=TPUWorkerConfig(
        worker_id=r.get_str("distributed.worker_id") or "tpu-worker-0",
        publish_embeddings=r.get_bool("inference.publish_embeddings", True),
        heartbeat_s=_heartbeat_interval(r),
        metrics_port=r.get_int("observability.metrics_port", 0),
        profiler_port=r.get_int("observability.profiler_port", 0),
        stall_warn_s=r.get_float("inference.stall_warn_s", 120.0),
        stall_exit_s=r.get_float("inference.stall_exit_s", 0.0),
        slo_batch_p95_ms=r.get_float("observability.slo_batch_p95_ms", 0.0),
        slo_queue_wait_ms=r.get_float("observability.slo_queue_wait_ms",
                                      0.0),
        slo_batch_age_ms=r.get_float("observability.slo_batch_age_ms", 0.0),
        profile_on_slow_ms=r.get_float("observability.profile_on_slow_ms",
                                       0.0),
        span_export_interval_s=r.get_float(
            "observability.span_export_interval_s", 15.0),
        span_export_max_spans=r.get_int(
            "observability.span_export_max_spans", 512),
        span_sample_rate=r.get_float("observability.span_sample_rate",
                                     1.0)))


def _make_pipeline(cfg: CrawlerConfig, r: ConfigResolver, device=None):
    from .inference.asr import ASRPipeline

    pipeline = ASRPipeline.from_pretrained(
        cfg.inference.asr_pretrained_dir,
        batch_size=r.get_int("inference.asr_batch_size", 8),
        window_buckets=cfg.media.window_buckets or None, device=device)
    if cfg.media.max_windows_per_file:
        pipeline.chunker.max_windows_per_file = \
            cfg.media.max_windows_per_file
    return pipeline


def _build_asr_worker(cfg: CrawlerConfig, r: ConfigResolver, device=None):
    """The ASR worker: Whisper pipeline, transcript sink, then the bus.
    Returns ``(worker, bridge)``: with ``--infer`` the `InferenceBridge`
    that carries its transcripts back into the text path, else None."""
    from .media.worker import ASRWorker, ASRWorkerConfig

    _check_serve_address(r)
    if not cfg.inference.asr_pretrained_dir:
        raise CliConfigError("asr-worker mode requires --asr-pretrained-dir")
    provider = _make_provider(cfg)
    pipeline = _make_pipeline(cfg, r, device=device)
    bus = _worker_bus(r)
    worker = ASRWorker(bus, pipeline, provider=provider, cfg=ASRWorkerConfig(
        worker_id=r.get_str("distributed.worker_id") or "asr-worker-0",
        heartbeat_s=_heartbeat_interval(r),
        metrics_port=r.get_int("observability.metrics_port", 0),
        coalesce_batches=cfg.media.coalesce_batches,
        slo_asr_batch_p95_ms=r.get_float(
            "observability.slo_asr_batch_p95_ms", 0.0),
        slo_queue_wait_ms=r.get_float("observability.slo_queue_wait_ms",
                                      0.0),
        slo_batch_age_ms=r.get_float("observability.slo_batch_age_ms", 0.0),
        span_export_interval_s=r.get_float(
            "observability.span_export_interval_s", 15.0),
        span_export_max_spans=r.get_int(
            "observability.span_export_max_spans", 512),
        span_sample_rate=r.get_float("observability.span_sample_rate",
                                     1.0)))
    bridge = None
    if cfg.inference.enabled:
        # The loop closes in this process: each transcript is stored in the
        # crawl's post sink as the post ``media:<media_id>`` and ships once
        # to the text worker on the worker's own bus.
        from .inference.bridge import InferenceBridge
        from .media.bridge import TranscriptReentry
        from .modes.common import create_state_manager

        bridge = InferenceBridge(
            create_state_manager(cfg), worker.bus, crawl_id=cfg.crawl_id,
            batch_size=cfg.inference.batch_size,
            deadline_s=cfg.inference.batch_deadline_ms / 1000.0)
        TranscriptReentry(bridge, worker.bus)
    return worker, bridge


def _build_cluster_worker(cfg: CrawlerConfig, r: ConfigResolver,
                          device=None):
    """The streaming clustering worker: engine, assignment sink, then the
    bus."""
    from .cluster.engine import ClusterEngine, ClusterEngineConfig
    from .cluster.worker import ClusterWorker, ClusterWorkerConfig

    _check_serve_address(r)
    _refuse_mesh(cfg)
    provider = _make_provider(cfg)
    k = r.get_int("cluster.k", 16)
    buckets = tuple(int(b) for b in r.get_list("cluster.buckets")) \
        or (64, 256)
    engine = ClusterEngine(ClusterEngineConfig(k=k, buckets=buckets),
                           device=device)
    bus = _worker_bus(r)
    return ClusterWorker(bus, engine=engine, provider=provider,
                         cfg=ClusterWorkerConfig(
        worker_id=r.get_str("distributed.worker_id") or "cluster-worker-0",
        heartbeat_s=_heartbeat_interval(r),
        metrics_port=r.get_int("observability.metrics_port", 0),
        k=k,
        buckets=buckets,
        checkpoint_every_batches=r.get_int(
            "cluster.checkpoint_every_batches", 8),
        min_cluster_fraction=r.get_float("cluster.min_cluster_fraction",
                                         0.5),
        slo_batch_p95_ms=r.get_float("observability.slo_batch_p95_ms", 0.0),
        slo_queue_wait_ms=r.get_float("observability.slo_queue_wait_ms",
                                      0.0),
        slo_batch_age_ms=r.get_float("observability.slo_batch_age_ms", 0.0),
        span_export_interval_s=r.get_float(
            "observability.span_export_interval_s", 15.0),
        span_export_max_spans=r.get_int(
            "observability.span_export_max_spans", 512),
        span_sample_rate=r.get_float("observability.span_sample_rate",
                                     1.0)))


def _serve_worker(worker, bridge=None) -> None:
    """Warm up, serve until interrupted, then stop the worker, close the
    re-entry ``bridge`` (shipping its last batch) and then the bus (serve
    mode: the loopback client, then the broker)."""
    t0 = time.perf_counter()
    worker.warmup()
    logger.info("warmup done", extra={
        "warmup_s": round(time.perf_counter() - t0, 3)})
    worker.start()
    try:
        _serve_forever()
    finally:
        worker.stop()
        if bridge is not None:
            try:
                bridge.close()
            except Exception as e:
                logger.warning("reentry bridge close failed: %s", e)
        try:
            worker.bus.close()
        except Exception as e:
            logger.warning("bus close failed: %s", e)


def _run_tpu_worker(cfg: CrawlerConfig, r: ConfigResolver,
                    device=None) -> None:
    """mode=tpu-worker: RecordBatches in, embeddings and labels out."""
    _refuse_multihost()
    cache_dir = r.get_str("inference.compilation_cache_dir", "")
    if cache_dir:
        logger.warning(
            "inference.compilation_cache_dir=%s ignored: the port compiles "
            "no XLA programs; its kernels are cached in their build "
            "directory (distributed_crawler_tpu_torch/_build)", cache_dir)
    _serve_worker(_build_tpu_worker(cfg, r, device=device))


def _run_asr_worker(cfg: CrawlerConfig, r: ConfigResolver,
                    device=None) -> None:
    """mode=asr-worker: AudioBatchMessages in, transcripts out; with
    ``--infer`` the transcripts re-enter the text path."""
    _serve_worker(*_build_asr_worker(cfg, r, device=device))


def _run_cluster_worker(cfg: CrawlerConfig, r: ConfigResolver,
                        device=None) -> None:
    """mode=cluster-worker: embedding-carrying result batches in, cluster
    assignments out; a restart resumes from the last checkpoint."""
    _serve_worker(_build_cluster_worker(cfg, r, device=device))


def _run_bus(r: ConfigResolver) -> int:
    """mode=bus: a dedicated broker process."""
    if not r.get_str("distributed.bus_address"):
        print("error: bus mode requires --bus-address", file=sys.stderr)
        return 2
    bus = _make_bus(r, serve=True)
    if r.get_str("bus.spool_dir", ""):
        # A durable broker serves its dead-letter queue on the metrics
        # port (`python -m distributed_crawler_tpu_torch.bus.dlq --url`).
        from .utils.metrics import set_dlq_provider

        set_dlq_provider(bus.dlq_snapshot)
    try:
        _serve_forever()
    finally:
        # Remote consumers may keep pulling while the broker drains;
        # close() runs even if the drain is interrupted.
        try:
            bus.drain(timeout_s=r.get_float("distributed.shutdown_drain_s",
                                            30.0))
        finally:
            bus.close()
    return 0


# -- the orchestrator ----------------------------------------------------------

def collect_urls(r: ConfigResolver) -> List[str]:
    """--urls + --url-file (one URL per line; blanks and '#' lines
    skipped)."""
    urls = list(r.get_list("crawler.urls"))
    url_file = r.get_str("crawler.url_file")
    if url_file:
        try:
            with open(url_file, "r", encoding="utf-8") as f:
                lines = f.read().split("\n")
        except OSError as e:
            raise CliConfigError(f"cannot read --url-file: {e}") from None
        urls.extend(ln.strip() for ln in lines
                    if ln.strip() and not ln.strip().startswith("#"))
    return urls


def _json_option(r: ConfigResolver, key: str, flag: str):
    """A config block given as YAML, or as inline JSON / ``@path`` by its
    flag."""
    import json

    raw = r.get(key)
    if isinstance(raw, str) and raw:
        if raw.startswith("@"):
            try:
                with open(raw[1:], "r", encoding="utf-8") as f:
                    raw = f.read()
            except OSError as e:
                raise CliConfigError(f"cannot read {flag} file: {e}")
        try:
            raw = json.loads(raw)
        except ValueError as e:
            raise CliConfigError(f"{flag} is not valid JSON: {e}")
    return raw or None


def _alert_rules(r: ConfigResolver):
    """The watchtower's rules from ``observability.alert_rules``;
    configured rules replace their same-named defaults, and a malformed
    rule is a config error (exit 2)."""
    from .utils.alerts import rules_from_config

    raw = _json_option(r, "observability.alert_rules", "--alert-rules")
    try:
        return rules_from_config(raw)
    except ValueError as e:
        raise CliConfigError(f"bad alert rule: {e}")


def _tenant_budgets(r: ConfigResolver):
    """``(budgets, window_s)`` from ``observability.tenant_budgets``; a
    malformed block is a config error (exit 2)."""
    from .orchestrator.tenants import budgets_from_config

    raw = _json_option(r, "observability.tenant_budgets",
                       "--tenant-budgets")
    try:
        return budgets_from_config(raw)
    except ValueError as e:
        raise CliConfigError(f"bad tenant budget: {e}")


def _autoscaler_config(r: ConfigResolver):
    """``(pools, argv by pool)`` of the elastic fleet, or None without
    ``--autoscaler``: the pool policies from ``autoscaler.pools`` (JSON or
    ``@path``) or the single-pool knobs, and each pool's child command
    line dialing this orchestrator's broker (or every shard).  Every
    error is the reference's, raised before the broker starts."""
    import shlex

    if not r.get_bool("autoscaler.enabled", False):
        return None
    bus_address = r.get_str("distributed.bus_address")
    shard_addresses = _parse_shard_addresses(r)
    if not bus_address and not shard_addresses:
        raise CliConfigError(
            "--autoscaler requires --bus-address (or "
            "--bus-shard-addresses on a partitioned control plane): "
            "spawned workers must be able to dial the broker(s)")
    from .orchestrator.autoscaler import (
        PoolPolicy,
        default_subprocess_argv,
        pools_from_config,
    )

    raw = _json_option(r, "autoscaler.pools", "--autoscaler-pools")
    try:
        pools = pools_from_config(raw)
        if not pools:
            pools = [PoolPolicy(
                pool="tpu",
                min_workers=r.get_int("autoscaler.min_workers", 1),
                max_workers=r.get_int("autoscaler.max_workers", 4),
                up_cooldown_s=r.get_float("autoscaler.up_cooldown_s",
                                          30.0),
                down_cooldown_s=r.get_float("autoscaler.down_cooldown_s",
                                            60.0),
                stabilization_s=r.get_float("autoscaler.stabilization_s",
                                            30.0))]
            pools[0].validate()
    except ValueError as e:
        raise CliConfigError(f"bad autoscaler pool: {e}")
    extra = shlex.split(r.get_str("autoscaler.worker_args", ""))
    return pools, {
        p.pool: default_subprocess_argv(
            p.pool, bus_address, extra_args=extra,
            shard_addresses=shard_addresses or None)
        for p in pools}


def _build_autoscaler(r: ConfigResolver, config, orch, bus):
    """The autoscaler over a `SubprocessSupervisor` of ``config``'s pools,
    reading the watchtower's alerts; not yet started."""
    from .orchestrator.autoscaler import Autoscaler, SubprocessSupervisor

    pools, pool_argv = config
    autoscaler = Autoscaler(
        SubprocessSupervisor(pool_argv), pools,
        eval_interval_s=r.get_float("autoscaler.eval_interval_s", 5.0),
        alerts_fn=orch.get_alerts)
    # The bus seam too, as a remote autoscaler would subscribe (the
    # in-process alerts_fn read stays authoritative).
    try:
        autoscaler.attach_bus(bus)
    except Exception as e:
        logger.warning("autoscaler TOPIC_ALERTS subscription failed: %s",
                       e)
    return autoscaler


def _check_orchestrator(urls: List[str], cfg: CrawlerConfig,
                        r: ConfigResolver) -> None:
    """The reference's sampling matrix for this mode (`config/sampling.
    validate_sampling_method`), before the broker starts; a validate-only
    config is exempt, as in the reference."""
    if cfg.validate_only:
        return
    try:
        validate_sampling_method(SamplingValidationInput(
            platform=cfg.platform, sampling_method=cfg.sampling_method,
            url_list=urls, mode="orchestrator", seed_size=cfg.seed_size,
            crawl_id=cfg.crawl_id))
    except ValueError as e:
        raise CliConfigError(str(e)) from None


def _run_orchestrator(urls: List[str], cfg: CrawlerConfig,
                      r: ConfigResolver) -> None:
    """mode=orchestrator: host the broker and coordinate the crawl until
    it completes (or the process is stopped)."""
    from .modes.common import create_state_manager
    from .orchestrator import CrawlJournal, Orchestrator, OrchestratorConfig
    from .utils import metrics

    _check_orchestrator(urls, cfg, r)
    if cfg.max_crawl_duration_s > 0:
        # As in the reference: only the standalone, layers and layerless
        # modes stop a crawl on its duration, and the port has none of them.
        logger.warning("--max-crawl-duration is ignored in orchestrator "
                       "mode: the crawl runs until its layers are done")
    rules = _alert_rules(r)
    budgets, budget_window_s = _tenant_budgets(r)
    fleet = _autoscaler_config(r)
    broker = _make_bus(r, serve=True)
    bus = broker
    outbox_cfg = _bus_outbox_config(r, "orchestrator")
    if outbox_cfg is not None and hasattr(broker, "dlq_snapshot"):
        # Bus durability on: the orchestrator's own publishes ride a
        # durable outbox (the dispatch valve watches its depth), and the
        # broker's dead-letter queue is served at /dlq.
        from .bus.outbox import OutboxBus

        bus = OutboxBus(broker, outbox_cfg, name="orchestrator")
        metrics.set_dlq_provider(broker.dlq_snapshot)
    ocfg = OrchestratorConfig(
        inference_backpressure_high=r.get_int(
            "distributed.inference_backpressure_high", 64),
        inference_backpressure_low=r.get_int(
            "distributed.inference_backpressure_low", 32),
        state_retry_attempts=r.get_int("resilience.state_retry_attempts", 2),
        state_breaker_threshold=r.get_int(
            "resilience.state_breaker_threshold", 5),
        state_breaker_recovery_s=r.get_float(
            "resilience.state_breaker_recovery_s", 15.0),
        publish_retry_attempts=r.get_int(
            "resilience.publish_retry_attempts", 3))
    journal_dir = r.get_str("orchestrator.journal_dir", "")
    if not journal_dir:
        # Keyed by crawl id, so a shared dump dir never hands one crawl
        # another's journal.
        dump_dir = r.get_str("observability.dump_dir", "")
        crawl = cfg.crawl_id or "crawl"
        journal_dir = (
            os.path.join(dump_dir, "orch-journal", crawl) if dump_dir
            else os.path.join(cfg.storage_root or "/tmp/crawl", crawl,
                              "orch-journal"))
    orch = Orchestrator(cfg.crawl_id, cfg, bus,
                        create_state_manager(cfg, cfg.crawl_id), ocfg=ocfg,
                        journal=CrawlJournal(journal_dir), alert_rules=rules)
    orch.watchtower.tenants.configure(budgets=budgets,
                                      window_s=budget_window_s)
    providers = (("status", orch.get_status), ("cluster", orch.get_cluster),
                 ("dtraces", orch.get_dtraces), ("alerts", orch.get_alerts),
                 ("tenants", orch.get_tenants))
    for kind, fn in providers:
        getattr(metrics, f"set_{kind}_provider")(fn)
    # The elastic fleet: tpu-worker children of this CLI on this broker,
    # their decisions served at /autoscaler.
    autoscaler = None
    if fleet is not None:
        autoscaler = _build_autoscaler(r, fleet, orch, bus)
        metrics.set_autoscaler_provider(autoscaler.snapshot)
    orch.start(urls, fresh=r.get_bool("orchestrator.fresh", False))
    if autoscaler is not None:
        autoscaler.start()
    try:
        _serve_forever(
            running=lambda: orch.is_running and not orch.crawl_completed)
    finally:
        if autoscaler is not None:
            # The control loop first, then every child through its
            # graceful SIGTERM path: their un-acked frames requeue into
            # the broker before it drains below.
            autoscaler.stop()
            try:
                autoscaler.supervisor.stop_all()
            except Exception as e:
                logger.warning("autoscaler child teardown failed: %s", e)
            metrics.clear_autoscaler_provider(autoscaler.snapshot)
        orch.stop()
        for kind, fn in providers:
            getattr(metrics, f"clear_{kind}_provider")(fn)
        # This process hosts the broker: frames the crawl's consumers have
        # not pulled yet (inference batches, say) would die with it.  A
        # completed crawl drains first; an interrupted one exits promptly.
        try:
            drain = getattr(broker, "drain", None)
            if callable(drain) and orch.crawl_completed:
                drain_s = r.get_float("distributed.shutdown_drain_s", 30.0)
                if bus is not broker:
                    # Flush buffered publishes into the broker first.
                    bus.outbox.drain(timeout_s=drain_s)
                drain(timeout_s=drain_s)
        finally:
            try:
                if bus is not broker:
                    # The outbox alone: the broker closes last, below.
                    bus.outbox.close()
                    metrics.clear_dlq_provider(broker.dlq_snapshot)
            finally:
                broker.close()


def _run_transcribe(cfg: CrawlerConfig, r: ConfigResolver,
                    device=None) -> int:
    """mode=transcribe: Whisper over a tree of 16 kHz PCM ``.wav`` files,
    long files across every 30 s window; one JSONL row per file:
    ``{"path", "tokens", "text", "windows", "error"}``.  Every file
    failing is a failed run (exit 1).  With ``--infer`` and
    ``--bus-address`` the successful transcripts are also published on
    ``tpu-inference-batches`` as one RecordBatch of posts ``media:<path>``,
    for a ``tpu-worker`` to embed and classify."""
    import json

    src = r.get_str("transcribe.input")
    asr_dir = cfg.inference.asr_pretrained_dir
    if not src or not asr_dir:
        print("error: transcribe mode needs --transcribe-input and "
              "--asr-pretrained-dir", file=sys.stderr)
        return 2
    if os.path.isfile(src):
        paths = [src]
        base = os.path.dirname(src) or "."
    else:
        paths = sorted(
            os.path.join(root, name)
            for root, _dirs, files in os.walk(src)
            for name in files if name.lower().endswith(".wav"))
        base = src
    if not paths:
        print(f"error: no .wav files under {src}", file=sys.stderr)
        return 2
    results = _make_pipeline(cfg, r, device=device).transcribe_files(paths)
    out_path = r.get_str("transcribe.output") or os.path.join(
        base, "transcripts.jsonl")
    failed = 0
    with open(out_path, "w", encoding="utf-8") as f:
        for res in results:
            failed += bool(res.error)
            f.write(json.dumps({
                "path": os.path.relpath(res.path, base),
                "tokens": res.tokens,
                "text": res.text,
                "windows": res.windows,
                "error": res.error,
            }, ensure_ascii=False) + "\n")
    if cfg.inference.enabled and r.get_str("distributed.bus_address"):
        _publish_transcripts(cfg, r, results, base)
    print(json.dumps({"transcribed": len(results) - failed,
                      "failed": failed, "output": out_path}))
    return 0 if len(results) > failed else 1


def _publish_transcripts(cfg: CrawlerConfig, r: ConfigResolver, results,
                         base: str) -> None:
    """``transcribe --infer --bus-address``: the successful, non-empty
    transcripts as one RecordBatch of posts on the inference topic.  A
    post's channel is the file's directory under the input, as the crawler
    lays media out per channel."""
    from .bus.codec import RecordBatch
    from .bus.messages import TOPIC_INFERENCE_BATCHES
    from .datamodel.post import Post

    posts = []
    for res in results:
        if res.error or not (res.tokens or res.text):
            continue
        rel = os.path.relpath(res.path, base)
        posts.append(Post(
            post_uid=f"media:{rel}",
            channel_name=os.path.dirname(rel) or "transcripts",
            description=res.text or " ".join(str(t) for t in res.tokens)))
    if not posts:
        return
    bus = _make_bus(r)
    try:
        bus.publish(TOPIC_INFERENCE_BATCHES, RecordBatch.from_posts(
            posts, crawl_id=cfg.crawl_id).to_dict())
    finally:
        bus.close()


def _train_examples(posts_file: str, labels_file: str):
    """train-head's examples: (texts, class ids, n_labels, the sorted
    vocabulary of string labels or None), in the labels file's order, of
    the labelled posts found in the crawl file; None after printing the
    error (exit 2)."""
    import json

    texts: dict = {}
    with open(posts_file, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            text = row.get("all_text") or row.get("description") or ""
            if row.get("post_uid") and text:
                texts[row["post_uid"]] = text

    raw_labels: list = []
    with open(labels_file, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            if row.get("post_uid") in texts:
                raw_labels.append((row["post_uid"], row["label"]))
    if not raw_labels:
        print("error: no labelled posts matched the crawl file",
              file=sys.stderr)
        return None

    values = [lbl for _, lbl in raw_labels]
    str_count = sum(isinstance(v, str) for v in values)
    if str_count and str_count != len(values):
        # One stray string would remap every int id through string-sort
        # order: refuse instead.
        print("error: labels file mixes string and integer labels; "
              "use one kind consistently", file=sys.stderr)
        return None
    if str_count:
        vocab = sorted({str(v) for v in values})
        index = {name: i for i, name in enumerate(vocab)}
        pairs = [(uid, index[str(v)]) for uid, v in raw_labels]
    else:
        vocab = None
        pairs = [(uid, int(v)) for uid, v in raw_labels]
        if any(lbl < 0 for _, lbl in pairs):
            print("error: negative label ids are not valid classes "
                  "(drop unlabeled rows instead of marking them -1)",
                  file=sys.stderr)
            return None
    n_labels = (len(vocab) if vocab is not None
                else max(lbl for _, lbl in pairs) + 1)
    return ([texts[uid] for uid, _ in pairs], [lbl for _, lbl in pairs],
            n_labels, vocab)


def _train_full(weights, r: ConfigResolver, token_lists, labels,
                epochs: int, state_dir: str = ""):
    """train-head's full scope from ``weights`` (`_train_weights`): its
    batch, accumulation and optimizer settings from ``r``; (params,
    history)."""
    from .models.train import TrainConfig, finetune_full

    batch = min(16, max(4, len(labels)))
    # Accumulation splits each batch; keep microbatches non-empty.
    grad_accum = min(r.get_int("train.grad_accum_steps", 1), batch)
    batch -= batch % grad_accum
    tc = TrainConfig(
        learning_rate=r.get_float("train.learning_rate", 2e-5),
        warmup_steps=10, grad_accum_steps=grad_accum)
    ecfg, params, _, device = weights
    return finetune_full(
        ecfg, params, token_lists, labels, tc=tc,
        epochs=epochs, batch_size=batch, state_dir=state_dir or None,
        device=device)


def _run_train_head(cfg: CrawlerConfig, r: ConfigResolver,
                    device=None) -> int:
    """mode=train-head: crawl JSONL + labels file -> fine-tuned classifier
    (head, LoRA or full scope) -> a port checkpoint (``step_N`` under
    --head-checkpoint, plus a ``labels.json`` vocabulary for string
    labels) that ``tpu-worker --head-checkpoint`` serves.  Every check,
    message and exit code is the reference's; so is the summary line.

    Labels file: one JSON object per line, ``{"post_uid": ..., "label":
    X}``, X an int class id or a string class name (a sorted vocabulary
    is built and saved for string labels)."""
    import json

    from .inference.checkpoint import latest_step_dir, save_params
    from .models.train import TrainConfig, finetune_head

    posts_file = r.get_str("train.posts_file")
    labels_file = r.get_str("train.labels_file")
    ckpt_dir = r.get_str("train.checkpoint_dir")
    if not (posts_file and labels_file and ckpt_dir):
        print("error: train-head needs --train-posts, --train-labels and "
              "--head-checkpoint", file=sys.stderr)
        return 2
    examples = _train_examples(posts_file, labels_file)
    if examples is None:
        return 2
    texts, labels, n_labels, vocab = examples

    weights = _train_weights(cfg, r, n_labels, device=device)
    ecfg, params, tokenizer, dev = weights
    token_lists = tokenizer.encode_batch(texts)
    epochs = r.get_int("train.epochs", 20)
    if epochs < 1:
        print("error: --train-epochs must be >= 1", file=sys.stderr)
        return 2
    lora_rank = r.get_int("train.lora_rank", 0)
    if lora_rank < 0:
        print(f"error: --train-lora-rank must be >= 0, got {lora_rank}",
              file=sys.stderr)
        return 2
    # An explicit --train-scope wins; else a positive rank means lora.
    scope = r.get_str("train.scope") or ("lora" if lora_rank > 0
                                         else "head")
    if scope not in ("head", "lora", "full"):
        print(f"error: train.scope must be head|lora|full, got {scope!r}",
              file=sys.stderr)
        return 2
    if scope == "lora" and lora_rank <= 0:
        print("error: --train-scope lora needs --train-lora-rank > 0",
              file=sys.stderr)
        return 2
    if scope != "lora" and lora_rank > 0:
        print(f"error: --train-lora-rank conflicts with --train-scope "
              f"{scope}", file=sys.stderr)
        return 2
    grad_accum = r.get_int("train.grad_accum_steps", 1)
    if grad_accum < 1:
        print(f"error: --train-grad-accum must be >= 1, got {grad_accum}",
              file=sys.stderr)
        return 2
    if grad_accum > 1 and scope != "full":
        print(f"error: --train-grad-accum applies to --train-scope full "
              f"only (scope is {scope})", file=sys.stderr)
        return 2
    state_dir = r.get_str("train.state_dir")
    if state_dir and scope != "full":
        print(f"error: --train-state-dir applies to --train-scope full "
              f"only (scope is {scope})", file=sys.stderr)
        return 2
    if scope == "lora":
        from .models.lora import finetune_lora

        tc = TrainConfig(
            learning_rate=r.get_float("train.learning_rate", 1e-4),
            warmup_steps=10)
        params, history = finetune_lora(
            ecfg, params, token_lists, labels,
            rank=lora_rank, tc=tc, epochs=epochs,
            batch_size=min(16, max(4, len(labels))), device=dev)
    elif scope == "full":
        params, history = _train_full(weights, r, token_lists, labels,
                                      epochs, state_dir)
    else:
        tc = TrainConfig(
            learning_rate=r.get_float("train.learning_rate", 1e-3),
            warmup_steps=10)
        params, history = finetune_head(
            ecfg, params, token_lists, labels, tc=tc,
            epochs=epochs, batch_size=min(32, max(8, len(labels))),
            buckets=tuple(cfg.inference.bucket_sizes), device=dev)

    # Monotonic step numbering: retraining into the same dir always makes
    # the new latest step, whatever the epoch counts.
    prior = latest_step_dir(ckpt_dir)
    next_step = (int(os.path.basename(prior).split("_", 1)[1]) + 1
                 if prior else 1)
    step_dir = os.path.join(ckpt_dir, f"step_{next_step}")
    save_params(step_dir, params)
    vocab_path = os.path.join(ckpt_dir, "labels.json")
    if vocab is not None:
        with open(vocab_path, "w", encoding="utf-8") as f:
            json.dump({"labels": vocab}, f)
    elif os.path.exists(vocab_path):
        # An integer-label retrain: the old names no longer describe this
        # head.
        os.remove(vocab_path)
    print(json.dumps({
        "trained_examples": len(labels),
        "n_labels": n_labels,
        "epochs": epochs,
        "lora_rank": lora_rank,
        "final_loss": history[-1]["loss"],
        "final_accuracy": history[-1]["accuracy"],
        "checkpoint": step_dir,
    }))
    return 0


def _read_cluster_rows(path: str):
    """(uids, embeddings, texts) of a cluster input JSONL: a row with an
    ``embedding`` list is an embedding row, else its text fields make a
    text row (rows without text are skipped)."""
    import json

    uids: list = []
    embeddings: list = []
    texts: list = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            uid = row.get("post_uid") or row.get("id") or str(len(uids))
            if isinstance(row.get("embedding"), list):
                uids.append(uid)
                embeddings.append(row["embedding"])
            else:
                text = row.get("all_text") or row.get("description") or ""
                if text:
                    uids.append(uid)
                    texts.append(text)
    return uids, embeddings, texts


def _run_cluster(cfg: CrawlerConfig, r: ConfigResolver, device=None) -> int:
    """mode=cluster: embeddings (or text, embedded on the fly) -> k-means
    `fit` on the one card -> cluster assignments.  The summary line adds
    the seconds spent reading the JSON, embedding text rows, fitting and
    writing."""
    import json

    import numpy as np
    import torch

    from .device import resolve_device
    from .models.clustering import fit

    input_file = r.get_str("cluster.input_file")
    output_file = r.get_str("cluster.output_file")
    k = r.get_int("cluster.k", 8)
    iters = r.get_int("cluster.iters", 25)
    if not input_file or not output_file:
        print("error: cluster mode needs --cluster-input and "
              "--cluster-output", file=sys.stderr)
        return 2
    if k < 2:
        print("error: --cluster-k must be >= 2", file=sys.stderr)
        return 2
    if iters < 1:
        print("error: --cluster-iters must be >= 1", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    uids, embeddings, texts = _read_cluster_rows(input_file)
    seconds = {"read": time.perf_counter() - t0}
    if embeddings and texts:
        print("error: input mixes 'embedding' rows with text rows; "
              "cluster one kind at a time", file=sys.stderr)
        return 2
    if texts:
        t0 = time.perf_counter()
        engine = _make_engine(cfg, r, device=device)
        x = engine.embed(texts)
        dev = engine.device
        seconds["embed"] = time.perf_counter() - t0
    else:
        widths = {len(e) for e in embeddings}
        if len(widths) != 1 or 0 in widths:
            print(f"error: embedding rows have inconsistent widths "
                  f"{sorted(widths)}; cluster one embedding space at a "
                  f"time", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        x = np.asarray(embeddings, np.float32)
        seconds["read"] += time.perf_counter() - t0
        dev = resolve_device(device)
    if len(x) < k:
        print(f"error: {len(x)} rows cannot form {k} clusters",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    result = fit(torch.as_tensor(np.asarray(x, np.float32), device=dev), k,
                 iters=iters)
    assignments = result.assignments.cpu().numpy()
    centroids = result.centroids.cpu().numpy()
    inertia = float(result.inertia)
    seconds["fit"] = time.perf_counter() - t0
    sizes = np.bincount(assignments, minlength=k).tolist()
    t0 = time.perf_counter()
    with open(output_file, "w", encoding="utf-8") as f:
        json.dump({
            "k": k,
            "iters": iters,
            "inertia": inertia,
            "cluster_sizes": sizes,
            "centroids": centroids.tolist(),
            "assignments": [
                {"post_uid": uid, "cluster": int(c)}
                for uid, c in zip(uids, assignments)],
        }, f)
    seconds["write"] = time.perf_counter() - t0
    print(json.dumps({
        "clustered": len(uids),
        "k": k,
        "inertia": round(inertia, 4),
        "cluster_sizes": sizes,
        "output": output_file,
        "seconds": seconds,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

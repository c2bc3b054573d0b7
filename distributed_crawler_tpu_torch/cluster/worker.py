"""Cluster worker service: embedding-carrying result batches in, cluster
assignments and a live centroid model out.

The reference's `distributed_crawler_tpu/cluster/worker.py`
(`ClusterWorker`), shaped like the port's other workers:

- the unit of work is a `RecordBatch` coming back from `TPUWorker` on
  ``TOPIC_INFERENCE_RESULTS`` with an ``embedding`` per result row; the bus
  handler only decodes and enqueues;
- the feed thread drains up to ``coalesce_batches`` queued batches and
  folds their embeddings as one `ClusterEngine.observe` (an online
  spherical k-means step on the card); every batch keeps its own
  idempotent writeback and ack; when the combined step raises, each batch
  runs alone;
- a batch whose embeddings were already folded (a redelivery: the
  folded-batch window, or a duplicate id in one group) is reassigned
  without folding it again;
- assignments are written as one JSONL file per batch under
  ``{storage_prefix}/{crawl_id}/batches/{batch_id}.jsonl`` (a redelivery
  overwrites, never duplicates); the model checkpoints through
  ``provider.save_json`` every ``checkpoint_every_batches`` committed
  batches and at a graceful stop, in the reference's layout, and each
  checkpoint announces a `ClusterUpdateMessage` on ``TOPIC_CLUSTERS``;
- a restarted worker resumes the model from the checkpoint, never
  re-seeds, and raises on an incompatible one;
- the operations layer of the text worker: heartbeats with telemetry
  (``worker_type="cluster"``), SLO budgets, span export, ``/metrics``,
  ``/status``, ``/costs`` (``path="cluster"`` rows) and ``/clusters`` on
  ``metrics_port``, a ``worker_stopping`` status on ``stop()`` and a
  silent ``kill()``.

``provider`` is anything with ``put_text``, ``get_text``, ``list_dir``,
``save_json`` and ``load_json``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..bus.codec import RecordBatch, utcnow
from ..bus.messages import (
    MSG_HEARTBEAT,
    MSG_WORKER_STOPPING,
    TOPIC_CLUSTERS,
    TOPIC_INFERENCE_RESULTS,
    TOPIC_SPANS,
    TOPIC_WORKER_STATUS,
    WORKER_BUSY,
    WORKER_IDLE,
    WORKER_OFFLINE,
    ClusterUpdateMessage,
    SpanBatchMessage,
    StatusMessage,
)
from ..utils import flight, trace
from ..utils.metrics import (
    REGISTRY,
    MetricsRegistry,
    clear_clusters_provider,
    serve_metrics,
    set_clusters_provider,
)
from ..utils.occupancy import QueueDepthSampler
from ..utils.slo import SLOWatchdog, standard_slos
from ..utils.telemetry import TelemetryEmitter
from ..utils.timeseries import RegistrySampler
from .engine import ClusterEngine, ClusterEngineConfig

logger = logging.getLogger(__name__)


def iter_assignments(provider, crawl_id: str,
                     storage_prefix: str = "cluster"):
    """Yield the assignment rows of every per-batch file of a crawl, in
    file order."""
    base = f"{storage_prefix}/{crawl_id}/batches"
    for name in provider.list_dir(base):
        if not name.endswith(".jsonl"):
            continue
        text = provider.get_text(f"{base}/{name}")
        for line in (text or "").splitlines():
            if line:
                yield json.loads(line)


@dataclass
class ClusterWorkerConfig:
    worker_id: str = "cluster-worker-0"
    heartbeat_s: float = 30.0
    queue_capacity: int = 64          # decoded result batches awaiting device
    metrics_port: int = 0             # 0 = don't serve; >0 = HTTP port
    storage_prefix: str = "cluster"
    # Model knobs, for the engine the worker builds when given none.
    k: int = 16
    buckets: Tuple[int, ...] = (64, 256)
    spherical: bool = True
    seed: int = 0
    # Coalescing feed: one dequeue drains up to this many queued result
    # batches and folds their embeddings as ONE mini-batch step, then
    # fans assignments back so every batch keeps its own ack + idempotent
    # writeback.
    coalesce_batches: int = 4
    # Checkpoint cadence: centroids+counts+inertia write atomically
    # through the state layer every N committed batches AND at graceful
    # stop (whichever first; 0 disables the count trigger).  Every
    # checkpoint also publishes a ClusterUpdateMessage on TOPIC_CLUSTERS.
    checkpoint_every_batches: int = 8
    # A cluster is "under-populated" when its assignment share is below
    # this fraction of the uniform share (1/k) — the frontier-priority
    # signal carried on TOPIC_CLUSTERS.
    min_cluster_fraction: float = 0.5
    # Bounded channel -> last-assigned-cluster map shipped with updates
    # (the orchestrator's join key for cluster-guided prioritization).
    channel_map_size: int = 256
    # SLO budgets (`utils/slo.py`); 0 = no budget declared.
    slo_batch_p95_ms: float = 0.0     # p95 of cluster_worker.process
    slo_queue_wait_ms: float = 0.0    # p95 of cluster_worker.queue_wait
    slo_batch_age_ms: float = 0.0     # p95 of cluster_worker.batch_age
    # Span export (`utils/trace.py:SpanExporter` -> TOPIC_SPANS).
    span_export_interval_s: float = 15.0
    span_export_max_spans: int = 512
    span_sample_rate: float = 1.0


class ClusterWorker:
    """Consume embedding-result batches, run online k-means, write the
    assignments back, checkpoint the model at
    ``{storage_prefix}/centroids.json``, serve ``/clusters``."""

    CHECKPOINT_PATH = "centroids.json"
    # Folded-batch idempotence window (the orchestrator's
    # `_applied_results` discipline): batch ids whose embeddings already
    # updated the model.  A redelivery — e.g. a nack after a failed
    # writeback, or an unacked frame requeued across a kill — re-writes
    # the ledger (idempotent file) but must NOT fold the same vectors a
    # second time; the newest SNAPSHOT-many ids persist inside the
    # checkpoint so the window holds exactly as far back as the model
    # state itself does (batches folded AFTER the last checkpoint are
    # genuinely absent from a resumed model, so refolding them is
    # correct).
    FOLDED_WINDOW = 4096
    FOLDED_SNAPSHOT = 2048

    def __init__(self, bus, engine: Optional[ClusterEngine] = None,
                 provider=None,
                 cfg: ClusterWorkerConfig = ClusterWorkerConfig(),
                 registry: MetricsRegistry = REGISTRY,
                 device: Optional[Union[str, torch.device]] = None):
        self.bus = bus
        self.engine = engine if engine is not None else ClusterEngine(
            ClusterEngineConfig(k=cfg.k, buckets=tuple(cfg.buckets),
                                spherical=cfg.spherical, seed=cfg.seed),
            registry=registry, device=device)
        self.provider = provider
        self.cfg = cfg
        self._queue: "queue.Queue[Tuple[RecordBatch, Any, float]]" = \
            queue.Queue(cfg.queue_capacity)
        self._stop = threading.Event()
        self._threads: list = []
        self._idle = threading.Condition()
        self._inflight = 0
        self._registry = registry
        self._started_at = 0.0
        self._processed = 0
        self._errors = 0
        self._skipped = 0           # batches with no embeddings to cluster
        self._batches_since_ckpt = 0
        self._metrics_server = None
        self._killed = False
        self._stop_announced = False
        self.resumed = False
        self._no_embeddings_warned = False
        # Bounded channel -> last cluster map (newest wins), the
        # ClusterUpdateMessage's frontier join key.
        self._channel_clusters: "OrderedDict[str, int]" = OrderedDict()
        # Folded-batch idempotence window (see the class constants).
        self._folded: "OrderedDict[str, None]" = OrderedDict()
        self.m_queue_depth = registry.gauge(
            "cluster_worker_queue_depth",
            "decoded result batches awaiting the k-means step "
            "(time-weighted rolling mean)")
        self._depth = QueueDepthSampler(self.m_queue_depth)
        self.m_batches = registry.counter(
            "cluster_worker_batches_total", "result batches clustered")
        self.m_vectors = registry.counter(
            "cluster_vectors_total", "embeddings assigned to clusters")
        self.m_outcomes = registry.counter(
            "cluster_worker_batch_outcomes_total",
            "result batches by final commit outcome")
        self.m_batch_age = registry.histogram(
            "cluster_worker_batch_age_seconds",
            "result-batch creation -> k-means step per batch")
        self.m_nonempty = registry.gauge(
            "cluster_nonempty",
            "clusters with at least one assigned embedding")
        self.m_inertia = registry.gauge(
            "cluster_inertia_per_vector",
            "rolling mean per-vector inertia of recent k-means steps "
            "(self-sampled into /timeseries)")
        self.m_checkpoints = registry.counter(
            "cluster_checkpoints_total", "centroid checkpoints written")
        self._telemetry = TelemetryEmitter(
            engine=self.engine, include_device=True,
            counters={"batch_outcomes": self.m_outcomes})
        self._slo = SLOWatchdog(
            standard_slos(batch_p95_ms=cfg.slo_batch_p95_ms,
                          queue_wait_ms=cfg.slo_queue_wait_ms,
                          batch_age_ms=cfg.slo_batch_age_ms),
            registry=registry)
        self._ts_sampler = RegistrySampler(registry)
        self._span_exporter = trace.SpanExporter(
            max_spans=cfg.span_export_max_spans,
            sample_rate=cfg.span_sample_rate,
            name_prefixes=("cluster_worker.", "cluster."))
        self._last_span_export = time.monotonic()
        # Crash recovery at construction, BEFORE the first subscribe: a
        # restarted worker resumes the model from the last checkpoint —
        # it must never re-seed from whatever mini-batch happens to
        # arrive first.
        self._try_resume()

    # -- crash recovery ----------------------------------------------------
    def _checkpoint_rel(self) -> str:
        return f"{self.cfg.storage_prefix}/{self.CHECKPOINT_PATH}"

    def _try_resume(self) -> None:
        if self.provider is None:
            return
        try:
            state = self.provider.load_json(self._checkpoint_rel())
        except Exception as e:
            logger.warning("cluster checkpoint read failed: %s", e)
            return
        if not state:
            return
        try:
            self.engine.load_state(state)
        except Exception as e:
            # A foreign/incompatible checkpoint (different k) is a loud
            # deployment error, not a silent re-seed.
            raise ValueError(
                f"cluster checkpoint at {self._checkpoint_rel()} is "
                f"incompatible: {e}") from e
        for bid in state.get("folded_batches") or []:
            self._folded[str(bid)] = None
        self.resumed = True
        flight.record("cluster_resume", worker=self.cfg.worker_id,
                      step=self.engine.step, vectors=self.engine.vectors,
                      k=self.engine.cfg.k)
        logger.info("cluster worker resumed from checkpoint",
                    extra={"worker_id": self.cfg.worker_id,
                           "step": self.engine.step,
                           "vectors": self.engine.vectors})

    def checkpoint(self) -> bool:
        """Write the model atomically through the state layer and publish
        a ClusterUpdateMessage; returns False (and logs) on failure — a
        wedged store must not take the serving loop down.  The cadence
        counter resets ONLY on success: a failed write retries on the
        very next committed batch instead of silently doubling the
        crash-recovery gap to the next full interval."""
        if self.provider is not None:
            try:
                state = self.engine.state_dict()
                state["saved_at"] = time.time()
                state["worker_id"] = self.cfg.worker_id
                with self._idle:
                    state["folded_batches"] = \
                        list(self._folded)[-self.FOLDED_SNAPSHOT:]
                self.provider.save_json(self._checkpoint_rel(), state)
                self.m_checkpoints.inc()
                flight.record("cluster_checkpoint",
                              worker=self.cfg.worker_id,
                              step=self.engine.step,
                              vectors=self.engine.vectors)
            except Exception as e:
                logger.warning("cluster checkpoint write failed: %s", e)
                return False
        self._batches_since_ckpt = 0
        self._publish_update()
        return True

    def _publish_update(self) -> None:
        """Best-effort ClusterUpdateMessage on TOPIC_CLUSTERS (fan-out:
        a missed update degrades prioritization freshness only)."""
        try:
            snap = self.engine.snapshot()
            with self._idle:
                channel_map = dict(self._channel_clusters)
            msg = ClusterUpdateMessage.new(
                self.cfg.worker_id, k=snap["k"], step=snap["step"],
                vectors=snap["vectors"], sizes=snap["sizes"],
                inertia=snap["inertia_per_vector"],
                underpopulated=self.engine.underpopulated(
                    self.cfg.min_cluster_fraction),
                channel_clusters=channel_map)
            self.bus.publish(TOPIC_CLUSTERS, msg.to_dict())
        except Exception as e:
            logger.warning("cluster update publish failed: %s", e)

    # -- observability surfaces --------------------------------------------
    def get_status(self) -> dict:
        return {
            "worker_id": self.cfg.worker_id,
            "worker_type": "cluster",
            "k": self.engine.cfg.k,
            "dim": self.engine.dim,
            "is_running": not self._stop.is_set() and bool(self._threads),
            "queue_depth": self._queue.qsize(),
            "inflight": self._inflight,
            "processed_batches": self._processed,
            "error_batches": self._errors,
            "skipped_batches": self._skipped,
            "vectors": self.engine.vectors,
            "resumed": self.resumed,
            "uptime_s": (time.monotonic() - self._started_at)
            if self._started_at else 0.0,
        }

    def get_costs(self) -> dict:
        """The /costs body: the cluster engine's cost/efficiency snapshot
        (path="cluster" rows) plus the worker's SLO state and per-tenant
        spend rows."""
        out = dict(self.engine.cost_snapshot())
        out["worker_id"] = self.cfg.worker_id
        out["slo"] = self._slo.snapshot()
        ledger = self._tenant_ledger()
        if ledger is not None:
            out["tenants"] = ledger.snapshot()
        return out

    # -- tenant attribution -------------------------------------------------
    def _tenant_ledger(self):
        return getattr(getattr(self.engine, "meter", None), "tenants", None)

    def _set_meter_tenants(self, weights) -> None:
        set_fn = getattr(getattr(self.engine, "meter", None),
                         "set_tenants", None)
        if callable(set_fn):
            set_fn(weights)

    def get_clusters(self) -> dict:
        """The /clusters body (`set_clusters_provider` seam): centroid
        sizes/norms, inertia trend, assignment throughput, checkpoint +
        resume state."""
        snap = self.engine.snapshot()
        eff = self.engine.meter.snapshot()
        snap.update({
            "worker_id": self.cfg.worker_id,
            "resumed": self.resumed,
            "resume_step": self.engine.resumed_from_step,
            "assign_vectors_per_s": eff.get("goodput_tokens_per_s", 0.0),
            "underpopulated": self.engine.underpopulated(
                self.cfg.min_cluster_fraction),
            "checkpoint": {
                "path": self._checkpoint_rel(),
                "every_batches": self.cfg.checkpoint_every_batches,
                "written": int(self.m_checkpoints.value),
            },
            "processed_batches": self._processed,
            "skipped_batches": self._skipped,
        })
        return snap

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._started_at = time.monotonic()
        # The process-wide provider feeds the flight recorder's postmortem
        # bundle (`flight.bundle` reads `clusters_snapshot()`); the routes
        # are served from this worker's own map below.
        set_clusters_provider(self.get_clusters)
        self.bus.subscribe(TOPIC_INFERENCE_RESULTS, self._handle_payload)
        for target, name in ((self._feed_loop, "cluster-feed"),
                             (self._heartbeat_loop, "cluster-heartbeat")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        if self.cfg.metrics_port:
            self._metrics_server = serve_metrics(
                self.cfg.metrics_port, self._registry,
                providers={"status": self.get_status,
                           "costs": self.get_costs,
                           "clusters": self.get_clusters})
        logger.info("cluster worker %s started (k=%d, resumed=%s)",
                    self.cfg.worker_id, self.engine.cfg.k, self.resumed)

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        clear_clusters_provider(self.get_clusters)
        for t in self._threads:
            t.join(timeout=timeout_s)
        if self.cfg.span_export_interval_s > 0:
            self.export_spans()
        # Final checkpoint on graceful stop only — kill() deliberately
        # loses everything since the last periodic checkpoint, exactly
        # like SIGKILL.
        if not self._killed and self.engine.step > 0:
            self.checkpoint()
        self._announce_stopping()
        if self.provider is not None:
            flush = getattr(self.provider, "flush", None)
            if callable(flush):
                flush()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()

    def kill(self) -> None:
        """Abrupt death, the in-process analog of SIGKILL: halt the threads
        without draining, checkpointing or acking queued batches; the
        clusters provider stays registered, so a postmortem bundle written
        after the death still carries the centroid state."""
        self._killed = True
        self._stop.set()
        flight.record("worker_kill", worker=self.cfg.worker_id,
                      queue_depth=self._queue.qsize(),
                      inflight=self._inflight, step=self.engine.step)
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def _announce_stopping(self) -> None:
        if self._killed or self._stop_announced:
            return
        self._stop_announced = True
        try:
            self.bus.publish(TOPIC_WORKER_STATUS, StatusMessage.new(
                self.cfg.worker_id, MSG_WORKER_STOPPING, WORKER_OFFLINE,
                tasks_processed=self._processed,
                tasks_success=self._processed - self._errors,
                tasks_error=self._errors,
                uptime_s=time.monotonic() - self._started_at,
                worker_type="cluster").to_dict())
        except Exception as e:  # a dead bus must not break shutdown
            logger.debug("stopping announcement failed: %s", e)

    def evaluate_slos(self) -> list:
        """One SLO evaluation tick on demand (the heartbeat's twin)."""
        return self._slo.evaluate()

    def export_spans(self) -> int:
        """Ship spans completed since the last export on TOPIC_SPANS;
        never raises — span telemetry must not take the worker down."""
        try:
            spans, dropped = self._span_exporter.collect()
            if not spans and not dropped:
                return 0
            msg = SpanBatchMessage.new(
                self.cfg.worker_id, [s.to_dict() for s in spans],
                dropped=dropped)
            self.bus.publish(TOPIC_SPANS, msg.to_dict())
            return len(spans)
        except Exception as e:
            logger.warning("span export failed: %s", e)
            return 0

    def warmup(self) -> None:
        """Dispatch every bucket's step once when the embedding dim is
        already known (a resumed checkpoint carries it)."""
        if self.engine.dim:
            self.engine.warmup(self.engine.dim)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every accepted batch — queued OR mid-step — has
        finished (the TPUWorker drain contract)."""
        with self._idle:
            return self._idle.wait_for(
                lambda: self._inflight == 0, timeout=timeout_s)

    # -- bus handler (never blocks on the device) --------------------------
    def _handle_payload(self, payload: Dict[str, Any], ack=None) -> None:
        """``ack`` is supplied by manual-ack buses (RemoteBus): the frame
        acks only after the step AND the assignment writeback, so a
        worker crash mid-queue requeues it server-side."""
        batch = RecordBatch.from_dict(payload)
        if not batch.records:
            if ack is not None:
                ack(True)
            return
        with self._idle:
            self._inflight += 1
        try:
            self._queue.put((batch, ack, time.monotonic()), timeout=5.0)
        except queue.Full:
            self._finish_one()
            if ack is not None:
                self.m_outcomes.labels(outcome="requeued").inc()
                flight.record("batch", batch=batch.batch_id,
                              outcome="requeued", reason="queue_full",
                              worker=self.cfg.worker_id)
                ack(False)  # requeue server-side; don't block the stream
                return
            raise
        self._depth.update(self._queue.qsize())

    def _finish_one(self) -> None:
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    # -- feed loop (coalescing) --------------------------------------------
    def _feed_loop(self) -> None:
        timeline = self.engine.timeline
        while not self._stop.is_set():
            try:
                items = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                # No work queued: the next step opens a new stream, so
                # this wait never scores as a pipeline bubble.
                timeline.start_stream()
                continue
            while len(items) < max(1, self.cfg.coalesce_batches):
                try:
                    items.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            self._depth.update(self._queue.qsize())
            try:
                self._process_group(items)
            finally:
                for _ in items:
                    self._finish_one()

    @staticmethod
    def _extract(batch: RecordBatch
                 ) -> Tuple[List[List[float]], List[Dict[str, Any]]]:
        """(embeddings, row metadata) for the rows of one result batch
        that carry an embedding — raises on malformed vectors so the
        batch fails alone (per-batch poison isolation)."""
        vecs: List[List[float]] = []
        rows: List[Dict[str, Any]] = []
        for record, result in zip(batch.records, batch.results):
            emb = (result or {}).get("embedding")
            if emb is None:
                continue
            vec = [float(v) for v in emb]
            if not vec:
                raise ValueError(
                    f"empty embedding for post "
                    f"{record.get('post_uid', '?')!r}")
            vecs.append(vec)
            rows.append({
                "post_uid": record.get("post_uid", ""),
                "channel_name": record.get("channel_name", ""),
            })
        return vecs, rows

    def _process_group(self,
                       items: List[Tuple[RecordBatch, Any, float]]) -> None:
        now = time.monotonic()
        ledger = self._tenant_ledger()
        for batch, _, enq_t in items:
            trace.record("cluster_worker.queue_wait", now - enq_t,
                         trace_id=batch.trace_id, batch=batch.batch_id,
                         worker=self.cfg.worker_id, tenant=batch.tenant)
            if ledger is not None and batch.tenant:
                ledger.observe_queue_wait(batch.tenant, now - enq_t)
        # Extract per batch FIRST: a batch whose embeddings are malformed
        # fails alone, before any neighbor joins it in the step.
        good: List[Tuple[RecordBatch, Any, list, list]] = []
        for batch, ack, _ in items:
            try:
                vecs, rows = self._extract(batch)
                self._observe_age(batch)
            except Exception as e:
                self._errors += 1
                self.m_outcomes.labels(outcome="error").inc()
                logger.exception("batch %s failed to extract embeddings: "
                                 "%s", batch.batch_id, e)
                if ack is not None:
                    ack(False)
                continue
            if not vecs:
                # No embeddings at all: the publisher runs with
                # publish_embeddings off — nothing to cluster, ack so the
                # frame doesn't redeliver forever, and say so LOUDLY once.
                self._skipped += 1
                self.m_outcomes.labels(outcome="skipped").inc()
                if not self._no_embeddings_warned:
                    self._no_embeddings_warned = True
                    logger.warning(
                        "result batch %s carries no embeddings — is the "
                        "TPU worker running with publish_embeddings "
                        "off? clustering requires embedding-carrying "
                        "result batches", batch.batch_id)
                if ack is not None:
                    ack(True)
                continue
            good.append((batch, ack, vecs, rows))
        if not good:
            return
        # Redeliveries (nack after a failed writeback, frames requeued
        # across a kill — or BOTH copies of one batch draining in the
        # same coalesced group after an ack-timeout requeue) must not
        # fold the same vectors twice: anything already folded, or a
        # duplicate batch_id WITHIN this group, re-assigns against the
        # current centroids (no model update) and re-writes its
        # idempotent ledger file.
        fresh, refold = [], []
        group_ids: set = set()
        with self._idle:
            for g in good:
                bid = g[0].batch_id
                if bid in self._folded or bid in group_ids:
                    refold.append(g)
                else:
                    group_ids.add(bid)
                    fresh.append(g)
        all_vecs = [v for _, _, vecs, _ in fresh for v in vecs]
        if fresh:
            # Tenant weights for the combined step = vector counts.
            weights: Dict[str, float] = {}
            for batch, _, vecs, _ in fresh:
                weights[batch.tenant] = weights.get(batch.tenant, 0.0) \
                    + max(1, len(vecs))
            self._set_meter_tenants(weights)
            dominant = max(weights, key=weights.get) if weights else ""
            try:
                # One mini-batch step for the coalesced group, under the
                # FIRST batch's trace (one device stream, one ambient
                # context); co-batched ids ride as attrs.
                with trace.span("cluster_worker.process",
                                trace_id=fresh[0][0].trace_id,
                                batches=len(fresh),
                                batch_ids=[b.batch_id
                                           for b, _, _, _ in fresh],
                                vectors=len(all_vecs),
                                worker=self.cfg.worker_id,
                                tenant=dominant):
                    assigns = self.engine.observe(all_vecs)
            except Exception as e:
                # The combined step failed; isolate per batch so one
                # poisoned batch cannot take its neighbors down.  The
                # model is untouched (engine.observe commits atomically
                # across its chunks), so the per-batch retry cannot
                # double-fold a partially-applied group.
                logger.exception(
                    "coalesced cluster step over %d batches failed (%s); "
                    "isolating per batch", len(fresh), e)
                for batch, ack, vecs, rows in fresh:
                    self._process_isolated(batch, ack, vecs, rows)
                for batch, ack, vecs, rows in refold:
                    self._process_refold(batch, ack, vecs, rows)
                return
            self._mark_folded(b.batch_id for b, _, _, _ in fresh)
            off = 0
            for batch, ack, vecs, rows in fresh:
                part = assigns[off:off + len(vecs)]
                off += len(vecs)
                self._commit_batch(batch, ack, rows, part)
        # Refolds AFTER the fresh fold: a first-ever group containing a
        # duplicate has seeded centroids to assign against by now.
        for batch, ack, vecs, rows in refold:
            self._process_refold(batch, ack, vecs, rows)
        self._refresh_gauges()
        self._maybe_checkpoint()

    def _mark_folded(self, batch_ids) -> None:
        """Record batch ids whose vectors just updated the model (the
        fold happened the moment observe() returned — even a later
        writeback failure must not refold them)."""
        with self._idle:
            for bid in batch_ids:
                self._folded[bid] = None
                self._folded.move_to_end(bid)
            while len(self._folded) > self.FOLDED_WINDOW:
                self._folded.popitem(last=False)

    def _process_refold(self, batch: RecordBatch, ack, vecs,
                        rows) -> None:
        """A redelivered already-folded batch: assignments against the
        current centroids (no model update), then the normal idempotent
        commit."""
        try:
            with trace.span("cluster_worker.process",
                            trace_id=batch.trace_id,
                            batch=batch.batch_id, refold=True,
                            worker=self.cfg.worker_id):
                assigns = self.engine.assign_only(vecs)
        except Exception as e:
            self._errors += 1
            self.m_outcomes.labels(outcome="error").inc()
            logger.exception("refold of batch %s failed: %s",
                             batch.batch_id, e)
            self._ack(batch, ack, False)
            return
        flight.record("batch", batch=batch.batch_id, outcome="refold",
                      vectors=len(assigns), worker=self.cfg.worker_id)
        self._commit_batch(batch, ack, rows, assigns)

    def _process_isolated(self, batch: RecordBatch, ack, vecs,
                          rows) -> None:
        try:
            self._set_meter_tenants({batch.tenant: max(1, len(vecs))})
            with trace.span("cluster_worker.process",
                            trace_id=batch.trace_id,
                            batch=batch.batch_id, isolated=True,
                            worker=self.cfg.worker_id,
                            tenant=batch.tenant):
                assigns = self.engine.observe(vecs)
        except Exception as e:
            self._errors += 1
            self.m_outcomes.labels(outcome="error").inc()
            flight.record("batch", batch=batch.batch_id, outcome="error",
                          error=str(e), worker=self.cfg.worker_id)
            logger.exception("cluster batch %s failed: %s",
                             batch.batch_id, e)
            self._ack(batch, ack, False)
            return
        self._mark_folded([batch.batch_id])
        self._commit_batch(batch, ack, rows, assigns)
        self._refresh_gauges()
        self._maybe_checkpoint()

    def _commit_batch(self, batch: RecordBatch, ack, rows,
                      assigns: List[int]) -> None:
        """The ONE commit/ack/error path every route shares: track the
        channel map, write assignments idempotently, ack."""
        try:
            for row, cluster in zip(rows, assigns):
                ch = row.get("channel_name") or ""
                if ch:
                    with self._idle:
                        self._channel_clusters[ch] = int(cluster)
                        self._channel_clusters.move_to_end(ch)
                        while len(self._channel_clusters) > \
                                max(1, self.cfg.channel_map_size):
                            self._channel_clusters.popitem(last=False)
            with trace.span("cluster_worker.commit",
                            trace_id=batch.trace_id,
                            batch=batch.batch_id, vectors=len(assigns)):
                self._writeback(batch, rows, assigns)
            self._processed += 1
            self._batches_since_ckpt += 1
            self.m_batches.inc()
            self.m_vectors.inc(len(assigns))
            self.m_outcomes.labels(outcome="ok").inc()
            flight.record("batch", batch=batch.batch_id, outcome="ok",
                          vectors=len(assigns), worker=self.cfg.worker_id)
            self._ack(batch, ack, True)
        except Exception as e:
            self._errors += 1
            self.m_outcomes.labels(outcome="error").inc()
            flight.record("batch", batch=batch.batch_id, outcome="error",
                          error=str(e), worker=self.cfg.worker_id)
            logger.exception("cluster batch %s commit failed: %s",
                             batch.batch_id, e)
            self._ack(batch, ack, False)

    def _ack(self, batch: RecordBatch, ack, ok: bool) -> None:
        if ack is None:
            return
        t0 = time.perf_counter()
        ack(ok)
        trace.record("cluster_worker.ack", time.perf_counter() - t0,
                     trace_id=batch.trace_id, batch=batch.batch_id, ok=ok)

    def _observe_age(self, batch: RecordBatch) -> None:
        if batch.created_at is None:
            return
        age = (utcnow() - batch.created_at).total_seconds()
        if age >= 0:
            self.m_batch_age.observe(age)
            trace.record("cluster_worker.batch_age", age,
                         trace_id=batch.trace_id, batch=batch.batch_id,
                         worker=self.cfg.worker_id, tenant=batch.tenant)

    def _writeback(self, batch: RecordBatch, rows,
                   assigns: List[int]) -> None:
        """Idempotent: one atomically-written file per batch_id — a bus
        redelivery (e.g. frames requeued across a worker kill)
        overwrites the same file with the same content instead of
        duplicating ledger rows."""
        if self.provider is None:
            return
        rel = (f"{self.cfg.storage_prefix}/{batch.crawl_id or 'adhoc'}"
               f"/batches/{batch.batch_id}.jsonl")
        lines = []
        for row, cluster in zip(rows, assigns):
            lines.append(json.dumps({
                "post_uid": row.get("post_uid", ""),
                "channel_name": row.get("channel_name", ""),
                "cluster": int(cluster),
                "batch_id": batch.batch_id,
                "trace_id": batch.trace_id,
                "tenant": batch.tenant,
            }, ensure_ascii=False))
        self.provider.put_text(rel, "\n".join(lines) + "\n")

    def _refresh_gauges(self) -> None:
        snap = self.engine.snapshot()
        self.m_nonempty.set(snap["nonempty"])
        if snap["inertia_per_vector"] is not None:
            self.m_inertia.set(snap["inertia_per_vector"])

    def _maybe_checkpoint(self) -> None:
        every = self.cfg.checkpoint_every_batches
        if every > 0 and self._batches_since_ckpt >= every:
            self.checkpoint()

    # -- heartbeats --------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._slo.evaluate()
            except Exception as e:  # budget math must never kill the beat
                logger.warning("slo evaluation failed: %s", e)
            status = WORKER_BUSY if not self._queue.empty() else WORKER_IDLE
            msg = StatusMessage.new(
                self.cfg.worker_id, MSG_HEARTBEAT, status,
                tasks_processed=self._processed,
                tasks_success=self._processed - self._errors,
                tasks_error=self._errors,
                uptime_s=time.monotonic() - self._started_at,
                worker_type="cluster")
            msg.queue_length = self._queue.qsize()
            msg.resource_usage = self._telemetry.snapshot()
            msg.resource_usage["queue"] = {
                "depth": self._queue.qsize(),
                "depth_time_weighted": round(self._depth.sample(), 4),
            }
            slo_snap = self._slo.snapshot()
            msg.resource_usage["slo_breaches"] = slo_snap["breaches"]
            if slo_snap.get("tenant_breaches"):
                msg.resource_usage["tenant_slo_breaches"] = \
                    slo_snap["tenant_breaches"]
            ledger = self._tenant_ledger()
            if ledger is not None:
                tenants = ledger.snapshot()
                if tenants["rows"]:
                    msg.resource_usage["tenants"] = tenants
            msg.resource_usage["cluster"] = {
                "step": self.engine.step,
                "vectors": self.engine.vectors,
                "nonempty": int(self.m_nonempty.value),
            }
            self._ts_sampler.sample()
            try:
                self.bus.publish(TOPIC_WORKER_STATUS, msg.to_dict())
            except Exception as e:  # bus outage must not kill the worker
                logger.warning("heartbeat publish failed: %s", e)
            self._wait_with_span_exports(self.cfg.heartbeat_s)

    def _wait_with_span_exports(self, wait_s: float) -> None:
        deadline = time.monotonic() + wait_s
        interval = self.cfg.span_export_interval_s
        while not self._stop.is_set():
            if interval > 0 and \
                    time.monotonic() - self._last_span_export >= interval:
                self._last_span_export = time.monotonic()
                self.export_spans()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            self._stop.wait(min(remaining, interval)
                            if interval > 0 else remaining)

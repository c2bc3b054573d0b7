"""Cluster worker service: embedding-carrying result batches in, cluster
assignments and a live centroid model out.

The serving core of the reference's `distributed_crawler_tpu/cluster/
worker.py` (`ClusterWorker`), shaped like the port's `ASRWorker`:

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
  re-seeds, and raises on an incompatible one.

``provider`` is anything with ``put_text``, ``get_text``, ``list_dir``,
``save_json`` and ``load_json``.  Heartbeats, SLOs, span export, the
flight recorder, the metrics server, ``/costs`` and the tenant ledger wait
for a later slice.
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
    TOPIC_CLUSTERS,
    TOPIC_INFERENCE_RESULTS,
    ClusterUpdateMessage,
)
from ..utils import trace
from ..utils.metrics import REGISTRY, MetricsRegistry
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
    queue_capacity: int = 64          # decoded result batches awaiting device
    storage_prefix: str = "cluster"
    # Model knobs, for the engine the worker builds when given none.
    k: int = 16
    buckets: Tuple[int, ...] = (64, 256)
    spherical: bool = True
    seed: int = 0
    # Result batches drained per step; every batch keeps its own ack and
    # writeback.
    coalesce_batches: int = 4
    # Checkpoint every N committed batches and at a graceful stop (0: at
    # the stop only).  Every checkpoint publishes a ClusterUpdateMessage.
    checkpoint_every_batches: int = 8
    # A cluster is under-populated below this fraction of the uniform
    # share (1/k).
    min_cluster_fraction: float = 0.5
    # Bounded channel -> last cluster map sent with each update.
    channel_map_size: int = 256


class ClusterWorker:
    """Consume embedding-result batches, run online k-means, write the
    assignments back, checkpoint the model."""

    CHECKPOINT_PATH = "centroids.json"
    # Folded-batch window: ids whose embeddings already updated the model.
    # The newest FOLDED_SNAPSHOT go into each checkpoint, so the window
    # reaches as far back as the resumed model does.
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
        # (batch, ack, enqueue time on the monotonic clock)
        self._queue: "queue.Queue[Tuple[RecordBatch, Any, float]]" = \
            queue.Queue(cfg.queue_capacity)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._idle = threading.Condition()
        self._inflight = 0          # batches accepted but not yet finished
        self._started_at = 0.0
        self._processed = 0
        self._errors = 0
        self._skipped = 0           # batches with no embeddings to cluster
        self._batches_since_ckpt = 0
        self._killed = False
        self.resumed = False
        self._no_embeddings_warned = False
        self._channel_clusters: "OrderedDict[str, int]" = OrderedDict()
        self._folded: "OrderedDict[str, None]" = OrderedDict()
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
            "per-vector inertia of the newest k-means step")
        self.m_checkpoints = registry.counter(
            "cluster_checkpoints_total", "centroid checkpoints written")
        # Before the first subscribe: a restarted worker resumes the model,
        # it never re-seeds from whatever batch arrives first.
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
            # A foreign checkpoint (another k) is a deployment error, not
            # a reason to re-seed silently.
            raise ValueError(
                f"cluster checkpoint at {self._checkpoint_rel()} is "
                f"incompatible: {e}") from e
        for bid in state.get("folded_batches") or []:
            self._folded[str(bid)] = None
        self.resumed = True
        logger.info("cluster worker %s resumed from checkpoint at step %d "
                    "(%d vectors)", self.cfg.worker_id, self.engine.step,
                    self.engine.vectors)

    def checkpoint(self) -> bool:
        """Write the model through ``provider.save_json`` and publish a
        ClusterUpdateMessage; False (logged) on failure, so a wedged store
        does not stop serving.  The cadence counter resets only on
        success: a failed write retries on the next committed batch."""
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
            except Exception as e:
                logger.warning("cluster checkpoint write failed: %s", e)
                return False
        self._batches_since_ckpt = 0
        self._publish_update()
        return True

    def _publish_update(self) -> None:
        """Best-effort ClusterUpdateMessage on TOPIC_CLUSTERS."""
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

    # -- observability -----------------------------------------------------
    def get_status(self) -> dict:
        return {
            "worker_id": self.cfg.worker_id,
            "worker_type": "cluster",
            "device": str(self.engine.device),
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

    def get_clusters(self) -> dict:
        """The ``/clusters`` body: centroid sizes and norms, the inertia
        trend, checkpoint and resume state."""
        snap = self.engine.snapshot()
        snap.update({
            "worker_id": self.cfg.worker_id,
            "resumed": self.resumed,
            "resume_step": self.engine.resumed_from_step,
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
        self.bus.subscribe(TOPIC_INFERENCE_RESULTS, self._handle_payload)
        t = threading.Thread(target=self._feed_loop, daemon=True,
                             name="cluster-feed")
        t.start()
        self._threads.append(t)
        logger.info("cluster worker %s started (k=%d, resumed=%s)",
                    self.cfg.worker_id, self.engine.cfg.k, self.resumed)

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the feed thread; a graceful stop writes a final checkpoint
        (`kill` does not, as a killed process would not)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        if not self._killed and self.engine.step > 0:
            self.checkpoint()
        flush = getattr(self.provider, "flush", None)
        if callable(flush):
            flush()

    def kill(self) -> None:
        """Abrupt death: halt the feed thread without draining,
        checkpointing or acking queued batches."""
        self._killed = True
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def warmup(self) -> None:
        """Dispatch every bucket's step once when the embedding dim is
        already known (a resumed checkpoint carries it)."""
        if self.engine.dim:
            self.engine.warmup(self.engine.dim)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every accepted batch, queued or mid-step, has
        finished."""
        with self._idle:
            return self._idle.wait_for(
                lambda: self._inflight == 0, timeout=timeout_s)

    # -- bus handler (never blocks on the device) --------------------------
    def _handle_payload(self, payload: Dict[str, Any], ack=None) -> None:
        """``ack`` comes from manual-ack buses: the batch is acked only
        after its step and its writeback."""
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
                ack(False)
                return
            raise  # the bus redelivers: backpressure

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
            try:
                self._process_group(items)
            finally:
                for _ in items:
                    self._finish_one()

    @staticmethod
    def _extract(batch: RecordBatch
                 ) -> Tuple[List[List[float]], List[Dict[str, Any]]]:
        """(embeddings, row metadata) of the rows that carry an embedding;
        raises on a malformed vector, so its batch fails alone."""
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
        for batch, _, enq_t in items:
            trace.record("cluster_worker.queue_wait", now - enq_t,
                         trace_id=batch.trace_id, batch=batch.batch_id,
                         worker=self.cfg.worker_id, tenant=batch.tenant)
        # Extract per batch first: a batch with malformed embeddings fails
        # alone, before it joins a step.
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
                # Published without embeddings: nothing to cluster.  Ack,
                # so it is not redelivered forever, and say so once.
                self._skipped += 1
                self.m_outcomes.labels(outcome="skipped").inc()
                if not self._no_embeddings_warned:
                    self._no_embeddings_warned = True
                    logger.warning(
                        "result batch %s carries no embeddings: is the "
                        "TPU worker running with publish_embeddings off? "
                        "clustering needs embedding-carrying result "
                        "batches", batch.batch_id)
                if ack is not None:
                    ack(True)
                continue
            good.append((batch, ack, vecs, rows))
        if not good:
            return
        # A batch already folded, or a second copy of one id in this
        # group, is reassigned against the current centroids, not folded.
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
            try:
                # One step for the group, under the first batch's trace.
                with trace.span("cluster_worker.process",
                                trace_id=fresh[0][0].trace_id,
                                batches=len(fresh),
                                batch_ids=[b.batch_id
                                           for b, _, _, _ in fresh],
                                vectors=len(all_vecs),
                                worker=self.cfg.worker_id):
                    assigns = self.engine.observe(all_vecs)
            except Exception as e:
                # The model is untouched (observe commits atomically), so
                # the per-batch retry cannot fold a group partly twice.
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
        # After the fresh fold: a first group holding a duplicate has
        # seeded centroids to assign against by now.
        for batch, ack, vecs, rows in refold:
            self._process_refold(batch, ack, vecs, rows)
        self._refresh_gauges()
        self._maybe_checkpoint()

    def _mark_folded(self, batch_ids) -> None:
        """Record ids whose vectors just updated the model: even a later
        writeback failure must not fold them again."""
        with self._idle:
            for bid in batch_ids:
                self._folded[bid] = None
                self._folded.move_to_end(bid)
            while len(self._folded) > self.FOLDED_WINDOW:
                self._folded.popitem(last=False)

    def _process_refold(self, batch: RecordBatch, ack, vecs,
                        rows) -> None:
        """A redelivered, already folded batch: assignments against the
        current centroids, then the normal commit."""
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
        self._commit_batch(batch, ack, rows, assigns)

    def _process_isolated(self, batch: RecordBatch, ack, vecs,
                          rows) -> None:
        try:
            with trace.span("cluster_worker.process",
                            trace_id=batch.trace_id,
                            batch=batch.batch_id, isolated=True,
                            worker=self.cfg.worker_id,
                            tenant=batch.tenant):
                assigns = self.engine.observe(vecs)
        except Exception as e:
            self._errors += 1
            self.m_outcomes.labels(outcome="error").inc()
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
        """The one commit path: the channel map, the idempotent
        writeback, the ack."""
        try:
            with self._idle:
                for row, cluster in zip(rows, assigns):
                    ch = row.get("channel_name") or ""
                    if ch:
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
            self._ack(batch, ack, True)
        except Exception as e:
            self._errors += 1
            self.m_outcomes.labels(outcome="error").inc()
            logger.exception("cluster batch %s commit failed: %s",
                             batch.batch_id, e)
            self._ack(batch, ack, False)

    @staticmethod
    def _ack(batch: RecordBatch, ack, ok: bool) -> None:
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
        """Idempotent: one file per batch_id, so a redelivery overwrites
        the same file with the same content."""
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

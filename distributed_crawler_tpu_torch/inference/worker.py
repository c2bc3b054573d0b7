"""Worker service: record batches in, embeddings+labels out.

The core of the reference's `distributed_crawler_tpu/inference/worker.py`
(`TPUWorker`), serving the port's `InferenceEngine`:

- the bus handler only decodes and enqueues (it never blocks on the
  device); raising into the bus on a full queue is the backpressure path;
- the feed thread drains up to ``coalesce_batches`` queued batches per
  dispatch and runs them through the engine as ONE token stream (packed
  when ``pack`` is on), then fans the results back so every batch keeps
  its own publish, writeback and ack; when the coalesced step raises, each
  batch is retried on its own so one poisoned batch cannot take its
  neighbours down;
- results are published on ``TOPIC_INFERENCE_RESULTS`` and, with a
  ``provider`` (anything with ``put_text(path, text)``), written back as one
  idempotent JSONL file per batch.

Heartbeats, telemetry, SLOs, the stall watchdog, span export, the profiler,
the metrics server and the tenant ledger wait for later slices.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from ..bus.codec import RecordBatch, utcnow
from ..bus.messages import TOPIC_INFERENCE_BATCHES, TOPIC_INFERENCE_RESULTS
from ..utils import trace
from ..utils.metrics import REGISTRY, MetricsRegistry
from .engine import InferenceEngine

logger = logging.getLogger(__name__)


@dataclass
class TPUWorkerConfig:
    worker_id: str = "tpu-worker-0"
    queue_capacity: int = 64          # decoded batches awaiting the device
    storage_prefix: str = "inference"
    write_embeddings: bool = True     # False: labels/scores only in JSONL
    # Whether result frames on TOPIC_INFERENCE_RESULTS carry embeddings.
    publish_embeddings: bool = True
    # Batches drained per dispatch and run as one token stream; 1 = one
    # batch per dispatch.
    coalesce_batches: int = 4
    # Sequence packing (`engine.run_tokenized(..., pack=True)`).
    pack: bool = True


class TPUWorker:
    """Consume RecordBatches from the bus, run the engine, publish and
    write back the results.  Results land as
    `{storage_prefix}/{crawl_id}/batches/{batch_id}.jsonl`."""

    def __init__(self, bus, engine: InferenceEngine, provider=None,
                 cfg: TPUWorkerConfig = TPUWorkerConfig(),
                 registry: MetricsRegistry = REGISTRY):
        self.bus = bus
        self.engine = engine
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
        self.m_batches = registry.counter(
            "tpu_worker_batches_total", "record batches processed")
        self.m_batch_age = registry.histogram(
            "tpu_worker_batch_age_seconds",
            "bus transit + queue wait per batch")
        self.m_coalesce = registry.histogram(
            "tpu_worker_coalesced_group_batches",
            "record batches coalesced into one device stream")
        self.m_outcomes = registry.counter(
            "tpu_worker_batch_outcomes_total",
            "record batches by final commit outcome")

    def get_status(self) -> dict:
        return {
            "worker_id": self.cfg.worker_id,
            "model": self.engine.cfg.model,
            "device": str(self.engine.device),
            "is_running": not self._stop.is_set() and bool(self._threads),
            "queue_depth": self._queue.qsize(),
            "inflight": self._inflight,
            "processed_batches": self._processed,
            "error_batches": self._errors,
            "uptime_s": (time.monotonic() - self._started_at)
            if self._started_at else 0.0,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._started_at = time.monotonic()
        self.bus.subscribe(TOPIC_INFERENCE_BATCHES, self._handle_payload)
        t = threading.Thread(target=self._feed_loop, daemon=True,
                             name="tpu-feed")
        t.start()
        self._threads.append(t)
        logger.info("worker %s started on %s", self.cfg.worker_id,
                    self.engine.device)

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        flush = getattr(self.provider, "flush", None)
        if callable(flush):
            flush()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every accepted batch — queued or mid-process — has
        finished."""
        with self._idle:
            return self._idle.wait_for(
                lambda: self._inflight == 0, timeout=timeout_s)

    # -- bus handler (never blocks on the device) --------------------------
    def _handle_payload(self, payload: Dict[str, Any], ack=None) -> None:
        """``ack`` comes from manual-ack buses: the batch is acked only once
        it is processed and written back.  The in-memory bus calls with the
        payload alone."""
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
                # No work queued: the next dispatch opens a new stream, so
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

    def _process_group(self,
                       items: List[Tuple[RecordBatch, Any, float]]) -> None:
        now = time.monotonic()
        for batch, _, enq_t in items:
            trace.record("tpu_worker.queue_wait", now - enq_t,
                         trace_id=batch.trace_id, batch=batch.batch_id,
                         worker=self.cfg.worker_id, tenant=batch.tenant)
        if len(items) == 1:
            batch, ack, _ = items[0]
            self._process_one(batch, ack)
            return
        self.m_coalesce.observe(len(items))
        # Tokenize per batch first: a record whose text cannot tokenize
        # fails its own batch here, before any neighbour joins it.
        good: List[Tuple[RecordBatch, Any, List[List[int]]]] = []
        for batch, ack, _ in items:
            try:
                with trace.span("engine.tokenize", trace_id=batch.trace_id,
                                records=len(batch.records)):
                    toks = self.engine.tokenizer.encode_batch(batch.texts())
            except Exception:
                self._errors += 1
                self.m_outcomes.labels(outcome="error").inc()
                logger.exception("batch %s failed to tokenize",
                                 batch.batch_id)
                if ack is not None:
                    ack(False)
                continue
            self._observe_age(batch)
            good.append((batch, ack, toks))
        if not good:
            return
        all_toks = [t for _, _, toks in good for t in toks]
        try:
            with trace.span("tpu_worker.coalesce",
                            trace_id=good[0][0].trace_id,
                            batches=len(good),
                            batch_ids=[b.batch_id for b, _, _ in good],
                            sequences=len(all_toks)):
                results = self.engine.run_tokenized(all_toks,
                                                    pack=self.cfg.pack)
        except Exception:
            logger.exception("coalesced step over %d batches failed; "
                             "isolating per batch", len(good))
            for batch, ack, toks in good:
                self._process_tokenized(batch, ack, toks)
            return
        off = 0
        for batch, ack, toks in good:
            rs = results[off:off + len(toks)]
            off += len(toks)
            self._finish_batch(batch, ack, lambda rs=rs: rs)

    def _finish_batch(self, batch: RecordBatch, ack, produce) -> None:
        """The one copy of the commit/ack/error accounting every path
        shares; ``produce`` yields the batch's results (or raises)."""
        try:
            results = produce()
            with trace.span("tpu_worker.commit", trace_id=batch.trace_id,
                            batch=batch.batch_id,
                            records=len(batch.records)):
                self._commit(batch, results)
        except Exception:
            self._errors += 1
            self.m_outcomes.labels(outcome="error").inc()
            logger.exception("batch %s failed", batch.batch_id)
            if ack is not None:
                ack(False)
            return
        self._processed += 1
        self.m_outcomes.labels(outcome="ok").inc()
        if ack is not None:
            ack(True)

    def _process_one(self, batch: RecordBatch, ack) -> None:
        def produce():
            self._observe_age(batch)
            with trace.span("tpu_worker.process", trace_id=batch.trace_id,
                            batch=batch.batch_id,
                            records=len(batch.records)):
                return self.engine.run(batch.texts(), pack=self.cfg.pack)

        self._finish_batch(batch, ack, produce)

    def _process_tokenized(self, batch: RecordBatch, ack, toks) -> None:
        """Per-batch retry after a failed coalesced step, reusing the
        batch's token lists."""
        def produce():
            with trace.span("tpu_worker.process", trace_id=batch.trace_id,
                            batch=batch.batch_id, isolated=True):
                return self.engine.run_tokenized(toks, pack=self.cfg.pack)

        self._finish_batch(batch, ack, produce)

    def _observe_age(self, batch: RecordBatch) -> None:
        if batch.created_at is None:
            return
        age = (utcnow() - batch.created_at).total_seconds()
        if age >= 0:
            self.m_batch_age.observe(age)
            trace.record("tpu_worker.batch_age", age,
                         trace_id=batch.trace_id, batch=batch.batch_id,
                         worker=self.cfg.worker_id, tenant=batch.tenant)

    @staticmethod
    def _strip_embeddings(results):
        return [{k: v for k, v in r.items() if k != "embedding"}
                for r in results]

    def _commit(self, batch: RecordBatch, results) -> None:
        # Two sinks, two knobs: publish_embeddings governs the bus frame,
        # write_embeddings the JSONL writeback.
        batch.results = results if self.cfg.publish_embeddings \
            else self._strip_embeddings(results)
        self.m_batches.inc()
        self.bus.publish(TOPIC_INFERENCE_RESULTS, batch.to_dict())
        if self.provider is not None:
            batch.results = results if self.cfg.write_embeddings \
                else self._strip_embeddings(results)
            self._writeback(batch)

    def _writeback(self, batch: RecordBatch) -> None:
        """Idempotent: one file per batch_id, so a redelivery overwrites
        the same file with the same content."""
        rel = (f"{self.cfg.storage_prefix}/{batch.crawl_id or 'adhoc'}"
               f"/batches/{batch.batch_id}.jsonl")
        lines = []
        for record, result in zip(batch.records, batch.results):
            lines.append(json.dumps({
                "post_uid": record.get("post_uid", ""),
                "channel_name": record.get("channel_name", ""),
                "batch_id": batch.batch_id,
                "trace_id": batch.trace_id,
                "tenant": batch.tenant,
                **result,
            }, ensure_ascii=False))
        self.provider.put_text(rel, "\n".join(lines) + "\n")

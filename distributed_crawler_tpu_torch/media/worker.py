"""ASR worker service: audio-ref batches in, transcripts out.

The serving core of the reference's `distributed_crawler_tpu/media/
worker.py` (`ASRWorker`), shaped like the port's `TPUWorker`:

- the bus handler only decodes and enqueues (it never blocks on the
  device); an undecodable envelope is nacked;
- the feed thread drains up to ``coalesce_batches`` queued audio batches
  per dispatch group so their windows share bucketed device batches
  (`media/chunker.py`); every `AudioBatchMessage` keeps its own transcript
  publish, idempotent writeback and ack; a file that fails to decode
  becomes an explicit error transcript; when the combined device step
  raises, each batch runs alone, so one poisoned batch cannot take its
  neighbours down;
- transcripts go out as `TranscriptMessage`s on ``TOPIC_TRANSCRIPTS`` and,
  with a ``provider`` (anything with ``put_text(path, text)``), are written
  as one JSONL file per batch under
  ``{storage_prefix}/{crawl_id}/batches/{batch_id}.jsonl``.

Heartbeats, SLOs, span export, the flight recorder, the metrics server and
the tenant ledger wait for a later slice.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..bus.codec import utcnow
from ..bus.messages import (
    TOPIC_MEDIA_BATCHES,
    TOPIC_TRANSCRIPTS,
    AudioBatchMessage,
    TranscriptMessage,
)
from ..utils import trace
from ..utils.metrics import REGISTRY, MetricsRegistry
from .chunker import ChunkPlan

logger = logging.getLogger(__name__)


def iter_transcripts(provider, crawl_id: str,
                     storage_prefix: str = "asr"):
    """Yield the transcript rows of every per-batch file of a crawl, in
    file order (``provider`` has ``list_dir`` and ``get_text``)."""
    base = f"{storage_prefix}/{crawl_id}/batches"
    for name in provider.list_dir(base):
        if not name.endswith(".jsonl"):
            continue
        text = provider.get_text(f"{base}/{name}")
        for line in (text or "").splitlines():
            if line:
                yield json.loads(line)


@dataclass
class ASRWorkerConfig:
    worker_id: str = "asr-worker-0"
    queue_capacity: int = 64          # decoded audio batches awaiting device
    storage_prefix: str = "asr"
    # Transcript rows carry token ids; False drops them from the writeback.
    write_tokens: bool = True
    # Audio batches drained per dispatch group, their windows sharing
    # bucketed device batches; 1 = one batch per group.
    coalesce_batches: int = 2


class ASRWorker:
    """Consume AudioBatchMessages, run the ASR pipeline, publish
    transcripts and write them back.  ``pipeline`` is an
    `inference.asr.ASRPipeline` (or anything with its ``chunker`` /
    ``transcribe_plan`` surface)."""

    def __init__(self, bus, pipeline, provider=None,
                 cfg: ASRWorkerConfig = ASRWorkerConfig(),
                 registry: MetricsRegistry = REGISTRY):
        self.bus = bus
        self.pipeline = pipeline
        self.provider = provider
        self.cfg = cfg
        # (message, ack, enqueue time on the monotonic clock)
        self._queue: "queue.Queue[Tuple[AudioBatchMessage, Any, float]]" = \
            queue.Queue(cfg.queue_capacity)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._idle = threading.Condition()
        self._inflight = 0          # batches accepted but not yet finished
        self._started_at = 0.0
        self._processed = 0
        self._errors = 0
        self.m_batches = registry.counter(
            "asr_worker_batches_total", "audio batches processed")
        self.m_media = registry.counter(
            "asr_worker_media_total", "media files transcribed (incl. "
            "explicit error rows)")
        self.m_batch_age = registry.histogram(
            "asr_worker_batch_age_seconds",
            "bus transit + queue wait per audio batch")
        self.m_coalesce = registry.histogram(
            "asr_worker_coalesced_group_batches",
            "audio batches coalesced into one device group")
        self.m_outcomes = registry.counter(
            "asr_worker_batch_outcomes_total",
            "audio batches by final commit outcome")

    def get_status(self) -> dict:
        return {
            "worker_id": self.cfg.worker_id,
            "model": "whisper",
            "device": str(getattr(self.pipeline, "device", "")),
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
        self.bus.subscribe(TOPIC_MEDIA_BATCHES, self._handle_payload)
        t = threading.Thread(target=self._feed_loop, daemon=True,
                             name="asr-feed")
        t.start()
        self._threads.append(t)
        logger.info("asr worker %s started", self.cfg.worker_id)

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        flush = getattr(self.provider, "flush", None)
        if callable(flush):
            flush()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every accepted batch has finished."""
        with self._idle:
            return self._idle.wait_for(
                lambda: self._inflight == 0, timeout=timeout_s)

    def warmup(self) -> None:
        """Dispatch every window bucket once before serving."""
        warm = getattr(self.pipeline, "warmup", None)
        if callable(warm):
            warm()

    # -- bus handler (never blocks on the device) --------------------------
    def _handle_payload(self, payload: Dict[str, Any], ack=None) -> None:
        """``ack`` comes from manual-ack buses: the batch is acked only
        once its transcripts are published and written back."""
        try:
            msg = AudioBatchMessage.from_dict(payload)
        except Exception as e:
            # Undecodable envelope: nothing to write back; nack it.
            logger.error("undecodable audio batch payload: %s", e)
            if ack is not None:
                ack(False)
            return
        if not msg.refs:
            if ack is not None:
                ack(True)
            return
        with self._idle:
            self._inflight += 1
        try:
            self._queue.put((msg, ack, time.monotonic()), timeout=5.0)
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
        timeline = getattr(self.pipeline, "timeline", None)
        while not self._stop.is_set():
            try:
                items = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                # No work queued: the next dispatch opens a new stream, so
                # this wait never scores as a pipeline bubble.
                if timeline is not None:
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

    def _process_group(
            self,
            items: List[Tuple[AudioBatchMessage, Any, float]]) -> None:
        now = time.monotonic()
        for msg, _, enq_t in items:
            trace.record("asr_worker.queue_wait", now - enq_t,
                         trace_id=msg.trace_id, batch=msg.batch_id,
                         worker=self.cfg.worker_id, tenant=msg.tenant)
            self._observe_age(msg)
        if len(items) == 1:
            msg, ack, _ = items[0]
            self._process_isolated(msg, ack, self._chunk(msg))
            return
        self.m_coalesce.observe(len(items))
        # Decode and chunk per batch first: a ref that fails to decode
        # becomes that batch's error row, never a neighbour's problem.
        plans = [self._chunk(msg) for msg, _, _ in items]
        try:
            with trace.span("asr_worker.coalesce",
                            trace_id=items[0][0].trace_id,
                            batches=len(items),
                            batch_ids=[m.batch_id for m, _, _ in items],
                            windows=sum(p.n_windows for p in plans
                                        if p is not None)):
                merged = self._merge_plans(plans)
                per_window = self.pipeline.transcribe_plan(merged) \
                    if merged is not None else []
        except Exception as e:
            logger.exception(
                "coalesced ASR step over %d batches failed (%s); "
                "isolating per batch", len(items), e)
            for (msg, ack, _), plan in zip(items, plans):
                self._process_isolated(msg, ack, plan)
            return
        off = 0
        for (msg, ack, _), plan in zip(items, plans):
            if plan is None:
                self._fail_batch(msg, ack, "chunking failed")
                continue
            rows = per_window[off:off + plan.n_windows]
            off += plan.n_windows
            self._finish_batch(msg, ack, plan, lambda rows=rows: rows)

    @staticmethod
    def _merge_plans(plans: List[Optional[ChunkPlan]]
                     ) -> Optional[ChunkPlan]:
        """Concatenate ChunkPlans into one (file indices offset) so the
        group's windows share bucketed batches."""
        plans = [p for p in plans if p is not None]
        if not plans:
            return None
        merged = ChunkPlan(
            window_samples=plans[0].window_samples,
            windows=np.concatenate([p.windows for p in plans])
            if any(p.n_windows for p in plans)
            else plans[0].windows[:0])
        base = 0
        for p in plans:
            merged.segment_map.extend(
                (base + fi, wi) for fi, wi in p.segment_map)
            merged.errors.update({base + i: e for i, e in p.errors.items()})
            merged.real_samples.extend(p.real_samples)
            base += p.n_files
        merged.n_files = base
        return merged

    def _chunk(self, msg: AudioBatchMessage) -> Optional[ChunkPlan]:
        """Decode and window one batch's refs; None only when the chunker
        itself fails (per-file failures are ``plan.errors`` entries)."""
        try:
            with trace.span("asr_worker.chunk", trace_id=msg.trace_id,
                            batch=msg.batch_id, refs=len(msg.refs)):
                return self.pipeline.chunker.chunk_files(
                    [r.path for r in msg.refs])
        except Exception as e:
            logger.exception("batch %s failed to chunk: %s",
                             msg.batch_id, e)
            return None

    # -- single-batch path -------------------------------------------------
    def _process_isolated(self, msg: AudioBatchMessage, ack,
                          plan: Optional[ChunkPlan]) -> None:
        if plan is None:
            self._fail_batch(msg, ack, "chunking failed")
            return

        def produce():
            with trace.span("asr_worker.process", trace_id=msg.trace_id,
                            batch=msg.batch_id, refs=len(msg.refs),
                            windows=plan.n_windows, tenant=msg.tenant):
                return self.pipeline.transcribe_plan(plan)

        self._finish_batch(msg, ack, plan, produce)

    # -- commit / ack (the one copy every path shares) ---------------------
    def _finish_batch(self, msg: AudioBatchMessage, ack, plan: ChunkPlan,
                      produce) -> None:
        try:
            per_window = produce()
            transcripts = self._assemble(msg, plan, per_window)
            with trace.span("asr_worker.commit", trace_id=msg.trace_id,
                            batch=msg.batch_id, refs=len(msg.refs)):
                self._commit(msg, transcripts)
        except Exception as e:
            self._fail_batch(msg, ack, str(e), exc=True)
            return
        self._processed += 1
        self.m_outcomes.labels(outcome="ok").inc()
        self._ack(msg, ack, True)

    def _fail_batch(self, msg: AudioBatchMessage, ack, reason: str,
                    exc: bool = False) -> None:
        self._errors += 1
        self.m_outcomes.labels(outcome="error").inc()
        if exc:
            logger.exception("audio batch %s failed: %s",
                             msg.batch_id, reason)
        else:
            logger.error("audio batch %s failed: %s", msg.batch_id, reason)
        self._ack(msg, ack, False)

    @staticmethod
    def _ack(msg: AudioBatchMessage, ack, ok: bool) -> None:
        if ack is None:
            return
        t0 = time.perf_counter()
        ack(ok)
        trace.record("asr_worker.ack", time.perf_counter() - t0,
                     trace_id=msg.trace_id, batch=msg.batch_id, ok=ok)

    def _assemble(self, msg: AudioBatchMessage, plan: ChunkPlan,
                  per_window) -> List[TranscriptMessage]:
        """Per-window tokens -> one TranscriptMessage per ref, in input
        order, failures explicit."""
        per_file = self.pipeline.chunker.reassemble(plan, per_window)
        counts = plan.windows_per_file()
        detok = getattr(self.pipeline, "detokenize", None)
        rate = float(getattr(self.pipeline, "sample_rate", 16_000))
        out: List[TranscriptMessage] = []
        for i, ref in enumerate(msg.refs):
            common = dict(crawl_id=msg.crawl_id, batch_id=msg.batch_id,
                          worker_id=self.cfg.worker_id,
                          trace_id=msg.trace_id, tenant=msg.tenant)
            if i in plan.errors:
                out.append(TranscriptMessage.new(
                    ref.media_id, path=ref.path,
                    channel_name=ref.channel_name,
                    error=plan.errors[i], **common))
                continue
            toks = per_file[i]
            text = detok(toks) if callable(detok) else ""
            out.append(TranscriptMessage.new(
                ref.media_id, path=ref.path,
                channel_name=ref.channel_name, text=text, tokens=toks,
                windows=counts[i],
                duration_s=counts[i] * plan.window_samples / rate,
                **common))
        return out

    def _commit(self, msg: AudioBatchMessage,
                transcripts: List[TranscriptMessage]) -> None:
        self.m_batches.inc()
        self.m_media.inc(len(transcripts))
        for t in transcripts:
            self.bus.publish(TOPIC_TRANSCRIPTS, t.to_dict())
        if self.provider is not None:
            self._writeback(msg, transcripts)

    def _writeback(self, msg: AudioBatchMessage,
                   transcripts: List[TranscriptMessage]) -> None:
        """Idempotent: one file per batch_id, so a redelivery overwrites
        the same file with the same content."""
        rel = (f"{self.cfg.storage_prefix}/{msg.crawl_id or 'adhoc'}"
               f"/batches/{msg.batch_id}.jsonl")
        lines = []
        for t in transcripts:
            row = {
                "media_id": t.media_id,
                "post_uid": t.post_uid,
                "channel_name": t.channel_name,
                "batch_id": msg.batch_id,
                "trace_id": msg.trace_id,
                "tenant": msg.tenant,
                "text": t.text,
                "windows": t.windows,
                "error": t.error,
            }
            if self.cfg.write_tokens:
                row["tokens"] = list(t.tokens)
            lines.append(json.dumps(row, ensure_ascii=False))
        self.provider.put_text(rel, "\n".join(lines) + "\n")

    def _observe_age(self, msg: AudioBatchMessage) -> None:
        if msg.created_at is None:
            return
        age = (utcnow() - msg.created_at).total_seconds()
        if age >= 0:
            self.m_batch_age.observe(age)
            trace.record("asr_worker.batch_age", age,
                         trace_id=msg.trace_id, batch=msg.batch_id,
                         worker=self.cfg.worker_id, tenant=msg.tenant)

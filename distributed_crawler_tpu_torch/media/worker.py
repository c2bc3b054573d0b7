"""ASR worker service: audio-ref batches in, transcripts out.

The reference's `distributed_crawler_tpu/media/worker.py` (`ASRWorker`),
shaped like the port's `TPUWorker`:

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
  ``{storage_prefix}/{crawl_id}/batches/{batch_id}.jsonl``;
- the operations layer of the text worker: heartbeats with telemetry
  (``worker_type="asr"``), the ``slo_asr_batch_p95_ms`` budget beside the
  shared queue-wait and batch-age budgets, span export, ``/metrics``,
  ``/status`` and ``/costs`` on ``metrics_port``, a ``worker_stopping``
  status on ``stop()`` and a silent ``kill()``.
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
    MSG_HEARTBEAT,
    MSG_WORKER_STOPPING,
    TOPIC_MEDIA_BATCHES,
    TOPIC_SPANS,
    TOPIC_TRANSCRIPTS,
    TOPIC_WORKER_STATUS,
    WORKER_BUSY,
    WORKER_IDLE,
    WORKER_OFFLINE,
    AudioBatchMessage,
    SpanBatchMessage,
    StatusMessage,
    TranscriptMessage,
)
from ..utils import flight, trace
from ..utils.metrics import (
    REGISTRY,
    MetricsRegistry,
    serve_metrics,
)
from ..utils.occupancy import QueueDepthSampler
from ..utils.slo import SLOWatchdog, standard_slos
from ..utils.telemetry import TelemetryEmitter
from ..utils.timeseries import RegistrySampler
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
    heartbeat_s: float = 30.0
    queue_capacity: int = 64          # decoded audio batches awaiting device
    metrics_port: int = 0             # 0 = don't serve; >0 = HTTP port
    storage_prefix: str = "asr"
    # Transcript rows carry token ids; False drops them from the writeback.
    write_tokens: bool = True
    # Audio batches drained per dispatch group, their windows sharing
    # bucketed device batches; 1 = one batch per group.
    coalesce_batches: int = 2
    # SLO budgets (`utils/slo.py`), evaluated once per heartbeat; 0 = no
    # budget declared.  asr_batch is the per-group budget; queue_wait and
    # batch_age share the text worker's budget families.
    slo_asr_batch_p95_ms: float = 0.0
    slo_queue_wait_ms: float = 0.0
    slo_batch_age_ms: float = 0.0
    # Span export, as the text worker's; interval 0 = off.
    span_export_interval_s: float = 15.0
    span_export_max_spans: int = 512
    span_sample_rate: float = 1.0


class ASRWorker:
    """Consume AudioBatchMessages, run the ASR pipeline, publish
    transcripts and write them back.  ``pipeline`` is an
    `inference.asr.ASRPipeline` (or anything with its ``chunker`` /
    ``transcribe_plan`` / ``cost_snapshot`` surface)."""

    def __init__(self, bus, pipeline,
                 provider=None,
                 cfg: ASRWorkerConfig = ASRWorkerConfig(),
                 registry: MetricsRegistry = REGISTRY):
        self.bus = bus
        self.pipeline = pipeline
        self.provider = provider
        self.cfg = cfg
        self._queue: "queue.Queue[Tuple[AudioBatchMessage, Any, float]]" = \
            queue.Queue(cfg.queue_capacity)
        self._stop = threading.Event()
        self._threads: list = []
        self._idle = threading.Condition()
        self._inflight = 0
        self._registry = registry
        self._started_at = 0.0
        self._processed = 0
        self._errors = 0
        self._metrics_server = None
        self._killed = False
        self._stop_announced = False
        self.m_queue_depth = registry.gauge(
            "asr_worker_queue_depth",
            "decoded audio batches awaiting device (time-weighted "
            "rolling mean — an edge-triggered gauge aliases between "
            "scrapes)")
        self._depth = QueueDepthSampler(self.m_queue_depth)
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
        self._telemetry = TelemetryEmitter(
            engine=pipeline, include_device=True,
            counters={"batch_outcomes": self.m_outcomes})
        self._slo = SLOWatchdog(
            standard_slos(queue_wait_ms=cfg.slo_queue_wait_ms,
                          batch_age_ms=cfg.slo_batch_age_ms,
                          asr_batch_p95_ms=cfg.slo_asr_batch_p95_ms),
            registry=registry)
        self._ts_sampler = RegistrySampler(registry)
        # This worker's stages, and the re-entry hop that runs in the ASR
        # worker's process (the reference's names).
        self._span_exporter = trace.SpanExporter(
            max_spans=cfg.span_export_max_spans,
            sample_rate=cfg.span_sample_rate,
            name_prefixes=("asr_worker.", "asr.", "media.reentry"))
        self._last_span_export = time.monotonic()

    # -- status/costs --------------------------------------------------------
    def get_status(self) -> dict:
        return {
            "worker_id": self.cfg.worker_id,
            "model": "whisper",
            "is_running": not self._stop.is_set() and bool(self._threads),
            "queue_depth": self._queue.qsize(),
            "inflight": self._inflight,
            "processed_batches": self._processed,
            "error_batches": self._errors,
            "uptime_s": (time.monotonic() - self._started_at)
            if self._started_at else 0.0,
        }

    def get_costs(self) -> dict:
        """The /costs body: Whisper program rows + efficiency window +
        this worker's SLO state + per-tenant spend rows."""
        snap_fn = getattr(self.pipeline, "cost_snapshot", None)
        out = dict(snap_fn()) if callable(snap_fn) else {}
        out["worker_id"] = self.cfg.worker_id
        out["slo"] = self._slo.snapshot()
        ledger = self._tenant_ledger()
        if ledger is not None:
            out["tenants"] = ledger.snapshot()
        return out

    # -- tenant attribution --------------------------------------------------
    def _tenant_ledger(self):
        return getattr(getattr(self.pipeline, "meter", None),
                       "tenants", None)

    def _set_meter_tenants(self, weights: Dict[str, float]) -> None:
        set_fn = getattr(getattr(self.pipeline, "meter", None),
                         "set_tenants", None)
        if callable(set_fn):
            set_fn(weights)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._started_at = time.monotonic()
        self.bus.subscribe(TOPIC_MEDIA_BATCHES, self._handle_payload)
        for target, name in ((self._feed_loop, "asr-feed"),
                             (self._heartbeat_loop, "asr-heartbeat")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        if self.cfg.metrics_port:
            self._metrics_server = serve_metrics(
                self.cfg.metrics_port, self._registry,
                providers={"status": self.get_status,
                           "costs": self.get_costs})
        logger.info("asr worker %s started", self.cfg.worker_id)

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        if self.cfg.span_export_interval_s > 0:
            # Graceful stop ships the span tail (kill() deliberately
            # doesn't — a crashed process exports nothing).
            self.export_spans()
        # Clean-shutdown announcement (the TPU worker's mirror): the
        # fleet view marks this worker OFFLINE instead of aging it into
        # "stale" — what autoscaler retirement relies on.
        self._announce_stopping()
        if self.provider is not None:
            flush = getattr(self.provider, "flush", None)
            if callable(flush):
                flush()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()

    def _announce_stopping(self) -> None:
        """Best-effort worker_stopping status on graceful stop;
        idempotent, and silent after kill() (SIGKILL fidelity)."""
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
                worker_type="asr").to_dict())
        except Exception as e:  # a dead bus must not break shutdown
            logger.debug("stopping announcement failed: %s", e)

    def kill(self) -> None:
        """Abrupt death (the text worker's `kill()`): halt the feed and
        heartbeat threads without draining or acking."""
        self._killed = True
        self._stop.set()
        flight.record("worker_kill", worker=self.cfg.worker_id,
                      queue_depth=self._queue.qsize(),
                      inflight=self._inflight)
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def evaluate_slos(self) -> list:
        """One SLO evaluation tick on demand (the heartbeat's twin)."""
        return self._slo.evaluate()

    def export_spans(self) -> int:
        """Ship spans completed since the last export on TOPIC_SPANS
        (the TPU worker's mirror); returns the count shipped.  Never
        raises into the serving path."""
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

    def drain(self, timeout_s: float = 30.0) -> bool:
        with self._idle:
            return self._idle.wait_for(
                lambda: self._inflight == 0, timeout=timeout_s)

    def warmup(self) -> None:
        """Dispatch every window bucket once before serving."""
        warm = getattr(self.pipeline, "warmup", None)
        if callable(warm):
            warm()

    # -- bus handler (never blocks on the device) ----------------------------
    def _handle_payload(self, payload: Dict[str, Any], ack=None) -> None:
        """``ack`` is supplied by manual-ack buses (RemoteBus); the frame
        is acked only after transcripts are published AND written back."""
        try:
            msg = AudioBatchMessage.from_dict(payload)
        except Exception as e:
            # Undecodable envelope: poison at the wire layer.  Nack so a
            # manual-ack bus dead-letters/requeues per its policy; there
            # is nothing to write back.
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
                flight.record("asr_batch", batch=msg.batch_id,
                              outcome="requeued", reason="queue_full")
                ack(False)
                return
            raise
        self._depth.update(self._queue.qsize())

    def _finish_one(self) -> None:
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    # -- feed loop (coalescing) ----------------------------------------------
    def _feed_loop(self) -> None:
        timeline = getattr(self.pipeline, "timeline", None)
        while not self._stop.is_set():
            try:
                items = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                # Queue dry = idle-by-no-work: the next dispatch opens a
                # new occupancy stream, never a pipeline bubble.
                if timeline is not None:
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

    def _process_group(
            self,
            items: List[Tuple[AudioBatchMessage, Any, float]]) -> None:
        now = time.monotonic()
        ledger = self._tenant_ledger()
        for msg, _, enq_t in items:
            trace.record("asr_worker.queue_wait", now - enq_t,
                         trace_id=msg.trace_id, batch=msg.batch_id,
                         worker=self.cfg.worker_id, tenant=msg.tenant)
            if ledger is not None and msg.tenant:
                ledger.observe_queue_wait(msg.tenant, now - enq_t)
            self._observe_age(msg)
        if len(items) == 1:
            msg, ack, _ = items[0]
            self._process_one(msg, ack)
            return
        self.m_coalesce.observe(len(items))
        # Decode + chunk per batch FIRST: a ref that fails to decode
        # becomes that batch's error row, never a neighbor's problem.
        plans = []
        for msg, ack, _ in items:
            plans.append(self._chunk(msg))
        # Tenant weights for the combined dispatch = window counts.
        weights: Dict[str, float] = {}
        for (msg, _, _), plan in zip(items, plans):
            if plan is not None:
                weights[msg.tenant] = weights.get(msg.tenant, 0.0) \
                    + max(1, plan.n_windows)
        self._set_meter_tenants(weights)
        dominant = max(weights, key=weights.get) if weights else ""
        # One combined window list across the group -> shared bucketed
        # device batches; per-batch window counts fan results back.
        try:
            with trace.span("asr_worker.coalesce",
                            trace_id=items[0][0].trace_id,
                            batches=len(items),
                            batch_ids=[m.batch_id for m, _, _ in items],
                            windows=sum(p.n_windows for p in plans
                                        if p is not None),
                            tenant=dominant):
                merged = self._merge_plans([p for p in plans
                                            if p is not None])
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

    def _chunk(self, msg: AudioBatchMessage):
        """Decode + window one batch's refs; None only on a total chunker
        failure (per-file failures are plan.errors entries)."""
        try:
            with trace.span("asr_worker.chunk", trace_id=msg.trace_id,
                            batch=msg.batch_id, refs=len(msg.refs)):
                return self.pipeline.chunker.chunk_files(
                    [r.path for r in msg.refs])
        except Exception as e:
            logger.exception("batch %s failed to chunk: %s",
                             msg.batch_id, e)
            return None

    # -- single-batch paths --------------------------------------------------
    def _process_one(self, msg: AudioBatchMessage, ack) -> None:
        plan = self._chunk(msg)
        self._process_isolated(msg, ack, plan)

    def _process_isolated(self, msg: AudioBatchMessage, ack, plan) -> None:
        if plan is None:
            self._fail_batch(msg, ack, "chunking failed")
            return

        def produce():
            self._set_meter_tenants({msg.tenant: max(1, plan.n_windows)})
            with trace.span("asr_worker.process", trace_id=msg.trace_id,
                            batch=msg.batch_id, refs=len(msg.refs),
                            windows=plan.n_windows, tenant=msg.tenant):
                return self.pipeline.transcribe_plan(plan)

        self._finish_batch(msg, ack, plan, produce)

    # -- commit / ack (the ONE copy every path shares) -----------------------
    def _finish_batch(self, msg: AudioBatchMessage, ack, plan,
                      produce) -> None:
        try:
            per_window = produce()
            transcripts = self._assemble(msg, plan, per_window)
            with trace.span("asr_worker.commit", trace_id=msg.trace_id,
                            batch=msg.batch_id, refs=len(msg.refs)):
                self._commit(msg, transcripts)
            self._processed += 1
            self.m_outcomes.labels(outcome="ok").inc()
            flight.record("asr_batch", batch=msg.batch_id, outcome="ok",
                          refs=len(msg.refs), windows=plan.n_windows)
            self._ack(msg, ack, True)
        except Exception as e:
            self._fail_batch(msg, ack, str(e), exc=True)

    def _fail_batch(self, msg: AudioBatchMessage, ack, reason: str,
                    exc: bool = False) -> None:
        self._errors += 1
        self.m_outcomes.labels(outcome="error").inc()
        flight.record("asr_batch", batch=msg.batch_id, outcome="error",
                      error=reason)
        if exc:
            logger.exception("audio batch %s failed: %s",
                             msg.batch_id, reason)
        else:
            logger.error("audio batch %s failed: %s", msg.batch_id, reason)
        self._ack(msg, ack, False)

    def _ack(self, msg: AudioBatchMessage, ack, ok: bool) -> None:
        if ack is None:
            return
        t0 = time.perf_counter()
        ack(ok)
        trace.record("asr_worker.ack", time.perf_counter() - t0,
                     trace_id=msg.trace_id, batch=msg.batch_id, ok=ok)

    def _assemble(self, msg: AudioBatchMessage, plan,
                  per_window) -> List[TranscriptMessage]:
        """Fan per-window tokens back to one TranscriptMessage per ref,
        input order, failures explicit."""
        per_file = self.pipeline.chunker.reassemble(plan, per_window)
        counts = plan.windows_per_file()
        detok = getattr(self.pipeline, "detokenize", None)
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
            rate = float(getattr(self.pipeline, "sample_rate", 16_000))
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
            # Retroactive span for the whole-pipeline age budget.
            trace.record("asr_worker.batch_age", age,
                         trace_id=msg.trace_id, batch=msg.batch_id,
                         worker=self.cfg.worker_id, tenant=msg.tenant)

    # -- heartbeats ----------------------------------------------------------
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
                worker_type="asr")
            msg.queue_length = self._queue.qsize()
            msg.resource_usage = self._telemetry.snapshot()
            msg.resource_usage["queue"] = {
                "depth": self._queue.qsize(),
                "depth_time_weighted": round(self._depth.sample(), 4),
            }
            # Burn-rate feed + self-sample, the TPU worker's mirror.
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
            self._ts_sampler.sample()
            try:
                self.bus.publish(TOPIC_WORKER_STATUS, msg.to_dict())
            except Exception as e:  # bus outage must not kill the worker
                logger.warning("heartbeat publish failed: %s", e)
            self._wait_with_span_exports(self.cfg.heartbeat_s)

    def _wait_with_span_exports(self, wait_s: float) -> None:
        """Sleep until the next heartbeat, firing span exports on their
        OWN cadence in between (the TPU worker's mirror)."""
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

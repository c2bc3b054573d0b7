"""Worker service: record batches in, embeddings+labels out.

The reference's `distributed_crawler_tpu/inference/worker.py`
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

The operations layer, with the reference's names and knobs:

- a heartbeat (`StatusMessage`, ``worker_type="tpu"``) on
  ``TOPIC_WORKER_STATUS`` every ``heartbeat_s``, carrying the telemetry
  snapshot (RSS, the card's memory, first-dispatch deltas, the engine's
  MFU window and occupancy, batch outcomes, a latency digest, the
  time-weighted queue depth, SLO breach counts, tenant spend rows), and a
  ``worker_stopping`` status on a graceful ``stop()`` (``kill()`` stays
  silent, as a killed process would);
- the SLO watchdog evaluated each beat, the registry self-sampled into the
  time-series store, and finished spans shipped as `SpanBatchMessage`s on
  ``TOPIC_SPANS`` every ``span_export_interval_s``;
- ``metrics_port`` serves ``/metrics``, ``/status``, ``/costs``,
  ``/traces``, ``/profile`` and ``/timeseries``; ``profile_on_slow_ms``
  starts one torch.profiler capture when a device step runs long;
- the stall watchdog: a device step older than ``stall_warn_s`` is
  counted and logged, and one older than ``stall_exit_s`` writes a
  ``stall_exit`` flight bundle and exits the process with code 17.  It
  relies on the feed thread releasing the GIL while it waits on the card,
  which the event wait, the readback and the kernel launch all do.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..bus.codec import RecordBatch, utcnow
from ..bus.messages import (
    MSG_HEARTBEAT,
    MSG_WORKER_STOPPING,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_INFERENCE_RESULTS,
    TOPIC_SPANS,
    TOPIC_WORKER_STATUS,
    WORKER_BUSY,
    WORKER_IDLE,
    WORKER_OFFLINE,
    SpanBatchMessage,
    StatusMessage,
)
from ..utils import flight, profiling, trace
from ..utils.metrics import (
    REGISTRY,
    MetricsRegistry,
    serve_metrics,
)
from ..utils.occupancy import QueueDepthSampler
from ..utils.slo import SLOWatchdog, standard_slos
from ..utils.telemetry import TelemetryEmitter
from ..utils.timeseries import RegistrySampler
from .engine import InferenceEngine

logger = logging.getLogger(__name__)

# The process's exit code when the stall watchdog gives up on the device.
STALL_EXIT_CODE = 17


@dataclass
class TPUWorkerConfig:
    worker_id: str = "tpu-worker-0"
    heartbeat_s: float = 30.0
    queue_capacity: int = 64          # decoded batches awaiting the device
    metrics_port: int = 0             # 0 = don't serve; >0 = HTTP port
    # Kept for the reference's configuration; torch has no attachable
    # trace server, so a non-zero port only logs a warning
    # (`utils/profiling.start_profiler_server`).
    profiler_port: int = 0
    storage_prefix: str = "inference"
    write_embeddings: bool = True     # False: labels/scores only in JSONL
    # Whether result frames on TOPIC_INFERENCE_RESULTS carry embeddings
    # (the cluster worker needs them).
    publish_embeddings: bool = True
    # Device-stall watchdog: a device step older than ``stall_warn_s`` is
    # counted, logged and flagged on /status; one older than
    # ``stall_exit_s`` (0 = never) exits the process so a supervisor
    # restarts it (un-acked frames requeue; the writeback is idempotent).
    # Warmup runs under the same watchdog (`TPUWorker.warmup`).
    stall_warn_s: float = 120.0       # 0 disables the watchdog
    stall_exit_s: float = 0.0         # 0 = warn only, never exit
    # Batches drained per dispatch and run as one token stream; 1 = one
    # batch per dispatch.
    coalesce_batches: int = 4
    # Sequence packing (`engine.run_tokenized(..., pack=True)`).
    pack: bool = True
    # SLO budgets (`utils/slo.py`), evaluated once per heartbeat over the
    # spans finished since the previous beat; 0 = no budget declared.
    slo_batch_p95_ms: float = 0.0     # p95 of tpu_worker.process/coalesce
    slo_queue_wait_ms: float = 0.0    # p95 of tpu_worker.queue_wait
    slo_batch_age_ms: float = 0.0     # p95 of tpu_worker.batch_age
    # A device step slower than this many ms starts one bounded
    # torch.profiler capture into the dump dir (`utils/profiling.py`).
    # 0 = off.
    profile_on_slow_ms: float = 0.0
    # Span export (`utils/trace.SpanExporter` -> SpanBatchMessage on
    # TOPIC_SPANS); interval 0 = never ship.  The per-batch bound and the
    # whole-trace sample rate keep a hot worker's export traffic flat.
    span_export_interval_s: float = 15.0
    span_export_max_spans: int = 512
    span_sample_rate: float = 1.0


class TPUWorker:
    """Consume RecordBatches from the bus, run the engine, write results.

    ``provider`` is any `state.providers.StorageProvider`; results land as
    one JSONL file per batch under
    `{storage_prefix}/{crawl_id}/batches/{batch_id}.jsonl` — the same sink
    family the crawler writes posts to, per the north star.  Use
    :func:`iter_results` to read them back as one stream.
    """

    def __init__(self, bus, engine: InferenceEngine,
                 provider=None,
                 cfg: TPUWorkerConfig = TPUWorkerConfig(),
                 registry: MetricsRegistry = REGISTRY):
        self.bus = bus
        self.engine = engine
        self.provider = provider
        self.cfg = cfg
        # Entries are (batch, ack, enqueue_monotonic): the third field is
        # what turns queue wait from a guess into a span.
        self._queue: "queue.Queue[Tuple[RecordBatch, Any, float]]" = \
            queue.Queue(cfg.queue_capacity)
        self._stop = threading.Event()
        self._threads: list = []
        self._idle = threading.Condition()
        self._inflight = 0          # batches accepted but not yet finished
        self._registry = registry
        self._started_at = 0.0
        self._processed = 0
        self._errors = 0
        self._metrics_server = None
        self._killed = False
        self._stop_announced = False
        self._step_started: Optional[float] = None   # monotonic, while in-step
        self._stall_warned = False
        self._watchdog_started = False
        self._exit_fn = None          # test seam; None -> os._exit
        self.m_queue_depth = registry.gauge(
            "tpu_worker_queue_depth",
            "decoded batches awaiting device (time-weighted rolling mean "
            "— an edge-triggered gauge aliases between scrapes)")
        # Time-weighted sampler over the gauge: enqueue/dequeue edges
        # feed it, the heartbeat re-samples it, so scrapes read what the
        # depth WAS over the window, not the last edge's leftovers.
        self._depth = QueueDepthSampler(self.m_queue_depth)
        self.m_stalls = registry.counter(
            "tpu_worker_device_stalls_total",
            "device steps exceeding stall_warn_s")
        self.m_batches = registry.counter(
            "tpu_worker_batches_total", "record batches processed")
        self.m_batch_age = registry.histogram(
            "tpu_worker_batch_age_seconds",
            "bus transit + queue wait per batch")
        self.m_coalesce = registry.histogram(
            "tpu_worker_coalesced_group_batches",
            "record batches coalesced into one device stream")
        # Outcome-labeled twin of m_batches: the ok/error split that the
        # single total hides (use .labels(outcome=...)).
        self.m_outcomes = registry.counter(
            "tpu_worker_batch_outcomes_total",
            "record batches by final commit outcome")
        # Telemetry-rich heartbeats: device memory, compile-cache deltas,
        # batch outcomes, per-stage latency digest — the fleet-view feed.
        self._telemetry = TelemetryEmitter(
            engine=engine, include_device=True,
            counters={"batch_outcomes": self.m_outcomes})
        # SLO watchdog: evaluated once per heartbeat over the spans since
        # the last beat.  Constructed even with no budgets declared (an
        # empty budget list evaluates to nothing) so /costs always shows
        # the slo map.
        self._slo = SLOWatchdog(
            standard_slos(batch_p95_ms=cfg.slo_batch_p95_ms,
                          queue_wait_ms=cfg.slo_queue_wait_ms,
                          batch_age_ms=cfg.slo_batch_age_ms),
            registry=registry)
        # Self-sampling (utils/timeseries.py): every metric in this
        # worker's registry becomes a rolling series once per heartbeat.
        self._ts_sampler = RegistrySampler(registry)
        # Span export cursor: starts at NOW so a fresh worker never
        # re-ships whatever history the process-wide ring carries; the
        # name filter ships only THIS worker's stages (shared-process
        # deployments must not re-export their neighbors' spans).
        self._span_exporter = trace.SpanExporter(
            max_spans=cfg.span_export_max_spans,
            sample_rate=cfg.span_sample_rate,
            name_prefixes=("tpu_worker.", "engine."))
        self._last_span_export = time.monotonic()
        # Capability probes, not flags: test doubles without
        # pack/coalescing keep working through the one-batch path.
        self._engine_coalesces = (
            callable(getattr(getattr(engine, "tokenizer", None),
                             "encode_batch", None))
            and callable(getattr(engine, "run_tokenized", None))
            and self._accepts_pack(getattr(engine, "run_tokenized", None)))
        self._engine_run_packs = self._accepts_pack(
            getattr(engine, "run", None))

    @staticmethod
    def _accepts_pack(fn) -> bool:
        try:
            return fn is not None and \
                "pack" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False

    def get_status(self) -> dict:
        """The /status map (the reference's keys)."""
        started = self._step_started
        step_age = (time.monotonic() - started) if started is not None else 0.0
        threshold = self._stall_threshold()
        return {
            "worker_id": self.cfg.worker_id,
            "model": self.engine.cfg.model,
            "n_devices": getattr(self.engine, "n_devices", 1),
            "mesh": None,
            "is_running": not self._stop.is_set() and bool(self._threads),
            "queue_depth": self._queue.qsize(),
            "inflight": self._inflight,
            "processed_batches": self._processed,
            "error_batches": self._errors,
            "device_step_age_s": round(step_age, 1),
            "device_stalled": bool(threshold and step_age >= threshold),
            "uptime_s": (time.monotonic() - self._started_at)
            if self._started_at else 0.0,
        }

    def get_costs(self) -> dict:
        """The /costs body: the engine's cost/efficiency snapshot plus the
        worker's SLO state, per-tenant spend rows, and profiler status."""
        snap_fn = getattr(self.engine, "cost_snapshot", None)
        out = dict(snap_fn()) if callable(snap_fn) else {}
        out["worker_id"] = self.cfg.worker_id
        out["slo"] = self._slo.snapshot()
        ledger = self._tenant_ledger()
        if ledger is not None:
            out["tenants"] = ledger.snapshot()
        out["profiler"] = profiling.PROFILER.snapshot()
        return out

    # -- tenant attribution ------------------------------------------------
    def _tenant_ledger(self):
        """The engine meter's TenantLedger, when the engine has one
        (test doubles and older engines simply don't attribute)."""
        return getattr(getattr(self.engine, "meter", None), "tenants", None)

    def _set_meter_tenants(self, weights: Dict[str, float]) -> None:
        """Declare the tenant split for the NEXT engine dispatches."""
        set_fn = getattr(getattr(self.engine, "meter", None),
                         "set_tenants", None)
        if callable(set_fn):
            set_fn(weights)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._started_at = time.monotonic()
        self.bus.subscribe(TOPIC_INFERENCE_BATCHES, self._handle_payload)
        self._start_watchdog()
        for target, name in ((self._feed_loop, "tpu-feed"),
                             (self._heartbeat_loop, "tpu-heartbeat")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        if self.cfg.metrics_port:
            self._metrics_server = serve_metrics(
                self.cfg.metrics_port, self._registry,
                providers={"status": self.get_status,
                           "costs": self.get_costs})
        if self.cfg.profiler_port:
            profiling.start_profiler_server(self.cfg.profiler_port)
        logger.info("worker %s started on %s", self.cfg.worker_id,
                    getattr(self.engine, "device", "?"))

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        if self.cfg.span_export_interval_s > 0:
            # Graceful stop ships the span tail (kill() deliberately
            # doesn't — a crashed process exports nothing).
            self.export_spans()
        # Announce the clean shutdown so the fleet view marks this worker
        # OFFLINE instead of letting it age into "stale".  Graceful stops
        # only: kill() stays silent, as a SIGKILLed process sends nothing.
        self._announce_stopping()
        if self.provider is not None:
            flush = getattr(self.provider, "flush", None)
            if callable(flush):
                flush()  # push any provider-side write buffering
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()

    def kill(self) -> None:
        """Abrupt death, the in-process analog of SIGKILL: halt the feed,
        heartbeat and watchdog threads without draining, flushing the
        provider, sending a stopping status or acking queued batches.
        Un-acked frames requeue on manual-ack buses."""
        self._killed = True
        self._stop.set()
        flight.record("worker_kill", worker=self.cfg.worker_id,
                      queue_depth=self._queue.qsize(),
                      inflight=self._inflight)
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def _announce_stopping(self) -> None:
        """Best-effort worker_stopping status on a graceful stop: the fleet
        view maps it to OFFLINE, so a retired worker is "cleanly gone",
        never "stale".  Idempotent, and silent after kill()."""
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
                worker_type="tpu").to_dict())
        except Exception as e:  # a dead bus must not break shutdown
            logger.debug("stopping announcement failed: %s", e)

    def evaluate_slos(self) -> list:
        """One SLO evaluation tick on demand (the heartbeat loop's twin):
        digests spans finished since the previous tick against the
        declared budgets and returns the breach records."""
        return self._slo.evaluate()

    def export_spans(self) -> int:
        """Ship spans finished since the last export as one
        SpanBatchMessage on TOPIC_SPANS; returns the count shipped.  The
        heartbeat loop calls this every ``span_export_interval_s``.  Never
        raises: span telemetry must not take a serving worker down."""
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
        """Block until every accepted batch — queued OR mid-process — has
        finished, so `drain(); stop()` never cuts off the final
        writeback/ack.  ``_inflight`` counts from enqueue to completion."""
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
        # Raising into the bus (queue full) makes it redeliver: the
        # backpressure path.  The in-flight count covers enqueue to
        # completion, so drain() sees the batch the moment it is accepted.
        with self._idle:
            self._inflight += 1
        try:
            self._queue.put((batch, ack, time.monotonic()), timeout=5.0)
        except queue.Full:
            self._finish_one()
            if ack is not None:
                self.m_outcomes.labels(outcome="requeued").inc()
                flight.record("batch", batch=batch.batch_id,
                              outcome="requeued", reason="queue_full")
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
        """Drain up to ``coalesce_batches`` queued batches per device
        dispatch and run them as one (packed) stream — a bursty crawl
        stream fills bucket rows across RecordBatch boundaries instead of
        padding each partial batch up to batch_size on its own."""
        timeline = getattr(self.engine, "timeline", None)
        while not self._stop.is_set():
            try:
                items = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                # The queue ran dry: the device is idle because there is
                # NO work — the next dispatch opens a new stream, so the
                # wait here never scores as a pipeline bubble
                # (`utils/occupancy.py`).
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

    def _process_group(self,
                       items: List[Tuple[RecordBatch, Any, float]]) -> None:
        now = time.monotonic()
        ledger = self._tenant_ledger()
        for batch, _, enq_t in items:
            # Queue wait as a span of each batch's own trace: the time
            # between the bus handler's enqueue and this dequeue, i.e.
            # what the batch spent behind its neighbors.
            trace.record("tpu_worker.queue_wait", now - enq_t,
                         trace_id=batch.trace_id, batch=batch.batch_id,
                         worker=self.cfg.worker_id, tenant=batch.tenant)
            if ledger is not None and batch.tenant:
                ledger.observe_queue_wait(batch.tenant, now - enq_t)
        if len(items) == 1 or not self._engine_coalesces:
            for batch, ack, _ in items:
                self._process_one(batch, ack)
            return
        self.m_coalesce.observe(len(items))
        # Tokenize per batch FIRST: a record whose text cannot tokenize
        # fails its own batch here, before any neighbor joins it on device.
        good: List[Tuple[RecordBatch, Any, List[List[int]]]] = []
        for batch, ack, _ in items:
            try:
                with trace.span("engine.tokenize",
                                trace_id=batch.trace_id,
                                records=len(batch.records)):
                    toks = self.engine.tokenizer.encode_batch(batch.texts())
                self._observe_age(batch)
                good.append((batch, ack, toks))
            except Exception as e:
                self._errors += 1
                self.m_outcomes.labels(outcome="error").inc()
                logger.exception("batch %s failed to tokenize: %s",
                                 batch.batch_id, e)
                if ack is not None:
                    ack(False)
        if not good:
            return
        all_toks = [t for _, _, toks in good for t in toks]
        # Per-tenant weight of this device stream = real token counts, so
        # the meter's ledger charges the coalesced dispatch fairly.
        weights: Dict[str, float] = {}
        for batch, _, toks in good:
            weights[batch.tenant] = weights.get(batch.tenant, 0.0) \
                + max(1, sum(len(t) for t in toks))
        self._set_meter_tenants(weights)
        dominant = max(weights, key=weights.get) if weights else ""
        started = self._step_started = time.monotonic()
        try:
            # The coalesce span runs under the FIRST batch's trace (one
            # device stream has one ambient context); the engine's stage
            # spans nest below it, and the co-batched ids are attrs so the
            # other batches' traces point here.
            with trace.span("tpu_worker.coalesce",
                            trace_id=good[0][0].trace_id,
                            batches=len(good),
                            batch_ids=[b.batch_id for b, _, _ in good],
                            sequences=len(all_toks),
                            tenant=dominant):
                results = self.engine.run_tokenized(all_toks,
                                                    pack=self.cfg.pack)
        except Exception as e:
            # The combined step failed; fall back to per-batch execution so
            # one poisoned batch cannot take its coalesced neighbors down.
            logger.exception(
                "coalesced step over %d batches failed (%s); isolating "
                "per batch", len(good), e)
            results = None
        finally:
            self._step_started = None
            self._stall_warned = False
            self._after_step(time.monotonic() - started,
                             good[0][0].trace_id)
        if results is None:
            for batch, ack, toks in good:
                self._process_tokenized(batch, ack, toks)
            return
        # Fan results back to each originating batch: every batch keeps its
        # OWN publish + idempotent writeback + ack, and a failure in one
        # batch's commit nacks only that batch.
        off = 0
        for batch, ack, toks in good:
            rs = results[off:off + len(toks)]
            off += len(toks)
            self._finish_batch(batch, ack, lambda rs=rs: rs)

    def _finish_batch(self, batch: RecordBatch, ack, produce) -> None:
        """The ONE copy of the commit/ack/error accounting every path
        shares; ``produce`` yields the batch's results (or raises)."""
        try:
            results = produce()
            with trace.span("tpu_worker.commit", trace_id=batch.trace_id,
                            batch=batch.batch_id,
                            records=len(batch.records)):
                self._commit(batch, results)
            self._processed += 1
            self.m_outcomes.labels(outcome="ok").inc()
            flight.record("batch", batch=batch.batch_id, outcome="ok",
                          records=len(batch.records))
            self._ack(batch, ack, True)
        except Exception as e:
            self._errors += 1
            self.m_outcomes.labels(outcome="error").inc()
            flight.record("batch", batch=batch.batch_id, outcome="error",
                          error=str(e))
            logger.exception("batch %s failed: %s", batch.batch_id, e)
            self._ack(batch, ack, False)

    def _ack(self, batch: RecordBatch, ack, ok: bool) -> None:
        if ack is None:
            return
        t0 = time.perf_counter()
        ack(ok)
        # Retroactive span: on RemoteBus this is the Ack RPC round trip
        # closing the at-least-once loop, and it is the LAST hop of the
        # batch's trace.
        trace.record("tpu_worker.ack", time.perf_counter() - t0,
                     trace_id=batch.trace_id, batch=batch.batch_id, ok=ok)

    def _run_step(self, fn, trace_id: str = ""):
        """Run a device step under the stall-watchdog bookkeeping."""
        started = self._step_started = time.monotonic()
        try:
            return fn()
        finally:
            self._step_started = None
            self._stall_warned = False
            self._after_step(time.monotonic() - started, trace_id)

    def _after_step(self, elapsed_s: float, trace_id: str) -> None:
        """Slow-batch hook (``profile_on_slow_ms``): a device step past
        the threshold fires ONE bounded automatic profiler capture into
        the dump dir (skipped while a capture runs) and a flight event, so
        the trace that explains the slowness exists before anyone asks.

        Never raises: this runs in the serving path's ``finally`` — an
        observability failure (e.g. thread exhaustion in capture_async)
        must not nack an already-computed batch, nor mask the engine's
        own exception in the coalesce path."""
        try:
            self._slow_batch_hook(elapsed_s, trace_id)
        except Exception as e:
            logger.warning("slow-batch hook failed: %s", e)

    def _slow_batch_hook(self, elapsed_s: float, trace_id: str) -> None:
        threshold = self.cfg.profile_on_slow_ms
        elapsed_ms = elapsed_s * 1000.0
        if threshold <= 0 or elapsed_ms < threshold:
            return
        fired = profiling.capture_async(
            reason=f"slow batch {elapsed_ms:.0f}ms")
        flight.record("slow_batch", worker=self.cfg.worker_id,
                      elapsed_ms=round(elapsed_ms, 1),
                      threshold_ms=threshold, trace_id=trace_id,
                      profile_capture=fired)
        logger.warning(
            "device batch took %.0fms >= profile_on_slow_ms %.0fms "
            "(trace=%s); auto profiler capture %s",
            elapsed_ms, threshold, trace_id,
            "started" if fired else "skipped (one already running)",
            extra={"worker_id": self.cfg.worker_id})

    def _process_one(self, batch: RecordBatch, ack) -> None:
        def produce():
            self._observe_age(batch)
            self._set_meter_tenants(
                {batch.tenant: max(1, len(batch.records))})
            # Rooted at the batch's own trace: engine.run's tokenize and
            # stage spans nest under this.
            with trace.span("tpu_worker.process", trace_id=batch.trace_id,
                            batch=batch.batch_id,
                            records=len(batch.records),
                            tenant=batch.tenant):
                if self.cfg.pack and self._engine_run_packs:
                    return self._run_step(
                        lambda: self.engine.run(batch.texts(), pack=True),
                        trace_id=batch.trace_id)
                return self._run_step(
                    lambda: self.engine.run(batch.texts()),
                    trace_id=batch.trace_id)

        self._finish_batch(batch, ack, produce)

    def _process_tokenized(self, batch: RecordBatch, ack, toks) -> None:
        """Per-batch fallback after a failed coalesced step: the batch was
        already tokenized and age-observed when the group formed, so reuse
        the token lists instead of re-running the text front door."""
        def produce():
            self._set_meter_tenants(
                {batch.tenant: max(1, sum(len(t) for t in toks))})
            with trace.span("tpu_worker.process", trace_id=batch.trace_id,
                            batch=batch.batch_id, isolated=True,
                            tenant=batch.tenant):
                return self._run_step(
                    lambda: self.engine.run_tokenized(toks,
                                                      pack=self.cfg.pack),
                    trace_id=batch.trace_id)

        self._finish_batch(batch, ack, produce)

    def _observe_age(self, batch: RecordBatch) -> None:
        if batch.created_at is not None:
            age = (utcnow() - batch.created_at).total_seconds()
            if age >= 0:
                self.m_batch_age.observe(age)
                # Retroactive span so the whole-pipeline age is SLO-
                # evaluable (``slo_batch_age_ms``): it covers the broker
                # leg queue_wait can't see — the signal that fires when a
                # killed worker's backlog finally lands.
                trace.record("tpu_worker.batch_age", age,
                             trace_id=batch.trace_id,
                             batch=batch.batch_id,
                             worker=self.cfg.worker_id,
                             tenant=batch.tenant)

    @staticmethod
    def _strip_embeddings(results):
        return [{k: v for k, v in r.items() if k != "embedding"}
                for r in results]

    def _commit(self, batch: RecordBatch, results) -> None:
        # Two independent sinks, two independent knobs:
        # publish_embeddings governs the BUS frame (the clustering
        # stage's feed), write_embeddings the JSONL writeback.  They
        # used to be one knob — turning off the JSONL embeddings also
        # silently starved any result-stream consumer.
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

    def warmup(self) -> None:
        """`engine.warmup()` under the stall watchdog: the warmup is the
        longest device window (every bucket back to back, the kernels'
        first build), so a card that wedges there must still hit
        stall_warn/exit.  Call this, not `engine.warmup()`, before
        serving."""
        self._start_watchdog()
        self._step_started = time.monotonic()
        try:
            if self._accepts_pack(getattr(self.engine, "warmup", None)):
                # Warm the path this worker actually serves: with pack on,
                # the packed programs are what live batches dispatch.
                self.engine.warmup(pack=self.cfg.pack)
            else:
                self.engine.warmup()
        finally:
            self._step_started = None
            self._stall_warned = False

    # -- device-stall watchdog ---------------------------------------------
    def _start_watchdog(self) -> None:
        if self._watchdog_started or self._stall_threshold() <= 0:
            return
        self._watchdog_started = True
        t = threading.Thread(target=self._watchdog_loop, daemon=True,
                             name="tpu-watchdog")
        t.start()
        self._threads.append(t)

    def _stall_threshold(self) -> float:
        """Smallest positive stall threshold; 0 when both are disabled.
        An exit-only config (warn 0, exit > 0) still runs the watchdog —
        the hard-exit safety must never silently depend on warnings being
        enabled."""
        positive = [t for t in (self.cfg.stall_warn_s, self.cfg.stall_exit_s)
                    if t > 0]
        return min(positive) if positive else 0.0

    def _watchdog_loop(self) -> None:
        poll = min(5.0, max(0.01, self._stall_threshold() / 10.0))
        while not self._stop.is_set():
            started = self._step_started
            if started is not None:
                age = time.monotonic() - started
                if (self.cfg.stall_warn_s > 0
                        and age >= self.cfg.stall_warn_s
                        and not self._stall_warned):
                    self._stall_warned = True
                    self.m_stalls.inc()
                    flight.record("device_stall",
                                  worker=self.cfg.worker_id,
                                  age_s=round(age, 1))
                    logger.warning(
                        "device step stalled %.0fs (warn threshold %.0fs); "
                        "card wedged or a kernel build outlasted "
                        "stall_warn_s",
                        age, self.cfg.stall_warn_s,
                        extra={"worker_id": self.cfg.worker_id})
                if self.cfg.stall_exit_s > 0 \
                        and age >= self.cfg.stall_exit_s:
                    logger.critical(
                        "device step stalled %.0fs >= stall_exit_s %.0fs; "
                        "exiting so the supervisor restarts this worker "
                        "(un-acked frames requeue; writeback is idempotent)",
                        age, self.cfg.stall_exit_s,
                        extra={"worker_id": self.cfg.worker_id})
                    # os._exit skips atexit and the excepthooks, so the
                    # bundle must be written here.
                    flight.dump("stall_exit",
                                error=f"device step stalled {age:.0f}s")
                    (self._exit_fn or os._exit)(STALL_EXIT_CODE)
                    return  # reached only through the test seam
            self._stop.wait(poll)

    # -- heartbeats --------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            # SLO tick: digest the spans completed since the last beat
            # against the declared budgets (WARN + counter + flight event
            # per breach; no-op with no budgets declared).
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
                worker_type="tpu")
            msg.queue_length = self._queue.qsize()
            msg.resource_usage = self._telemetry.snapshot()
            # Heartbeat queue depth matches the gauge: the time-weighted
            # mean over the sampler window, next to the instantaneous
            # value (the edge-triggered number scrapes used to alias on).
            msg.resource_usage["queue"] = {
                "depth": self._queue.qsize(),
                "depth_time_weighted": round(self._depth.sample(), 4),
            }
            # Cumulative per-SLO breach counts ride every beat, for
            # burn-rate rules evaluated fleet-wide.
            slo_snap = self._slo.snapshot()
            msg.resource_usage["slo_breaches"] = slo_snap["breaches"]
            if slo_snap.get("tenant_breaches"):
                msg.resource_usage["tenant_slo_breaches"] = \
                    slo_snap["tenant_breaches"]
            # Per-tenant spend rows, for the fleet's tenant accounting.
            ledger = self._tenant_ledger()
            if ledger is not None:
                tenants = ledger.snapshot()
                if tenants["rows"]:
                    msg.resource_usage["tenants"] = tenants
            # Self-sample the registry into the rolling store on the
            # same cadence (never raises).
            self._ts_sampler.sample()
            try:
                self.bus.publish(TOPIC_WORKER_STATUS, msg.to_dict())
            except Exception as e:  # bus outage must not kill the worker
                logger.warning("heartbeat publish failed: %s", e)
            self._wait_with_span_exports(self.cfg.heartbeat_s)

    def _wait_with_span_exports(self, wait_s: float) -> None:
        """Sleep until the next heartbeat, firing span exports on their
        OWN cadence in between — a 30 s heartbeat must not stretch a
        15 s span_export_interval_s to 30."""
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

    def status(self) -> Dict[str, Any]:
        """Back-compat alias over get_status() (older key names kept)."""
        full = self.get_status()
        return {
            "worker_id": full["worker_id"],
            "queue_depth": full["queue_depth"],
            "processed": full["processed_batches"],
            "errors": full["error_batches"],
            "uptime_s": full["uptime_s"],
        }

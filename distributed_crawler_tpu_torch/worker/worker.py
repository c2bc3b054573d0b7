"""The crawl worker: consume work items, crawl, report results and
heartbeats.  The port's copy of the reference's `distributed_crawler_tpu/
worker/worker.py`.

- subscribe to the work queue; per item, busy and idle status
  transitions, the ``worker.process`` and ``worker.publish_result`` spans
  on the item's trace, and the ``work_start``/``work_done`` flight events;
- heartbeats with ``worker_type="crawl"`` every ``heartbeat_s``, carrying
  the telemetry snapshot and the SLO watchdog's breach counts;
- telegram items through the pool-backed channel crawl
  (`crawl/runner.run_for_channel_with_pool`) behind the fetch
  `resilience.Policy`; a youtube item gets the reference's error for a
  worker built without a YouTube crawler (the crawler waits for ROADMAP
  Queue 1 part C);
- retryable-versus-permanent error classification by substring;
- `WorkItemConfig` -> `CrawlerConfig`.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..bus.messages import (
    MSG_HEARTBEAT,
    MSG_WORK_ITEM,
    MSG_WORKER_STARTED,
    MSG_WORKER_STOPPING,
    STATUS_ERROR,
    STATUS_SUCCESS,
    TOPIC_RESULTS,
    TOPIC_WORK_QUEUE,
    TOPIC_WORKER_STATUS,
    WORKER_ACTIVE,
    WORKER_BUSY,
    WORKER_IDLE,
    WORKER_OFFLINE,
    DiscoveredPage,
    ResultMessage,
    StatusMessage,
    WorkItem,
    WorkItemConfig,
    WorkQueueMessage,
    WorkResult,
)
from ..config.crawler import CrawlerConfig
from ..crawl import runner as crawl_runner
from ..utils import flight, resilience, trace
from ..utils.slo import SLOWatchdog, standard_slos
from ..utils.telemetry import TelemetryEmitter
from ..state.datamodels import PAGE_PROCESSING, Page, new_id, utcnow

logger = logging.getLogger("dct.worker")

# In-worker fetch attempts per crawl item (utils/resilience.py): transient
# errors retry locally with backoff, and FLOOD_WAIT-style ``retry_after_s``
# hints are honoured as server-directed backoff, before the item goes back
# to the orchestrator's page-level retry loop.  The reference's default,
# which no caller of the port changes.
FETCH_ATTEMPTS = 2

# Error-classification substrings.
_PERMANENT_MARKERS = ("not found", "access denied", "forbidden")


def should_retry_error(err: Exception) -> bool:
    """Permanent markers win; everything else (connection, timeout,
    unknown) is retried."""
    return not any(m in str(err).lower() for m in _PERMANENT_MARKERS)


def work_item_config_to_crawler_config(config: WorkItemConfig,
                                       platform: str) -> CrawlerConfig:
    """The crawl settings of a work item as a `CrawlerConfig`."""
    return CrawlerConfig(
        storage_root=config.storage_root, concurrency=config.concurrency,
        timeout=config.timeout, platform=platform,
        min_post_date=config.min_post_date, post_recency=config.post_recency,
        date_between_min=config.date_between_min,
        date_between_max=config.date_between_max,
        sample_size=config.sample_size, max_comments=config.max_comments,
        max_posts=config.max_posts, max_depth=config.max_depth,
        max_pages=config.max_pages, min_users=config.min_users,
        crawl_label=config.crawl_label,
        skip_media_download=config.skip_media_download,
        youtube_api_key=config.youtube_api_key,
        sampling_method=config.sampling_method or "channel",
        min_channel_videos=config.min_channel_videos)


@dataclass
class WorkerConfig:
    worker_id: str = ""
    heartbeat_s: float = 30.0
    # SLO budget on the worker.process span's p95 (`utils/slo.py`),
    # evaluated once per heartbeat; 0 = no budget declared.  The crawl
    # worker's unit of work is a crawl item, so this is the crawl-latency
    # twin of the TPU worker's batch budget.
    slo_batch_p95_ms: float = 0.0


class CrawlWorker:
    """The work consumer."""

    def __init__(self, worker_id: str, config: CrawlerConfig, bus, sm,
                 wcfg: Optional[WorkerConfig] = None):
        if not worker_id:
            raise ValueError("worker ID cannot be empty")
        self.id = worker_id
        self.config = config
        self.bus = bus
        self.sm = sm
        self.wcfg = wcfg or WorkerConfig(worker_id=worker_id)

        self.tasks_processed = 0
        self.tasks_success = 0
        self.tasks_error = 0
        self.current_work: Optional[WorkItem] = None
        # Telemetry-rich heartbeats (RSS, threads, latency digest; no
        # device stats: the crawl worker holds nothing on the card).
        self._telemetry = TelemetryEmitter()
        # SLO watchdog over worker.process p95; empty with no budget.
        self._slo = SLOWatchdog(standard_slos(
            batch_p95_ms=self.wcfg.slo_batch_p95_ms))
        # Crawl fetches run under the shared resiliency policy: only
        # errors `should_retry_error` classifies as transient are
        # retried; permanent failures go straight back as an error
        # result.
        self._fetch_policy = resilience.Policy(
            op="crawl.fetch",
            retry=resilience.RetryPolicy(
                max_attempts=FETCH_ATTEMPTS,
                base_delay_s=0.2, max_delay_s=5.0,
                retryable=should_retry_error))
        self._mu = threading.RLock()
        self._running = False
        self._threads: List[threading.Thread] = []
        self._started_at = time.monotonic()

    # -- lifecycle -------------------------------------------------------
    def start(self, background: bool = True) -> None:
        with self._mu:
            if self._running:
                raise RuntimeError("worker is already running")
            self._running = True
        self._started_at = time.monotonic()
        self.bus.subscribe(TOPIC_WORK_QUEUE, self.handle_work_payload)
        if background:
            t = threading.Thread(target=self._heartbeat_loop, daemon=True,
                                 name=f"worker-heartbeat-{self.id}")
            t.start()
            self._threads.append(t)
        self.send_status_update(MSG_WORKER_STARTED, WORKER_ACTIVE,
                                telemetry=True)
        logger.info("worker started", extra={"worker_id": self.id})

    def stop(self) -> None:
        with self._mu:
            self._running = False
        self.send_status_update(MSG_WORKER_STOPPING, WORKER_OFFLINE)
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        self.sm.close()
        logger.info("worker stopped", extra={"worker_id": self.id})

    def kill(self) -> None:
        """Abrupt-death simulation (the chaos and `loadgen` seam): stop the
        heartbeat loop WITHOUT the stopping status message or the state-
        manager close — the in-process analog of SIGKILL.  The orchestrator
        discovers the death the production way: heartbeats go silent until
        `check_worker_health` marks the worker offline and reassigns its
        in-flight items."""
        with self._mu:
            self._running = False
        flight.record("worker_kill", worker=self.id,
                      current_work=(self.current_work.id
                                    if self.current_work else None))
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def evaluate_slos(self) -> list:
        """One on-demand SLO tick (the heartbeat loop's twin) — see
        `TPUWorker.evaluate_slos`."""
        return self._slo.evaluate()

    @property
    def is_running(self) -> bool:
        with self._mu:
            return self._running

    # -- heartbeats ------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while self.is_running:
            deadline = time.monotonic() + self.wcfg.heartbeat_s
            while self.is_running and time.monotonic() < deadline:
                time.sleep(0.05)
            if not self.is_running:
                return
            try:
                # SLO tick: spans completed since the last beat vs the
                # declared budget (no-op without one).
                self._slo.evaluate()
            except Exception as e:
                logger.warning("slo evaluation failed: %s", e)
            self.send_status_update(MSG_HEARTBEAT, self.determine_status(),
                                    telemetry=True)

    def determine_status(self) -> str:
        if not self.is_running:
            return WORKER_OFFLINE
        with self._mu:
            return WORKER_BUSY if self.current_work is not None else WORKER_IDLE

    def send_status_update(self, message_type: str, status: str,
                           telemetry: bool = False) -> None:
        """Publish a status message.  ``telemetry=True`` (the interval
        heartbeat and the started announcement) attaches the
        `utils/telemetry.py` snapshot; per-item busy/idle transitions
        stay light — snapshotting there would both pay an O(trace-ring)
        digest per work item and reset the digest window the interval
        beat is supposed to cover."""
        with self._mu:
            current = self.current_work.id if self.current_work else None
        msg = StatusMessage.new(
            self.id, message_type, status,
            tasks_processed=self.tasks_processed,
            tasks_success=self.tasks_success, tasks_error=self.tasks_error,
            uptime_s=time.monotonic() - self._started_at)
        msg.current_work = current
        if telemetry:
            msg.resource_usage = self._telemetry.snapshot()
            # Cumulative breach counts for the watchtower's burn-rate
            # fold (the serving workers' discipline).
            msg.resource_usage["slo_breaches"] = \
                self._slo.snapshot()["breaches"]
        try:
            self.bus.publish(TOPIC_WORKER_STATUS, msg)
        except Exception as e:
            logger.error("failed to send status update", extra={
                "message_type": message_type, "error": str(e)})

    # -- work handling ---------------------------------------------------
    def handle_work_payload(self, payload: Dict[str, Any]) -> None:
        self.handle_work_message(WorkQueueMessage.from_dict(payload))

    def handle_work_message(self, message: WorkQueueMessage) -> None:
        if message.message_type != MSG_WORK_ITEM:
            logger.debug("ignoring non-work message",
                         extra={"message_type": message.message_type})
            return
        if message.expired():
            logger.warning("dropping expired work item", extra={
                "work_item_id": message.work_item.id})
            return
        item = message.work_item
        with self._mu:
            self.current_work = item
        start = time.monotonic()
        flight.record("work_start", work_item=item.id, worker=self.id,
                      url=item.url)
        self.send_status_update(MSG_HEARTBEAT, WORKER_BUSY)
        try:
            # Same trace as the orchestrator's dispatch span: the item
            # carried its trace_id across the bus hop.
            with trace.span("worker.process", trace_id=item.trace_id,
                            work_item=item.id, worker=self.id,
                            platform=item.platform) as sp:
                result = self.process_work_item(item)
                sp.set(status=result.status,
                       message_count=result.message_count)
        finally:
            with self._mu:
                self.current_work = None
        try:
            with trace.span("worker.publish_result", trace_id=item.trace_id,
                            work_item=item.id, status=result.status):
                self.bus.publish(TOPIC_RESULTS,
                                 ResultMessage.new(result,
                                                   result.discovered_pages,
                                                   trace_id=item.trace_id))
        except Exception as e:
            # Re-raise so the bus redelivers the work item.
            logger.error("failed to publish result", extra={
                "work_item_id": item.id, "error": str(e)})
            raise
        # Counters move only after a successful publish so a redelivered
        # item doesn't double-count.
        with self._mu:
            if result.status == STATUS_SUCCESS:
                self.tasks_success += 1
            else:
                self.tasks_error += 1
            self.tasks_processed += 1
        flight.record("work_done", work_item=item.id, worker=self.id,
                      status=result.status, error=result.error or None)
        self.send_status_update(MSG_HEARTBEAT, WORKER_IDLE)
        logger.info("work item processed and result sent", extra={
            "work_item_id": item.id, "status": result.status,
            "processing_time_s": time.monotonic() - start})

    # -- processing ------------------------------------------------------
    def process_work_item(self, item: WorkItem) -> WorkResult:
        start = time.monotonic()
        page = Page(id=item.parent_id or new_id(), url=item.url,
                    depth=item.depth, status=PAGE_PROCESSING,
                    timestamp=utcnow(), parent_id=item.parent_id)
        discovered: List[Page] = []
        message_count = 0
        error: Optional[Exception] = None
        try:
            if item.platform == "telegram":
                discovered = self._process_telegram(page, item)
                message_count = sum(1 for m in page.messages
                                    if m.status == "fetched")
            elif item.platform == "youtube":
                # The reference's error for a worker built without a
                # YouTube crawler: the port has none to give it yet
                # (ROADMAP Queue 1 part C).
                raise ValueError(
                    "YouTube processing requires a youtube_crawler instance")
            else:
                raise ValueError(f"unsupported platform: {item.platform}")
        except Exception as e:
            error = e
            logger.error("failed to process work item", extra={
                "work_item_id": item.id, "error": str(e)})

        result = WorkResult(
            work_item_id=item.id, worker_id=self.id, processed_url=item.url,
            message_count=message_count,
            processing_time_s=time.monotonic() - start,
            completed_at=utcnow(),
            metadata={"platform": item.platform, "depth": item.depth})
        if error is not None:
            result.status = STATUS_ERROR
            result.error = str(error)
            result.retry_recommended = should_retry_error(error)
        else:
            result.status = STATUS_SUCCESS
            result.discovered_pages = [
                DiscoveredPage(url=p.url, parent_id=p.parent_id,
                               depth=p.depth, platform=item.platform)
                for p in discovered]
        return result

    def _process_telegram(self, page: Page, item: WorkItem) -> List[Page]:
        """The pool-backed channel crawl, behind the fetch policy."""
        cfg = work_item_config_to_crawler_config(item.config, "telegram")
        cfg.crawl_id = item.crawl_id or self.config.crawl_id
        return self._fetch_policy.call(
            crawl_runner.run_for_channel_with_pool,
            page, item.config.storage_root, self.sm, cfg)

    # -- status ----------------------------------------------------------
    def get_status(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "worker_id": self.id,
                "is_running": self._running,
                "platform": self.config.platform,
                "tasks_processed": self.tasks_processed,
                "tasks_success": self.tasks_success,
                "tasks_error": self.tasks_error,
                "uptime_seconds": time.monotonic() - self._started_at,
            }

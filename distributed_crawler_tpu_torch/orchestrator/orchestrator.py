"""The orchestrator: BFS work distribution, result fan-in, worker health.

The port's copy of the reference's `distributed_crawler_tpu/orchestrator/
orchestrator.py`, with the same wire frames, journal and page state:

- a work distributor ticking every ``DISTRIBUTE_INTERVAL_S`` over the
  current BFS depth, one `WorkItem` per pending page on
  ``crawl-work-queue``;
- result handling: page status, retries up to ``MAX_RETRIES`` for
  errors the worker calls transient, and each result's discovered pages
  as the next layer;
- the worker registry from ``worker-status`` heartbeats, and the health
  monitor: a worker silent past ``WORKER_TIMEOUT_S`` goes offline and its
  items are republished at high priority; an item without a result past
  ``WORK_TTL_S`` is requeued, then abandoned;
- the dispatch valves: the inference backlog (the live serving workers'
  summed ``queue_length`` against ``--infer-backpressure-high``/``-low``),
  an open state-store circuit, and a publish outbox near its bound;
- the sharded frontier (pages dispatched round-robin across a
  partitioned bus's shard lanes) and the cluster guide (pages of
  under-populated clusters dispatched at high priority for
  ``CLUSTER_GUIDE_TTL_S`` after a ``ClusterUpdateMessage``);
- crash recovery from the journal (`orchestrator/journal.py`), with a
  bounded window of applied result ids that absorbs redeliveries;
- the fleet view, trace collector and watchtower behind ``/cluster``,
  ``/dtraces``, ``/alerts`` and ``/tenants``.

Tick methods (`distribute_work`, `check_worker_health`,
`requeue_stale_work`, `log_progress`) are public and side-effect-complete,
so tests drive them without timers; `start()` wires them to background
threads.  The orchestrator runs no model and takes no device.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from datetime import datetime
from typing import Any, Dict, List, Optional

from ..bus.messages import (
    PRIORITY_HIGH,
    PRIORITY_MEDIUM,
    STATUS_SUCCESS,
    TOPIC_ALERTS,
    TOPIC_CLUSTERS,
    TOPIC_RESULTS,
    TOPIC_SPANS,
    TOPIC_WORK_QUEUE,
    TOPIC_WORKER_STATUS,
    AlertMessage,
    ClusterUpdateMessage,
    WORKER_ACTIVE,
    WORKER_BUSY,
    WORKER_IDLE,
    WORKER_OFFLINE,
    ResultMessage,
    SpanBatchMessage,
    StatusMessage,
    WorkItem,
    WorkItemConfig,
    WorkQueueMessage,
    WorkResult,
)
from .fleet import STALE_AFTER_S, FleetView
from .tracecollect import TraceCollector
from .watchtower import Watchtower
from .journal import CrawlJournal
from ..config.crawler import CrawlerConfig
from ..utils import flight, resilience, trace
from ..utils.metrics import REGISTRY
from ..state.datamodels import (
    PAGE_ABANDONED,
    PAGE_ERROR,
    PAGE_FETCHED,
    PAGE_PROCESSING,
    PAGE_UNFETCHED,
    Page,
    utcnow,
)

logger = logging.getLogger("dct.orchestrator")

# Circuit-breaker target name for the orchestrator's state-store ops
# (the `resilience_circuit_state{target=...}` label value).
STATE_STORE_TARGET = "state-store"

# Applied-result idempotence window: ids of results already applied,
# kept so broker redeliveries (incl. across a restart) single-count.
# Bounded — only ids within the broker's plausible redelivery horizon
# matter.  Snapshots persist only the newest SNAPSHOT-many ids: the
# cross-restart redelivery horizon is far smaller than the live window,
# and compaction fsyncs the list every ~256 events.
APPLIED_RESULTS_WINDOW = 65536
APPLIED_RESULTS_SNAPSHOT = 8192

# Work deferred while the state-store circuit is open (discovered layers
# and result applications) is retried each tick, bounded: beyond the cap
# the oldest entries drop from memory — their recovery story is the
# journal (layers are journaled before the store write; an unjournaled
# result leaves its item in-flight, so a restart requeues it).
DEFERRED_CAP = 4096


# Timing and retry constants, the reference's defaults.  No flag sets
# them; tests call the tick methods directly instead of shrinking them.
DISTRIBUTE_INTERVAL_S = 5.0
HEALTH_INTERVAL_S = 30.0
WORKER_TIMEOUT_S = STALE_AFTER_S   # heartbeat silence before a worker is offline
MAX_RETRIES = 3               # dispatches per page before it is abandoned
WORK_TTL_S = 3600             # an item's life without a result
CLUSTER_GUIDE_TTL_S = 600.0   # how long a ClusterUpdateMessage steers


@dataclass
class OrchestratorConfig:
    """The knobs the CLI sets (``--infer-backpressure-high``/``-low`` and
    the ``resilience.*`` keys)."""

    # The inference valve: when the summed queue_length of live serving
    # workers reaches HIGH, crawl distribution pauses until the backlog
    # drains below LOW (hysteresis).  high=0 disables the valve.
    inference_backpressure_high: int = 64
    inference_backpressure_low: int = 32
    # State-store ops run behind retry + circuit breaker; an OPEN circuit
    # engages the dispatch valve instead of erroring the tick loop.
    state_retry_attempts: int = 2
    state_breaker_threshold: int = 5
    state_breaker_recovery_s: float = 15.0
    publish_retry_attempts: int = 3


@dataclass
class WorkerInfo:
    """Tracked per-worker state (`orchestrator.go:46-56`)."""

    id: str = ""
    status: str = WORKER_IDLE
    worker_type: str = "crawl"  # "crawl" | "tpu" (StatusMessage.worker_type)
    last_seen: Optional[datetime] = None
    current_work: Optional[str] = None
    queue_length: int = 0  # TPU workers: pending inference batches
    tasks_total: int = 0
    tasks_success: int = 0
    tasks_error: int = 0
    metadata: Dict[str, Any] = field(default_factory=dict)


class Orchestrator:
    """Central coordinator (`orchestrator.go:26-106`)."""

    def __init__(self, crawl_id: str, config: CrawlerConfig, bus, sm,
                 ocfg: Optional[OrchestratorConfig] = None, *,
                 journal: CrawlJournal, alert_rules=None):
        self.crawl_id = crawl_id
        self.config = config
        self.bus = bus
        self.sm = sm
        self.ocfg = ocfg or OrchestratorConfig()
        self.clock = time.monotonic
        self.journal = journal
        registry = REGISTRY

        self.workers: Dict[str, WorkerInfo] = {}
        self.active_work: Dict[str, WorkItem] = {}
        self.completed_work: Dict[str, WorkResult] = {}
        self.current_depth = 0
        self.total_work_items = 0
        self.completed_items = 0
        self.error_items = 0
        self.discovered_pages = 0
        self.crawl_completed = False
        self.resumed = False
        self._retry_counts: Dict[str, int] = {}  # page id -> retries
        # Work-item ids whose results were applied (insertion-ordered,
        # bounded to APPLIED_RESULTS_WINDOW): the idempotence window that
        # makes results replayed across a restart single-count.
        self._applied_results: "OrderedDict[str, None]" = OrderedDict()
        # State-store work parked while the circuit is open, retried per
        # tick (`_flush_deferred`).
        self._deferred_layers: List[List[Page]] = []
        self._deferred_results: List[tuple] = []
        # The circuit's dispatch-pause latch (separate from the
        # inference-backlog hysteresis valve `_backpressure_active`).
        self._circuit_backpressure = False
        self._backpressure_active = False
        # Bus-outbox latch: when publishes ride a durable outbox
        # (`bus/outbox.py`) and the broker outage has it near its bound,
        # dispatch pauses instead of filling the buffer to OutboxFull.
        self._outbox_backpressure = False
        # Telemetry-rich per-worker fold behind /cluster; its staleness
        # rule tracks the same timeout check_worker_health enforces.
        self.fleet = FleetView(registry=registry)
        # The watchtower (orchestrator/watchtower.py): rolling history
        # for every heartbeat series + the declarative alert engine,
        # evaluated on the orchestrator tick and served at /alerts.
        # Wall clock (not self.clock, which is monotonic by default):
        # the time-series store keys samples by epoch.
        self.watchtower = Watchtower(
            self.fleet, rules=alert_rules, registry=registry,
            bus=bus)
        # Distributed-trace assembly behind /dtraces: workers ship
        # completed spans on TOPIC_SPANS; the collector corrects each
        # worker's span walls by the clock offset the fleet estimates
        # from heartbeat send/receive walls, and merges this process's
        # own spans in at export (`orchestrator/tracecollect.py`).
        self.trace_collector = TraceCollector(
            offsets_fn=self.fleet.clock_offsets)
        # Declarative resiliency (utils/resilience.py): state-store ops
        # behind retry + circuit breaker (an open circuit engages the
        # dispatch backpressure), bus publishes behind jittered retry.
        self._state_policy = resilience.Policy(
            op="orchestrator.state_store",
            retry=resilience.RetryPolicy(
                max_attempts=self.ocfg.state_retry_attempts,
                base_delay_s=0.05, max_delay_s=0.5, jitter=0.0),
            breaker=resilience.CircuitBreaker(
                STATE_STORE_TARGET,
                failure_threshold=self.ocfg.state_breaker_threshold,
                recovery_timeout_s=self.ocfg.state_breaker_recovery_s,
                clock=self.clock))
        self._publish_policy = resilience.Policy(
            op="orchestrator.publish",
            retry=resilience.RetryPolicy(
                max_attempts=self.ocfg.publish_retry_attempts,
                base_delay_s=0.05, max_delay_s=0.5))

        # Cluster-guided frontier prioritization (`cluster/`): the
        # latest ClusterUpdateMessage's under-populated cluster ids and
        # channel->cluster map.  A frontier page whose channel maps to
        # an under-populated cluster dispatches at PRIORITY_HIGH — the
        # snowball steers toward the sparse corners of the embedding
        # space instead of re-crawling the dense ones.
        self._cluster_guide: Optional[Dict[str, Any]] = None
        self._cluster_prioritized = 0

        # Sharded frontier (`bus/partition.py`): when the bus exposes a
        # consistent-hash shard map, frontier pages partition by channel
        # hash into shard-owned dispatch lanes — per-lane counts kept
        # for /status + the frontier_shards flight event.
        self._frontier_lane_counts: Dict[str, int] = {}

        self._mu = threading.RLock()
        self._running = False
        self._killed = False
        self._threads: List[threading.Thread] = []
        self._started_at = 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self, seed_urls: List[str], background: bool = True,
              fresh: bool = False) -> None:
        """`orchestrator.go:106-137`, plus crash recovery.

        An existing crawl (journal or persisted state-manager snapshot)
        is RESUMED, never clobbered: coordination state is rebuilt from
        journal + state manager and in-flight pages are requeued.  Pass
        ``fresh=True`` (the ``--fresh`` flag) to explicitly discard the
        previous crawl and re-seed."""
        with self._mu:
            if self._running:
                raise RuntimeError("orchestrator is already running")
            self._running = True
        self._started_at = self.clock()
        if fresh:
            self._discard_existing_crawl()
        else:
            self._discard_foreign_journal()
        pending: List[WorkItem] = []
        if not fresh and self._has_existing_crawl():
            pending = self._resume_state()
        else:
            self.sm.initialize(seed_urls)
            self._journal_begin()
        # Subscribe BEFORE republishing in-flight work: on a synchronous
        # transport a worker can crawl a requeued item and publish its
        # result inline, which must not race the subscription.
        self.bus.subscribe(TOPIC_RESULTS, self.handle_result_payload)
        self.bus.subscribe(TOPIC_WORKER_STATUS, self.handle_status_payload)
        self.bus.subscribe(TOPIC_SPANS, self.handle_spans_payload)
        # Route the watchtower's own announcements: the coordinator logs
        # them, and a durable broker never holds alert frames as
        # unrouted dead letters just because no external tool listens.
        self.bus.subscribe(TOPIC_ALERTS, self.handle_alert_payload)
        # Cluster-state announcements feed the frontier prioritization
        # (fan-out: a missed update degrades freshness, never progress).
        self.bus.subscribe(TOPIC_CLUSTERS, self.handle_cluster_payload)
        if self.resumed:
            self._resume_requeue(pending)
        if background:
            for target, interval, name in (
                    (self.distribute_work, DISTRIBUTE_INTERVAL_S,
                     "orch-distribute"),
                    (self._health_tick, HEALTH_INTERVAL_S,
                     "orch-health")):
                t = threading.Thread(target=self._loop,
                                     args=(target, interval), daemon=True,
                                     name=name)
                t.start()
                self._threads.append(t)
        logger.info("orchestrator started", extra={
            "crawl_id": self.crawl_id, "seed_count": len(seed_urls),
            "resumed": self.resumed})

    def stop(self) -> None:
        with self._mu:
            self._running = False
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        self._compact_journal(force=True)
        self.journal.close()
        self.sm.close()
        logger.info("orchestrator stopped", extra={"crawl_id": self.crawl_id})

    def kill(self) -> None:
        """Abrupt-death simulation: drop everything in memory WITHOUT a journal
        snapshot or a state-manager save — the in-process analog of
        SIGKILL.  Recovery must run from the journal + the last persisted
        snapshot alone.  Handlers go silent (a dead process's bus
        subscriptions are gone; in-process buses can't unsubscribe)."""
        with self._mu:
            self._running = False
            self._killed = True
            active = len(self.active_work)
        flight.record("orch_kill", crawl_id=self.crawl_id,
                      active_work=active, depth=self.current_depth)
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        self.journal.close()

    @property
    def is_running(self) -> bool:
        with self._mu:
            return self._running

    # -- crash recovery ----------------------------------------------------
    def _has_existing_crawl(self) -> bool:
        """Is there a previous crawl to resume — a non-empty journal, or a
        persisted state-manager snapshot with layers?"""
        if self.journal.exists():
            return True
        provider = getattr(self.sm, "provider", None)
        path_fn = getattr(self.sm, "_state_path", None)
        if provider is None or not callable(path_fn):
            return False
        try:
            existing = provider.load_json(path_fn())
        except Exception as e:
            logger.warning("existing-crawl probe failed: %s", e)
            return False
        return bool(existing and existing.get("layers"))

    def _discard_foreign_journal(self) -> None:
        """A journal recorded by a DIFFERENT crawl id (shared journal
        dir, e.g. a common --dump-dir) must not be resumed as ours —
        discard it loudly instead of silently running someone else's
        crawl."""
        if not self.journal.exists():
            return
        recorded = self.journal.recorded_crawl_id()
        if recorded and recorded != self.crawl_id:
            logger.warning(
                "journal at %s belongs to crawl %r, not %r; discarding it",
                self.journal.journal_dir, recorded, self.crawl_id)
            self.journal.reset()

    def _discard_existing_crawl(self) -> None:
        """``--fresh``: drop the journal and blank the persisted state
        snapshot so ``sm.initialize`` re-seeds instead of resuming."""
        self.journal.reset()
        provider = getattr(self.sm, "provider", None)
        path_fn = getattr(self.sm, "_state_path", None)
        if provider is not None and callable(path_fn):
            try:
                provider.save_json(path_fn(), {})
            except Exception as e:
                logger.warning("could not blank persisted state: %s", e)
        logger.info("fresh start requested; discarded existing crawl state")

    def _journal_begin(self) -> None:
        """Stamp the crawl identity + the seed layer so a crash before the
        first state-manager save can still rebuild layer 0."""
        self._jappend("begin", crawl_id=self.crawl_id)
        try:
            seeds = self.sm.get_layer_by_depth(0)
        except Exception as e:
            logger.warning("seed-layer journal stamp skipped: %s", e)
            seeds = []
        if seeds:
            self._jappend("layer", depth=0,
                          pages=[p.to_dict() for p in seeds])

    def _jappend(self, kind: str, **fields) -> None:
        """Journal append that never takes the crawl down with it."""
        try:
            self.journal.append(kind, **fields)
        except Exception as e:
            logger.error("journal append failed (%s): %s", kind, e)

    def _snapshot_dict(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "crawl_id": self.crawl_id,
                "current_depth": self.current_depth,
                "total_work_items": self.total_work_items,
                "completed_items": self.completed_items,
                "error_items": self.error_items,
                "discovered_pages": self.discovered_pages,
                "crawl_completed": self.crawl_completed,
                "active_work": {wid: item.to_dict()
                                for wid, item in self.active_work.items()},
                "retry_counts": dict(self._retry_counts),
                # Insertion order = recency; only the newest slice is
                # persisted (APPLIED_RESULTS_SNAPSHOT) so compaction
                # cost stays flat on long crawls.
                "applied_results":
                    list(self._applied_results)[-APPLIED_RESULTS_SNAPSHOT:],
            }

    def _mark_applied_locked(self, work_item_id: str) -> None:
        """Record an applied (or abandoned) work-item id in the bounded
        idempotence window; caller holds ``_mu``."""
        self._applied_results[work_item_id] = None
        while len(self._applied_results) > APPLIED_RESULTS_WINDOW:
            self._applied_results.popitem(last=False)

    def _compact_journal(self, force: bool = False) -> None:
        """Snapshot + truncate the event log.  The state manager is saved
        FIRST: once the journal truncates, the persisted snapshot is the
        only carrier of page statuses the dropped events described."""
        if not force and not self.journal.should_compact():
            return
        try:
            self._state_policy.call(self.sm.save_state)
        except Exception as e:
            logger.warning("journal compaction skipped; state save "
                           "failed: %s", e)
            return
        try:
            self.journal.snapshot(self._snapshot_dict())
        except Exception as e:
            logger.error("journal snapshot failed: %s", e)

    def _find_page(self, item: WorkItem) -> Optional[Page]:
        try:
            return self.sm.get_page(item.parent_id)
        except KeyError:
            pass  # fall through to the by-url scan
        try:
            for page in self.sm.get_layer_by_depth(item.depth):
                if page.url == item.url:
                    return page
        except Exception as e:
            logger.warning("page lookup for %s failed: %s", item.id, e)
        return None

    def _resume_state(self) -> List[WorkItem]:
        """Rebuild coordination state from journal + state manager; no
        re-seed — the existing crawl continues where the dead process
        left it.  Returns the in-flight items to republish once the bus
        subscriptions are up (`_resume_requeue`)."""
        rec = self.journal.replay()
        # Load whatever the state manager persisted; empty seed list so a
        # backend without a persisted snapshot doesn't grow stray pages.
        self.sm.initialize([])
        # Re-add journaled pages the persisted snapshot may predate.
        # Filtered by page ID — not add_layer's URL dedup, which
        # random-walk crawls disable — so replays never duplicate layer
        # entries or clobber fresher persisted statuses.
        for depth, page_dicts in rec.layers:
            pages = []
            for d in page_dicts:
                page = Page.from_dict(d)
                try:
                    self.sm.get_page(page.id)
                except KeyError:
                    pages.append(page)
                except Exception as e:
                    logger.warning("resume: page probe failed (%s); "
                                   "skipping re-add", e)
            if not pages:
                continue
            try:
                self.sm.add_layer(pages)
            except Exception as e:
                logger.error("resume: failed to re-add layer %d: %s",
                             depth, e)
        # Replay journaled page outcomes over the (possibly stale)
        # persisted statuses.
        for page_id, (status, error) in rec.page_fixups.items():
            try:
                page = self.sm.get_page(page_id)
            except KeyError:
                continue  # page's layer event lost with a torn journal
            page.status = status
            if error:
                page.error = error
            self._update_page(page)
        with self._mu:
            self.current_depth = rec.current_depth
            self.total_work_items = rec.total_work_items
            self.completed_items = rec.completed_items
            self.error_items = rec.error_items
            self.discovered_pages = rec.discovered_pages
            self.crawl_completed = rec.crawl_completed
            self._retry_counts = dict(rec.retry_counts)
            self._applied_results = OrderedDict.fromkeys(
                sorted(rec.applied_results))
        # In-flight work: the dispatch happened but no result was
        # journaled — the result may be lost (worker died with us) or
        # still in flight.  Rebuild active_work + page state now; the
        # republish happens in `_resume_requeue` once subscriptions are
        # live.
        pending: List[WorkItem] = []
        for wid, item_dict in sorted(rec.active_work.items()):
            try:
                item = WorkItem.from_dict(item_dict)
            except Exception as e:
                logger.error("resume: undecodable journaled item %s: %s",
                             wid, e)
                continue
            with self._mu:
                self.active_work[item.id] = item
            page = self._find_page(item)
            if page is not None:
                page.status = PAGE_PROCESSING
                page.timestamp = utcnow()
                self._update_page(page)
            pending.append(item)
        # Safety sweep: PROCESSING pages nobody claims (torn dispatch
        # line, pre-journal crawls) go back to UNFETCHED so the
        # distributor re-dispatches rather than waiting forever.
        with self._mu:
            claimed = {i.parent_id for i in self.active_work.values()}
            claimed |= {i.url for i in self.active_work.values()}
        self._swept_on_resume = 0
        try:
            max_depth = self.sm.get_max_depth()
        except LookupError:
            max_depth = -1  # no layers at all: nothing to sweep
        for depth in range(max_depth + 1):
            try:
                layer = self.sm.get_layer_by_depth(depth)
            except Exception as e:
                logger.warning("resume sweep: layer %d unreadable: %s",
                               depth, e)
                continue
            for page in layer:
                if page.status == PAGE_PROCESSING \
                        and page.id not in claimed \
                        and page.url not in claimed:
                    page.status = PAGE_UNFETCHED
                    self._update_page(page)
                    self._swept_on_resume += 1
        self.resumed = True
        self._events_replayed = rec.events_replayed
        return pending

    def _resume_requeue(self, pending: List[WorkItem]) -> None:
        """Republish the resumed in-flight items at high priority under
        the SAME item id: a late result from the original delivery and
        one from the republication reconcile through active_work + the
        idempotence window.  Runs after the bus subscriptions are live."""
        requeued = 0
        for item in pending:
            with self._mu:
                if item.id not in self.active_work:
                    continue  # its result landed already
            try:
                with trace.span("orchestrator.resume_requeue",
                                trace_id=item.trace_id, work_item=item.id):
                    self._publish_policy.call(
                        self.bus.publish, TOPIC_WORK_QUEUE,
                        WorkQueueMessage.new(item, PRIORITY_HIGH,
                                             WORK_TTL_S))
                requeued += 1
                flight.record("resume_requeue", work_item=item.id,
                              url=item.url)
            except Exception as e:
                # Leave it to the normal distributor instead.
                logger.error("resume: failed to requeue %s: %s", item.id, e)
                with self._mu:
                    self.active_work.pop(item.id, None)
                page = self._find_page(item)
                if page is not None and page.status == PAGE_PROCESSING:
                    page.status = PAGE_UNFETCHED
                    self._update_page(page)
        swept = getattr(self, "_swept_on_resume", 0)
        flight.record("orch_resume", crawl_id=self.crawl_id,
                      depth=self.current_depth, requeued=requeued,
                      swept=swept, completed=self.completed_items,
                      events_replayed=getattr(self, "_events_replayed", 0),
                      crawl_completed=self.crawl_completed)
        logger.info("resumed crawl from journal", extra={
            "crawl_id": self.crawl_id, "current_depth": self.current_depth,
            "requeued": requeued, "swept": swept,
            "completed_items": self.completed_items})
        # The resume itself is the new durable baseline.
        self._compact_journal(force=True)

    def _update_page(self, page: Page) -> None:
        """Policy-guarded page update: retries transient failures, feeds
        the breaker, and never raises into a tick loop (an OPEN circuit
        defers the write — the journal still carries the transition)."""
        try:
            self._state_policy.call(self.sm.update_page, page)
        except resilience.CircuitOpenError:
            logger.warning("state-store circuit open; page %s update "
                           "deferred", page.id)
        except Exception as e:
            logger.error("failed to update page status", extra={
                "page_url": page.url, "error": str(e)})

    def _loop(self, tick, interval_s: float) -> None:
        while self.is_running:
            deadline = self.clock() + interval_s
            # Coarse sleep in small slices so stop() is responsive.
            while self.is_running and self.clock() < deadline:
                time.sleep(0.05)
            if not self.is_running:
                return
            try:
                tick()
            except Exception as e:
                logger.error("orchestrator tick error: %s", e)

    def _health_tick(self) -> None:
        self.check_worker_health()
        self.fleet.refresh_staleness()  # bounded-memory eviction sweep
        self.watchtower.tick()
        self.requeue_stale_work()
        self._flush_deferred()
        self._compact_journal()
        self.log_progress()

    # -- co-scheduling backpressure ----------------------------------------
    def inference_backlog(self, now: Optional[datetime] = None) -> int:
        """Summed queue_length of live TPU workers — the inference-side
        backlog the crawl must not outrun.  Offline workers AND workers
        whose heartbeat is older than worker_timeout_s are excluded: a
        stale queue_length (worker died between health sweeps) must not
        hold the valve shut."""
        now = now or utcnow()
        with self._mu:
            return sum(
                w.queue_length for w in self.workers.values()
                if w.worker_type == "tpu" and w.status != WORKER_OFFLINE
                and w.last_seen is not None
                and (now - w.last_seen).total_seconds()
                <= WORKER_TIMEOUT_S)

    def _backpressure_engaged(self) -> bool:
        """Hysteresis valve: engage at HIGH, release below LOW.  A LOW at
        or above HIGH would invert the hysteresis into per-tick chatter,
        so it is clamped to HIGH (degenerating to a plain threshold).

        An OPEN state-store circuit also engages the valve — a wedged
        backend must pause dispatch (degrade), not error the loop
        (cascade) — via its OWN latch, released the moment the breaker
        allows traffic again (it must not inherit the inference valve's
        backlog hysteresis, nor survive with that valve disabled)."""
        if self._state_policy.circuit_open:
            if not self._circuit_backpressure:
                self._circuit_backpressure = True
                flight.record("backpressure", reason="state_circuit_open",
                              target=STATE_STORE_TARGET)
                logger.warning("state-store circuit open; pausing crawl "
                               "distribution")
            return True
        if self._circuit_backpressure:
            self._circuit_backpressure = False
            logger.info("state-store circuit recovered; resuming crawl "
                        "distribution")
        # A near-full publish outbox is the broker-outage analog of the
        # state circuit: the buffered-and-retried degradation only holds
        # while there is buffer left, so dispatch pauses before the bound
        # turns publishes into OutboxFull errors.  Own latch, released
        # the moment the flusher drains back under the high-water mark.
        outbox = getattr(self.bus, "outbox", None)
        if outbox is not None:
            if self._outbox_backpressure:
                # Hysteresis: release only once the flusher has drained
                # well below the engage mark (below_low_water), so a
                # depth hovering at the boundary can't flap the valve —
                # the same discipline as the inference valve below.
                low_fn = getattr(outbox, "below_low_water", None)
                released = low_fn() if callable(low_fn) \
                    else not outbox.near_full()
                if not released:
                    return True
                self._outbox_backpressure = False
                logger.info("bus outbox drained below the low-water mark; "
                            "resuming crawl distribution")
            elif outbox.near_full():
                self._outbox_backpressure = True
                flight.record("backpressure", reason="bus_outbox_near_full",
                              depth=outbox.depth())
                logger.warning("bus outbox near its bound (%d buffered); "
                               "pausing crawl distribution", outbox.depth())
                return True
        high = self.ocfg.inference_backpressure_high
        if high <= 0:
            return False
        low = min(self.ocfg.inference_backpressure_low, high)
        backlog = self.inference_backlog()
        if self._backpressure_active:
            if backlog < low:
                self._backpressure_active = False
                flight.record("backpressure_released",
                              reason="inference_backlog", backlog=backlog,
                              low=low)
                logger.info("inference backlog drained; resuming crawl "
                            "distribution", extra={"backlog": backlog})
        elif backlog >= high:
            self._backpressure_active = True
            flight.record("backpressure", reason="inference_backlog",
                          backlog=backlog, high=high)
            logger.warning("inference backlog high; pausing crawl "
                           "distribution", extra={
                               "backlog": backlog, "high_watermark": high})
        return self._backpressure_active

    # -- work distribution (`orchestrator.go:182-277`) ---------------------
    def distribute_work(self) -> int:
        """One distribution pass; returns the number of items published.

        The reference only advanced depth on an *empty* layer
        (`orchestrator.go:189-210`), which stalls once a layer is fully
        fetched; here a layer with no pending and no in-flight pages also
        advances.  A backed-up inference stage (TPU worker queue_length
        over the high watermark) pauses PUBLISHING — crawl admission
        follows the slowest co-scheduled stage — but never
        completion/depth bookkeeping: a crawl whose pages are all fetched
        still completes while the valve is closed.  A wedged state store
        opens the resilience circuit: the tick degrades to a no-op
        (backpressure) instead of raising."""
        if self._killed:
            return 0
        self._flush_deferred()
        # Alert evaluation rides the distribute cadence too (the
        # watchtower rate-limits itself), so an orchestrator driven by
        # distribute_work alone still alerts.
        self.watchtower.tick()
        throttled = self._backpressure_engaged()
        if self.config.max_depth > 0 and \
                self.current_depth > self.config.max_depth:
            with self._mu:
                active = len(self.active_work)
            if active == 0 and not self.crawl_completed:
                logger.info("configured max depth reached",
                            extra={"max_depth": self.config.max_depth})
                self._mark_crawl_completed()
            return 0
        try:
            pages = self._state_policy.call(self.sm.get_layer_by_depth,
                                            self.current_depth)
        except resilience.CircuitOpenError:
            return 0  # backpressure engages on the next tick
        except Exception as e:
            logger.error("state-store layer read failed: %s", e)
            return 0
        pending = [p for p in pages
                   if p.status == PAGE_UNFETCHED
                   or (p.status == PAGE_ERROR and self._should_retry(p))]
        in_flight = any(p.status == PAGE_PROCESSING for p in pages)

        if not pending:
            if in_flight:
                return 0  # wait for results at this depth
            max_depth = self.sm.get_max_depth()
            if self.current_depth < max_depth:
                with self._mu:
                    self.current_depth += 1
                self._jappend("depth", depth=self.current_depth)
                logger.info("moving to next depth",
                            extra={"new_depth": self.current_depth})
                return 0
            with self._mu:
                active = len(self.active_work)
            if active == 0 and not self.crawl_completed:
                self._mark_crawl_completed()
            return 0
        if throttled:
            return 0  # pending work exists but inference must drain first
        published = 0
        for page in self._frontier_lanes(pending):
            item = self.create_work_item(page)
            with self._mu:
                self.active_work[item.id] = item
                self.total_work_items += 1
            page.status = PAGE_PROCESSING
            page.timestamp = utcnow()
            self._update_page(page)
            try:
                # The root span of the work item's trace: everything
                # downstream (bus delivery, worker processing, the result
                # leg) shares item.trace_id, so /traces shows dispatch ->
                # crawl -> result as one timeline.
                with trace.span("orchestrator.dispatch",
                                trace_id=item.trace_id, work_item=item.id,
                                depth=item.depth, platform=item.platform):
                    self._publish_policy.call(
                        self.bus.publish, TOPIC_WORK_QUEUE,
                        WorkQueueMessage.new(item,
                                             self._frontier_priority(item),
                                             WORK_TTL_S))
                published += 1
                self._jappend("dispatch", item=item.to_dict(),
                              page_id=page.id)
                flight.record("dispatch", work_item=item.id, url=item.url,
                              depth=item.depth)
            except Exception as e:
                # Revert on publish failure (`orchestrator.go:255-268`).
                logger.error("failed to publish work item", extra={
                    "work_item_id": item.id, "error": str(e)})
                page.status = PAGE_UNFETCHED
                self._update_page(page)
                with self._mu:
                    self.active_work.pop(item.id, None)
                    self.total_work_items -= 1
        if published:
            self._compact_journal()
        return published

    def _frontier_lanes(self, pending: List[Page]) -> List[Page]:
        """Partition frontier pages into shard-owned dispatch lanes.

        With a partitioned bus (`bus/partition.py`: the bus — possibly
        behind an outbox/chaos wrapper — exposes ``shard_map``), pages
        group by the consistent hash of their CHANNEL (the same key the
        bus routes the resulting WorkQueueMessages by, so a lane's pages
        genuinely land on that lane's broker shard) and dispatch
        round-robin ACROSS lanes: publishes alternate shards instead of
        draining one channel's run into one queue, and each shard's
        outbox flushes its lane concurrently — the distribute_work
        fan-out is no longer serialized through one broker queue.  Page
        state stays coordinated through the state layer exactly as
        before (every status write goes through ``sm``); only the
        dispatch order and the broker each item rides change.  Without
        a shard map this is the identity.
        """
        smap = getattr(self.bus, "shard_map", None)
        if smap is None:
            return pending
        from ..bus.partition import channel_of

        lanes: Dict[str, List[Page]] = {}
        for page in pending:
            lanes.setdefault(
                smap.shard_for(channel_of(page.url)), []).append(page)
        counts = {sid: len(ps) for sid, ps in sorted(lanes.items())}
        with self._mu:
            changed = counts != self._frontier_lane_counts
            self._frontier_lane_counts = counts
        if changed:
            flight.record("frontier_shards", depth=self.current_depth,
                          lanes=counts)
            logger.info("frontier partitioned across %d shard lane(s): %s",
                        len(counts), counts)
        # O(n) round-robin interleave (a large pending layer re-runs
        # this every distribute tick — pop(0) shuffling would be
        # quadratic exactly at the scale this subsystem targets).
        ordered: List[Page] = []
        pools = [iter(lanes[sid]) for sid in sorted(lanes)]
        while pools:
            alive = []
            for it in pools:
                page = next(it, None)
                if page is not None:
                    ordered.append(page)
                    alive.append(it)
            pools = alive
        return ordered

    def create_work_item(self, page: Page) -> WorkItem:
        """`orchestrator.go:280-303`."""
        c = self.config
        cfg = WorkItemConfig(
            storage_root=c.storage_root, concurrency=c.concurrency,
            timeout=c.timeout, min_post_date=c.min_post_date,
            post_recency=c.post_recency, date_between_min=c.date_between_min,
            date_between_max=c.date_between_max, sample_size=c.sample_size,
            max_comments=c.max_comments, max_posts=c.max_posts,
            max_depth=c.max_depth, max_pages=c.max_pages,
            min_users=c.min_users, crawl_label=c.crawl_label,
            skip_media_download=c.skip_media_download,
            youtube_api_key=c.youtube_api_key,
            sampling_method=c.sampling_method,
            min_channel_videos=c.min_channel_videos)
        return WorkItem.new(page.url, page.depth, page.id, self.crawl_id,
                            c.platform, cfg)

    def _should_retry(self, page: Page) -> bool:
        """`orchestrator.go:306-312`, with real per-page retry tracking."""
        return self._retry_counts.get(page.id, 0) < MAX_RETRIES

    # -- result handling (`orchestrator.go:315-416`) -----------------------
    def handle_result_payload(self, payload: Dict[str, Any]) -> None:
        self.handle_result(ResultMessage.from_dict(payload))

    def handle_result(self, message: ResultMessage) -> None:
        if self._killed:
            return
        result = message.work_result
        with self._mu:
            if result.work_item_id in self._applied_results:
                # Idempotent apply: a result replayed across a restart
                # (bus redelivery of a frame the dead generation already
                # applied) is single-counted by work-item id.
                logger.debug("ignoring already-applied result",
                             extra={"work_item_id": result.work_item_id})
                return
            item = self.active_work.pop(result.work_item_id, None)
            if item is not None:
                self._mark_applied_locked(result.work_item_id)
                self.completed_work[result.work_item_id] = result
                if result.status == STATUS_SUCCESS:
                    self.completed_items += 1
                else:
                    self.error_items += 1
        if item is None:
            logger.warning("result for unknown work item", extra={
                "work_item_id": result.work_item_id})
            return
        flight.record("result", work_item=result.work_item_id,
                      status=result.status, worker=result.worker_id,
                      error=result.error or None)
        with trace.span("orchestrator.handle_result",
                        trace_id=item.trace_id or message.trace_id,
                        work_item=result.work_item_id, status=result.status,
                        worker=result.worker_id):
            self._apply_result(item, message, result)

    def _apply_result(self, item: WorkItem, message: ResultMessage,
                      result: WorkResult) -> None:
        applied_page: Optional[Page] = None
        try:
            layer = self._state_policy.call(self.sm.get_layer_by_depth,
                                            item.depth)
        except Exception as e:
            # Wedged store: park the whole application (page transition,
            # discovery, journal event) for the tick-loop retry.  The
            # result is NOT journaled yet, so a crash before the retry
            # leaves the item in-flight and a restart requeues it.
            logger.warning("deferring result apply for %s; state store "
                           "unavailable: %s", item.id, e)
            with self._mu:
                self._deferred_results.append((item, message, result))
                del self._deferred_results[:-DEFERRED_CAP]
            return
        for page in layer:
            if page.url != item.url:
                continue
            if result.status == STATUS_SUCCESS:
                page.status = PAGE_FETCHED
                self._retry_counts.pop(page.id, None)
            else:
                page.error = result.error
                if result.retry_recommended:
                    retries = self._retry_counts.get(page.id, 0) + 1
                    if retries >= MAX_RETRIES:
                        # Budget exhausted: terminal.  The retry counter
                        # is PRUNED on every terminal transition — the
                        # page's status is the durable marker, so the
                        # map stays bounded by in-flight pages.
                        page.status = PAGE_ABANDONED
                        self._retry_counts.pop(page.id, None)
                    else:
                        page.status = PAGE_ERROR
                        self._retry_counts[page.id] = retries
                else:
                    # Worker classified the failure as permanent
                    # (`worker.go:436-456`): terminal immediately.
                    page.status = PAGE_ABANDONED
                    self._retry_counts.pop(page.id, None)
            page.timestamp = result.completed_at or utcnow()
            self._update_page(page)
            applied_page = page
            break

        discovered = message.discovered_pages or result.discovered_pages
        if discovered:
            try:
                self._process_discovered(discovered, item.depth)
                with self._mu:
                    self.discovered_pages += len(discovered)
            except Exception as e:
                logger.error("failed to process discovered pages",
                             extra={"error": str(e)})
        self._jappend(
            "result", work_item_id=item.id,
            page_id=applied_page.id if applied_page is not None else "",
            status=result.status, error=result.error or "",
            page_status=applied_page.status if applied_page is not None
            else "",
            retries=(self._retry_counts.get(applied_page.id, 0)
                     if applied_page is not None else 0),
            discovered=len(discovered) if discovered else 0)
        self._compact_journal()

    def _process_discovered(self, discovered, current_depth: int) -> None:
        """`orchestrator.go:386-416`."""
        from ..state.datamodels import new_id
        pages = [Page(id=new_id(), url=dp.url, depth=current_depth + 1,
                      status=PAGE_UNFETCHED, timestamp=utcnow(),
                      parent_id=dp.parent_id)
                 for dp in discovered]
        # Journal BEFORE the store write: if the store is wedged the
        # pages are still recoverable (live via the deferred retry,
        # across a crash via the layer event).
        self._jappend("layer", depth=current_depth + 1,
                      pages=[p.to_dict() for p in pages])
        self._add_layer_or_defer(pages)
        logger.info("added discovered pages as new layer", extra={
            "count": len(pages), "new_depth": current_depth + 1})

    def _add_layer_or_defer(self, pages: List[Page]) -> None:
        try:
            self._state_policy.call(self.sm.add_layer, pages)
        except Exception as e:
            logger.warning("deferring %d discovered pages; state store "
                           "unavailable: %s", len(pages), e)
            with self._mu:
                self._deferred_layers.append(pages)
                del self._deferred_layers[:-DEFERRED_CAP]

    def _flush_deferred(self) -> None:
        """Re-attempt state-store work parked while the circuit was open
        (discovered layers, result applications).  Failures re-defer."""
        with self._mu:
            if not self._deferred_layers and not self._deferred_results:
                return
        if self._state_policy.circuit_open:
            return  # still shedding; the valve keeps dispatch paused
        with self._mu:
            layers, self._deferred_layers = self._deferred_layers, []
            results, self._deferred_results = self._deferred_results, []
        for pages in layers:
            self._add_layer_or_defer(pages)
        for item, message, result in results:
            self._apply_result(item, message, result)

    # -- distributed-trace fold (`tracecollect.py`) ------------------------
    def handle_spans_payload(self, payload: Dict[str, Any]) -> None:
        if self._killed:
            return
        self.trace_collector.observe(SpanBatchMessage.from_dict(payload))

    def get_dtraces(self, limit: int = 0) -> Dict[str, Any]:
        """The ``/dtraces`` JSON body (assembled distributed traces);
        registered via `utils.metrics.set_dtraces_provider` by the CLI."""
        return self.trace_collector.export(limit=limit)

    # -- watchtower (`watchtower.py`) --------------------------------------
    def handle_alert_payload(self, payload: Dict[str, Any]) -> None:
        """Log fleet alert announcements at the coordinator (firing at
        WARNING, the rest at INFO); never raises into the bus."""
        if self._killed:
            return
        try:
            msg = AlertMessage.from_dict(payload)
        except Exception as e:
            logger.debug("undecodable alert announcement: %s", e)
            return
        logger.log(
            logging.WARNING if msg.state == "firing" else logging.INFO,
            "fleet alert %s: %s -> %s (value=%s)",
            msg.rule, msg.prev_state, msg.state, msg.value)

    def get_alerts(self) -> Dict[str, Any]:
        """The ``/alerts`` JSON body (alert lifecycle state + log);
        registered via `utils.metrics.set_alerts_provider` by the CLI."""
        return self.watchtower.get_alerts()

    def get_tenants(self) -> Dict[str, Any]:
        """The ``/tenants`` JSON body (per-tenant spend + error budgets);
        registered via `utils.metrics.set_tenants_provider` by the CLI."""
        return self.watchtower.get_tenants()

    # -- cluster-guided frontier (`cluster/`) ------------------------------
    def handle_cluster_payload(self, payload: Dict[str, Any]) -> None:
        """Fold a ClusterUpdateMessage into the frontier-priority guide;
        never raises into the bus."""
        if self._killed:
            return
        try:
            msg = ClusterUpdateMessage.from_dict(payload)
            msg.validate()
        except Exception as e:
            logger.debug("undecodable cluster update: %s", e)
            return
        with self._mu:
            self._cluster_guide = {
                "worker_id": msg.worker_id,
                "k": msg.k,
                "step": msg.step,
                "vectors": msg.vectors,
                "underpopulated": set(int(c) for c in msg.underpopulated),
                "channel_clusters": {
                    ch.lower(): int(c)
                    for ch, c in msg.channel_clusters.items()},
                "inertia": msg.inertia,
                "received_at": self.clock(),
            }

    @staticmethod
    def _channel_of(url: str) -> str:
        """Channel name from a frontier URL — ONE rule shared with the
        partitioned bus's routing key (`bus/partition.py:channel_of`),
        so the cluster guide's channel map and the sharded frontier's
        lane assignment agree on what 'the same channel' means."""
        from ..bus.partition import channel_of

        return channel_of(url)

    def _frontier_priority(self, item: WorkItem) -> int:
        """PRIORITY_HIGH when the page's channel last landed in an
        under-populated cluster — the cluster-guided snowball: frontier
        budget flows to the sparse corners of the embedding space.
        A guide older than ``cluster_guide_ttl_s`` is ignored: a dead
        cluster worker's final snapshot must not steer dispatch
        forever."""
        with self._mu:
            guide = self._cluster_guide
        if not guide or not guide["underpopulated"]:
            return PRIORITY_MEDIUM
        ttl = CLUSTER_GUIDE_TTL_S
        if ttl > 0 and self.clock() - guide["received_at"] > ttl:
            return PRIORITY_MEDIUM
        cluster = guide["channel_clusters"].get(self._channel_of(item.url))
        if cluster is None or cluster not in guide["underpopulated"]:
            return PRIORITY_MEDIUM
        with self._mu:
            self._cluster_prioritized += 1
        flight.record("cluster_priority", work_item=item.id, url=item.url,
                      cluster=int(cluster))
        return PRIORITY_HIGH

    # -- worker registry (`orchestrator.go:419-449`) -----------------------
    def handle_status_payload(self, payload: Dict[str, Any]) -> None:
        self.handle_status(StatusMessage.from_dict(payload))

    def handle_status(self, message: StatusMessage) -> None:
        if self._killed:
            return
        if self.fleet.observe(message):
            # Only heartbeats the fleet ACCEPTED reach the time-series
            # fold: a reordered/redelivered older frame carries lower
            # cumulative breach counts, which the store's reset-aware
            # increase() would misread as a counter restart and count
            # as phantom breaches — enough to fire a zero-budget burn
            # rule on a healthy fleet.
            self.watchtower.observe_status(message)
        with self._mu:
            worker = self.workers.get(message.worker_id)
            if worker is None:
                worker = WorkerInfo(id=message.worker_id)
                self.workers[message.worker_id] = worker
            worker.status = message.status
            worker.worker_type = message.worker_type or "crawl"
            worker.last_seen = message.timestamp or utcnow()
            worker.queue_length = message.queue_length
            worker.tasks_total = message.tasks_processed
            worker.tasks_success = message.tasks_success
            worker.tasks_error = message.tasks_error
            if message.current_work is not None:
                worker.current_work = message.current_work
                # Record the claim so failed-worker reassignment knows which
                # items this worker held (the busy heartbeat carries the
                # item id, `worker.go:255-263`).
                item = self.active_work.get(message.current_work)
                if item is not None:
                    item.assigned_to = message.worker_id
                    item.assigned_at = worker.last_seen

    # -- health monitoring (`orchestrator.go:472-559`) ---------------------
    def check_worker_health(self, now: Optional[datetime] = None) -> List[str]:
        """Mark silent workers offline and reassign their work; returns the
        failed worker IDs."""
        now = now or utcnow()
        failed: List[str] = []
        with self._mu:
            for worker_id, worker in self.workers.items():
                if worker.status == WORKER_OFFLINE or worker.last_seen is None:
                    continue
                silence = (now - worker.last_seen).total_seconds()
                if silence > WORKER_TIMEOUT_S:
                    logger.warning("worker appears to have failed", extra={
                        "worker_id": worker_id,
                        "last_seen": str(worker.last_seen)})
                    worker.status = WORKER_OFFLINE
                    failed.append(worker_id)
                    flight.record("worker_offline", worker=worker_id,
                                  silence_s=round(silence, 1))
        if failed:
            self.reassign_work_from_failed_workers(failed)
        return failed

    def requeue_stale_work(self, now: Optional[datetime] = None) -> int:
        """Age out active work whose result never arrived within
        ``work_ttl_s`` even though its worker still heartbeats (lost frame,
        wedged handler): republish at high priority up to the retry budget,
        then drop the item and mark its page errored so the crawl can't
        stall forever on one in-flight entry."""
        now = now or utcnow()
        if self._killed:
            return 0
        with self._mu:
            stale = [i for i in self.active_work.values()
                     if i.created_at is not None and
                     (now - i.created_at).total_seconds() >
                     WORK_TTL_S]
        requeued = 0
        for item in stale:
            if item.retry_count >= MAX_RETRIES:
                logger.error("abandoning stale work item past retry budget",
                             extra={"work_item_id": item.id, "url": item.url})
                with self._mu:
                    self.active_work.pop(item.id, None)
                    self.error_items += 1
                    # Abandons join the idempotence window too: their
                    # journal fold must also be replay-safe.
                    self._mark_applied_locked(item.id)
                abandoned_page_id = ""
                try:
                    layer = self._state_policy.call(
                        self.sm.get_layer_by_depth, item.depth)
                except Exception as e:
                    # Wedged store: the journaled abandon below still
                    # carries the page id, so the terminal status is
                    # replayed on resume even though the live write
                    # couldn't land.
                    logger.warning("abandon: state store unavailable "
                                   "(%s); page fixup deferred", e)
                    layer = []
                for page in layer:
                    if page.url == item.url:
                        # Terminal: abandoned pages carry no live retry
                        # counter (the status itself blocks re-dispatch).
                        page.status = PAGE_ABANDONED
                        page.error = "work item expired without result"
                        self._retry_counts.pop(page.id, None)
                        self._update_page(page)
                        abandoned_page_id = page.id
                        break
                self._jappend("abandon", work_item_id=item.id,
                              page_id=abandoned_page_id or item.parent_id,
                              page_status=PAGE_ABANDONED,
                              error="work item expired without result")
                continue
            # Rotate the item id on requeue (generation suffix) so a late
            # result from the stale attempt can't complete the fresh one —
            # and mutate under the lock so the result handler never sees a
            # half-updated entry still keyed in active_work.
            with self._mu:
                if item.id not in self.active_work:
                    continue  # result arrived between snapshot and requeue
                self.active_work.pop(item.id, None)
                fresh = replace(item,
                                id=(item.id.rsplit("#", 1)[0] +
                                    f"#{item.retry_count + 1}"),
                                retry_count=item.retry_count + 1,
                                assigned_to="", created_at=now)
                self.active_work[fresh.id] = fresh
            try:
                with trace.span("orchestrator.requeue",
                                trace_id=fresh.trace_id, work_item=fresh.id,
                                retry=fresh.retry_count):
                    self._publish_policy.call(
                        self.bus.publish, TOPIC_WORK_QUEUE,
                        WorkQueueMessage.new(fresh, PRIORITY_HIGH,
                                             WORK_TTL_S))
                requeued += 1
                self._jappend("requeue", old_id=item.id,
                              item=fresh.to_dict(),
                              page_id=fresh.parent_id)
                flight.record("requeue", work_item=fresh.id,
                              retry=fresh.retry_count)
                logger.warning("requeued stale work item", extra={
                    "work_item_id": fresh.id,
                    "retry_count": fresh.retry_count})
            except Exception as e:
                logger.error("failed to requeue stale work item", extra={
                    "work_item_id": fresh.id, "error": str(e)})
        return requeued

    def reassign_work_from_failed_workers(self, failed: List[str]) -> int:
        """`orchestrator.go:520-559`."""
        reassigned = 0
        with self._mu:
            items = [i for i in self.active_work.values()
                     if i.assigned_to in failed]
        for item in items:
            with self._mu:
                if item.id not in self.active_work:
                    continue  # result landed before the reassignment
                self.active_work.pop(item.id, None)
                fresh = replace(item,
                                id=(item.id.rsplit("#", 1)[0] +
                                    f"#{item.retry_count + 1}"),
                                retry_count=item.retry_count + 1,
                                assigned_to="", created_at=utcnow())
                self.active_work[fresh.id] = fresh
            try:
                with trace.span("orchestrator.reassign",
                                trace_id=fresh.trace_id, work_item=fresh.id,
                                retry=fresh.retry_count):
                    self._publish_policy.call(
                        self.bus.publish, TOPIC_WORK_QUEUE,
                        WorkQueueMessage.new(fresh, PRIORITY_HIGH,
                                             WORK_TTL_S))
                reassigned += 1
                self._jappend("reassign", old_id=item.id,
                              item=fresh.to_dict(),
                              page_id=fresh.parent_id)
                flight.record("reassign", work_item=fresh.id,
                              retry=fresh.retry_count)
                logger.info("reassigned work item from failed worker", extra={
                    "work_item_id": fresh.id, "retry_count": fresh.retry_count})
            except Exception as e:
                logger.error("failed to reassign work item", extra={
                    "work_item_id": fresh.id, "error": str(e)})
        return reassigned

    # -- progress / status (`orchestrator.go:562-633`) ---------------------
    def _mark_crawl_completed(self) -> None:
        with self._mu:
            self.crawl_completed = True
        self._jappend("completed")
        metadata = {
            "status": "completed",
            "end_time": utcnow().isoformat(),
            "total_work_items": self.total_work_items,
            "completed_items": self.completed_items,
            "error_items": self.error_items,
            "discovered_pages": self.discovered_pages,
            "max_depth_reached": self.current_depth,
            "duration_s": self.clock() - self._started_at,
        }
        try:
            self.sm.update_crawl_metadata(self.crawl_id, metadata)
        except Exception as e:
            logger.error("failed to update crawl completion metadata",
                         extra={"error": str(e)})
        flight.record("crawl_completed", crawl_id=self.crawl_id,
                      completed=self.completed_items,
                      errors=self.error_items)
        logger.info("crawl marked as completed", extra={"stats": metadata})

    def log_progress(self) -> None:
        with self._mu:
            active_workers = sum(
                1 for w in self.workers.values()
                if w.status in (WORKER_ACTIVE, WORKER_BUSY, WORKER_IDLE))
            logger.info("crawl progress status", extra={
                "current_depth": self.current_depth,
                "active_work": len(self.active_work),
                "completed_work": self.completed_items,
                "error_work": self.error_items,
                "total_work": self.total_work_items,
                "total_workers": len(self.workers),
                "active_workers": active_workers,
                "discovered_pages": self.discovered_pages,
                "uptime_s": self.clock() - self._started_at})

    def get_status(self) -> Dict[str, Any]:
        """`orchestrator.go:596-633`."""
        backlog = self.inference_backlog()
        with self._mu:
            tpu = {k: w for k, w in self.workers.items()
                   if w.worker_type == "tpu"}
            return {
                "crawl_id": self.crawl_id,
                "is_running": self._running,
                "platform": self.config.platform,
                "current_depth": self.current_depth,
                "worker_count": len(self.workers),
                "crawl_worker_count": len(self.workers) - len(tpu),
                "tpu_worker_count": len(tpu),
                "inference_backlog": backlog,
                "backpressure_active": (self._backpressure_active or self._circuit_backpressure),
                "state_circuit": self._state_policy.breaker.state,
                "resumed": self.resumed,
                "frontier_lanes": dict(self._frontier_lane_counts) or None,
                "cluster_guide": {
                    "step": self._cluster_guide["step"],
                    "vectors": self._cluster_guide["vectors"],
                    "underpopulated": sorted(
                        self._cluster_guide["underpopulated"]),
                    "channels_mapped": len(
                        self._cluster_guide["channel_clusters"]),
                    "prioritized_items": self._cluster_prioritized,
                } if self._cluster_guide else None,
                "workers": {k: vars(v).copy()
                            for k, v in self.workers.items()},
                "work_stats": {
                    "active_work": len(self.active_work),
                    "completed_work": len(self.completed_work),
                    "total_work": self.total_work_items,
                    "completed_items": self.completed_items,
                    "error_items": self.error_items,
                    "discovered_pages": self.discovered_pages,
                },
                "uptime_s": self.clock() - self._started_at,
                "crawl_completed": self.crawl_completed,
            }

    def get_cluster(self) -> Dict[str, Any]:
        """The ``/cluster`` JSON body: the FleetView's per-worker fold
        (telemetry, rates, history, staleness) plus the orchestrator-side
        work summary — one page answering "what is the fleet doing".
        Registered via `utils.metrics.set_cluster_provider` by the CLI."""
        out = self.fleet.export()
        with self._mu:
            out["orchestrator"] = {
                "crawl_id": self.crawl_id,
                "is_running": self._running,
                "current_depth": self.current_depth,
                "active_work": len(self.active_work),
                "completed_items": self.completed_items,
                "error_items": self.error_items,
                "backpressure_active": (self._backpressure_active or self._circuit_backpressure),
                "uptime_s": self.clock() - self._started_at,
            }
        return out

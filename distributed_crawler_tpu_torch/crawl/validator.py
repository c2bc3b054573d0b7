"""The tandem validator: the port's copy of the reference's
`distributed_crawler_tpu/crawl/validator.py`.

- Two loops, coupled to the crawler only through the SQL queue: edge
  validation and walkback processing (`RunValidationLoop`).
- Edge validation: claim a batch of pending edges, answer from the
  invalid and discovered caches where they can, else validate over HTTP
  at the rate limiter's pace, and apply the status with first-claim
  semantics (`validate_single_edge`, `edge_validation_step`).
- The blocked state: after ``blocked_threshold`` blocked outcomes in a row
  the loop stops claiming, probes a canary channel every
  ``probe_interval_s`` and inserts an ``access_events`` row, so that an
  outside process can rotate the IP.
- Walkback processing: claim a batch whose edges are all validated, take
  the walkback decision, write the edge records and the next page,
  complete the batch, then flush its stats (`process_walkback_batch`).
  The batch is completed before the flush, so a crash between the two
  leaves orphan edges, which the next start sweeps, and never a batch
  that could be claimed again.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..clients.http_validator import (
    BLOCKED,
    ChannelValidationResult,
    ValidationHTTPError,
    ValidatorRateLimiter,
    make_transport,
    validate_channel_http,
)
from ..config.crawler import CrawlerConfig
from ..state.datamodels import (
    EdgeRecord,
    Page,
    PendingEdge,
    PendingEdgeBatch,
    PendingEdgeUpdate,
    new_id,
    utcnow,
)
from .runner import pick_walkback_channel

logger = logging.getLogger("dct.crawl.validator")

# Outcome kinds.
OUTCOME_DEFINITIVE = "definitive"
OUTCOME_TRANSIENT = "transient"
OUTCOME_BLOCKED = "blocked"

ValidateFunc = Callable[[str], ChannelValidationResult]


@dataclass
class ValidatorConfig:
    """The loops' timing and thresholds."""

    edge_poll_interval_s: float = 2.0
    walkback_poll_interval_s: float = 3.0
    stale_batch_recovery_interval_s: float = 300.0
    stale_batch_recovery_threshold_s: float = 600.0
    blocked_threshold: int = 5
    probe_interval_s: float = 300.0
    probe_channel: str = "telegram"  # a well-known canary


@dataclass
class BlockedState:
    """Consecutive blocked outcomes and the probe's schedule."""

    active: bool = False
    consecutive_count: int = 0
    last_probe_at: float = 0.0


def _pending(edge: PendingEdge) -> PendingEdgeUpdate:
    return PendingEdgeUpdate(pending_id=edge.pending_id,
                             validation_status="pending")


def validate_single_edge(sm, cfg: CrawlerConfig,
                         rate_limiter: ValidatorRateLimiter,
                         edge: PendingEdge,
                         validate_fn: ValidateFunc
                         ) -> Tuple[PendingEdgeUpdate, str]:
    """Validate one edge.  An access problem never invalidates a channel:
    the edge goes back to pending."""
    channel = edge.destination_channel

    if sm.is_invalid_channel(channel):
        return PendingEdgeUpdate(pending_id=edge.pending_id,
                                 validation_status="invalid",
                                 validation_reason="cached_invalid"), \
            OUTCOME_DEFINITIVE

    # Already discovered by any crawl (read only: no claim here).
    try:
        if sm.is_channel_discovered(channel):
            return PendingEdgeUpdate(pending_id=edge.pending_id,
                                     validation_status="duplicate"), \
                OUTCOME_DEFINITIVE
    except Exception as e:
        logger.warning("is_channel_discovered check failed: %s", e)

    rate_limiter.wait()

    try:
        result = validate_fn(channel)
    except ValidationHTTPError as e:
        kind = OUTCOME_BLOCKED if e.kind == BLOCKED else OUTCOME_TRANSIENT
        return _pending(edge), kind
    except Exception as e:
        logger.warning("validate failed for %s: %s", channel, e)
        return _pending(edge), OUTCOME_TRANSIENT

    logger.info("validation result", extra={
        "channel": channel, "status": result.status, "reason": result.reason,
        "source_type": edge.source_type})

    if result.status == "valid":
        try:
            claimed = sm.claim_discovered_channel(channel, edge.crawl_id)
        except Exception as e:
            # A store failure leaves the edge pending to be claimed again,
            # rather than finalizing a valid channel as a duplicate.
            logger.warning("claim_discovered_channel failed: %s", e)
            return _pending(edge), OUTCOME_TRANSIENT
        if not claimed:
            return PendingEdgeUpdate(pending_id=edge.pending_id,
                                     validation_status="duplicate"), \
                OUTCOME_DEFINITIVE
        try:
            sm.upsert_seed_channel_chat_id(channel, 0)
        except Exception as e:
            logger.warning("failed to cache channel: %s", e)
        return PendingEdgeUpdate(pending_id=edge.pending_id,
                                 validation_status="valid"), \
            OUTCOME_DEFINITIVE

    if result.status in ("not_channel", "invalid"):
        try:
            sm.mark_channel_invalid(channel, result.reason)
        except Exception as e:
            logger.warning("mark_channel_invalid failed: %s", e)
        return PendingEdgeUpdate(pending_id=edge.pending_id,
                                 validation_status=result.status,
                                 validation_reason=result.reason), \
            OUTCOME_DEFINITIVE

    return PendingEdgeUpdate(pending_id=edge.pending_id,
                             validation_status="invalid",
                             validation_reason="unknown_status"), \
        OUTCOME_DEFINITIVE


def edge_validation_step(sm, cfg: CrawlerConfig, vcfg: ValidatorConfig,
                         rate_limiter: ValidatorRateLimiter,
                         blocked: BlockedState, validate_fn: ValidateFunc,
                         now_fn: Callable[[], float]) -> int:
    """One pass of the edge-validation loop; returns the edges processed.

    While blocked it claims nothing and probes the canary channel every
    ``probe_interval_s`` (the first probe at once), resuming on success."""
    if blocked.active:
        if now_fn() - blocked.last_probe_at < vcfg.probe_interval_s \
                and blocked.last_probe_at != 0.0:
            return 0
        blocked.last_probe_at = now_fn()
        try:
            validate_fn(vcfg.probe_channel)
            logger.info("probe succeeded, resuming validation")
            blocked.active = False
            blocked.consecutive_count = 0
        except Exception as e:
            logger.warning("probe failed, still blocked: %s", e)
        return 0

    edges = sm.claim_pending_edges(cfg.validator_claim_batch_size or 10)
    for edge in edges:
        update, kind = validate_single_edge(sm, cfg, rate_limiter, edge,
                                            validate_fn)
        if kind == OUTCOME_BLOCKED:
            blocked.consecutive_count += 1
            logger.warning("access blocked, edge left pending", extra={
                "channel": edge.destination_channel,
                "consecutive_blocked": blocked.consecutive_count})
            if not blocked.active and \
                    blocked.consecutive_count >= vcfg.blocked_threshold:
                blocked.active = True
                blocked.last_probe_at = 0.0  # the first probe fires at once
                logger.warning("entering blocked state")
                try:
                    sm.insert_access_event("ip_blocked")
                except Exception as e:
                    logger.warning("failed to insert access event: %s", e)
        elif kind == OUTCOME_TRANSIENT:
            if blocked.consecutive_count > 0:
                blocked.consecutive_count -= 1
        else:
            blocked.consecutive_count = 0
        try:
            sm.update_pending_edge(update)
        except Exception as e:
            logger.warning("failed to update edge status: %s", e)
    return len(edges)


def process_walkback_batch(sm, cfg: CrawlerConfig, batch: PendingEdgeBatch,
                           all_edges: List[PendingEdge],
                           rng: Optional[random.Random] = None) -> None:
    """The walkback decision over a validated batch, its edge records and
    next page, then the batch completed and its stats flushed."""
    rng = rng or random.Random()
    valid_first_claimed = [e.destination_channel for e in all_edges
                           if e.validation_status == "valid"]

    walkback = False
    rnd = -1
    if not valid_first_claimed:
        walkback = True
    else:
        rnd = rng.randint(1, 100)
        if cfg.walkback_rate >= rnd:
            walkback = True

    logger.info("walkback decision data (validator)", extra={
        "log_tag": "rw_channel", "walkback_rate": cfg.walkback_rate,
        "random_num": rnd, "walkback": walkback,
        "valid_channels": len(valid_first_claimed),
        "source_channel": batch.source_channel, "batch_id": batch.batch_id})

    if walkback:
        exclude = {ch: True for ch in valid_first_claimed}
        next_url = pick_walkback_channel(sm, batch.source_channel, exclude,
                                         rng=rng)
        sequence_id = batch.sequence_id  # the edge belongs to this chain
        page_sequence_id = new_id()  # the next crawl starts a new chain
    else:
        idx = rng.randrange(len(valid_first_claimed))
        next_url = valid_first_claimed.pop(idx)
        sequence_id = batch.sequence_id
        page_sequence_id = batch.sequence_id

    # The crawl id is the batch's: the page must land under its own crawl
    # when this validator serves another.
    page = Page(id=new_id(), parent_id=batch.source_page_id,
                depth=batch.source_depth + 1, url=next_url,
                sequence_id=page_sequence_id, status="unfetched",
                crawl_id=batch.crawl_id)
    sm.add_page_to_page_buffer(page)  # unblocks the crawler

    edge_records = [EdgeRecord(
        destination_channel=next_url, source_channel=batch.source_channel,
        walkback=walkback, skipped=False, discovery_time=utcnow(),
        sequence_id=sequence_id, crawl_id=batch.crawl_id)]
    for ch in valid_first_claimed:
        edge_records.append(EdgeRecord(
            destination_channel=ch, source_channel=batch.source_channel,
            walkback=False, skipped=True, discovery_time=utcnow(),
            sequence_id=batch.sequence_id, crawl_id=batch.crawl_id))
    sm.save_edge_records(edge_records)

    # Complete before the flush: a crash here leaves orphan edges, swept
    # at the next start, and no batch to claim again.
    sm.complete_pending_batch(batch.batch_id)
    try:
        sm.flush_batch_stats(batch.batch_id, batch.crawl_id, all_edges)
    except Exception as e:
        logger.warning("flush_batch_stats failed; orphan edges cleaned at "
                       "next startup: %s", e)
    logger.info("batch completed", extra={
        "batch_id": batch.batch_id, "next_url": next_url,
        "walkback": walkback, "edge_records": len(edge_records)})


def walkback_step(sm, cfg: CrawlerConfig,
                  rng: Optional[random.Random] = None) -> bool:
    """One pass of the walkback processor; True if it took a batch."""
    batch, edges = sm.claim_walkback_batch()
    if batch is None:
        return False
    try:
        process_walkback_batch(sm, cfg, batch, edges, rng=rng)
    except Exception as e:
        logger.error("failed to process batch %s: %s", batch.batch_id, e)
    return True


class RunValidationLoop:
    """The validator pod: the edge-validation and walkback threads."""

    def __init__(self, sm, cfg: CrawlerConfig,
                 vcfg: Optional[ValidatorConfig] = None,
                 validate_fn: Optional[ValidateFunc] = None,
                 rate_limiter: Optional[ValidatorRateLimiter] = None,
                 rng: Optional[random.Random] = None):
        self.sm = sm
        self.cfg = cfg
        self.vcfg = vcfg or ValidatorConfig()
        if validate_fn is not None:
            self.validate_fn = validate_fn
        else:
            transport = make_transport(cfg.validator_transport or "urllib")
            base_url = cfg.validator_base_url or "https://t.me"
            self.validate_fn = (
                lambda username: validate_channel_http(
                    username, transport=transport, base_url=base_url))
        self.rate_limiter = rate_limiter or ValidatorRateLimiter(
            cfg.validator_request_rate or 6.0,
            cfg.validator_request_jitter_ms or 200)
        self.rng = rng or random.Random()
        self.blocked = BlockedState()
        self.stop_event = threading.Event()
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        logger.info("validator: starting validation loop", extra={
            "request_rate_per_min": self.cfg.validator_request_rate,
            "claim_batch_size": self.cfg.validator_claim_batch_size})

        def edge_loop():
            while not self.stop_event.is_set():
                n = edge_validation_step(self.sm, self.cfg, self.vcfg,
                                         self.rate_limiter, self.blocked,
                                         self.validate_fn, time.monotonic)
                if n == 0:
                    self.stop_event.wait(self.vcfg.edge_poll_interval_s)

        def walkback_loop():
            last_recovery = time.monotonic()
            while not self.stop_event.is_set():
                if time.monotonic() - last_recovery >= \
                        self.vcfg.stale_batch_recovery_interval_s:
                    last_recovery = time.monotonic()
                    try:
                        n = self.sm.recover_stale_batch_claims(
                            self.vcfg.stale_batch_recovery_threshold_s)
                        if n:
                            logger.info("recovered %d stale batch claims", n)
                    except Exception as e:
                        logger.warning("stale recovery failed: %s", e)
                if not walkback_step(self.sm, self.cfg, rng=self.rng):
                    self.stop_event.wait(self.vcfg.walkback_poll_interval_s)

        self._threads = [
            threading.Thread(target=edge_loop, name="dct-validator-edges",
                             daemon=True),
            threading.Thread(target=walkback_loop,
                             name="dct-validator-walkback", daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self.stop_event.set()
        for t in self._threads:
            t.join(timeout=timeout_s)

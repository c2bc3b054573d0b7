"""The 400-replacement: the port's copy of the reference's
`distributed_crawler_tpu/crawl/replacement.py`, which repairs a random
walk when a channel it stepped to turns out invalid (TDLib's 400).

1. Mark the channel invalid (the invalid channels and the seed pool).
2. Delete its edge record.
3. Replace it:
   - the edge was a walkback -> walk back again;
   - a forward edge -> promote a random skipped edge of the same chain and
     source;
   - no skipped edge, or no edge -> walk back; a seed channel instead gets
     a random seed.

The caller deletes the failed page from the page buffer.
"""

from __future__ import annotations

import logging
import random
from typing import Optional

from ..config.crawler import CrawlerConfig
from ..state.datamodels import EdgeRecord, Page, new_id, utcnow
from .runner import pick_walkback_channel

logger = logging.getLogger("dct.crawl.replace")


def handle_400_replacement(sm, page: Page, cfg: CrawlerConfig,
                           rng: Optional[random.Random] = None) -> None:
    channel = page.url
    sequence_id = page.sequence_id
    logger.error("TDLib 400 - marking invalid and finding replacement edge",
                 extra={"log_tag": "rw_channel", "channel": channel,
                        "sequence_id": sequence_id})

    try:
        sm.mark_channel_invalid(channel, "tdlib_400")
    except Exception as e:
        logger.warning("failed to mark channel invalid: %s", e)
    try:
        sm.mark_seed_channel_invalid(channel)
    except Exception as e:
        logger.warning("failed to mark seed channel invalid: %s", e)

    edge = sm.get_edge_record(sequence_id, channel)
    try:
        sm.delete_edge_record(sequence_id, channel)
    except Exception as e:
        logger.warning("failed to delete edge record: %s", e)

    if edge is None:
        if sm.is_seed_channel(channel):
            _seed_replacement(sm, page)
            return
        _walkback_replacement(sm, page, channel, sequence_id, rng)
        return

    if edge.walkback:
        _walkback_replacement(sm, page, edge.source_channel, sequence_id, rng)
        return

    # A forward edge: promote a random skipped sibling.
    skipped = sm.get_random_skipped_edge(sequence_id, edge.source_channel)
    if skipped is None:
        _walkback_replacement(sm, page, edge.source_channel, sequence_id, rng)
        return
    try:
        sm.promote_edge(sequence_id, skipped.destination_channel)
    except Exception as e:
        logger.warning("promote_edge failed: %s", e)
    sm.add_page_to_page_buffer(Page(
        id=new_id(), parent_id=page.parent_id, depth=page.depth,
        url=skipped.destination_channel, sequence_id=sequence_id,
        status="unfetched"))
    logger.info("replaced with skipped edge", extra={
        "failed_channel": channel,
        "replacement_channel": skipped.destination_channel,
        "sequence_id": sequence_id})


def _walkback_replacement(sm, page: Page, source_channel: str,
                          sequence_id: str,
                          rng: Optional[random.Random]) -> None:
    walkback_url = pick_walkback_channel(sm, source_channel,
                                         {page.url: True}, rng=rng)
    sm.add_page_to_page_buffer(Page(
        id=new_id(), parent_id=page.parent_id, depth=page.depth,
        url=walkback_url, sequence_id=new_id(),  # a walkback starts a chain
        status="unfetched"))
    sm.save_edge_records([EdgeRecord(
        destination_channel=walkback_url, source_channel=source_channel,
        walkback=True, skipped=False, discovery_time=utcnow(),
        sequence_id=sequence_id)])  # the edge belongs to the current chain
    logger.info("replaced with walkback", extra={
        "failed_channel": page.url, "walkback_channel": walkback_url,
        "sequence_id": sequence_id})


def _seed_replacement(sm, page: Page) -> None:
    """An invalid seed channel: a random seed, and no edge."""
    seed_url = sm.get_random_seed_channel()
    sm.add_page_to_page_buffer(Page(
        id=new_id(), parent_id=page.parent_id, depth=page.depth,
        url=seed_url, sequence_id=new_id(), status="unfetched"))
    logger.info("replaced invalid seed channel with random seed", extra={
        "failed_channel": page.url, "seed_channel": seed_url})

"""Paged history fetching with date windows and sampling: the port's copy
of the reference's `distributed_crawler_tpu/telegram/fetch.py`.

`fetch_channel_messages_with_sampling` walks 100-message pages newest to
oldest inside the min/max date window, stops early, detects a stalled
walk and samples by Fisher-Yates.  The reference's
``get_channel_member_count`` and ``get_message_comments`` are not ported:
nothing calls them.
"""

from __future__ import annotations

import logging
import random
from datetime import datetime
from typing import List, Optional

from ..clients.telegram import TelegramClient, TLMessage
from ..state.datamodels import Page

logger = logging.getLogger("dct.telegram.fetch")

PAGE_SIZE = 100  # messages per history page


def fetch_channel_messages_with_sampling(
        client: TelegramClient, chat_id: int, page: Page,
        min_post_date: Optional[datetime] = None,
        max_post_date: Optional[datetime] = None,
        max_posts: int = -1, sample_size: int = 0,
        rng: Optional[random.Random] = None) -> List[TLMessage]:
    """A channel's messages, newest first, inside the date window, at most
    ``max_posts`` of them, sampled down to ``sample_size`` when set."""
    all_messages: List[TLMessage] = []
    from_message_id = 0
    oldest_message_id = 0
    first_batch = True
    min_unix = int(min_post_date.timestamp()) if min_post_date else None
    max_unix = int(max_post_date.timestamp()) if max_post_date else None

    while True:
        history = client.get_chat_history(chat_id,
                                          from_message_id=from_message_id,
                                          limit=PAGE_SIZE)
        if not history.messages:
            break
        if first_batch:
            public_msg_id = history.messages[0].id // 1048576
            logger.info("estimated post count for channel", extra={
                "channel": page.url, "total_posts": public_msg_id})
            first_batch = False

        reached_old = False
        for msg in history.messages:
            if min_unix is not None and msg.date < min_unix:
                reached_old = True
                break
            if max_unix is not None and msg.date > max_unix:
                continue  # newer than the window: skip, keep walking older
            all_messages.append(msg)
            if 0 <= max_posts == len(all_messages):
                reached_old = True
                break
        if reached_old:
            break

        last_message_id = history.messages[-1].id
        if last_message_id == oldest_message_id:
            break  # stalled: same oldest message as the previous page
        oldest_message_id = last_message_id
        from_message_id = last_message_id

    logger.debug("fetched %d messages for %s", len(all_messages), page.url)

    # Fisher-Yates sample when requested.
    if 0 < sample_size < len(all_messages):
        rng = rng or random.Random()
        sampled = list(all_messages)
        rng.shuffle(sampled)
        sampled = sampled[:sample_size]
        logger.info("random sampling applied", extra={
            "channel": page.url, "original": len(all_messages),
            "sampled": len(sampled)})
        return sampled
    return all_messages

"""Channel info gathering: the port's copy of the reference's
`distributed_crawler_tpu/crawl/channelinfo.py`.

Resolve the chat, load its supergroup details, estimate the message
count from the newest public message id, fetch the message window and
sum the views.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import List, Optional, Tuple

from ..clients.errors import TelegramError
from ..clients.telegram import (
    TelegramClient,
    TLChat,
    TLMessage,
    TLSupergroup,
    TLSupergroupFullInfo,
)
from ..config.crawler import CrawlerConfig
from ..state.datamodels import Page
from ..telegram.fetch import fetch_channel_messages_with_sampling
from .errors import TDLib400Error, is_telegram_400

logger = logging.getLogger("dct.crawl.channelinfo")


@dataclass
class ChannelInfo:
    """Aggregated channel stats."""

    chat: TLChat
    chat_details: TLChat
    supergroup: Optional[TLSupergroup] = None
    supergroup_info: Optional[TLSupergroupFullInfo] = None
    member_count: int = 0
    message_count: int = 0
    total_views: int = 0


def get_channel_info(client: TelegramClient, page: Page,
                     cfg: CrawlerConfig) -> Tuple[ChannelInfo, List[TLMessage]]:
    """Resolve and profile a channel and fetch its message window.
    Raises TDLib400Error for permanently invalid channels.  (The
    reference's cached chat-id path is the random walk's, ROADMAP Queue 1
    part B.)"""
    try:
        chat = client.search_public_chat(page.url)
    except TelegramError as e:
        if is_telegram_400(e):
            raise TDLib400Error(str(e)) from e
        raise

    supergroup = None
    supergroup_info = None
    member_count = 0
    if chat.supergroup_id:
        try:
            supergroup = client.get_supergroup(chat.supergroup_id)
            member_count = supergroup.member_count
        except TelegramError as e:
            logger.debug("get_supergroup failed: %s", e)
        try:
            supergroup_info = client.get_supergroup_full_info(chat.supergroup_id)
            if supergroup_info.member_count:
                member_count = supergroup_info.member_count
        except TelegramError as e:
            logger.debug("get_supergroup_full_info failed: %s", e)

    min_date = cfg.min_post_date or cfg.date_between_min
    max_date = cfg.date_between_max
    messages = fetch_channel_messages_with_sampling(
        client, chat.id, page, min_post_date=min_date, max_post_date=max_date,
        max_posts=cfg.max_posts, sample_size=cfg.sample_size)

    # Estimate total channel posts from the newest public message ID.
    message_count = 0
    if messages:
        message_count = max(m.id for m in messages) // 1048576
    total_views = sum(m.view_count for m in messages)

    info = ChannelInfo(chat=chat, chat_details=chat, supergroup=supergroup,
                       supergroup_info=supergroup_info,
                       member_count=member_count,
                       message_count=message_count, total_views=total_views)
    return info, messages


def is_channel_active_within_period(client: TelegramClient, chat_id: int,
                                    post_recency: Optional[datetime]) -> bool:
    """The latest message's recency gate."""
    if post_recency is None:
        return True
    history = client.get_chat_history(chat_id, from_message_id=0, limit=1)
    if not history.messages:
        raise TDLib400Error("no messages found in the chat")
    latest = datetime.fromtimestamp(history.messages[0].date, tz=timezone.utc)
    return latest >= post_recency

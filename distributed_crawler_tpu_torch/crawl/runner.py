"""The channel crawl: the port's copy of the reference's
`distributed_crawler_tpu/crawl/runner.py` for channel and snowball
sampling.

- the process-wide connection-pool facade (`init_connection_pool`,
  `get_connection_from_pool`, `release_connection_to_pool`,
  `retire_connection_from_pool`, `shutdown_connection_pool`) and
  `run_for_channel_with_pool`, which retires a connection on a long
  FLOOD_WAIT and releases it otherwise;
- `run_for_channel`: the channel's info, its data validated, the activity
  and member gates, then `process_all_messages`;
- `process_all_messages`: each message parsed and stored with its failure
  contained, message statuses kept on the page, outlinks discovered as
  the next depth's pages;
- message dedup (`add_new_messages`) and `resample_marker`.

Each package keeps its own pool and its own `_run_for_channel_fn`, so a
process that runs both packages' runners installs a pool in each.

``sampling_method == "random-walk"`` is refused at the entry of
`run_for_channel` and `process_all_messages`: its branches (the walkback,
the tandem pending edges, the cached chat ids) read and write the SQL
graph store, which the port does not have yet (ROADMAP Queue 1 part B).
`setup_pool_from_config` builds its pool from the native client
(`clients/native.py`), which waits for ROADMAP Queue 1 part D: it keeps
the reference's no-op when a pool is installed or no URL is configured
and raises otherwise.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, List, Optional, Protocol

from ..clients.pool import ConnectionPool, PooledConnection, PoolEmptyError
from ..clients.telegram import TelegramClient, TLMessage
from ..config.crawler import CrawlerConfig
from ..datamodel import ChannelData, EngagementData, NullValidator
from ..state.datamodels import Message, Page, new_id
from ..telegram.parsing import parse_message
from .channelinfo import (
    ChannelInfo,
    get_channel_info,
    is_channel_active_within_period,
)
from .errors import FloodWaitRetireError, TDLib400Error, is_telegram_400

logger = logging.getLogger("dct.crawl")

# ---------------------------------------------------------------------------
# The process-wide connection pool
# ---------------------------------------------------------------------------

_pool: Optional[ConnectionPool] = None
_pool_lock = threading.Lock()
# Serializes setup_pool_from_config against concurrent entry paths.
_setup_lock = threading.Lock()


def _refuse_random_walk(cfg: CrawlerConfig) -> None:
    if cfg.sampling_method == "random-walk":
        raise NotImplementedError(
            "random-walk sampling needs the SQL graph store, which the port "
            "does not have yet (ROADMAP Queue 1 part B); run it from "
            "distributed_crawler_tpu")


def init_connection_pool(pool: ConnectionPool) -> None:
    """Install the process-wide pool (the first installer wins)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = pool


def setup_pool_from_config(cfg: CrawlerConfig) -> bool:
    """The production pool from config: one native connection per entry of
    ``tdlib_database_urls`` (or the single ``tdlib_database_url``), or
    wire connections to the DC gateway at ``dc_address``.

    Returns True when a pool is already installed (tests and embedders
    install their own) and False when no URL or address is configured,
    as the reference does; a configured URL or address raises, because
    both build clients from `clients/native.py`, which waits for ROADMAP
    Queue 1 part D."""
    with _setup_lock:
        with _pool_lock:
            if _pool is not None:
                return True
        urls = list(cfg.tdlib_database_urls) or (
            [cfg.tdlib_database_url] if cfg.tdlib_database_url else [])
        if not cfg.dc_address and not urls:
            return False
        source = (f"the DC gateway at {cfg.dc_address}" if cfg.dc_address
                  else f"{len(urls)} tdlib database url(s)")
        raise NotImplementedError(
            f"a connection pool from {source} needs the native Telegram "
            f"client (clients/native.py), which the port has not ported yet "
            f"(ROADMAP Queue 1 part D); install a pool of SimTelegramClients "
            f"with init_connection_pool")


def get_connection_from_pool(timeout_s: float = 30.0) -> PooledConnection:
    with _pool_lock:
        pool = _pool
    if pool is None:
        raise PoolEmptyError("connection pool not initialized")
    return pool.acquire(timeout_s=timeout_s)


def release_connection_to_pool(conn: PooledConnection) -> None:
    with _pool_lock:
        pool = _pool
    if pool is not None:
        pool.release(conn)


def retire_connection_from_pool(conn_id: str, reason: str = "") -> None:
    with _pool_lock:
        pool = _pool
    if pool is not None:
        pool.retire(conn_id, reason)


def shutdown_connection_pool() -> None:
    global _pool
    with _pool_lock:
        if _pool is not None:
            _pool.close_all()
            _pool = None


# ---------------------------------------------------------------------------
# Message bookkeeping
# ---------------------------------------------------------------------------

def add_new_messages(discovered: List[Message], owner: Page) -> List[Message]:
    """The page's messages plus the discovered ones that are new."""
    existing = {(m.chat_id, m.message_id) for m in owner.messages}
    new = [m for m in discovered if (m.chat_id, m.message_id) not in existing]
    return owner.messages + new


def resample_marker(messages: List[Message],
                    discovered: List[Message]) -> List[Message]:
    """Mark messages not yet fetched 'resample' if still present and
    'deleted' if gone; a 'fetched' message is never touched."""
    discovered_keys = {(m.chat_id, m.message_id) for m in discovered}
    for m in messages:
        if m.status == "fetched":
            continue
        if (m.chat_id, m.message_id) in discovered_keys:
            m.status = "resample"
        else:
            m.status = "deleted"
    return messages


# ---------------------------------------------------------------------------
# The message processor seam (tests override it)
# ---------------------------------------------------------------------------

class MessageProcessor(Protocol):
    def process_message(self, client: TelegramClient, message: TLMessage,
                        message_id: int, chat_id: int, info: ChannelInfo,
                        crawl_id: str, channel_username: str, sm,
                        cfg: CrawlerConfig) -> List[str]:
        """Returns the message's outlinks."""


class DefaultMessageProcessor:
    """Parses and stores the message; contains a failure per message."""

    def process_message(self, client, message, message_id, chat_id, info,
                        crawl_id, channel_username, sm, cfg) -> List[str]:
        try:
            post = parse_message(crawl_id, message, info.chat_details,
                                 info.supergroup, info.supergroup_info,
                                 info.message_count, info.total_views,
                                 channel_username, client, sm, cfg)
        except Exception as e:
            raise RuntimeError(
                f"failed to parse message {message_id}: {e}") from e
        if _null_validator(cfg).validate_post(post).valid:
            sm.store_post(channel_username, post)
        return post.outlinks


def _null_validator(cfg: CrawlerConfig) -> NullValidator:
    validator = getattr(cfg, "_null_validator_cache", None)
    if validator is None:
        if cfg.null_config:
            validator = NullValidator.from_json(cfg.null_config, "telegram")
        else:
            validator = NullValidator("telegram")
        object.__setattr__(cfg, "_null_validator_cache", validator)
    return validator


# ---------------------------------------------------------------------------
# The channel pipeline
# ---------------------------------------------------------------------------

def run_for_channel(client: TelegramClient, page: Page, storage_prefix: str,
                    sm, cfg: CrawlerConfig,
                    processor: Optional[MessageProcessor] = None
                    ) -> List[Page]:
    """Process one channel end to end; returns the discovered pages."""
    _refuse_random_walk(cfg)
    cfg = dataclasses.replace(cfg)  # never mutate the caller's config

    info, messages = get_channel_info(client, page, cfg)

    channel_data = ChannelData(
        channel_id=str(info.chat.id),
        channel_name=info.chat.title,
        channel_profile_image=info.chat.photo_remote_id,
        channel_engagement_data=EngagementData(
            follower_count=info.member_count,
            post_count=info.message_count,
            views_count=info.total_views,
        ),
        channel_url_external=f"https://t.me/{page.url}",
        channel_url=f"https://t.me/{page.url}",
    )
    validation = _null_validator(cfg).validate_channel_data(channel_data)
    if not validation.valid:
        raise ValueError(
            f"channel {page.url} is missing critical fields: "
            f"{validation.errors}")

    try:
        active = is_channel_active_within_period(client, info.chat_details.id,
                                                 cfg.post_recency)
    except Exception as e:
        if isinstance(e, TDLib400Error) or is_telegram_400(e):
            raise TDLib400Error(str(e)) from e
        raise

    too_small = cfg.min_users > 0 and info.member_count < cfg.min_users
    if not active or info.message_count == 0 or too_small:
        logger.info("channel inactive/small, marking deadend",
                    extra={"channel": page.url})
        page.status = "deadend"
        sm.update_page(page)
        sm.save_state()
        return []

    return process_all_messages(client, info, messages, cfg.crawl_id,
                                page.url, sm, page, cfg, processor=processor)


# The run_for_channel seam for tests.
_run_for_channel_fn: Callable = run_for_channel


def set_run_for_channel_fn(fn: Optional[Callable]) -> None:
    global _run_for_channel_fn
    _run_for_channel_fn = fn if fn is not None else run_for_channel


def run_for_channel_with_pool(page: Page, storage_prefix: str, sm,
                              cfg: CrawlerConfig,
                              processor: Optional[MessageProcessor] = None
                              ) -> List[Page]:
    """A channel run on a pooled connection: the connection is retired on
    FloodWaitRetireError and released otherwise."""
    conn = get_connection_from_pool()
    page.connection_id = conn.conn_id
    logger.info("started connection", extra={
        "log_tag": "rw_pool", "connection_id": conn.conn_id,
        "channel": page.url})
    retire = False
    try:
        return _run_for_channel_fn(conn.client, page, storage_prefix, sm, cfg,
                                   processor=processor)
    except FloodWaitRetireError:
        retire = True
        raise
    finally:
        if retire:
            retire_connection_from_pool(conn.conn_id, "flood_wait_retire")
        else:
            release_connection_to_pool(conn)


# ---------------------------------------------------------------------------
# The per-message loop
# ---------------------------------------------------------------------------

def process_all_messages(client: TelegramClient, info: ChannelInfo,
                         messages: List[TLMessage], crawl_id: str,
                         channel_username: str, sm, owner: Page,
                         cfg: CrawlerConfig,
                         processor: Optional[MessageProcessor] = None
                         ) -> List[Page]:
    """Process each message and discover the next depth's pages."""
    _refuse_random_walk(cfg)
    processor = processor or DefaultMessageProcessor()

    discovered_channels: List[Page] = []
    discovered_messages = [
        Message(chat_id=m.chat_id, message_id=m.id, status="unfetched",
                page_id=owner.id)
        for m in messages
    ]
    owner.messages = add_new_messages(discovered_messages, owner)
    pre_deleted = {(m.chat_id, m.message_id) for m in owner.messages
                   if m.status == "deleted"}
    owner.messages = resample_marker(owner.messages, discovered_messages)
    deleted = sum(1 for m in owner.messages if m.status == "deleted"
                  and (m.chat_id, m.message_id) not in pre_deleted)
    sm.update_page(owner)

    by_id = {m.id: m for m in messages}
    fetched = processed = failed = 0

    for message in list(owner.messages):
        if message.status in ("fetched", "deleted"):
            continue
        # Every surviving message is in the discovered set: resample_marker
        # just deleted the rest, and add_new_messages only adds discovered.
        disc = by_id[message.message_id]
        processed += 1
        try:
            outlinks = processor.process_message(
                client, disc, message.message_id, message.chat_id, info,
                crawl_id, channel_username, sm, cfg)
        except FloodWaitRetireError:
            raise
        except Exception as e:
            logger.error("error processing message", extra={
                "message_id": message.message_id, "error": str(e)})
            sm.update_message(owner.id, message.chat_id, message.message_id,
                              "failed")
            failed += 1
            continue
        sm.update_message(owner.id, message.chat_id, message.message_id,
                          "fetched")
        fetched += 1
        for o in outlinks or ():
            if o == owner.url:
                continue  # self-reference
            discovered_channels.append(Page(
                url=o, status="unfetched", parent_id=owner.id,
                id=new_id(), depth=owner.depth + 1))

    logger.info("message processing summary", extra={
        "messages_processed": processed, "messages_fetched": fetched,
        "messages_deleted": deleted, "messages_failed": failed,
        "discovered_channels": len(discovered_channels),
        "page_url": owner.url})

    owner.status = "fetched"
    sm.update_page(owner)
    return discovered_channels

"""The channel crawl and the random walk's step: the port's copy of the
reference's `distributed_crawler_tpu/crawl/runner.py` for channel,
snowball and random-walk sampling.

- the process-wide connection-pool facade (`init_connection_pool`,
  `get_connection_from_pool`, `release_connection_to_pool`,
  `retire_connection_from_pool`, `shutdown_connection_pool`) and
  `run_for_channel_with_pool`, which retires a connection on a long
  FLOOD_WAIT and releases it otherwise;
- `run_for_channel`: the channel's info (in a random walk from the cached
  chat id, and only the messages newer than the channel's last crawl),
  its data validated (and stored, in a random walk), the activity and
  member gates, then `process_all_messages`, and in a random walk the
  channel marked crawled;
- `process_all_messages`: each message parsed and stored with its failure
  contained (a random walk stores no posts), message statuses kept on the
  page, outlinks discovered as the next depth's pages or, in a random
  walk, looked up with ``SearchPublicChat`` (a short FLOOD_WAIT slept
  through, a long one retiring the connection; unknown names and chats
  that are not supergroups marked invalid) and followed by the walkback
  decision (`_walkback_decision`): forward to a random new channel, its
  siblings written as skipped edges, or back to a random discovered
  channel (`pick_walkback_channel`), the next page put in the page buffer;
- the tandem crawl (``tandem_crawl``): a random walk's outlinks that pass
  the username filter are streamed, without lookups, into one
  pending-edge batch per page, which `_finish_tandem` closes for the
  validator (`crawl/validator.py`), who owns the walkback decision; a
  page that found no edge walks back at once;
- message dedup (`add_new_messages`) and `resample_marker`.

Each package keeps its own pool and its own `_run_for_channel_fn`, so a
process that runs both packages' runners installs a pool in each.

Not ported: `setup_pool_from_config` builds its pool from the native
client (`clients/native.py`), which waits for ROADMAP Queue 1 part D: it
keeps the reference's no-op when a pool is installed or no URL is
configured and raises otherwise.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
from typing import Callable, Dict, List, Optional, Protocol, Set

from ..clients.errors import FLOOD_WAIT_RETIRE_THRESHOLD_S
from ..clients.pool import ConnectionPool, PooledConnection, PoolEmptyError
from ..clients.telegram import TelegramClient, TLMessage
from ..clients.username_filter import filter_username
from ..config.crawler import CrawlerConfig
from ..datamodel import ChannelData, EngagementData, NullValidator
from ..state.datamodels import (
    BATCH_OPEN,
    EdgeRecord,
    Message,
    Page,
    PendingEdge,
    PendingEdgeBatch,
    new_id,
    utcnow,
)
from ..telegram.parsing import extract_channel_links_with_source, parse_message
from .channelinfo import (
    ChannelInfo,
    get_channel_info,
    is_channel_active_within_period,
)
from .errors import (
    FloodWaitRetireError,
    TDLib400Error,
    WalkbackExhaustedError,
    is_telegram_400,
    parse_flood_wait_seconds,
)

logger = logging.getLogger("dct.crawl")

# Random draws before a walkback gives up (the reference's budget: with
# few valid candidates among the discovered set, 10 draws exhausted
# spuriously).
MAX_WALKBACK_ATTEMPTS = 25

# ---------------------------------------------------------------------------
# The process-wide connection pool
# ---------------------------------------------------------------------------

_pool: Optional[ConnectionPool] = None
_pool_lock = threading.Lock()
# Serializes setup_pool_from_config against concurrent entry paths.
_setup_lock = threading.Lock()


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


def pool_is_empty() -> bool:
    with _pool_lock:
        pool = _pool
    return pool is None or pool.empty()


def shutdown_connection_pool() -> None:
    global _pool
    with _pool_lock:
        if _pool is not None:
            _pool.close_all()
            _pool = None


# ---------------------------------------------------------------------------
# Walkback channel selection
# ---------------------------------------------------------------------------

def pick_walkback_channel(sm, source_url: str,
                          exclude: Optional[Dict[str, bool]] = None,
                          rng: Optional[random.Random] = None) -> str:
    """A random discovered channel that is neither the source nor
    excluded; raises WalkbackExhaustedError after MAX_WALKBACK_ATTEMPTS
    draws (the draws are the state manager's)."""
    exclude = exclude or {}
    for _ in range(MAX_WALKBACK_ATTEMPTS):
        try:
            url = sm.get_random_discovered_channel()
        except LookupError as e:
            raise WalkbackExhaustedError(
                f"no discovered channels to walk back to from {source_url}"
            ) from e
        if url == source_url or exclude.get(url):
            continue
        logger.info("selected walkback channel", extra={
            "log_tag": "rw_channel", "walkback_url": url,
            "source_channel": source_url})
        return url
    raise WalkbackExhaustedError(
        f"channel {source_url}: walkback attempts exhausted")


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
        valid = _null_validator(cfg).validate_post(post).valid
        if valid and cfg.sampling_method != "random-walk":
            # A random walk stores the channel's data, not its posts.
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
                    processor: Optional[MessageProcessor] = None,
                    rng: Optional[random.Random] = None) -> List[Page]:
    """Process one channel end to end; returns the discovered pages (none
    in a random walk, whose next page goes to the page buffer)."""
    cfg = dataclasses.replace(cfg)  # never mutate the caller's config

    cached_chat_id = 0
    if cfg.sampling_method == "random-walk":
        chat_id, ok = sm.get_cached_chat_id(page.url)
        if ok:
            cached_chat_id = chat_id
        # The incremental window: only messages newer than the last crawl.
        last_crawled = sm.get_channel_last_crawled(page.url)
        if last_crawled is not None and (
                cfg.min_post_date is None
                or last_crawled > cfg.min_post_date):
            logger.info("channel previously crawled, fetching only new "
                        "messages", extra={"log_tag": "rw_channel",
                                           "channel": page.url})
            cfg.min_post_date = last_crawled

    info, messages = get_channel_info(client, page, cached_chat_id, cfg)

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

    if cfg.sampling_method == "random-walk":
        sm.store_channel_data(page.url, channel_data)

    try:
        active = is_channel_active_within_period(client, info.chat_details.id,
                                                 cfg.post_recency)
    except Exception as e:
        if isinstance(e, TDLib400Error) or is_telegram_400(e):
            raise TDLib400Error(str(e)) from e
        raise

    too_small = (cfg.sampling_method != "random-walk" and cfg.min_users > 0
                 and info.member_count < cfg.min_users)
    if not active or info.message_count == 0 or too_small:
        logger.info("channel inactive/small, marking deadend",
                    extra={"channel": page.url})
        page.status = "deadend"
        sm.update_page(page)
        sm.save_state()
        return []

    discovered = process_all_messages(client, info, messages, cfg.crawl_id,
                                      page.url, sm, page, cfg,
                                      processor=processor, rng=rng)

    if cfg.sampling_method == "random-walk":
        sm.mark_channel_crawled(page.url, info.chat.id)
    return discovered


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
                         processor: Optional[MessageProcessor] = None,
                         rng: Optional[random.Random] = None,
                         sleep=None) -> List[Page]:
    """Process each message and discover the next depth's pages, or in a
    random walk the new channels and the walk's next page (in a tandem
    crawl, the page's pending-edge batch).  ``rng`` draws the walkback
    decision, ``sleep`` waits out a short FLOOD_WAIT."""
    import time as _time
    sleep = sleep or _time.sleep
    rng = rng or random.Random()
    processor = processor or DefaultMessageProcessor()

    discovered_channels: List[Page] = []
    discovered_edges: List[EdgeRecord] = []
    new_channels: Dict[str, bool] = {}
    lookup_stats = _LookupStats()

    # The tandem batch, created on the page's first edge.
    tandem_batch: Optional[PendingEdgeBatch] = None
    seen_in_batch: Set[str] = set()

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
        if not outlinks:
            continue

        # Source-type attribution for the lookup stats (random walk only).
        msg_source_map: Dict[str, str] = {}
        if cfg.sampling_method == "random-walk":
            for link in extract_channel_links_with_source(disc):
                msg_source_map[link.name] = link.source_type

        for o in outlinks:
            if o == owner.url:
                continue  # self-reference
            if cfg.sampling_method != "random-walk":
                discovered_channels.append(Page(
                    url=o, status="unfetched", parent_id=owner.id,
                    id=new_id(), depth=owner.depth + 1))
                continue

            # --- the random walk ---
            if sm.is_invalid_channel(o):
                continue

            if cfg.tandem_crawl:
                # Stream the edge to the pending-edge queue: no lookup and
                # no walkback decision here.
                src_type = msg_source_map.get(o, "unknown")
                if not filter_username(o).valid:
                    continue
                if o in seen_in_batch:
                    continue
                seen_in_batch.add(o)
                if tandem_batch is None:
                    tandem_batch = PendingEdgeBatch(
                        batch_id=new_id(), crawl_id=cfg.crawl_id,
                        source_channel=owner.url, source_page_id=owner.id,
                        source_depth=owner.depth,
                        sequence_id=owner.sequence_id, status=BATCH_OPEN)
                    sm.create_pending_batch(tandem_batch)
                    logger.info("created pending batch", extra={
                        "log_tag": "rw_channel",
                        "batch_id": tandem_batch.batch_id,
                        "source_channel": owner.url})
                try:
                    sm.insert_pending_edge(PendingEdge(
                        batch_id=tandem_batch.batch_id, crawl_id=cfg.crawl_id,
                        destination_channel=o, source_channel=owner.url,
                        sequence_id=owner.sequence_id,
                        discovery_time=utcnow(), source_type=src_type))
                except Exception as e:
                    logger.error("failed to insert pending edge",
                                 extra={"channel": o, "error": str(e)})
                continue

            # Otherwise validate through SearchPublicChat.
            if sm.is_discovered_channel(o):
                continue
            _, is_seed = sm.get_cached_chat_id(o)
            if is_seed:
                # A seed channel: discovered, but no edge.
                sm.add_discovered_channel(o)
                continue
            src_type = msg_source_map.get(o, "unknown")
            chat = None
            while True:
                try:
                    chat = client.search_public_chat(o)
                    break
                except Exception as search_err:
                    secs, is_flood = parse_flood_wait_seconds(search_err)
                    if is_flood:
                        if secs >= FLOOD_WAIT_RETIRE_THRESHOLD_S:
                            raise FloodWaitRetireError(secs) from search_err
                        logger.warning("FLOOD_WAIT on SearchPublicChat, "
                                       "sleeping and retrying", extra={
                                           "retry_after_secs": secs,
                                           "channel": o})
                        sleep(secs)
                        continue
                    lookup_stats.record(src_type, False)
                    sm.mark_channel_invalid(o, "not_found")
                    chat = None
                    break
            if chat is None:
                continue
            if chat.type != "supergroup":
                lookup_stats.record(src_type, False)
                sm.mark_channel_invalid(o, "not_supergroup")
                continue
            lookup_stats.record(src_type, True)
            sm.add_discovered_channel(o)
            new_channels[o] = True
            sm.upsert_seed_channel_chat_id(o, chat.id)

    if cfg.sampling_method == "random-walk" and lookup_stats.total > 0:
        lookup_stats.log(owner.url, "final")

    logger.info("message processing summary", extra={
        "messages_processed": processed, "messages_fetched": fetched,
        "messages_deleted": deleted, "messages_failed": failed,
        "discovered_channels": len(seen_in_batch) if cfg.tandem_crawl
        else len(discovered_channels),
        "page_url": owner.url})

    if cfg.sampling_method == "random-walk":
        if cfg.tandem_crawl:
            _finish_tandem(sm, owner, tandem_batch, rng)
        else:
            _walkback_decision(sm, owner, new_channels, discovered_edges,
                               cfg, rng)

    owner.status = "fetched"
    sm.update_page(owner)
    return discovered_channels


def _finish_tandem(sm, owner: Page, tandem_batch: Optional[PendingEdgeBatch],
                   rng: random.Random) -> None:
    """Close the page's batch (the validator then decides the walkback),
    or, when the page found no edge, walk back at once: the edge stays in
    this chain and the next page starts a new one."""
    if tandem_batch is not None:
        sm.close_pending_batch(tandem_batch.batch_id)
        logger.info("batch closed, validator will handle walkback", extra={
            "log_tag": "rw_channel", "batch_id": tandem_batch.batch_id})
        return
    walkback_url = pick_walkback_channel(sm, owner.url, rng=rng)
    page = Page(id=new_id(), parent_id=owner.id, depth=owner.depth + 1,
                url=walkback_url, sequence_id=new_id(), status="unfetched")
    edge = EdgeRecord(destination_channel=walkback_url,
                      source_channel=owner.url, walkback=True, skipped=False,
                      discovery_time=utcnow(), sequence_id=owner.sequence_id)
    sm.add_page_to_page_buffer(page)
    sm.save_edge_records([edge])


def _walkback_decision(sm, owner: Page, new_channels: Dict[str, bool],
                       discovered_edges: List[EdgeRecord], cfg: CrawlerConfig,
                       rng: random.Random) -> None:
    """Walk forward to a random new channel or back to a random discovered
    one, writing the primary and skipped edges: forward keeps the chain's
    ``sequence_id`` for the next page, a walkback starts a new one."""
    page = Page(status="unfetched", parent_id=owner.id, id=new_id(),
                depth=owner.depth + 1)
    primary = EdgeRecord(discovery_time=utcnow(), source_channel=owner.url,
                         skipped=False)

    walkback = not new_channels
    rnd = rng.randint(1, 100) if new_channels else -1
    logger.info("walkback decision data", extra={
        "log_tag": "rw_channel", "walkback_rate": cfg.walkback_rate,
        "random_num": rnd, "walkback": walkback,
        "new_channels": len(new_channels), "source_channel": owner.url})

    if walkback or cfg.walkback_rate >= rnd:
        primary.walkback = True
        walkback_url = pick_walkback_channel(sm, owner.url, new_channels,
                                             rng=rng)
        page.url = walkback_url
        primary.sequence_id = owner.sequence_id  # edge belongs to this chain
        page.sequence_id = new_id()  # the next crawl starts a new chain
    else:
        primary.walkback = False
        choices = sorted(new_channels)
        page.url = choices[rng.randrange(len(choices))]
        del new_channels[page.url]  # the rest become skipped edges
        primary.sequence_id = owner.sequence_id
        page.sequence_id = owner.sequence_id

    primary.destination_channel = page.url
    discovered_edges.append(primary)
    sm.add_page_to_page_buffer(page)

    for channel in new_channels:
        discovered_edges.append(EdgeRecord(
            destination_channel=channel, discovery_time=utcnow(),
            skipped=True, source_channel=owner.url, walkback=False,
            sequence_id=owner.sequence_id))
    sm.save_edge_records(discovered_edges)


class _LookupStats:
    """SearchPublicChat hits and misses by source type."""

    def __init__(self):
        self.total = 0
        self.by_type: Dict[str, List[int]] = {}

    def record(self, source_type: str, hit: bool) -> None:
        self.total += 1
        entry = self.by_type.setdefault(source_type, [0, 0])
        entry[0 if hit else 1] += 1
        if self.total % 100 == 0:
            self.log("", "periodic")

    def log(self, channel: str, kind: str) -> None:
        logger.info("lookup stats", extra={
            "log_tag": "rw_lookup_stats", "channel": channel, "kind": kind,
            "total": self.total,
            "by_type": {k: {"hits": v[0], "misses": v[1]}
                        for k, v in self.by_type.items()}})

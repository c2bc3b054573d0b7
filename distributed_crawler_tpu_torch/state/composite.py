"""The composite state manager: the local page state, the URL cache that
spans a crawl's previous executions, and the SQL graph store.

The reference's `CompositeStateManager` (`distributed_crawler_tpu/state/
composite.py`):

- page/layer/metadata persistence, posts and the media cache through
  `LocalStateManager`;
- the URL cache: `initialize` hydrates it from the ``state.json`` of every
  previous crawl named in this crawl's metadata and skips seed URLs already
  processed there (but in a random walk); `add_layer` and `seen_url` keep
  it current;
- the random-walk graph and the tandem queue in `SqlGraphStore`, on
  ``config.sql.url`` when set and otherwise a SQLite file
  ``<storage_root>/graph.db`` (``:memory:`` without a storage root): the
  discovered channels are a claim registry across crawls, so the graph
  outlives the process;
- in-memory caches: seed-channel chat ids, seed membership, invalid
  channels.

Every graph method of the reference delegates to the store, the tandem
queue's too: its producer is the tandem crawl (`crawl/runner.
_finish_tandem`), its consumer the validator (`crawl/validator.py`).
"""

from __future__ import annotations

import logging
import os
import threading
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

from ..datamodel.post import ChannelData
from .datamodels import (
    EdgeRecord,
    Page,
    PendingEdge,
    PendingEdgeBatch,
    PendingEdgeUpdate,
    State,
    new_id,
)
from .interface import StateConfig
from .local import LocalStateManager
from .sqlstore import SqlGraphStore, SqliteBinding

logger = logging.getLogger("dct.state.composite")


class CompositeStateManager(LocalStateManager):
    """Full state manager: LocalStateManager persistence + SQL graph store."""

    def __init__(self, config: StateConfig,
                 graph: Optional[SqlGraphStore] = None):
        super().__init__(config)
        if graph is None:
            url = config.sql.url if config.sql else ""
            if not url:
                # The graph must survive the process: discovered_channels is a
                # cross-crawl exactly-once claim registry (sql/schema.sql).
                url = (os.path.join(config.storage_root, "graph.db")
                       if config.storage_root else ":memory:")
            graph = SqlGraphStore(SqliteBinding(url), config.crawl_id)
            graph.ensure_schema()
        self.graph = graph
        self._cache_lock = threading.RLock()
        # username -> chat ID (`daprstate.go` seed chat-ID cache)
        self._chat_id_cache: Dict[str, int] = {}
        self._seed_channels: set = set()
        self._invalid_channels: set = set()
        # URL -> crawl_id where first seen (dedup across crawls)
        self._url_cache: Dict[str, str] = {}

    # --- resume + URL cache ----------------------------------------------
    def _hydrate_url_cache(self) -> None:
        """Load URLs processed by previous crawl executions
        (`daprstate.go:550-624,2700`)."""
        with self._cache_lock:
            meta = self.provider.load_json(self._metadata_path())
            for prev_id in (meta or {}).get("previousCrawlId") or []:
                prev_state = self.provider.load_json(f"{prev_id}/state.json")
                if not prev_state:
                    continue
                for layer in prev_state.get("layers") or []:
                    for p in layer.get("pages") or []:
                        if p.get("url"):
                            self._url_cache.setdefault(p["url"], prev_id)

    def initialize(self, seed_urls: List[str]) -> None:
        """Resume persisted state, skipping seed URLs a previous crawl already
        processed (`daprstate.go:487-500`), and hydrate the cross-crawl URL
        cache."""
        self._hydrate_url_cache()
        if self.config.sampling_method != "random-walk":
            skipped = [u for u in seed_urls if self.seen_url(u)]
            if skipped:
                logger.info("skipping %d seed URLs already processed in "
                            "previous crawls", len(skipped))
            seed_urls = [u for u in seed_urls if u not in set(skipped)]
        super().initialize(seed_urls)
        with self._cache_lock:
            for page in self.page_map.values():
                self._url_cache.setdefault(page.url, self.config.crawl_id)

    def add_layer(self, pages: List[Page]) -> None:
        super().add_layer(pages)
        with self._cache_lock:
            for page in pages:
                if page.url:
                    self._url_cache.setdefault(page.url, self.config.crawl_id)

    def seen_url(self, url: str) -> bool:
        with self._cache_lock:
            return url in self._url_cache

    # --- seed channels ----------------------------------------------------
    def load_seed_channels(self) -> None:
        """Hydrate discovered set + chat-ID cache from seed_channels
        (`state/interface.go:80-82`)."""
        rows = self.graph.load_seed_channels()
        with self._cache_lock:
            for username, chat_id in rows:
                self._seed_channels.add(username)
                if chat_id:
                    self._chat_id_cache[username] = int(chat_id)
                self.discovered_channels.add(username)
        logger.info("loaded %d seed channels", len(rows),
                    extra={"log_tag": "rw_pool"})

    def upsert_seed_channel_chat_id(self, username: str, chat_id: int) -> None:
        with self._cache_lock:
            self._chat_id_cache[username] = chat_id
        self.graph.upsert_seed_channel_chat_id(username, chat_id)

    def get_cached_chat_id(self, username: str) -> Tuple[int, bool]:
        with self._cache_lock:
            chat_id = self._chat_id_cache.get(username)
            return (chat_id, True) if chat_id is not None else (0, False)

    def is_seed_channel(self, username: str) -> bool:
        with self._cache_lock:
            return username in self._seed_channels

    def get_channel_last_crawled(self, username: str) -> Optional[datetime]:
        return self.graph.get_channel_last_crawled(username)

    def mark_channel_crawled(self, username: str, chat_id: int) -> None:
        with self._cache_lock:
            if chat_id:
                self._chat_id_cache[username] = chat_id
        self.graph.mark_channel_crawled(username, chat_id)

    def mark_seed_channel_invalid(self, username: str) -> None:
        self.graph.mark_seed_channel_invalid(username)

    def get_random_seed_channel(self) -> str:
        username = self.graph.get_random_seed_channel()
        if username is None:
            raise LookupError("no seed channels available")
        return username

    # --- invalid channels -------------------------------------------------
    def load_invalid_channels(self) -> None:
        rows = self.graph.load_invalid_channels()
        with self._cache_lock:
            self._invalid_channels.update(rows)
        logger.info("loaded %d invalid channels", len(rows),
                    extra={"log_tag": "rw_pool"})

    def is_invalid_channel(self, username: str) -> bool:
        with self._cache_lock:
            return username in self._invalid_channels

    def mark_channel_invalid(self, username: str, reason: str) -> None:
        with self._cache_lock:
            self._invalid_channels.add(username)
        self.graph.mark_channel_invalid(username, reason)

    # --- discovered channels ---------------------------------------------
    def initialize_discovered_channels(self) -> None:
        """Hydrate the in-memory set from discovered_channels
        (`state/interface.go:91-93`)."""
        for username in self.graph.load_discovered_channels():
            self.discovered_channels.add(username)

    def add_discovered_channel(self, channel_id: str) -> None:
        self.discovered_channels.add(channel_id)
        self.graph.add_discovered_channel(channel_id, self.config.crawl_id)

    def claim_discovered_channel(self, username: str, crawl_id: str) -> bool:
        won = self.graph.claim_discovered_channel(username, crawl_id)
        if won:
            self.discovered_channels.add(username)
        return won

    def is_channel_discovered(self, username: str) -> bool:
        if self.discovered_channels.contains(username):
            return True
        return self.graph.is_channel_discovered(username)

    def _random_walk_pick(self) -> str:
        # Random-walk layers draw from the persistent seed pool, not the
        # in-memory discovered set (`daprstate.go` GetRandomSeedChannel).
        return self.get_random_seed_channel()

    def store_channel_data(self, channel_id: str, channel_data: ChannelData) -> None:
        """Persist channel metadata JSON next to the channel's posts
        (`daprstate.go` StoreChannelData analog)."""
        self.provider.save_json(
            f"{self.config.crawl_id}/{channel_id}/channel.json",
            channel_data.to_dict())

    # --- random-walk graph delegation -------------------------------------
    def save_edge_records(self, edges: List[EdgeRecord]) -> None:
        self.graph.save_edge_records(edges)

    def get_pages_from_page_buffer(self, limit: int) -> List[Page]:
        return self.graph.get_pages_from_page_buffer(limit)

    def execute_database_operation(self, sql_query: str, params: List[Any]) -> None:
        self.graph.execute(sql_query, params or [])

    def add_page_to_page_buffer(self, page: Page) -> None:
        if not page.id:
            page.id = new_id()
        self.graph.add_page_to_page_buffer(page)

    def delete_page_buffer_pages(self, page_ids: List[str],
                                 page_urls: List[str]) -> None:
        self.graph.delete_page_buffer_pages(page_ids, page_urls)

    # --- tandem validator delegation ---------------------------------------
    def create_pending_batch(self, batch: PendingEdgeBatch) -> None:
        self.graph.create_pending_batch(batch)

    def insert_pending_edge(self, edge: PendingEdge) -> None:
        self.graph.insert_pending_edge(edge)

    def close_pending_batch(self, batch_id: str) -> None:
        self.graph.close_pending_batch(batch_id)

    def claim_pending_edges(self, limit: int) -> List[PendingEdge]:
        return self.graph.claim_pending_edges(limit)

    def update_pending_edge(self, update: PendingEdgeUpdate) -> None:
        self.graph.update_pending_edge(update)

    def claim_walkback_batch(self) -> Tuple[Optional[PendingEdgeBatch],
                                            List[PendingEdge]]:
        return self.graph.claim_walkback_batch()

    def complete_pending_batch(self, batch_id: str) -> None:
        self.graph.complete_pending_batch(batch_id)

    def recover_stale_batch_claims(self, stale_threshold_s: float) -> int:
        return self.graph.recover_stale_batch_claims(stale_threshold_s)

    def recover_stale_edge_claims(self, stale_threshold_s: float) -> int:
        return self.graph.recover_stale_edge_claims(stale_threshold_s)

    def recover_orphan_edges(self) -> int:
        return self.graph.recover_orphan_edges()

    def flush_batch_stats(self, batch_id: str, crawl_id: str,
                          edges: List[PendingEdge]) -> None:
        self.graph.flush_batch_stats(batch_id, crawl_id, edges)

    def count_incomplete_batches(self, crawl_id: str) -> int:
        return self.graph.count_incomplete_batches(crawl_id)

    def insert_access_event(self, reason: str) -> None:
        self.graph.insert_access_event(reason)

    # --- edge repair -------------------------------------------------------
    def get_edge_record(self, sequence_id: str,
                        destination_channel: str) -> Optional[EdgeRecord]:
        return self.graph.get_edge_record(sequence_id, destination_channel)

    def delete_edge_record(self, sequence_id: str, destination_channel: str) -> None:
        self.graph.delete_edge_record(sequence_id, destination_channel)

    def get_random_skipped_edge(self, sequence_id: str,
                                source_channel: str) -> Optional[EdgeRecord]:
        return self.graph.get_random_skipped_edge(sequence_id, source_channel)

    def promote_edge(self, sequence_id: str, destination_channel: str) -> None:
        self.graph.promote_edge(sequence_id, destination_channel)

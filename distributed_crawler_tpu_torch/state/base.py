"""In-memory page state shared by the state managers.

The reference's `BaseStateManager` (`distributed_crawler_tpu/state/
base.py`), for what the orchestrator drives: a layer map + page map
behind a lock, URL dedup and the max-pages deadend-replacement rule in
`add_layer`, crawl metadata and incomplete-crawl detection, and what the
channel crawl calls: `update_message` and the processed-media set, which
remembers nothing here (the reference's `LocalStateManager` backs it with
a media cache, `state/media_cache.py`, ROADMAP Queue 1 part B).  The random-walk and tandem methods, the random-walk seeding of
`initialize` and the combined-file upload need the SQL graph store or the
crawl modes and are not ported (ROADMAP Queue 1 parts B and C).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from datetime import datetime
from typing import Any, Dict, List, Tuple

from ..datamodel.post import parse_time
from .datamodels import (
    PAGE_DEADEND,
    PAGE_FETCHED,
    CrawlMetadata,
    Layer,
    Message,
    Page,
    State,
    new_id,
    utcnow,
)
from .interface import StateConfig

logger = logging.getLogger("dct.state")


class BaseStateManager:
    """Pages by depth and by id, in memory; persistence is the
    subclass's."""

    def __init__(self, config: StateConfig):
        self.config = config
        self._lock = threading.RLock()
        self.metadata = CrawlMetadata(
            crawl_id=config.crawl_id,
            execution_id=config.crawl_execution_id,
            start_time=utcnow(),
            status="running",
            platform=config.platform,
        )
        self.last_updated = utcnow()
        self.layer_map: Dict[int, List[str]] = {}   # depth -> [page ids]
        self.page_map: Dict[str, Page] = {}         # page id -> Page

    # --- lifecycle -------------------------------------------------------
    def initialize(self, seed_urls: List[str]) -> None:
        """Create the depth-0 layer from the seeds."""
        with self._lock:
            self.layer_map.setdefault(0, [])
            for url in seed_urls:
                page = Page(id=new_id(), url=url, depth=0, timestamp=utcnow(),
                            platform=self.config.platform)
                self.page_map[page.id] = page
                self.layer_map[0].append(page.id)
        logger.info("initialized state with %d seed URLs", len(seed_urls))

    def save_state(self) -> None:
        return None  # persistence is backend-specific

    def close(self) -> None:
        return None

    # --- pages -----------------------------------------------------------
    def get_page(self, page_id: str) -> Page:
        with self._lock:
            page = self.page_map.get(page_id)
            if page is None:
                raise KeyError(f"page with ID {page_id} not found")
            return page

    def update_page(self, page: Page) -> None:
        with self._lock:
            self.page_map[page.id] = page
            ids = self.layer_map.get(page.depth)
            if ids is not None and page.id not in ids:
                ids.append(page.id)

    def update_message(self, page_id: str, chat_id: int, message_id: int,
                       status: str) -> None:
        """Set a message's status, appending it if new."""
        with self._lock:
            page = self.page_map.get(page_id)
            if page is None:
                raise KeyError(f"page with ID {page_id} not found")
            for m in page.messages:
                if m.chat_id == chat_id and m.message_id == message_id:
                    m.status = status
                    return
            page.messages.append(Message(chat_id=chat_id,
                                         message_id=message_id,
                                         status=status, page_id=page_id))

    # --- layers ----------------------------------------------------------
    def add_layer(self, pages: List[Page]) -> None:
        """Add pages at one depth, skipping URLs already held; past
        ``max_pages`` only as many pages as there are deadend pages to
        replace are added."""
        if not pages:
            return
        with self._lock:
            total_existing = len(self.page_map)
            deadend_count = sum(1 for p in self.page_map.values()
                                if p.status == PAGE_DEADEND)
            max_pages = self.config.max_pages
            max_reached = max_pages > 0 and total_existing >= max_pages
            if max_reached:
                logger.info(
                    "maximum page limit reached (%d/%d), only adding "
                    "replacements for %d deadend pages", total_existing,
                    max_pages, deadend_count)
            existing_urls = {p.url: pid for pid, p in self.page_map.items()}
            depth = pages[0].depth
            self.layer_map.setdefault(depth, [])
            replacements_available = deadend_count
            added = 0
            for page in pages:
                if page.url in existing_urls:
                    continue
                if max_reached:
                    if replacements_available <= 0:
                        continue
                    replacements_available -= 1
                if not page.id:
                    page.id = new_id()
                if page.timestamp is None:
                    page.timestamp = utcnow()
                self.page_map[page.id] = page
                existing_urls[page.url] = page.id
                self.layer_map[depth].append(page.id)
                added += 1
            logger.debug("added %d unique pages to depth %d (filtered %d "
                         "duplicates)", added, depth, len(pages) - added)

    def get_layer_by_depth(self, depth: int) -> List[Page]:
        with self._lock:
            ids = self.layer_map.get(depth, [])
            return [self.page_map[i] for i in ids if i in self.page_map]

    def get_max_depth(self) -> int:
        with self._lock:
            if not self.layer_map:
                raise LookupError("no layers found")
            return max(self.layer_map)

    # --- state snapshot --------------------------------------------------
    def get_state(self) -> State:
        """A consistent snapshot with copied pages, so serialization
        outside the lock cannot see a page mutated mid-write."""
        with self._lock:
            def copy_page(p: Page) -> Page:
                return dataclasses.replace(
                    p, messages=[dataclasses.replace(m) for m in p.messages])

            layers = [
                Layer(depth=d, pages=[copy_page(self.page_map[i])
                                      for i in ids if i in self.page_map])
                for d, ids in sorted(self.layer_map.items())
            ]
            return State(layers=layers,
                         metadata=dataclasses.replace(
                             self.metadata,
                             previous_crawl_id=list(
                                 self.metadata.previous_crawl_id),
                             target_channels=list(
                                 self.metadata.target_channels)),
                         last_updated=self.last_updated)

    def set_state(self, state: State) -> None:
        """Replace the in-memory state."""
        with self._lock:
            self.metadata = state.metadata
            self.last_updated = utcnow()
            self.layer_map = {}
            self.page_map = {}
            for layer in state.layers:
                self.layer_map[layer.depth] = []
                for page in layer.pages:
                    self.page_map[page.id] = page
                    self.layer_map[layer.depth].append(page.id)

    # --- crawl management ------------------------------------------------
    def update_crawl_metadata(self, crawl_id: str,
                              metadata: Dict[str, Any]) -> None:
        """Fold the keys the reference folds (``status``, ``endTime``,
        ``previousCrawlID``, ``messagesCount``, ``errorsCount``); others
        are ignored, as there."""
        with self._lock:
            if self.metadata.crawl_id != crawl_id:
                raise ValueError(
                    "cannot update metadata for a different crawl ID")
            for key, value in metadata.items():
                if key == "status" and isinstance(value, str):
                    self.metadata.status = value
                elif key == "endTime":
                    if isinstance(value, datetime):
                        self.metadata.end_time = value
                    elif isinstance(value, str):
                        self.metadata.end_time = parse_time(value)
                elif key == "previousCrawlID":
                    if isinstance(value, str):
                        self.metadata.previous_crawl_id.append(value)
                    elif isinstance(value, list):
                        self.metadata.previous_crawl_id.extend(value)
                elif key == "messagesCount" and isinstance(value, int):
                    self.metadata.messages_count = value
                elif key == "errorsCount" and isinstance(value, int):
                    self.metadata.errors_count = value
            self.last_updated = utcnow()

    def find_incomplete_crawl(self, crawl_id: str) -> Tuple[str, bool]:
        """Incomplete if the status is not ``completed`` or any page is
        not fetched; returns (execution id, found)."""
        with self._lock:
            if self.metadata.crawl_id == crawl_id:
                if self.metadata.status != "completed" \
                        and self.metadata.execution_id:
                    return self.metadata.execution_id, True
                for ids in self.layer_map.values():
                    for pid in ids:
                        page = self.page_map.get(pid)
                        if page is not None and page.status != PAGE_FETCHED:
                            return self.metadata.execution_id, True
            return "", False

    # --- the processed-media set -----------------------------------------
    def has_processed_media(self, media_id: str) -> bool:
        return False

    def mark_media_as_processed(self, media_id: str) -> None:
        return None

"""Local-filesystem state manager: the crawl's page state and post sink.

The reference's `LocalStateManager` (`distributed_crawler_tpu/state/
local.py`), with its layout under the storage root:

- ``<crawl_id>/state.json`` and ``<crawl_id>/metadata.json``: the page
  state and crawl metadata, byte-equal to the reference's, so each
  package resumes the other's files;
- ``<crawl_id>/<channel>/posts/posts.jsonl``: `store_post` appends
  `Post.to_json()` (the transcript re-entry's sink);
- ``<crawl_id>/media-cache-index.json`` and its shards: the processed-media
  set (`state/media_cache.ShardedMediaCache`), written only once it was
  read or marked.

`initialize` resumes a persisted ``state.json`` that has layers and seeds
a fresh one otherwise; `close` saves the state only if `initialize` ran,
so a post sink that never initialized writes no ``state.json``.  It always
writes through a `LocalStorageProvider` on the storage root, also when
``--object-store`` sends the workers' results elsewhere, as the
reference's does (`LocalConfig(base_path=storage_root)`).

The page buffer and raw SQL need a SQL-backed manager
(`state/composite.py`) and raise here, as the reference's do.
`export_pages_to_binding` writes the crawl's pages to
``<crawl_id>/exports/pages-export-<stamp>.jsonl`` (`modes/runner.launch`
calls it at the end).  Not ported: media files (`store_file`), whose
callers are the crawl modes (ROADMAP Queue 1 part C).
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple

from ..datamodel.post import Post
from .base import BaseStateManager
from .datamodels import Page, State, utcnow
from .interface import StateConfig
from .media_cache import ShardedMediaCache
from .providers import LocalStorageProvider


class LocalStateManager(BaseStateManager):
    """Filesystem-backed page state and post sink."""

    def __init__(self, config: StateConfig):
        super().__init__(config)
        base_path = (config.local.base_path if config.local else None) \
            or config.storage_root
        self.provider = LocalStorageProvider(base_path)
        self.media_cache = ShardedMediaCache(self.provider, config.crawl_id)
        self.crawl_id = config.crawl_id
        self._initialized = False

    # --- paths -------------------------------------------------------------
    def _state_path(self) -> str:
        return f"{self.config.crawl_id}/state.json"

    def _metadata_path(self, crawl_id: Optional[str] = None) -> str:
        return f"{crawl_id or self.config.crawl_id}/metadata.json"

    # --- lifecycle -----------------------------------------------------------
    def initialize(self, seed_urls: List[str]) -> None:
        """Load the persisted state if it has layers, else seed a fresh
        one and save it (an empty ``state.json`` is not a crawl)."""
        self._initialized = True
        existing = self.provider.load_json(self._state_path())
        if existing and existing.get("layers"):
            self.set_state(State.from_dict(existing))
            return
        super().initialize(seed_urls)
        self.save_state()

    def save_state(self) -> None:
        """Persist ``state.json`` and ``metadata.json``."""
        state = self.get_state()
        self.provider.save_json(self._state_path(), state.to_dict())
        self.provider.save_json(self._metadata_path(),
                                self.metadata.to_dict())
        self.media_cache.save()

    def close(self) -> None:
        if self._initialized:
            self.save_state()
        self.provider.flush()

    # --- posts ---------------------------------------------------------------
    def store_post(self, channel_id: str, post: Post) -> None:
        rel = f"{self.config.crawl_id}/{channel_id}/posts/posts.jsonl"
        self.provider.append_jsonl(rel, post.to_json())

    def export_pages_to_binding(self, crawl_id: str) -> None:
        """Append every page of the state to a pages-export JSONL."""
        state = self.get_state()
        stamp = utcnow().strftime("%Y%m%d%H%M%S")
        rel = f"{crawl_id}/exports/pages-export-{stamp}.jsonl"
        for layer in state.layers:
            for page in layer.pages:
                self.provider.append_jsonl(rel, json.dumps(page.to_dict()))

    # --- the media cache ------------------------------------------------------
    def has_processed_media(self, media_id: str) -> bool:
        return self.media_cache.has(media_id)

    def mark_media_as_processed(self, media_id: str) -> None:
        self.media_cache.mark(media_id, platform=self.config.platform)

    # --- resume --------------------------------------------------------------
    def find_incomplete_crawl(self, crawl_id: str) -> Tuple[str, bool]:
        """Also read the persisted metadata of this crawl and of the
        previous executions it names."""
        exec_id, found = super().find_incomplete_crawl(crawl_id)
        if found:
            return exec_id, True
        meta = self.provider.load_json(self._metadata_path(crawl_id))
        if meta:
            if meta.get("status") != "completed" and meta.get("executionId"):
                return meta["executionId"], True
            for prev_id in meta.get("previousCrawlId") or []:
                prev = self.provider.load_json(self._metadata_path(prev_id))
                if prev and prev.get("status") != "completed" \
                        and prev.get("executionId"):
                    return prev["executionId"], True
        return "", False

    # --- random-walk (not supported on plain local storage) ------------------
    def get_pages_from_page_buffer(self, limit: int) -> List[Page]:
        raise NotImplementedError(
            "page buffer requires a SQL-backed state manager")

    def execute_database_operation(self, sql_query: str,
                                   params: List[Any]) -> None:
        raise NotImplementedError(
            "database operations require a SQL-backed state manager")

    def add_page_to_page_buffer(self, page: Page) -> None:
        raise NotImplementedError(
            "page buffer requires a SQL-backed state manager")

    def delete_page_buffer_pages(self, page_ids: List[str],
                                 page_urls: List[str]) -> None:
        raise NotImplementedError(
            "page buffer requires a SQL-backed state manager")

"""Local-filesystem state manager: the crawl's page state and post sink.

The reference's `LocalStateManager` (`distributed_crawler_tpu/state/
local.py`), with its layout under the storage root:

- ``<crawl_id>/state.json`` and ``<crawl_id>/metadata.json``: the page
  state and crawl metadata, byte-equal to the reference's, so each
  package resumes the other's files;
- ``<crawl_id>/<channel>/posts/posts.jsonl``: `store_post` appends
  `Post.to_json()` (the transcript re-entry's sink).

`initialize` resumes a persisted ``state.json`` that has layers and seeds
a fresh one otherwise; `close` saves the state only if `initialize` ran,
so a post sink that never initialized writes no ``state.json``.  It always
writes through a `LocalStorageProvider` on the storage root, also when
``--object-store`` sends the workers' results elsewhere, as the
reference's does (`LocalConfig(base_path=storage_root)`).

Not ported: the media cache (``media-cache.json``), media files and page
exports belong to the crawler's half; the reference's manager writes no
media cache unless one was read or marked.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..datamodel.post import Post
from .base import BaseStateManager
from .datamodels import State
from .interface import StateConfig
from .providers import LocalStorageProvider


class LocalStateManager(BaseStateManager):
    """Filesystem-backed page state and post sink."""

    def __init__(self, config: StateConfig):
        super().__init__(config)
        base_path = (config.local.base_path if config.local else None) \
            or config.storage_root
        self.provider = LocalStorageProvider(base_path)
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

    def close(self) -> None:
        if self._initialized:
            self.save_state()
        self.provider.flush()

    # --- posts ---------------------------------------------------------------
    def store_post(self, channel_id: str, post: Post) -> None:
        rel = f"{self.config.crawl_id}/{channel_id}/posts/posts.jsonl"
        self.provider.append_jsonl(rel, post.to_json())

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

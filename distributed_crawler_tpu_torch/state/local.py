"""The crawl's post sink on the local filesystem: what the transcript
re-entry writes its synthetic posts through.

The part of the reference's `LocalStateManager`
(`distributed_crawler_tpu/state/local.py`) that the ASR worker's re-entry
reaches: `store_post` appends `Post.to_json()` to
``<crawl_id>/<channel_id>/posts/posts.jsonl`` under the storage root, and
`close` flushes the provider.  The reference's manager on this path never
initializes, so its `close` writes no ``state.json``; neither does this
one.  It always writes through a `LocalStorageProvider` on the storage
root, also when ``--object-store`` sends the workers' results elsewhere:
the reference builds its manager from `LocalConfig(base_path=
storage_root)` (`modes/common.py:22-43`, `state/local.py:33-40`).

Not ported (ROADMAP Queue 3): the reference's factory returns a
`CompositeStateManager`, whose SQL graph store creates
``<storage_root>/graph.sqlite`` and which holds the crawl's page state and
media cache.  The re-entry reads and writes none of them; the random-walk
graph belongs to the crawler's half.
"""

from __future__ import annotations

from ..config.crawler import CrawlerConfig
from ..datamodel.post import Post
from .providers import LocalStorageProvider


class LocalStateManager:
    """Posts appended per channel under ``<storage_root>/<crawl_id>``."""

    def __init__(self, storage_root: str, crawl_id: str):
        self.crawl_id = crawl_id
        self.provider = LocalStorageProvider(storage_root)

    def store_post(self, channel_id: str, post: Post) -> None:
        rel = f"{self.crawl_id}/{channel_id}/posts/posts.jsonl"
        self.provider.append_jsonl(rel, post.to_json())

    def close(self) -> None:
        self.provider.flush()


def create_state_manager(cfg: CrawlerConfig) -> LocalStateManager:
    """The crawl's post sink for ``cfg`` (the counterpart of the
    reference's `modes/common.create_state_manager`, whose execution-id
    argument only the crawl's page state reads)."""
    return LocalStateManager(cfg.storage_root, cfg.crawl_id)

"""The composite state manager: the local page state plus the URL cache
that spans a crawl's previous executions.

The reference's `CompositeStateManager` (`distributed_crawler_tpu/state/
composite.py`) for what the orchestrator uses: `initialize` hydrates the
cache from the ``state.json`` of every previous crawl named in this
crawl's metadata and skips seed URLs already processed there; `add_layer`
and `seen_url` keep it current.

Not ported (ROADMAP Queue 3): the SQL graph store (the random-walk graph,
the tandem queue, seed channels), so the port creates no ``graph.sqlite``;
its state tree is otherwise the reference's.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List

from .datamodels import Page
from .local import LocalStateManager

logger = logging.getLogger("dct.state.composite")


class CompositeStateManager(LocalStateManager):

    def __init__(self, config):
        super().__init__(config)
        self._cache_lock = threading.RLock()
        # URL -> the crawl id it was first seen in
        self._url_cache: Dict[str, str] = {}

    def _hydrate_url_cache(self) -> None:
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
        """Resume or seed as `LocalStateManager` does, without the seed
        URLs a previous crawl already processed."""
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
                    self._url_cache.setdefault(page.url,
                                               self.config.crawl_id)

    def seen_url(self, url: str) -> bool:
        with self._cache_lock:
            return url in self._url_cache

"""Helpers the modes share: the reference's `distributed_crawler_tpu/
modes/common.py`, for the state manager a mode builds from its
`CrawlerConfig`, the resume of an incomplete execution and the seed URLs'
normalization."""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from ..config.crawler import CrawlerConfig, generate_crawl_id
from ..state.factory import create_state_manager as factory_create
from ..state.interface import LocalConfig, SqlConfig, StateConfig
from ..state.local import LocalStateManager

logger = logging.getLogger("dct.modes")


def state_config_from_crawler_config(cfg: CrawlerConfig,
                                     crawl_exec_id: str = "") -> StateConfig:
    """The reference's `StateConfig` for ``cfg``, cut to the fields the
    port reads; ``max_pages`` binds only for an execution, and the graph
    store is ``<storage_root>/graph.sqlite``."""
    return StateConfig(
        storage_root=cfg.storage_root,
        crawl_id=cfg.crawl_id,
        crawl_execution_id=crawl_exec_id,
        platform=cfg.platform,
        sampling_method=cfg.sampling_method,
        seed_size=cfg.seed_size,
        max_pages=cfg.max_pages if crawl_exec_id else 0,
        local=LocalConfig(base_path=cfg.storage_root),
        sql=SqlConfig(url=cfg.storage_root + "/graph.sqlite"
                      if cfg.storage_root else ":memory:"),
    )


def create_state_manager(cfg: CrawlerConfig,
                         crawl_exec_id: str = "") -> LocalStateManager:
    """The factory's manager for the mode's config: a
    `CompositeStateManager`, since the config names a SQL store."""
    return factory_create(state_config_from_crawler_config(cfg,
                                                           crawl_exec_id))


def determine_crawl_id(temp_sm: Optional[LocalStateManager],
                       cfg: CrawlerConfig) -> Tuple[str, bool]:
    """Resume an incomplete execution of ``cfg.crawl_id`` or start a new
    one; returns ``(execution id, resuming)``.  ``temp_sm`` is closed."""
    crawl_exec_id = ""
    if temp_sm is not None:
        try:
            existing, exists = temp_sm.find_incomplete_crawl(cfg.crawl_id)
        except Exception as e:
            logger.warning("error checking for existing crawls, "
                           "starting fresh: %s", e)
            existing, exists = "", False
        if exists and existing:
            crawl_exec_id = existing
            logger.info("resuming existing crawl", extra={
                "crawl_id": cfg.crawl_id, "execution_id": crawl_exec_id})
        try:
            temp_sm.close()
        except Exception:
            pass
    is_resuming = bool(crawl_exec_id)
    if not crawl_exec_id:
        crawl_exec_id = generate_crawl_id()
        logger.info("starting new crawl execution",
                    extra={"execution_id": crawl_exec_id})
    return crawl_exec_id, is_resuming


def normalize_seed_urls(urls: List[str]) -> List[str]:
    """Strip the t.me prefixes and ``@``, and lowercase."""
    out = []
    for u in urls:
        for prefix in ("https://t.me/", "http://t.me/", "t.me/", "@"):
            if u.startswith(prefix):
                u = u[len(prefix):]
        out.append(u.lower())
    return out

"""The state manager a mode builds from its `CrawlerConfig`: the
reference's `distributed_crawler_tpu/modes/common.py:22-47`."""

from __future__ import annotations

from ..config.crawler import CrawlerConfig
from ..state.composite import CompositeStateManager
from ..state.interface import LocalConfig, StateConfig


def state_config_from_crawler_config(cfg: CrawlerConfig,
                                     crawl_exec_id: str = "") -> StateConfig:
    """The reference's `StateConfig` for ``cfg``, cut to the fields the
    port reads (no ``sql``: the port has no SQL graph store, ROADMAP
    Queue 3); ``max_pages`` binds only for an execution."""
    return StateConfig(
        storage_root=cfg.storage_root,
        crawl_id=cfg.crawl_id,
        crawl_execution_id=crawl_exec_id,
        platform=cfg.platform,
        sampling_method=cfg.sampling_method,
        max_pages=cfg.max_pages if crawl_exec_id else 0,
        local=LocalConfig(base_path=cfg.storage_root),
    )


def create_state_manager(cfg: CrawlerConfig,
                         crawl_exec_id: str = "") -> CompositeStateManager:
    """The composite manager, the reference factory's choice for every
    config a mode builds (it always names a SQL store)."""
    return CompositeStateManager(state_config_from_crawler_config(
        cfg, crawl_exec_id))

"""The mode router: the port's copy of the reference's
`distributed_crawler_tpu/modes/runner.py` for its validate-only and
random-walk branches.

`launch` resumes an incomplete execution (when it builds its own state
manager), then runs the validator pod (``validate_only``) or the
layerless random walk: its pool built from config unless one is
installed (`crawl/runner.setup_pool_from_config`: the native client over
the ``tdlib_database_urls`` seed DBs or a DC gateway), the seeds
normalized, the caches loaded, the page buffer seeded on a fresh start
(`seed_random_walk`), the walk run, and at the end the crawl's metadata
marked completed and its pages exported.

Not ported: the layered crawl and the YouTube branches, which `launch`
refuses before any set-up, naming ROADMAP Queue 1 part C, and the
chunker (``combine_files``, which the port's config lacks) with
`ship_crawl_output`, which wait with them.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..config.crawler import CrawlerConfig
from ..crawl import setup_pool_from_config
from ..state.datamodels import PAGE_UNFETCHED, Page, new_id, utcnow
from .common import create_state_manager, determine_crawl_id, normalize_seed_urls
from .layerless import run_random_walk_layerless
from .validate import run_validate_only

logger = logging.getLogger("dct.modes.runner")


def _refuse_unported(cfg: CrawlerConfig) -> None:
    """The router's branches that wait for the crawl modes (ROADMAP Queue
    1 part C)."""
    if cfg.validate_only or (cfg.sampling_method == "random-walk"
                             and cfg.platform == "telegram"):
        return
    raise NotImplementedError(
        f"launch: the {cfg.platform} crawl with {cfg.sampling_method} "
        f"sampling runs in the crawl modes, which the port has not ported "
        f"yet (ROADMAP Queue 1 part C); the port's launch runs the "
        f"validator (validate_only) and the telegram random walk")


def seed_random_walk(sm, seed_urls: List[str]) -> None:
    """The random walk's start: the caches loaded, and on a fresh start
    the page buffer seeded from the URLs (each its own chain) or, without
    URLs, from the seed pool (``seed_size``)."""
    seed_urls = normalize_seed_urls(seed_urls)
    sm.initialize([])  # the store's set-up, without a layer for the seeds
    try:
        sm.load_seed_channels()
    except Exception as e:
        logger.warning("random-walk-init: failed to load seed channels "
                       "(continuing): %s", e)
    try:
        sm.load_invalid_channels()
    except Exception as e:
        logger.warning("random-walk-init: failed to load invalid channels "
                       "(continuing): %s", e)
    sm.initialize_discovered_channels()

    existing = sm.get_pages_from_page_buffer(1)
    if existing:
        logger.info("random-walk-init: resuming from existing page buffer",
                    extra={"count": len(existing)})
        return
    if seed_urls:
        logger.info("random-walk-init: seeding page buffer from URL list",
                    extra={"count": len(seed_urls)})
        for url in seed_urls:
            try:
                sm.add_page_to_page_buffer(Page(
                    id=new_id(), url=url, depth=0, status=PAGE_UNFETCHED,
                    timestamp=utcnow(), sequence_id=new_id()))
            except Exception as e:
                logger.error("random-walk-init: failed to seed URL", extra={
                    "url": url, "error": str(e)})
    else:
        sm.initialize_random_walk_layer()


def launch(seed_urls: List[str], cfg: CrawlerConfig, sm=None,
           validate_fn=None, layerless_poll_s: Optional[float] = None
           ) -> None:
    """Run the validator pod or the random walk (see the module
    docstring).  ``sm`` is a state manager the caller built (and closes),
    ``validate_fn`` the validator's HTTP seam, ``layerless_poll_s`` the
    walk's page-buffer poll."""
    _refuse_unported(cfg)
    owns_sm = sm is None
    if owns_sm:
        temp_sm = create_state_manager(cfg)
        crawl_exec_id, _ = determine_crawl_id(temp_sm, cfg)
        sm = create_state_manager(cfg, crawl_exec_id)
    else:
        crawl_exec_id = cfg.crawl_id

    if cfg.platform == "telegram" and not cfg.validate_only:
        setup_pool_from_config(cfg)  # a no-op when a pool is installed

    try:
        if cfg.validate_only:
            sm.initialize([])
            run_validate_only(sm, cfg, validate_fn=validate_fn)
            return

        seed_random_walk(sm, seed_urls)
        run_random_walk_layerless(sm, cfg, poll_interval_s=layerless_poll_s)

        logger.info("saving final state before marking crawl as completed")
        sm.save_state()
        sm.update_crawl_metadata(cfg.crawl_id, {
            "status": "completed",
            "endTime": utcnow().isoformat(),
            "previousCrawlID": crawl_exec_id,
        })
        try:
            sm.export_pages_to_binding(cfg.crawl_id)
        except Exception as e:
            logger.error("error exporting pages to binding: %s", e)
        logger.info("all items processed successfully")
    finally:
        if owns_sm:
            try:
                sm.close()
            except Exception:
                pass

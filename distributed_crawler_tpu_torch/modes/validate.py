"""The validator pod's mode: the port's copy of the reference's
`distributed_crawler_tpu/modes/validate.py`.  It loads the seed, invalid
and discovered caches, recovers edges and batches left in an
intermediate state by an earlier crash (older than 10 minutes), then runs
the tandem validation loop (`crawl/validator.RunValidationLoop`).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..config.crawler import CrawlerConfig
from ..crawl.validator import RunValidationLoop, ValidatorConfig

logger = logging.getLogger("dct.modes.validate")

STALE_THRESHOLD_S = 600.0  # 10 minutes


def prepare_validator_state(sm) -> None:
    """Warm the caches and recover from an earlier crash."""
    try:
        sm.load_seed_channels()
    except Exception as e:
        logger.warning("validator-mode: failed to load seed channels "
                       "(continuing): %s", e)
    try:
        sm.load_invalid_channels()
    except Exception as e:
        logger.warning("validator-mode: failed to load invalid channels "
                       "(continuing): %s", e)
    sm.initialize_discovered_channels()

    for name, fn in (
            ("stale edge claims",
             lambda: sm.recover_stale_edge_claims(STALE_THRESHOLD_S)),
            ("stale batch claims",
             lambda: sm.recover_stale_batch_claims(STALE_THRESHOLD_S)),
            ("orphan edges", sm.recover_orphan_edges)):
        try:
            n = fn()
            if n:
                logger.info("validator-mode: recovered %d %s", n, name)
        except Exception as e:
            logger.warning("validator-mode: failed to recover %s: %s",
                           name, e)


def run_validate_only(sm, cfg: CrawlerConfig,
                      vcfg: Optional[ValidatorConfig] = None,
                      validate_fn=None,
                      loop: Optional[RunValidationLoop] = None,
                      block: bool = True) -> RunValidationLoop:
    """Prepare the state and start the loop; with ``block`` wait until it
    stops (or the caller is interrupted), then stop it and close ``sm``.
    Returns the loop, which the caller stops when ``block`` is False."""
    prepare_validator_state(sm)
    loop = loop or RunValidationLoop(sm, cfg, vcfg=vcfg,
                                     validate_fn=validate_fn)
    loop.start()
    if block:
        try:
            loop.stop_event.wait()
        finally:
            loop.stop()
            sm.close()
    return loop

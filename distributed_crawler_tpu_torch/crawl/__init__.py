"""The crawl engine: the port's copy of the reference's
`distributed_crawler_tpu/crawl/`.  `run_for_channel(_with_pool)`,
`process_all_messages` with the random walk's step (the lookups, the
walkback decision, `pick_walkback_channel`) and the tandem crawl's
pending-edge batches, message dedup and resampling, the FLOOD_WAIT
policy, the process-wide connection-pool facade, the 400-replacement
(`replacement.py`) and the tandem validator (`validator.py`).
"""

from .errors import FloodWaitRetireError, TDLib400Error, WalkbackExhaustedError
from .replacement import handle_400_replacement
from .runner import (
    add_new_messages,
    get_connection_from_pool,
    init_connection_pool,
    pick_walkback_channel,
    pool_is_empty,
    process_all_messages,
    release_connection_to_pool,
    resample_marker,
    retire_connection_from_pool,
    run_for_channel,
    run_for_channel_with_pool,
    set_run_for_channel_fn,
    setup_pool_from_config,
    shutdown_connection_pool,
)
from .validator import BlockedState, RunValidationLoop, ValidatorConfig

__all__ = [
    "run_for_channel",
    "run_for_channel_with_pool",
    "process_all_messages",
    "add_new_messages",
    "resample_marker",
    "pick_walkback_channel",
    "init_connection_pool",
    "get_connection_from_pool",
    "release_connection_to_pool",
    "retire_connection_from_pool",
    "pool_is_empty",
    "setup_pool_from_config",
    "shutdown_connection_pool",
    "set_run_for_channel_fn",
    "handle_400_replacement",
    "WalkbackExhaustedError",
    "FloodWaitRetireError",
    "TDLib400Error",
    "RunValidationLoop",
    "ValidatorConfig",
    "BlockedState",
]

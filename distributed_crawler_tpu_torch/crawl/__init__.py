"""The channel crawl engine: the port's copy of what the reference's
`distributed_crawler_tpu/crawl/` runs for channel and snowball sampling.
`run_for_channel(_with_pool)`, `process_all_messages`, message dedup and
resampling, the FLOOD_WAIT policy and the process-wide connection-pool
facade.  The random walk, the tandem validator and the 400-replacement
wait for the SQL graph store (ROADMAP Queue 1 part B).
"""

from .errors import FloodWaitRetireError, TDLib400Error
from .runner import (
    add_new_messages,
    get_connection_from_pool,
    init_connection_pool,
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

__all__ = [
    "run_for_channel",
    "run_for_channel_with_pool",
    "process_all_messages",
    "add_new_messages",
    "resample_marker",
    "init_connection_pool",
    "get_connection_from_pool",
    "release_connection_to_pool",
    "retire_connection_from_pool",
    "setup_pool_from_config",
    "shutdown_connection_pool",
    "set_run_for_channel_fn",
    "FloodWaitRetireError",
    "TDLib400Error",
]

"""The Telegram client boundary of the channel crawl: the port's copy of
what the reference's `distributed_crawler_tpu/clients/` gives it.

The 16-method `TelegramClient` protocol and its TL dataclasses, the error
taxonomy, the per-method rate limiter, the connection pool, the username
filter, the account-free t.me validator of the tandem crawl
(`http_validator.py`), and the in-process network simulation that stands
in for Telegram (`sim.py`).  The reference's native client, DC gateway
and TL API wait for ROADMAP Queue 1 part D, its YouTube client for part C.
"""

from .errors import FloodWaitError, TelegramError, parse_flood_wait_seconds
from .http_validator import (
    BLOCKED,
    TRANSIENT,
    ChannelValidationResult,
    ValidationHTTPError,
    ValidatorRateLimiter,
    parse_channel_html,
    validate_channel_http,
)
from .pool import ConnectionPool, PooledConnection, PoolEmptyError
from .rate_limiter import (
    Clock,
    FakeClock,
    RateLimitedTelegramClient,
    SystemClock,
    TokenBucket,
    detect_cache_or_server,
)
from .sim import SimChannel, SimNetwork, SimTelegramClient
from .telegram import (
    TelegramClient,
    TLChat,
    TLFile,
    TLMessage,
    TLMessageLink,
    TLMessages,
    TLMessageThreadInfo,
    TLSupergroup,
    TLSupergroupFullInfo,
    TLUser,
)
from .username_filter import UsernameFilterResult, filter_username

__all__ = [
    "TelegramClient", "TelegramError", "FloodWaitError",
    "parse_flood_wait_seconds",
    "TLMessage", "TLMessages", "TLChat", "TLSupergroup",
    "TLSupergroupFullInfo", "TLUser", "TLFile", "TLMessageLink",
    "TLMessageThreadInfo",
    "TokenBucket", "RateLimitedTelegramClient", "detect_cache_or_server",
    "Clock", "SystemClock", "FakeClock",
    "ConnectionPool", "PooledConnection", "PoolEmptyError",
    "SimTelegramClient", "SimNetwork", "SimChannel",
    "filter_username", "UsernameFilterResult",
    "ChannelValidationResult", "ValidationHTTPError", "ValidatorRateLimiter",
    "parse_channel_html", "validate_channel_http", "TRANSIENT", "BLOCKED",
]

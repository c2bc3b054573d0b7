"""The Telegram client boundary of the channel crawl: the port's copy of
what the reference's `distributed_crawler_tpu/clients/` gives it.

The 16-method `TelegramClient` protocol and its TL dataclasses, the error
taxonomy, the per-method rate limiter, the connection pool, the username
filter, the account-free t.me validator of the tandem crawl
(`http_validator.py`), the in-process network simulation that stands in
for Telegram (`sim.py`), and the native client (`native.py`: the C++
client in `native/`, built at first use, over a seed DB or the DCT wire
to a DC gateway).  The reference's MTProto wire, DC gateway and TL API
wait for the wire's half of ROADMAP Queue 1 part D, its YouTube client
for part C.
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
from .native import (
    NativeTelegramClient,
    find_library as find_native_library,
    generate_pcode,
    load_credentials,
    native_client_factory,
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
    "NativeTelegramClient", "native_client_factory", "find_native_library",
    "generate_pcode", "load_credentials",
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

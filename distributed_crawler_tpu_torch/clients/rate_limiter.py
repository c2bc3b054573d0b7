"""Per-method rate limiting for the Telegram client: the port's copy of
the reference's `distributed_crawler_tpu/clients/rate_limiter.py`.

- independent per-method token buckets plus jitter: proactive waits for
  GetChatHistory, SearchPublicChat and the supergroup info calls;
- **reactive** GetMessage limiting: a token is consumed only when the call
  misses the client's local cache, which its latency tells;
- latency-based cache attribution (under 5 ms is the cache).

Clocks are injectable, so tests assert the spacing between calls without
sleeping (`FakeClock`).
"""

from __future__ import annotations

import logging
import random
import threading
import time as _time
from typing import Callable, Optional

from ..config.crawler import TelegramRateLimitConfig
from .telegram import (
    TelegramClient,
    TLBasicGroupFullInfo,
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

logger = logging.getLogger("dct.clients.ratelimit")

# Latency thresholds for cache attribution.
CACHE_HIT_THRESHOLD_S = 0.005
SERVER_HIT_THRESHOLD_S = 0.015


class Clock:
    """Injectable time source."""

    def time(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    def time(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)


class FakeClock(Clock):
    """Deterministic clock for tests; sleep() advances time instantly."""

    def __init__(self, start: float = 0.0):
        self.now = start
        self.sleeps: list = []

    def time(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self.sleeps.append(seconds)
            self.now += seconds

    def advance(self, seconds: float) -> None:
        self.now += seconds


def detect_cache_or_server(elapsed_s: float, api_call: str = "") -> bool:
    """True if the call latency indicates a local-cache hit; logs the
    attribution."""
    cache_hit = elapsed_s < CACHE_HIT_THRESHOLD_S
    if api_call:
        logger.debug("call attribution", extra={
            "api_call": api_call, "elapsed_ms": int(elapsed_s * 1000),
            "source": "cache" if cache_hit else (
                "server" if elapsed_s > SERVER_HIT_THRESHOLD_S else "unknown")})
    return cache_hit


class TokenBucket:
    """A calls-per-minute token bucket, burst 1."""

    def __init__(self, calls_per_minute: float, clock: Optional[Clock] = None):
        self.clock = clock or SystemClock()
        self._lock = threading.Lock()
        if calls_per_minute <= 0:
            self.interval_s = 0.0  # unlimited
        else:
            self.interval_s = 60.0 / calls_per_minute
        self._next_free = self.clock.time()

    def reserve(self) -> float:
        """Consume a token; returns the delay the caller should wait."""
        with self._lock:
            if self.interval_s == 0.0:
                return 0.0
            now = self.clock.time()
            delay = max(0.0, self._next_free - now)
            self._next_free = max(self._next_free, now) + self.interval_s
            return delay

    def wait(self) -> float:
        """Block until a token is available; returns the time waited."""
        delay = self.reserve()
        self.clock.sleep(delay)
        return delay


class RateLimitedTelegramClient:
    """Decorator enforcing per-method limits over any TelegramClient.
    Each instance owns its buckets, so pooled connections never share
    quota."""

    def __init__(self, inner: TelegramClient,
                 config: Optional[TelegramRateLimitConfig] = None,
                 clock: Optional[Clock] = None,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        cfg = config or TelegramRateLimitConfig()
        self.config = cfg
        self.clock = clock or SystemClock()
        self._rng = rng or random.Random()
        self._chat_history = TokenBucket(cfg.get_chat_history_rate, self.clock)
        self._search_chat = TokenBucket(cfg.search_public_chat_rate, self.clock)
        self._supergroup = TokenBucket(cfg.get_supergroup_info_rate, self.clock)
        self._get_message = TokenBucket(cfg.get_message_server_hit_rate, self.clock)

    # --- helpers ----------------------------------------------------------
    def _jitter_s(self, max_ms: int) -> float:
        return self._rng.randint(0, max_ms) / 1000.0 if max_ms > 0 else 0.0

    def _wait_with_jitter(self, bucket: TokenBucket, jitter_ms: int,
                          api_call: str) -> None:
        bucket.wait()
        jitter = self._jitter_s(jitter_ms)
        logger.debug("rate limit wait", extra={"api_call": api_call,
                                               "jitter_ms": int(jitter * 1000)})
        self.clock.sleep(jitter)

    def _timed(self, api_call: str, fn: Callable):
        start = self.clock.time()
        result = fn()
        detect_cache_or_server(self.clock.time() - start, api_call)
        return result

    # --- proactively limited methods ------------------------------------
    def get_chat_history(self, chat_id: int, from_message_id: int = 0,
                         offset: int = 0, limit: int = 100) -> TLMessages:
        self._wait_with_jitter(self._chat_history,
                               self.config.get_chat_history_jitter_ms,
                               "GetChatHistory")
        return self._timed("GetChatHistory", lambda: self.inner.get_chat_history(
            chat_id, from_message_id, offset, limit))

    def search_public_chat(self, username: str) -> TLChat:
        self._wait_with_jitter(self._search_chat,
                               self.config.search_public_chat_jitter_ms,
                               "SearchPublicChat")
        return self._timed("SearchPublicChat",
                           lambda: self.inner.search_public_chat(username))

    def get_supergroup_full_info(self, supergroup_id: int) -> TLSupergroupFullInfo:
        self._wait_with_jitter(self._supergroup,
                               self.config.get_supergroup_info_jitter_ms,
                               "GetSupergroupFullInfo")
        return self._timed("GetSupergroupFullInfo",
                           lambda: self.inner.get_supergroup_full_info(supergroup_id))

    def get_basic_group_full_info(self, basic_group_id: int) -> TLBasicGroupFullInfo:
        self._wait_with_jitter(self._supergroup,
                               self.config.get_supergroup_info_jitter_ms,
                               "GetBasicGroupFullInfo")
        return self._timed("GetBasicGroupFullInfo",
                           lambda: self.inner.get_basic_group_full_info(basic_group_id))

    # --- reactive GetMessage ----------------------------------------------
    def get_message(self, chat_id: int, message_id: int) -> TLMessage:
        start = self.clock.time()
        error: Optional[BaseException] = None
        result = None
        try:
            result = self.inner.get_message(chat_id, message_id)
        except BaseException as e:
            error = e
        cache_hit = detect_cache_or_server(self.clock.time() - start, "GetMessage")
        if not cache_hit:
            delay = self._get_message.reserve()
            total = delay + self._jitter_s(self.config.get_message_server_hit_jitter_ms)
            if total > 0:
                logger.debug("reactive throttle (server hit)",
                             extra={"api_call": "GetMessage",
                                    "throttle_delay_ms": int(delay * 1000)})
                self.clock.sleep(total)
        if error is not None:
            raise error
        return result

    # --- pass-through ----------------------------------------------------
    def get_message_link(self, chat_id: int, message_id: int) -> TLMessageLink:
        return self.inner.get_message_link(chat_id, message_id)

    def get_message_thread_history(self, chat_id: int, message_id: int,
                                   from_message_id: int = 0,
                                   limit: int = 100) -> TLMessages:
        return self.inner.get_message_thread_history(chat_id, message_id,
                                                     from_message_id, limit)

    def get_message_thread(self, chat_id: int, message_id: int) -> TLMessageThreadInfo:
        return self.inner.get_message_thread(chat_id, message_id)

    def get_remote_file(self, remote_file_id: str) -> TLFile:
        return self.inner.get_remote_file(remote_file_id)

    def download_file(self, file_id: int) -> TLFile:
        return self.inner.download_file(file_id)

    def get_chat(self, chat_id: int) -> TLChat:
        return self.inner.get_chat(chat_id)

    def get_supergroup(self, supergroup_id: int) -> TLSupergroup:
        return self.inner.get_supergroup(supergroup_id)

    def close(self) -> None:
        return self.inner.close()

    def get_me(self) -> TLUser:
        return self.inner.get_me()

    def get_user(self, user_id: int) -> TLUser:
        return self.inner.get_user(user_id)

    def delete_file(self, file_id: int) -> None:
        return self.inner.delete_file(file_id)

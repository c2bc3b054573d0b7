"""Connection pool of Telegram clients: the port's copy of the
reference's `distributed_crawler_tpu/clients/pool.py`.

- a pool keyed by connection id, filled from a factory (one connection
  per database URL); acquire and release without a new login;
- the error path: close, then recreate in place;
- permanent retirement on a long FLOOD_WAIT; empty-pool detection;
- every client wrapped in its own rate limiter as it goes in; stats; a
  testing constructor over pre-built clients (`ConnectionPool.for_testing`).
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..config.crawler import TelegramRateLimitConfig
from .rate_limiter import Clock, RateLimitedTelegramClient
from .telegram import TelegramClient

logger = logging.getLogger("dct.clients.pool")

ClientFactory = Callable[[str], TelegramClient]


class PoolEmptyError(Exception):
    """All connections are retired or the pool was never initialized."""


@dataclass
class PooledConnection:
    conn_id: str
    client: TelegramClient  # rate-limited wrapper
    database_url: str = ""
    uses: int = 0
    errors: int = 0
    retired: bool = False
    retire_reason: str = ""


class ConnectionPool:
    """Thread-safe pool with retire/recreate semantics."""

    def __init__(self, factory: ClientFactory,
                 database_urls: Optional[List[str]] = None,
                 rate_limit: Optional[TelegramRateLimitConfig] = None,
                 clock: Optional[Clock] = None):
        self.factory = factory
        self.database_urls = list(database_urls or [])
        self.rate_limit = rate_limit or TelegramRateLimitConfig()
        self.clock = clock
        self._lock = threading.RLock()
        self._conns: Dict[str, PooledConnection] = {}
        self._available: "queue.Queue[str]" = queue.Queue()

    # --- construction -----------------------------------------------------
    def initialize(self) -> int:
        """Create one connection per database URL.  Returns the number
        of live connections; a connection that fails to be created is
        logged and skipped."""
        created = 0
        urls = self.database_urls or [""]
        for i, url in enumerate(urls):
            conn_id = f"conn_{i}"
            try:
                self._insert(conn_id, self.factory(conn_id), url)
                created += 1
            except Exception as e:
                logger.error("failed to create connection %s: %s", conn_id, e)
        logger.info("connection pool initialized", extra={
            "log_tag": "rw_pool", "connections": created})
        return created

    @classmethod
    def for_testing(cls, clients: Dict[str, TelegramClient],
                    rate_limit: Optional[TelegramRateLimitConfig] = None,
                    clock: Optional[Clock] = None) -> "ConnectionPool":
        """Build a pool from pre-built clients."""
        pool = cls(factory=lambda cid: clients[cid], rate_limit=rate_limit,
                   clock=clock)
        for conn_id, client in clients.items():
            pool._insert(conn_id, client, "")
        return pool

    def _insert(self, conn_id: str, raw_client: TelegramClient,
                database_url: str) -> None:
        # Rate limiter wraps at insertion so quota follows the connection.
        wrapped = RateLimitedTelegramClient(raw_client, self.rate_limit,
                                            clock=self.clock)
        with self._lock:
            self._conns[conn_id] = PooledConnection(
                conn_id=conn_id, client=wrapped, database_url=database_url)
        self._available.put(conn_id)

    # --- acquire / release -------------------------------------------------
    def acquire(self, timeout_s: Optional[float] = None) -> PooledConnection:
        """Get a connection without a new login."""
        while True:
            if self.empty():
                raise PoolEmptyError("no live connections in pool")
            try:
                conn_id = self._available.get(
                    timeout=timeout_s if timeout_s is not None else 5.0)
            except queue.Empty:
                if timeout_s is not None:
                    raise TimeoutError("timed out waiting for a pool connection")
                continue
            with self._lock:
                conn = self._conns.get(conn_id)
                if conn is None or conn.retired:
                    continue  # retired while queued
                conn.uses += 1
                return conn

    def release(self, conn: PooledConnection) -> None:
        with self._lock:
            # Ignore stale handles (retired, or replaced by recreate()) so a
            # conn_id can never be queued twice and shared by two acquirers.
            if conn.retired or self._conns.get(conn.conn_id) is not conn:
                return
        self._available.put(conn.conn_id)

    # --- failure handling --------------------------------------------------
    def recreate(self, conn: PooledConnection) -> PooledConnection:
        """Close and rebuild a connection in place after a
        connection-level error."""
        try:
            conn.client.close()
        except Exception:
            pass
        with self._lock:
            conn.errors += 1
            database_url = conn.database_url
        try:
            raw = self.factory(conn.conn_id)
        except Exception:
            # The old client is closed and unusable: retire the slot so the
            # pool doesn't count a phantom live connection forever.
            self.retire(conn.conn_id, "recreate_failed")
            raise
        wrapped = RateLimitedTelegramClient(raw, self.rate_limit, clock=self.clock)
        with self._lock:
            fresh = PooledConnection(conn_id=conn.conn_id, client=wrapped,
                                     database_url=database_url,
                                     errors=conn.errors)
            self._conns[conn.conn_id] = fresh
        # The caller owns `fresh` (as if acquired) and must release() it;
        # enqueueing here as well would hand the same connection to two users.
        fresh.uses += 1
        return fresh

    def retire(self, conn_id: str, reason: str = "") -> None:
        """Permanently remove a connection (a long FLOOD_WAIT)."""
        with self._lock:
            conn = self._conns.get(conn_id)
            if conn is None or conn.retired:
                return
            conn.retired = True
            conn.retire_reason = reason
        try:
            conn.client.close()
        except Exception:
            pass
        logger.warning("connection retired", extra={
            "log_tag": "rw_pool", "conn_id": conn_id, "reason": reason})

    # --- introspection ------------------------------------------------------
    def empty(self) -> bool:
        with self._lock:
            return all(c.retired for c in self._conns.values()) or not self._conns

    def stats(self) -> Dict[str, object]:
        with self._lock:
            live = [c for c in self._conns.values() if not c.retired]
            return {
                "total": len(self._conns),
                "live": len(live),
                "retired": len(self._conns) - len(live),
                "total_uses": sum(c.uses for c in self._conns.values()),
                "total_errors": sum(c.errors for c in self._conns.values()),
            }

    def close_all(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            try:
                c.client.close()
            except Exception:
                pass

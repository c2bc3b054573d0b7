"""Durable publisher outbox: a broker outage buffers, it does not raise.

The port's copy of the reference's `distributed_crawler_tpu/bus/
outbox.py`, with the same spill WAL format (``outbox.jsonl``: ``put``
and ``done`` events, read by the spool's `_fold_lines`), so either
package's publisher resumes the other's WAL.

Publishes land in a bounded in-process queue (with an optional
spill-to-disk WAL, so a publisher restart re-sends what it had buffered),
and a background flusher drives them to the transport through
`utils/resilience.py`: per-frame `retry_call` with jittered exponential
backoff plus a circuit breaker on target ``bus`` (or a shard's own
target, ``breaker_target``).  An outage shows as ``bus_outbox_depth`` and
``resilience_circuit_state{target="bus"}``.

Ordering is preserved (head of line: the flusher never skips a frame),
and the bound is hard: a full outbox raises :class:`OutboxFull` into the
publisher.  :meth:`DurableOutbox.near_full` and
:meth:`DurableOutbox.below_low_water` are the high and low marks a
publisher's backpressure valve reads.

`OutboxBus` is the drop-in wrapper: ``publish`` goes through the outbox,
everything else delegates to the inner bus.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from ..utils import resilience, trace
from ..utils.metrics import REGISTRY, MetricsRegistry
from .inmemory import serialize_payload
from .spool import _fold_lines

logger = logging.getLogger("dct.torch.bus.outbox")

OUTBOX_TARGET = "bus"  # the circuit-breaker target name
WAL_FILE = "outbox.jsonl"

DEFAULT_MAX_FRAMES = 1024
NEAR_FULL_FRACTION = 0.8  # the high mark a dispatch valve engages on
RETRY_ATTEMPTS = 4        # per retry_call round; the outer loop is
                          # unbounded: frames are never dropped
FSYNC_EVERY = 16          # the TopicSpool discipline: flush per line
                          # (process-crash safe), fsync every N lines
COMPACT_EVERY = 256


class OutboxFull(RuntimeError):
    """The bounded outbox is at capacity — the publish was NOT accepted."""

    def __init__(self, depth: int, max_frames: int):
        super().__init__(
            f"bus outbox full ({depth}/{max_frames} frames buffered)")
        self.depth = depth
        self.max_frames = max_frames


@dataclass(frozen=True)
class OutboxConfig:
    """Knobs for one publisher's outbox (``bus.outbox_max_frames`` sets
    ``max_frames`` from the CLI)."""

    dir: str = ""                    # spill-to-disk WAL; "" = memory-only
    max_frames: int = DEFAULT_MAX_FRAMES
    flush_wait_s: float = 0.05       # idle/backoff granularity
    retry_base_s: float = 0.05
    retry_max_s: float = 1.0
    breaker_threshold: int = 5
    breaker_recovery_s: float = 1.0


class DurableOutbox:
    """Bounded spill-to-disk publish queue + resilience-wrapped flusher.

    ``send(topic, payload)`` is the transport call (e.g. the Publish RPC);
    it is invoked from the flusher thread only, through
    ``resilience.retry_call`` + the ``bus`` circuit breaker.
    """

    def __init__(self, send: Callable[[str, Any], None],
                 cfg: OutboxConfig = OutboxConfig(),
                 name: str = OUTBOX_TARGET,
                 registry: MetricsRegistry = REGISTRY,
                 breaker_target: Optional[str] = None):
        self._send = send
        self.cfg = cfg
        self.name = name
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # (seq, topic, payload-or-None, serialized bytes); payload is the
        # live object when the publish happened in THIS process (no
        # decode cost on flush), None for WAL-reloaded entries.
        self._q: "deque[Tuple[int, str, Any, bytes]]" = deque()
        self._seq = 0
        self._wal_fh = None
        self._wal_puts = 0
        self._wal_dones = 0
        self._since_fsync = 0
        self._retry = resilience.RetryPolicy(
            max_attempts=RETRY_ATTEMPTS,
            base_delay_s=cfg.retry_base_s, max_delay_s=cfg.retry_max_s,
            jitter=0.2)
        # One breaker target ("bus") whatever the publisher: every outbox
        # in a process talks to the same broker, so they share the
        # resilience_circuit_state{target="bus"} series; the depth and
        # flow series are labelled per publisher.  The partitioned bus
        # (`bus/partition.py`) passes a per-shard ``breaker_target``: one
        # shard's outage must not open the circuit for its siblings.
        self._breaker = resilience.CircuitBreaker(
            breaker_target or OUTBOX_TARGET,
            failure_threshold=cfg.breaker_threshold,
            recovery_timeout_s=cfg.breaker_recovery_s, registry=registry)
        self.m_depth = registry.gauge(
            "bus_outbox_depth",
            "publishes buffered awaiting the broker (bus/outbox.py)"
        ).labels(publisher=name)
        self.m_capacity = registry.gauge(
            "bus_outbox_capacity", "outbox frame bound (max_frames)"
        ).labels(publisher=name)
        self.m_flushed = registry.counter(
            "bus_outbox_flushed_total",
            "buffered publishes delivered to the transport"
        ).labels(publisher=name)
        self.m_rejected = registry.counter(
            "bus_outbox_rejected_total",
            "publishes refused because the outbox was full"
        ).labels(publisher=name)
        self.m_capacity.set(float(cfg.max_frames))
        self.m_depth.set(0.0)
        if cfg.dir:
            os.makedirs(cfg.dir, exist_ok=True)
            self._reload()
        self._thread = threading.Thread(target=self._flush_loop,
                                        daemon=True,
                                        name=f"dct-outbox-{name}")
        self._thread.start()

    # -- introspection ------------------------------------------------------
    @property
    def wal_path(self) -> str:
        return os.path.join(self.cfg.dir, WAL_FILE) if self.cfg.dir else ""

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def near_full(self) -> bool:
        """True once the buffer crosses the near-full fraction of its
        bound: a publisher's dispatch valve engages on this."""
        with self._lock:
            return len(self._q) >= self._high_mark()

    def below_low_water(self) -> bool:
        """True once the buffer has drained to half the near-full mark:
        the valve releases on this (distinct marks are the hysteresis, so a
        depth hovering at the boundary cannot flap the valve per tick)."""
        with self._lock:
            return len(self._q) <= self._high_mark() // 2

    def _high_mark(self) -> int:
        return max(1, int(self.cfg.max_frames * NEAR_FULL_FRACTION))

    @property
    def circuit_state(self) -> str:
        return self._breaker.state

    # -- WAL ----------------------------------------------------------------
    def _reload(self) -> None:
        """Fold put/done events into the pending set (publisher restart:
        what was buffered but never delivered is re-sent).  Torn-tail /
        corrupt-line handling is the spool's (`spool._fold_lines`) — ONE
        crash-recovery parsing rule for every WAL in this package."""
        pending: "dict[int, Tuple[str, bytes]]" = {}
        path = self.wal_path
        for ev in _fold_lines(path):
            seq = int(ev.get("s", -1))
            if seq < 0:
                continue
            if ev.get("k") == "put":
                try:
                    data = base64.b64decode(ev.get("d", ""))
                except (ValueError, TypeError):
                    continue
                pending[seq] = (str(ev.get("t", "")), data)
            elif ev.get("k") == "done":
                pending.pop(seq, None)
        for seq in sorted(pending):
            topic, data = pending[seq]
            self._q.append((seq, topic, None, data))
            self._seq = max(self._seq, seq + 1)
        if pending:
            logger.info("outbox reloaded %d buffered publish(es) from %s",
                        len(pending), path)
        self.m_depth.set(float(len(self._q)))

    def _wal_append_locked(self, ev: dict) -> None:
        if not self.cfg.dir:
            return
        if self._wal_fh is None:
            # Caller holds _lock (the `_locked` suffix contract).
            self._wal_fh = open(self.wal_path, "a",
                                encoding="utf-8")
        self._wal_fh.write(json.dumps(ev) + "\n")
        self._wal_fh.flush()
        self._since_fsync += 1
        if self._since_fsync >= FSYNC_EVERY:
            # fsync per frame would serialize the publish hot path on
            # disk latency; batching bounds the OS-crash window instead
            # (a process crash loses nothing — lines are flushed).
            os.fsync(self._wal_fh.fileno())
            self._since_fsync = 0

    def _wal_maybe_compact_locked(self) -> None:
        # Once the done-prefix dominates, atomically rewrite the WAL as
        # just the pending puts (the TopicSpool discipline).  Waiting for
        # an EMPTY queue would never fire under sustained load with a
        # standing depth, growing the file for the life of the process.
        if not self.cfg.dir:
            return
        total = self._wal_puts + self._wal_dones
        if total < COMPACT_EVERY or self._wal_dones * 2 < total:
            return
        tmp = self.wal_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for seq, topic, _payload, data in self._q:
                f.write(json.dumps({
                    "k": "put", "s": seq, "t": topic,
                    "d": base64.b64encode(data).decode("ascii")}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if self._wal_fh is not None:
            try:
                self._wal_fh.close()
            except OSError:
                pass
            self._wal_fh = None
        os.replace(tmp, self.wal_path)
        # Caller holds _lock (the `_locked` suffix contract).
        self._wal_puts = len(self._q)
        self._wal_dones = 0

    # -- publish side -------------------------------------------------------
    def publish(self, topic: str, payload: Any) -> None:
        """Accept a publish into the buffer (raises :class:`OutboxFull`
        at the bound).  The trace parent is stamped HERE — the flusher
        thread has no span context, so injection at enqueue is what keeps
        the publish site in the trace."""
        payload = trace.inject(payload)
        # Serialize only when a spill WAL needs the bytes: a memory-only
        # outbox flushes the live object, so serializing here would be
        # pure hot-path waste.
        data = serialize_payload(payload) if self.cfg.dir else b""
        with self._lock:
            if len(self._q) >= self.cfg.max_frames:
                self.m_rejected.inc()
                raise OutboxFull(len(self._q), self.cfg.max_frames)
            seq = self._seq
            self._seq += 1
            self._wal_append_locked({
                "k": "put", "s": seq, "t": topic,
                "d": base64.b64encode(data).decode("ascii")})
            self._wal_puts += 1
            self._q.append((seq, topic, payload, data))
            self.m_depth.set(float(len(self._q)))
        self._wake.set()

    # -- flusher ------------------------------------------------------------
    def _deliver(self, topic: str, payload: Any, data: bytes) -> None:
        if payload is None:
            # WAL-reloaded frame: recover the object form when it is
            # JSON (the transports re-serialize), else send raw bytes.
            try:
                payload = json.loads(data.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                payload = data
        self._send(topic, payload)

    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                head = self._q[0] if self._q else None
            if head is None:
                if self._stop.is_set():
                    return
                self._wake.wait(self.cfg.flush_wait_s)
                self._wake.clear()
                continue
            seq, topic, payload, data = head
            try:
                resilience.retry_call(
                    self._deliver, topic, payload, data,
                    retry=self._retry, op=f"bus.outbox.{self.name}",
                    stop=self._stop, breaker=self._breaker)
            except Exception as e:
                # Exhausted this round (or the circuit is open): the
                # frame STAYS at the head — never dropped — and the loop
                # backs off before the next round.
                if self._stop.is_set():
                    # Closing against a dead broker: keep the WAL — the
                    # next process re-sends — but stop burning retries.
                    return
                logger.warning(
                    "outbox flush of %s deferred (%d buffered): %s",
                    topic, self.depth(), e)
                self._stop.wait(self.cfg.flush_wait_s)
                continue
            with self._lock:
                if self._q and self._q[0][0] == seq:
                    self._q.popleft()
                self._wal_append_locked({"k": "done", "s": seq})
                self._wal_dones += 1
                self._wal_maybe_compact_locked()
                self.m_depth.set(float(len(self._q)))
            self.m_flushed.inc()

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every buffered publish has been delivered (or the
        timeout passes); returns True when empty."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.depth() == 0:
                return True
            time.sleep(0.01)
        return self.depth() == 0

    def close(self, drain_s: float = 5.0) -> None:
        """Try to drain, then stop the flusher.  Undelivered frames stay
        in the WAL (when one is configured) for the next process.
        Idempotent: a second close returns at once instead of burning
        another drain window."""
        if self._stop.is_set():
            return
        if drain_s > 0:
            self.drain(timeout_s=drain_s)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=max(2.0, drain_s))
        with self._lock:
            remaining = len(self._q)
            if self._wal_fh is not None:
                try:
                    if self._since_fsync:
                        os.fsync(self._wal_fh.fileno())
                    self._wal_fh.close()
                except OSError:
                    pass
                self._wal_fh = None
        if remaining:
            log = logger.warning if self.cfg.dir else logger.error
            log("outbox closed with %d undelivered publish(es)%s",
                remaining,
                " (kept in the WAL for the next run)" if self.cfg.dir
                else " LOST (no spill dir configured)")


class OutboxBus:
    """Any bus, with ``publish`` routed through a :class:`DurableOutbox`.

    The wrapper owns the outbox and the inner bus: ``close()`` drains
    and stops the outbox, then closes the inner bus."""

    def __init__(self, inner, cfg: OutboxConfig = OutboxConfig(),
                 name: str = OUTBOX_TARGET,
                 registry: MetricsRegistry = REGISTRY):
        self.inner = inner
        self.outbox = DurableOutbox(inner.publish, cfg, name=name,
                                    registry=registry)

    def publish(self, topic: str, payload: Any) -> None:
        self.outbox.publish(topic, payload)

    def close(self) -> None:
        self.outbox.close()
        close = getattr(self.inner, "close", None)
        if callable(close):
            close()

    def __getattr__(self, name):
        return getattr(self.inner, name)

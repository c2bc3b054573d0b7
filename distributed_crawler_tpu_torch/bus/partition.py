"""Consistent-hash partitioned message bus: N broker shards behind one
bus.

The port's copy of the reference's `distributed_crawler_tpu/bus/
partition.py`, with the same ring and the same routing keys, so a port
client and a reference client send every frame to the same shard.  Every
shard is a stock `GrpcBusServer` with its own spool directory, so a shard
is killed and resumed as one broker is.

- :class:`ShardMap` — a stable consistent-hash ring over shard ids: 64
  points per shard from ``md5(f"{shard}#{replica}")`` (never Python's
  salted ``hash()``), so the same key maps to the same shard in every
  process and across restarts, and adding or removing one shard moves
  only about 1/N of the keys.
- :func:`routing_key` — the per-frame key of a routed (pull/work) topic:
  the page's channel for work-queue frames, the work-item id for results,
  the batch id for record and audio batches, ``post_uid``/``media_id``
  for single records, else the topic name.  Redeliveries of one item
  land on one shard.
- :class:`PartitionedBus` — N bus endpoints behind the bus interface.
  Routed topics go to exactly one shard; fan-out topics
  (:data:`BROADCAST_TOPICS`) go to every shard, and subscribers dedupe by
  a broadcast id stamped at publish time.  Every shard has its own
  :class:`~.outbox.DurableOutbox` (its own spill WAL when configured) and
  its own circuit-breaker target (the shard id): a dead shard's frames
  park in its outbox until it returns, never re-hashed to a live shard.

Two shards sharing one WAL directory (spool or outbox spill) would
cross-contaminate each other's recovery: :func:`validate_shard_spool_dirs`
rejects it, and :func:`shard_spool_dirs` only derives distinct ones.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import uuid
from bisect import bisect_right
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

from ..utils import trace
from ..utils.metrics import REGISTRY, MetricsRegistry
from .messages import (
    TOPIC_ALERTS,
    TOPIC_CHAOS,
    TOPIC_CLUSTERS,
    TOPIC_ORCHESTRATOR,
    TOPIC_SPANS,
    TOPIC_TRANSCRIPTS,
    TOPIC_WORKER_STATUS,
)
from .outbox import DurableOutbox, OutboxConfig

logger = logging.getLogger("dct.torch.bus.partition")

# Fan-out (announce) topics: every subscriber must see every frame, and no
# frame may depend on one shard's liveness, so a publish broadcasts to all
# shards and the broadcast id dedupes.  Every other topic is routed: one
# shard per frame, chosen by routing_key().
BROADCAST_TOPICS = frozenset({
    TOPIC_WORKER_STATUS, TOPIC_ORCHESTRATOR, TOPIC_CHAOS, TOPIC_SPANS,
    TOPIC_ALERTS, TOPIC_CLUSTERS, TOPIC_TRANSCRIPTS,
})

# The broadcast-id stamp (an extra envelope key, as trace.inject's);
# stripped before handlers see the payload.
_BCAST_KEY = "_pbus_bcast"

RING_REPLICAS = 64      # ring points per shard
DEDUPE_WINDOW = 4096    # broadcast ids remembered per subscription


def default_shard_ids(count: int) -> List[str]:
    """The canonical shard names (spool subdirectories and breaker targets
    use them): ``bus-0`` .. ``bus-<n-1>``."""
    return [f"bus-{i}" for i in range(count)]


def channel_of(url: str) -> str:
    """Channel name from a frontier URL: the last non-empty path segment,
    lowercased (t.me/<channel>, youtube.com/@<handle>, or a bare channel
    name all resolve the same way)."""
    tail = url.rstrip("/").rsplit("/", 1)[-1]
    return tail.partition("?")[0].lstrip("@").lower()


class ShardMap:
    """Stable consistent-hash ring over shard ids.

    Each shard owns ``replicas`` points (:data:`RING_REPLICAS` by
    default) on a 64-bit ring derived from ``md5(f"{shard}#{replica}")``;
    ``shard_for(key)`` walks clockwise from ``md5(key)`` to the next
    point."""

    def __init__(self, shard_ids: Iterable[str],
                 replicas: int = RING_REPLICAS):
        self.shard_ids = list(shard_ids)
        self.replicas = max(1, int(replicas))
        if not self.shard_ids:
            raise ValueError("ShardMap needs at least one shard id")
        if len(set(self.shard_ids)) != len(self.shard_ids):
            raise ValueError(f"duplicate shard ids in {self.shard_ids!r}")
        points = sorted((self._point(f"{sid}#{r}"), sid)
                        for sid in self.shard_ids
                        for r in range(self.replicas))
        self._points = [p for p, _ in points]
        self._owners = [s for _, s in points]

    @staticmethod
    def _point(key: str) -> int:
        # hashlib, not hash(): Python's str hash is salted per process,
        # which would re-deal the ring on every restart.
        return int.from_bytes(
            hashlib.md5(key.encode("utf-8")).digest()[:8], "big")

    def shard_for(self, key: str) -> str:
        i = bisect_right(self._points, self._point(str(key)))
        return self._owners[i if i < len(self._points) else 0]

    def spread(self, keys: Iterable[str]) -> Dict[str, int]:
        """Key count per shard."""
        out = {sid: 0 for sid in self.shard_ids}
        for k in keys:
            out[self.shard_for(k)] += 1
        return out


def routing_key(topic: str, payload: Any) -> str:
    """The stable per-frame routing key of a routed topic (see the module
    docstring).  An unrecognized payload routes by the topic name, so all
    frames of an unknown topic share one shard and stay ordered."""
    if hasattr(payload, "to_dict"):
        payload = payload.to_dict()
    if isinstance(payload, (bytes, bytearray)):
        # Pre-encoded frames carry no inspectable key; identical bytes (a
        # redelivered frame) still hash identically.
        return hashlib.md5(bytes(payload)).hexdigest()
    if not isinstance(payload, Mapping):
        return topic
    item = payload.get("work_item") or payload.get("item")
    if isinstance(item, Mapping):
        url = str(item.get("url") or "")
        if url:
            return channel_of(url)
        if item.get("id"):
            return str(item["id"])
    result = payload.get("work_result") or payload.get("result")
    if isinstance(result, Mapping) and result.get("work_item_id"):
        return str(result["work_item_id"])
    for key in ("work_item_id", "post_uid", "batch_id", "media_id"):
        if payload.get(key):
            return str(payload[key])
    return topic


def shard_spool_dirs(base_dir: str,
                     shard_ids: Iterable[str]) -> Dict[str, str]:
    """One spool (or outbox-spill) directory per shard under
    ``base_dir``: distinct by construction, validated anyway."""
    dirs = {sid: os.path.join(base_dir, sid) for sid in shard_ids}
    validate_shard_spool_dirs(dirs)
    return dirs


def validate_shard_spool_dirs(dirs_by_shard: Mapping[str, str]) -> None:
    """Reject shared or empty per-shard WAL directories: one spool across
    two shards lets each generation replay the other's frames (duplicate
    delivery), and an empty one is durability that silently is not."""
    dirs = dict(dirs_by_shard)
    empty = sorted(sid for sid, d in dirs.items() if not str(d or "").strip())
    if empty:
        raise ValueError(
            f"bus durability is enabled but shard(s) {', '.join(empty)} "
            f"have no spool directory — every shard needs its OWN WAL dir")
    normalized: Dict[str, str] = {}
    for sid, d in dirs.items():
        key = os.path.normpath(os.path.abspath(str(d)))
        if key in normalized:
            raise ValueError(
                f"bus shards {normalized[key]!r} and {sid!r} share one "
                f"spool directory {d!r} — a shared WAL cross-contaminates "
                f"crash recovery; give every shard its own directory")
        normalized[key] = sid


class _BroadcastDedupe:
    """Bounded seen-set of broadcast ids: the N shard copies of one
    fan-out frame collapse to one handler delivery (the newest
    :data:`DEDUPE_WINDOW` ids are remembered)."""

    def __init__(self):
        self._seen: set = set()
        self._order: deque = deque()
        self._lock = threading.Lock()

    def first_sighting(self, bcast_id: str) -> bool:
        with self._lock:
            if bcast_id in self._seen:
                return False
            self._seen.add(bcast_id)
            self._order.append(bcast_id)
            while len(self._order) > DEDUPE_WINDOW:
                self._seen.discard(self._order.popleft())
            return True


class PartitionedBus:
    """N bus endpoints behind the one-bus interface.

    ``endpoints`` maps shard id -> transport (a ``RemoteBus`` dialling that
    shard's broker, or an in-process server).  Publishes flow through one
    :class:`DurableOutbox` per shard, whose breaker target is the shard id.

    A routed topic's handler is registered on every shard (competing
    consumers per shard queue); a broadcast topic's handler is wrapped in
    a deduping one-argument handler on every shard.  Whether a handler
    acks by hand is read from its signature on each endpoint, as
    `RemoteBus` reads it; a manual-ack handler on a broadcast topic is
    refused.
    """

    def __init__(self, endpoints: Mapping[str, Any],
                 shard_map: Optional[ShardMap] = None,
                 outbox: Optional[Callable[[str], OutboxConfig]] = None,
                 name: str = "pbus",
                 registry: MetricsRegistry = REGISTRY):
        if not endpoints:
            raise ValueError("PartitionedBus needs at least one endpoint")
        self._endpoints: Dict[str, Any] = dict(endpoints)
        self.shard_map = shard_map or ShardMap(list(self._endpoints))
        extra = set(self.shard_map.shard_ids) ^ set(self._endpoints)
        if extra:
            raise ValueError(
                f"shard map and endpoints disagree on shard ids: "
                f"{sorted(extra)}")
        self.name = name
        self._lock = threading.Lock()
        self._pull_topics: List[str] = []
        self._routed_counts: Dict[tuple, int] = {}
        self._broadcast_count = 0
        self.m_routed = registry.counter(
            "bus_shard_frames_total",
            "frames routed to one shard of the partitioned bus "
            "(bus/partition.py; key = routing_key)")
        self.m_broadcast = registry.counter(
            "bus_shard_broadcast_total",
            "fan-out frames broadcast to every shard of the "
            "partitioned bus")
        cfgs = {sid: (outbox(sid) if callable(outbox) else OutboxConfig())
                for sid in self._endpoints}
        spill = {sid: c.dir for sid, c in cfgs.items() if c.dir}
        if spill:
            missing = sorted(set(self._endpoints) - set(spill))
            if missing:
                raise ValueError(
                    f"outbox spill WALs configured for only part of the "
                    f"fleet (shard(s) {', '.join(missing)} have none) — "
                    f"durability must cover every shard or none")
            validate_shard_spool_dirs(spill)
        self._outboxes: Dict[str, DurableOutbox] = {
            sid: DurableOutbox(ep.publish, cfgs[sid], name=f"{name}-{sid}",
                               registry=registry, breaker_target=sid)
            for sid, ep in self._endpoints.items()}

    # -- publish side --------------------------------------------------------
    def publish(self, topic: str, payload: Any) -> None:
        # The dict form first, then the trace parent stamped here (the
        # flusher threads have no span context): one stamp keeps the N
        # broadcast copies identical.
        if hasattr(payload, "to_dict"):
            payload = payload.to_dict()
        payload = trace.inject(payload)
        if topic in BROADCAST_TOPICS:
            self._broadcast(topic, payload)
            return
        sid = self.shard_map.shard_for(routing_key(topic, payload))
        self._outboxes[sid].publish(topic, payload)
        self.m_routed.labels(shard=sid, topic=topic).inc()
        with self._lock:
            self._routed_counts[(sid, topic)] = \
                self._routed_counts.get((sid, topic), 0) + 1

    def _broadcast(self, topic: str, payload: Any) -> None:
        if isinstance(payload, dict):
            payload = {**payload, _BCAST_KEY: uuid.uuid4().hex}
        # One delivered copy is delivery (subscribers attach to every shard
        # and dedupe), so only a rejection by every target raises: raising
        # after siblings enqueued would make the caller retry a frame that
        # will be delivered, under a fresh broadcast id.  A shard whose
        # breaker is open is skipped, not parked into: a copy parked for
        # minutes outlives the dedupe window and would replay as a stale
        # duplicate.  With every breaker open, every shard buffers.
        open_shards = {sid for sid, ob in self._outboxes.items()
                       if ob.circuit_state == "open"}
        targets = [sid for sid in self._endpoints
                   if sid not in open_shards] or list(self._endpoints)
        errors: List[tuple] = []
        for sid in targets:
            try:
                self._outboxes[sid].publish(topic, payload)
            except Exception as e:  # OutboxFull, a closed outbox
                errors.append((sid, e))
        if len(errors) == len(targets):
            raise errors[0][1]
        if errors:
            logger.warning(
                "broadcast on %s skipped %d/%d shard outbox(es) (%s); the "
                "live copies still deliver", topic, len(errors),
                len(targets), "; ".join(f"{sid}: {e}" for sid, e in errors))
        with self._lock:
            self._broadcast_count += 1
        self.m_broadcast.labels(topic=topic).inc()

    def shard_for_key(self, key: str) -> str:
        return self.shard_map.shard_for(key)

    # -- subscribe side ------------------------------------------------------
    def subscribe(self, topic: str, handler: Callable[..., None]) -> None:
        if topic in BROADCAST_TOPICS:
            from .grpc_bus import _wants_ack

            if _wants_ack(handler):
                raise ValueError(
                    f"manual-ack subscription on broadcast topic "
                    f"{topic!r}: fan-out frames are auto-ack by design")
            handler = self._dedupe_wrapper(handler)
        for ep in self._endpoints.values():
            ep.subscribe(topic, handler)

    def _dedupe_wrapper(self, handler: Callable[[Any], None]
                        ) -> Callable[[Any], None]:
        # No span here: the endpoint's own dispatch already wraps the
        # delivery in `bus.deliver`.
        dedupe = _BroadcastDedupe()

        def _deliver(payload: Any) -> None:
            if isinstance(payload, dict):
                bcast_id = payload.get(_BCAST_KEY)
                if bcast_id is not None:
                    if not dedupe.first_sighting(str(bcast_id)):
                        return  # another shard's copy already delivered
                    payload = {k: v for k, v in payload.items()
                               if k != _BCAST_KEY}
            handler(payload)

        return _deliver

    # -- the rest of the bus interface ---------------------------------------
    def _each(self, method: str):
        """(shard id, bound method) of every endpoint that has it."""
        for sid, ep in self._endpoints.items():
            fn = getattr(ep, method, None)
            if callable(fn):
                yield sid, fn

    def enable_pull(self, topic: str) -> None:
        with self._lock:
            if topic not in self._pull_topics:
                self._pull_topics.append(topic)
        for _, fn in self._each("enable_pull"):
            fn(topic)

    def pending_count(self, topic: str) -> int:
        return sum(int(fn(topic)) for _, fn in self._each("pending_count"))

    def flush_local(self, timeout_s: float = 5.0) -> bool:
        ok = True
        for _, fn in self._each("flush_local"):
            ok = fn(timeout_s) and ok
        return ok

    def drain(self, timeout_s: float = 30.0, poll_s: float = 0.2) -> bool:
        """Outboxes first (a parked frame is work the brokers cannot see
        yet), then every shard against one shared deadline."""
        deadline = time.monotonic() + timeout_s
        ok = self.drain_outboxes(timeout_s)
        for _, fn in self._each("drain"):
            left = max(0.1, deadline - time.monotonic())
            ok = fn(timeout_s=left, poll_s=poll_s) and ok
        return ok

    def dlq_snapshot(self, topic: Optional[str] = None,
                     id: Optional[str] = None) -> Dict[str, Any]:
        """Merged ``/dlq`` body: per-shard bodies under ``shards`` and a
        top-level ``topics`` fold (counts summed, entries stamped with
        their shard), so the DLQ tool reads a sharded broker as one."""
        shards: Dict[str, Any] = {}
        merged: Dict[str, Any] = {}
        enabled = False
        total = 0
        entry = None
        for sid, fn in self._each("dlq_snapshot"):
            body = fn(topic=topic, id=id)
            shards[sid] = body
            enabled = enabled or bool(body.get("enabled"))
            total += int(body.get("dead_letters_total", 0) or 0)
            if body.get("entry") is not None and entry is None:
                entry = {**body["entry"], "shard": sid}
            for t, info in (body.get("topics") or {}).items():
                agg = merged.setdefault(
                    t, {"count": 0, "pending": 0, "entries": []})
                agg["count"] += int(info.get("count", 0) or 0)
                agg["pending"] += int(info.get("pending", 0) or 0)
                agg["entries"].extend(
                    {**e, "shard": sid} if isinstance(e, dict) else e
                    for e in info.get("entries") or [])
        out = {"enabled": enabled, "sharded": True,
               "dead_letters_total": total, "topics": merged,
               "shards": shards}
        if entry is not None:
            out["entry"] = entry
        return out

    # -- failover and introspection ------------------------------------------
    def shard_outboxes(self) -> List[DurableOutbox]:
        return list(self._outboxes.values())

    def outbox_depth(self) -> int:
        return sum(ob.depth() for ob in self._outboxes.values())

    def drain_outboxes(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        ok = True
        for ob in self._outboxes.values():
            ok = ob.drain(timeout_s=max(0.1, deadline - time.monotonic())) \
                and ok
        return ok

    def routed_counts(self, topic: Optional[str] = None) -> Dict[str, int]:
        """Frames routed per shard (optionally for one topic)."""
        with self._lock:
            out = {sid: 0 for sid in self._endpoints}
            for (sid, t), n in self._routed_counts.items():
                if topic is None or t == topic:
                    out[sid] += n
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The ``/shards`` body: per shard its address, generation,
        liveness, outbox depth and bound, breaker state, routed frames and
        pending frames per pull topic; the ring; the broadcast count."""
        with self._lock:
            pull_topics = list(self._pull_topics)
            routed = dict(self._routed_counts)
            broadcast = self._broadcast_count
        shards: Dict[str, Any] = {}
        for sid, ep in self._endpoints.items():
            ob = self._outboxes[sid]
            pending: Dict[str, int] = {}
            fn = getattr(ep, "pending_count", None)
            if callable(fn):
                for t in pull_topics:
                    try:
                        pending[t] = int(fn(t))
                    except Exception as e:
                        logger.debug("pending_count(%s) on %s failed: %s",
                                     t, sid, e)
            shards[sid] = {
                "address": getattr(ep, "address", None)
                or getattr(ep, "target", None),
                "generation": getattr(ep, "generation", None),
                # Known only for a handle that holds its server.
                "alive": (ep.server is not None) if hasattr(ep, "server")
                else None,
                "outbox_depth": ob.depth(),
                "outbox_capacity": ob.cfg.max_frames,
                "breaker": ob.circuit_state,
                "routed_frames": {t: n for (s, t), n in routed.items()
                                  if s == sid},
                "pending": pending,
            }
        return {
            "name": self.name,
            "shards": shards,
            "ring": {"shard_ids": list(self.shard_map.shard_ids),
                     "replicas": self.shard_map.replicas},
            "broadcast_frames": broadcast,
            "pull_topics": pull_topics,
            "outbox_depth_total": sum(
                s["outbox_depth"] for s in shards.values()),
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        for _, fn in self._each("start"):
            fn()

    def close(self, drain_s: float = 2.0) -> None:
        for ob in self._outboxes.values():
            ob.close(drain_s=drain_s)
        for sid, fn in self._each("close"):
            try:
                fn()
            except Exception as e:
                logger.warning("shard %s close error: %s", sid, e)

"""gRPC transport: the bus between processes.

The port's copy of the core of the reference's `distributed_crawler_tpu/
bus/grpc_bus.py`, wire-compatible with it: the same service
(``dct.bus.Bus``), the same three raw-bytes methods, the same envelope
(``topic \\0 payload``) and the same JSON payloads, so a port worker can
pull from a reference broker and the other way round.

- ``Publish`` (unary): topic + payload -> ack;
- ``Pull`` (server-streaming): competing consumers pull a topic's queue,
  each frame prefixed with its delivery id;
- ``Ack`` (unary): ``topic \\0 delivery \\0 ok|fail`` closes the
  at-least-once loop.

A pulled frame stays in flight until acked.  It is requeued when its
stream dies, when the consumer nacks, or when ``ack_timeout_s`` passes;
after ``max_attempts`` deliveries it is dead-lettered: counted in
``bus_dead_letters_total{topic}``, flight-recorded and, with a spool,
persisted to the dead-letter queue (`bus/spool.py`; ``/dlq``, and
``python -m distributed_crawler_tpu_torch.bus.dlq`` lists, inspects and
replays it).  Topics that are not pull-enabled go to the server's local
subscribers (fan-out), each topic on a dispatch thread of its own with
bounded retries; a frame with neither a handler nor a pull queue is
counted and, with a spool, held in the DLQ with reason ``no_route`` (up to
:data:`UNROUTED_SPOOL_CAP` per topic).

Broker durability (``spool_dir``): every pull-topic frame is journaled in
a per-topic WAL, and a new server over the same directory rebuilds the
queued and unacked-in-flight frames, attempt counts and frame ids
preserved, so a broker crash redelivers instead of losing.  ``kill()``
drops all RAM state as a SIGKILL would.  The publisher half is
`bus/outbox.py`: ``RemoteBus(outbox=OutboxConfig(...))`` buffers publishes
through an outage.  The client rebuilds a channel that keeps failing
(``GrpcBusClient.REBUILD_AFTER_FAILURES``).  Sharding over several brokers
is `bus/partition.py`.

``grpc`` is imported inside the functions that use it, never when the
module is imported: a deployment without ``grpcio`` can run every mode
that has no bus address.
"""

from __future__ import annotations

import inspect
import json
import logging
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from ..utils import flight, resilience, trace
from ..utils.metrics import REGISTRY, MetricsRegistry
from .inmemory import serialize_payload
from .outbox import DurableOutbox, OutboxConfig
from .spool import BusSpool, new_frame_id

logger = logging.getLogger("dct.torch.bus.grpc")

SERVICE_NAME = "dct.bus.Bus"
MAX_FRAME_BYTES = 201 * 1024 * 1024

DEFAULT_ACK_TIMEOUT_S = 300.0
DEFAULT_MAX_ATTEMPTS = 5
# Unrouted frames held in the DLQ per topic: a topic nobody consumes must
# not grow the spool without bound.
UNROUTED_SPOOL_CAP = 1024

_TOPIC_SEP = b"\x00"


def _encode_envelope(topic: str, payload: bytes) -> bytes:
    return topic.encode("utf-8") + _TOPIC_SEP + payload


def _decode_envelope(data: bytes) -> tuple:
    topic, _, payload = data.partition(_TOPIC_SEP)
    return topic.decode("utf-8"), payload


def _identity(b: bytes) -> bytes:
    return b


def _channel_options():
    return [("grpc.max_receive_message_length", MAX_FRAME_BYTES),
            ("grpc.max_send_message_length", MAX_FRAME_BYTES)]


@dataclass
class _QueuedFrame:
    payload: bytes
    attempts: int = 0
    # Stable spool frame id (minted at enqueue, kept across requeues and
    # broker generations); "" when the server runs without a spool.
    fid: str = ""


@dataclass
class _Inflight:
    payload: bytes
    attempts: int
    deadline: float
    stream_id: int
    fid: str = ""


@dataclass
class _TopicQueue:
    """Pull queue + in-flight ledger for one topic."""

    q: "queue.Queue[_QueuedFrame]" = field(default_factory=queue.Queue)
    inflight: Dict[str, _Inflight] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)


class GrpcBusServer:
    """Hosts topics: local subscribers receive published payloads, and
    remote pullers stream a pull-enabled topic's queue with per-delivery
    acks."""

    def __init__(self, address: str = "127.0.0.1:50551",
                 ack_timeout_s: float = DEFAULT_ACK_TIMEOUT_S,
                 max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                 spool_dir: Optional[str] = None,
                 registry: MetricsRegistry = REGISTRY):
        import grpc
        from concurrent import futures

        self.address = address
        self.ack_timeout_s = ack_timeout_s
        self.max_attempts = max_attempts
        self._spool = BusSpool(spool_dir) if spool_dir else None
        self._killed = False
        self.m_dead = registry.counter(
            "bus_dead_letters_total",
            "frames dead-lettered per topic (exhausted max_attempts or a "
            "local handler's retry budget)")
        self.m_redeliveries = registry.counter(
            "bus_redeliveries_total",
            "frames requeued for redelivery per topic (nack, ack timeout, "
            "or pull-stream death)")
        self.m_unrouted = registry.counter(
            "bus_dropped_no_route_total",
            "publishes that reached a topic with no handler and no pull "
            "queue (held in the DLQ spool when durability is on, dropped "
            "otherwise)")
        # WARN once per topic, then debug.
        self._unrouted_warned: set = set()
        # Unrouted frames held in the DLQ, per topic, up to the cap.
        self._unrouted_spooled: Dict[str, int] = {}
        self._local_retry = resilience.RetryPolicy(
            max_attempts=max_attempts, base_delay_s=0.05, max_delay_s=0.5,
            jitter=0.0, retry_after_cap_s=2.0)
        self._handlers: Dict[str, list] = {}
        self._pull_queues: Dict[str, _TopicQueue] = {}
        self._lock = threading.RLock()
        self._stream_counter = 0
        self.dead_letters = 0
        # Local-subscriber dispatch: a queue and a thread per topic, so
        # handlers run off the gRPC threads, with bounded retries.
        self._local_queues: Dict[str, "queue.Queue"] = {}
        self._local_threads: Dict[str, threading.Thread] = {}
        self._local_idle = threading.Condition()
        self._local_inflight = 0
        self._stop = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        self._executor = futures.ThreadPoolExecutor(max_workers=8)
        self._server = grpc.server(self._executor,
                                   options=_channel_options())
        handlers = {
            "Publish": grpc.unary_unary_rpc_method_handler(
                self._publish_rpc, request_deserializer=_identity,
                response_serializer=_identity),
            "Pull": grpc.unary_stream_rpc_method_handler(
                self._pull_rpc, request_deserializer=_identity,
                response_serializer=_identity),
            "Ack": grpc.unary_unary_rpc_method_handler(
                self._ack_rpc, request_deserializer=_identity,
                response_serializer=_identity),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))
        self.bound_port = self._server.add_insecure_port(address)
        if self._spool is not None:
            self._rebuild_from_spool()

    def _rebuild_from_spool(self) -> None:
        """Resume: rebuild every spooled topic's queue (queued and
        unacked-in-flight frames of the dead generation, attempt counts
        kept) before the first RPC can land."""
        # The unrouted-hold cap counts what is already on disk, so a
        # restart loop does not grow the DLQ by a cap's worth per
        # generation.
        for topic in self._spool.dlq.topics():
            held = sum(1 for e in self._spool.dlq.entries(topic)
                       if e.reason == "no_route" and not e.replayed)
            if held:
                self._unrouted_spooled[topic] = held
        restored = {topic: self._ensure_topic_queue(topic).q.qsize()
                    for topic in self._spool.existing_topics()}
        if restored:
            flight.record("bus_resume", address=self.address,
                          restored=restored, frames=sum(restored.values()))
            logger.info("bus spool resume: %d frame(s) restored across %d "
                        "topic(s): %s", sum(restored.values()),
                        len(restored), restored)

    def _ensure_topic_queue(self, topic: str) -> _TopicQueue:
        """Create a pull queue on first use; with a spool, the topic's live
        WAL frames are replayed into it exactly once."""
        with self._lock:
            tq = self._pull_queues.get(topic)
            if tq is None:
                tq = _TopicQueue()
                if self._spool is not None:
                    for frame in self._spool.replay(topic):
                        tq.q.put(_QueuedFrame(frame.payload, frame.attempts,
                                              frame.fid))
                self._pull_queues[topic] = tq
            return tq

    # --- service ----------------------------------------------------------
    def _publish_rpc(self, request: bytes, context) -> bytes:
        if self._killed:
            raise RuntimeError("bus server killed")
        topic, payload = _decode_envelope(request)
        with self._lock:
            has_handlers = bool(self._handlers.get(topic))
            tq = self._pull_queues.get(topic)
            lq = self._local_queues.get(topic) if has_handlers else None
        if tq is None and lq is None:
            self._record_unrouted(topic, payload)
        if tq is not None:
            fid = ""
            if self._spool is not None:
                # WAL append before the in-memory enqueue: a crash between
                # the two redelivers on restart instead of acking a frame
                # that never survived.
                fid = self._spool.enqueue(topic, payload)
            tq.q.put(_QueuedFrame(payload, 0, fid))
        if lq is not None:
            try:
                decoded = json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                # Undecodable payloads are dropped, never retried.
                logger.error("dropping undecodable message on %s", topic)
                return b"ok"
            with self._local_idle:
                self._local_inflight += 1
            lq.put(decoded)
        return b"ok"

    def _record_unrouted(self, topic: str, payload: bytes) -> None:
        self.m_unrouted.labels(topic=topic).inc()
        spooled = False
        if self._spool is not None:
            with self._lock:
                n = self._unrouted_spooled.get(topic, 0)
                spooled = n < UNROUTED_SPOOL_CAP
                if spooled:
                    self._unrouted_spooled[topic] = n + 1
            if spooled:
                self._spool.dlq.append(topic, new_frame_id(), payload,
                                       attempts=0, reason="no_route")
        flight.record("bus_unrouted", topic=topic, spooled=spooled)
        first = topic not in self._unrouted_warned
        self._unrouted_warned.add(topic)
        log = logger.warning if first else logger.debug
        log("no route for message on %s (no handler, no pull queue); %s",
            topic,
            "held in the DLQ spool" if spooled else
            ("DLQ spool cap reached; frame dropped" if self._spool
             is not None else "frame DROPPED (no spool configured)"))

    def _local_dispatch_loop(self, topic: str, lq: "queue.Queue") -> None:
        # Drains until the queue is empty even after _stop: a Publish
        # answered b"ok" must reach the local handlers across close().
        while True:
            if self._killed:
                return  # kill(): RAM state is gone, nothing drains
            try:
                decoded = lq.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                with self._lock:
                    handlers = list(self._handlers.get(topic, []))
                with trace.payload_span("bus.deliver", decoded, topic=topic,
                                        transport="grpc-local"):
                    for handler in handlers:
                        try:
                            resilience.retry_call(
                                handler, decoded, retry=self._local_retry,
                                op=f"bus.local.{topic}", stop=self._stop)
                        except Exception as e:
                            self._dead_letter(
                                topic, "",
                                json.dumps(decoded,
                                           default=str).encode("utf-8"),
                                self.max_attempts,
                                reason=f"local_handler: {e}")
            finally:
                with self._local_idle:
                    self._local_inflight -= 1
                    if self._local_inflight == 0:
                        self._local_idle.notify_all()

    def flush_local(self, timeout_s: float = 5.0) -> bool:
        """Block until every queued local delivery has been dispatched;
        False on timeout."""
        with self._local_idle:
            return self._local_idle.wait_for(
                lambda: self._local_inflight == 0, timeout=timeout_s)

    def _sweep_loop(self) -> None:
        # Ack deadlines fire even with no active puller.
        interval = max(0.05, min(1.0, self.ack_timeout_s / 4.0))
        while not self._stop.wait(interval):
            with self._lock:
                topics = list(self._pull_queues.items())
            for topic, tq in topics:
                self._sweep_expired(topic, tq)

    def _spool_op(self, fn, *args) -> None:
        """Run a spool mutation, tolerating a spool closed by kill(): a
        requeue or ack racing the kill does not commit, so the frame stays
        journaled in its earlier state and the next generation redelivers
        it, as after a real SIGKILL mid-write.  Any other spool failure
        raises."""
        try:
            fn(*args)
        except RuntimeError:
            if not self._killed:
                raise
            logger.debug("spool op skipped: broker killed mid-%s",
                         getattr(fn, "__name__", "op"))

    def _dead_letter(self, topic: str, fid: str, payload: bytes,
                     attempts: int, reason: str) -> None:
        """A frame leaves the delivery loop for good: counted, flight-
        recorded and, with a spool, persisted to the topic's dead-letter
        queue (without one it is dropped)."""
        with self._lock:
            self.dead_letters += 1
        self.m_dead.labels(topic=topic).inc()
        persisted = self._spool is not None and not self._killed
        if persisted:
            fid = self._spool.dead(topic, fid, payload, attempts, reason)
        flight.record("dead_letter", topic=topic, frame=fid,
                      attempts=attempts, reason=reason, persisted=persisted)
        logger.error(
            "dead-lettering frame on %s after %d attempts (id=%s; %s): %s",
            topic, attempts, fid or "-",
            "persisted to DLQ spool" if persisted else "DROPPED", reason)

    def _requeue_or_drop(self, topic: str, tq: _TopicQueue,
                         inf: _Inflight) -> None:
        """``inf`` has been removed from the in-flight map by the
        caller."""
        if inf.attempts + 1 >= self.max_attempts:
            self._dead_letter(topic, inf.fid, inf.payload, inf.attempts + 1,
                              reason="max_attempts")
            return
        attempts = inf.attempts + 1
        self.m_redeliveries.labels(topic=topic).inc()
        if self._spool is not None:
            self._spool_op(self._spool.requeue, topic, inf.fid, attempts)
        tq.q.put(_QueuedFrame(inf.payload, attempts, inf.fid))

    def _sweep_expired(self, topic: str, tq: _TopicQueue) -> None:
        now = time.monotonic()
        with tq.lock:
            expired = [(d, i) for d, i in tq.inflight.items()
                       if i.deadline <= now]
            for d, _ in expired:
                del tq.inflight[d]
        for d, inf in expired:
            logger.warning("ack timeout on %s (id=%s); requeueing", topic, d)
            self._requeue_or_drop(topic, tq, inf)

    def _pull_rpc(self, request: bytes, context) -> Iterator[bytes]:
        topic = request.decode("utf-8")
        tq = self._ensure_topic_queue(topic)
        with self._lock:
            self._stream_counter += 1
            stream_id = self._stream_counter
        try:
            while context.is_active():
                self._sweep_expired(topic, tq)
                # Pop and register in flight atomically: a frame popped but
                # not registered would be invisible to pending_count().
                with tq.lock:
                    try:
                        frame = tq.q.get_nowait()
                    except queue.Empty:
                        frame = None
                    else:
                        delivery_id = uuid.uuid4().hex
                        tq.inflight[delivery_id] = _Inflight(
                            frame.payload, frame.attempts,
                            time.monotonic() + self.ack_timeout_s,
                            stream_id, frame.fid)
                if frame is None:
                    time.sleep(0.05)
                    continue
                try:
                    yield delivery_id.encode("ascii") + _TOPIC_SEP + \
                        frame.payload
                except BaseException:
                    # Cancelled between pop and consume: requeue the frame
                    # without charging an attempt, then re-raise.
                    with tq.lock:
                        inf = tq.inflight.pop(delivery_id, None)
                    if inf is not None:
                        tq.q.put(_QueuedFrame(inf.payload, inf.attempts,
                                              inf.fid))
                    raise
        finally:
            # Stream gone: everything it delivered but never acked goes
            # back on the queue.
            with tq.lock:
                orphaned = [(d, i) for d, i in tq.inflight.items()
                            if i.stream_id == stream_id]
                for d, _ in orphaned:
                    del tq.inflight[d]
            for d, inf in orphaned:
                logger.info("stream for %s closed with unacked frame "
                            "(id=%s); requeueing", topic, d)
                self._requeue_or_drop(topic, tq, inf)

    def _ack_rpc(self, request: bytes, context) -> bytes:
        topic_b, _, rest = request.partition(_TOPIC_SEP)
        delivery_b, _, status = rest.partition(_TOPIC_SEP)
        topic = topic_b.decode("utf-8")
        with self._lock:
            tq = self._pull_queues.get(topic)
        if tq is None:
            return b"unknown-topic"
        with tq.lock:
            inf = tq.inflight.pop(delivery_b.decode("ascii"), None)
        if inf is None:
            return b"unknown-delivery"  # already requeued or expired
        if status != b"ok":
            self._requeue_or_drop(topic, tq, inf)
        elif self._spool is not None:
            # Durably done: the WAL forgets the frame.
            self._spool_op(self._spool.ack, topic, inf.fid)
        return b"ok"

    # --- local wiring -----------------------------------------------------
    def subscribe(self, topic: str,
                  handler: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)
            if topic not in self._local_queues:
                lq: "queue.Queue" = queue.Queue()
                self._local_queues[topic] = lq
                t = threading.Thread(
                    target=self._local_dispatch_loop, args=(topic, lq),
                    daemon=True, name=f"dct-bus-local-{topic}")
                self._local_threads[topic] = t
                t.start()

    def publish(self, topic: str, payload: Any) -> None:
        """Local publish: the same fan-out as a remote Publish, so the
        hosting process can use the server as its bus.  Raises once the
        server is killed (a durable publisher's outbox retries against the
        next generation)."""
        self._publish_rpc(_encode_envelope(
            topic, serialize_payload(trace.inject(payload))), None)

    def enable_pull(self, topic: str) -> None:
        self._ensure_topic_queue(topic)

    def pending_count(self, topic: str) -> int:
        """Queued + in-flight frames of ``topic``."""
        with self._lock:
            tq = self._pull_queues.get(topic)
        if tq is None:
            return 0
        with tq.lock:
            return tq.q.qsize() + len(tq.inflight)

    def drain(self, timeout_s: float = 30.0, poll_s: float = 0.2) -> bool:
        """Block until every pull topic is empty (queued and in flight) or
        the timeout expires; True when drained.  Call before close() in a
        process whose consumers are elsewhere."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                topics = list(self._pull_queues)
            remaining = {t: n for t in topics
                         if (n := self.pending_count(t))}
            if not remaining:
                return True
            if time.monotonic() >= deadline:
                logger.warning(
                    "bus drain timed out with frames pending: %s", remaining)
                return False
            time.sleep(poll_s)

    def dlq_snapshot(self, topic: Optional[str] = None,
                     id: Optional[str] = None) -> Dict[str, Any]:
        """The ``/dlq`` body: per-topic dead-letter counts and the newest
        entries' metadata (the full payload only for an explicit ``id``).
        Answers, empty, without a spool."""
        if self._spool is None:
            return {"enabled": False, "topics": {},
                    "dead_letters_total": self.dead_letters}
        body = self._spool.dlq.snapshot(topic=topic or None, fid=id or None)
        body["enabled"] = True
        body["dead_letters_total"] = self.dead_letters
        return body

    def dlq_replay(self, topic: str, fid: str) -> Dict[str, Any]:
        """Re-drive one dead letter onto its topic: the frame re-enters
        the delivery loop with a fresh attempt budget, and the DLQ entry is
        marked replayed."""
        if self._spool is None:
            raise RuntimeError("dead-letter replay needs a spool_dir")
        entry = self._spool.dlq.get(topic, fid)
        if entry is None:
            raise KeyError(f"no dead letter {fid!r} on topic {topic!r}")
        if entry.reason == "no_route":
            # Release the hold's cap slot before re-publishing: a topic
            # still unrouted re-holds the frame inside the cap.
            with self._lock:
                if self._unrouted_spooled.get(topic, 0) > 0:
                    self._unrouted_spooled[topic] -= 1
        self._publish_rpc(_encode_envelope(topic, entry.payload), None)
        self._spool.dlq.mark_replayed(topic, fid)
        flight.record("dlq_replay", topic=topic, frame=fid)
        return entry.meta()

    def start(self) -> None:
        self._server.start()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         daemon=True, name="dct-bus-sweeper")
        self._sweeper.start()
        logger.info("bus server listening on %s", self.address)

    def kill(self) -> None:
        """Abrupt death, as a SIGKILLed broker process: hard-stop the gRPC
        server and drop all RAM state (queued frames, in-flight ledgers,
        local dispatch queues), with no drain, no local flush and no WAL
        compaction.  What survives is what the spool already journaled; a
        new server over the same ``spool_dir`` is the restart."""
        if self._killed:
            return
        self._killed = True
        pending = {t: n for t in list(self._pull_queues)
                   if (n := self.pending_count(t))}
        flight.record("bus_kill", address=self.address, pending=pending)
        logger.warning("bus server KILLED with pending frames: %s",
                       pending or "none")
        if self._spool is not None:
            # Closed first: a racing publish fails loudly (its outbox
            # retries against the next generation) rather than land in a
            # WAL the next generation has already read, and the aborted
            # streams' requeues below journal nothing, as after a SIGKILL.
            self._spool.close(compact=False)
        self._server.stop(None).wait(5.0)  # in-flight RPCs are aborted
        self._executor.shutdown(wait=True)
        self._stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=2.0)
        for t in self._local_threads.values():
            t.join(timeout=2.0)

    def close(self) -> None:
        if self._killed:
            return  # already hard-stopped: nothing left to drain
        # Wait for the server to terminate BEFORE setting _stop, or a
        # dispatch thread could exit on an empty queue while an in-flight
        # Publish is about to enqueue a frame already answered b"ok".
        self._server.stop(0.5).wait(5.5)
        # The RPC threads too: a stopped server's streams end within one
        # poll, and no thread of the server outlives close().
        self._executor.shutdown(wait=True)
        self._stop.set()          # dispatch loops drain, then exit
        if not self.flush_local(timeout_s=5.0):
            with self._local_idle:
                remaining = self._local_inflight
            logger.error("bus closed with %d undelivered local "
                         "message(s)", remaining)
        if self._sweeper is not None:
            self._sweeper.join(timeout=2.0)
        for t in self._local_threads.values():
            t.join(timeout=2.0)
        if self._spool is not None:
            self._spool.close(compact=True)


class GrpcBusClient:
    """Publishes payloads to, and pulls frames from, a bus server.

    A channel hammered with RPCs while its broker is down can stay stuck
    in grpcio's connect machinery after a new broker listens on the same
    address, so the client counts consecutive unary transport failures and
    rebuilds the channel (at most once per ``REBUILD_COOLDOWN_S``) once
    they reach ``REBUILD_AFTER_FAILURES``.  The channel's own reconnect
    backoff is capped at 5 s (from grpc's default of about 2 minutes), so
    a restarted broker is dialled within seconds."""

    REBUILD_AFTER_FAILURES = 8
    REBUILD_COOLDOWN_S = 2.0

    def __init__(self, target: str = "127.0.0.1:50551"):
        self.target = target
        self._state_lock = threading.Lock()
        self._consecutive_failures = 0
        self._last_rebuild = 0.0
        self.rebuilds = 0
        self._build_channel()

    def _build_channel(self) -> None:
        import grpc

        self._channel = grpc.insecure_channel(
            self.target, options=_channel_options() + [
                ("grpc.min_reconnect_backoff_ms", 200),
                ("grpc.max_reconnect_backoff_ms", 5000)])
        self._publish = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Publish", request_serializer=_identity,
            response_deserializer=_identity)
        self._pull = self._channel.unary_stream(
            f"/{SERVICE_NAME}/Pull", request_serializer=_identity,
            response_deserializer=_identity)
        self._ack = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Ack", request_serializer=_identity,
            response_deserializer=_identity)

    def _note_failure(self) -> None:
        with self._state_lock:
            self._consecutive_failures += 1
            now = time.monotonic()
            rebuild = (self._consecutive_failures
                       >= self.REBUILD_AFTER_FAILURES
                       and now - self._last_rebuild >= self.REBUILD_COOLDOWN_S)
            if rebuild:
                self._last_rebuild = now
                self._consecutive_failures = 0
                self.rebuilds += 1
                old = self._channel
                self._build_channel()
        if rebuild:
            logger.warning(
                "bus channel to %s rebuilt after sustained transport "
                "failure (rebuild #%d); live pull streams redial onto the "
                "new one", self.target, self.rebuilds)
            try:
                old.close()
            except Exception as e:  # best effort: the channel is dead
                logger.debug("old channel close failed: %s", e)

    def _unary(self, stub_name: str, request: bytes) -> bytes:
        import grpc

        stub = getattr(self, stub_name)
        try:
            response = stub(request)
        except grpc.RpcError:
            self._note_failure()
            raise
        with self._state_lock:
            self._consecutive_failures = 0
        return response

    def publish(self, topic: str, payload: Any) -> None:
        # The envelope crosses a process boundary here: the hop the
        # parent-span stamp exists for.
        self._unary("_publish", _encode_envelope(
            topic, serialize_payload(trace.inject(payload))))

    def publish_frame(self, topic: str, frame: bytes) -> None:
        """Publish already-encoded payload bytes (a dead letter's, on
        replay)."""
        self._unary("_publish", _encode_envelope(topic, frame))

    def pull(self, topic: str) -> Iterator[Tuple[str, bytes]]:
        """Server-streaming pull; yields (delivery_id, payload).  Closing
        the generator cancels the RPC, which requeues any unacked
        deliveries server-side."""
        call = self._pull(topic.encode("utf-8"))
        try:
            for framed in call:
                delivery_b, _, payload = framed.partition(_TOPIC_SEP)
                yield delivery_b.decode("ascii"), payload
        finally:
            call.cancel()

    def ack(self, topic: str, delivery_id: str, ok: bool = True) -> None:
        self._unary("_ack", topic.encode("utf-8") + _TOPIC_SEP +
                    delivery_id.encode("ascii") + _TOPIC_SEP +
                    (b"ok" if ok else b"fail"))

    def close(self) -> None:
        self._channel.close()


def _wants_ack(handler: Callable) -> bool:
    """True if the handler takes two or more named positional parameters:
    manual-ack mode, ``handler(payload, ack)``.  A bare ``*args`` handler
    is not manual-ack (it would never ack)."""
    try:
        sig = inspect.signature(handler)
    except (TypeError, ValueError):
        return False
    params = [p for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(params) >= 2


class RemoteBus:
    """An `InMemoryBus`-shaped facade over a `GrpcBusClient` for worker
    processes.  ``publish`` is a Publish RPC; ``subscribe`` starts a puller
    thread that streams the topic's queue (competing consumers) and
    dispatches to local handlers.

    A one-argument handler is retried inline up to ``max_redeliveries``
    times; success acks the frame and final failure nacks it, so the server
    requeues it for another consumer.  A two-argument handler ``(payload,
    ack)`` owns the ack: ``ack(True)`` when the work is durably done,
    ``ack(False)`` to requeue.

    With ``outbox``, every publish goes through a `DurableOutbox` (its
    spill WAL under ``outbox.dir``): a broker outage buffers the publish
    instead of raising it into the caller.
    """

    def __init__(self, target: str = "127.0.0.1:50551",
                 max_redeliveries: int = 3,
                 outbox: Optional[OutboxConfig] = None,
                 registry: MetricsRegistry = REGISTRY):
        self._client = GrpcBusClient(target)
        self.max_redeliveries = max_redeliveries
        self._retry = resilience.RetryPolicy(
            max_attempts=max_redeliveries + 1, base_delay_s=0.0,
            jitter=0.0, retry_after_cap_s=2.0)
        # Reconnect schedule for a dropped pull stream: jittered
        # exponential backoff that resets on a delivered frame.
        self._reconnect = resilience.RetryPolicy(
            max_attempts=1 << 30, base_delay_s=0.1, max_delay_s=2.0,
            multiplier=2.0, jitter=0.25)
        self.outbox: Optional[DurableOutbox] = None
        if outbox is not None:
            self.outbox = DurableOutbox(self._client.publish, outbox,
                                        registry=registry)
        self._handlers: Dict[str, list] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()

    def publish(self, topic: str, payload: Any) -> None:
        if self.outbox is not None:
            self.outbox.publish(topic, payload)
            return
        self._client.publish(topic, payload)

    def subscribe(self, topic: str, handler: Callable[..., None]) -> None:
        """Register ``handler`` for ``topic``; its signature says whether it
        acks manually.  A manual-ack handler owns its topic's deliveries,
        so mixing it with another handler is refused."""
        wants = _wants_ack(handler)
        with self._lock:
            existing = self._handlers.get(topic, [])
            if wants and existing:
                raise ValueError(
                    f"manual-ack handler on '{topic}' would shadow "
                    f"{len(existing)} existing subscriber(s); use a "
                    f"dedicated topic per manual-ack consumer")
            if existing and any(w for _, w in existing):
                raise ValueError(
                    f"topic '{topic}' already has a manual-ack handler; "
                    f"additional subscribers would never receive frames")
            self._handlers.setdefault(topic, []).append((handler, wants))
            if topic in self._threads:
                return
            t = threading.Thread(target=self._pull_loop, args=(topic,),
                                 daemon=True, name=f"dct-bus-pull-{topic}")
            self._threads[topic] = t
            t.start()

    def _pull_loop(self, topic: str) -> None:
        import grpc

        attempt = 0
        while not self._stop.is_set():
            try:
                for delivery_id, frame in self._client.pull(topic):
                    if self._stop.is_set():
                        return
                    attempt = 0  # a delivered frame proves the broker is up
                    self._dispatch(topic, delivery_id, frame)
            except grpc.RpcError as e:
                if self._stop.is_set():
                    return
                delay = self._reconnect.delay_s(attempt)
                attempt = min(attempt + 1, 16)
                logger.warning("pull stream for %s dropped (%s); "
                               "reconnecting in %.2fs", topic,
                               e.code() if hasattr(e, "code") else e, delay)
                self._stop.wait(delay)

    def _safe_ack(self, topic: str, delivery_id: str, ok: bool) -> None:
        import grpc

        if self._stop.is_set():
            # Shutting down: the server requeues the unacked delivery when
            # the stream tears down.
            return
        try:
            self._client.ack(topic, delivery_id, ok)
        except grpc.RpcError as e:
            logger.warning("ack for %s/%s failed: %s", topic, delivery_id, e)
        except ValueError:
            # "Cannot invoke RPC on closed channel!": close() won the race
            # against a dispatching pull thread; the same requeue holds.
            logger.warning("ack for %s/%s skipped: channel closed",
                           topic, delivery_id)

    def _dispatch(self, topic: str, delivery_id: str, frame: bytes) -> None:
        try:
            payload = json.loads(frame.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            logger.error("dropping undecodable message on %s", topic)
            # Never retried: ack so it is not redelivered.
            self._safe_ack(topic, delivery_id, True)
            return
        with self._lock:
            handlers = list(self._handlers.get(topic, []))
        manual = [h for h, wants in handlers if wants]
        if manual:
            handler = manual[0]
            acked = threading.Event()

            def ack(ok: bool = True) -> None:
                if not acked.is_set():
                    acked.set()
                    self._safe_ack(topic, delivery_id, ok)

            with trace.payload_span("bus.deliver", payload, topic=topic,
                                    transport="grpc", manual_ack=True):
                try:
                    handler(payload, ack)
                except Exception as e:
                    logger.warning("handler error on %s: %s", topic, e)
                    ack(False)
            return
        ok = True
        with trace.payload_span("bus.deliver", payload, topic=topic,
                                transport="grpc"):
            for handler, _ in handlers:
                try:
                    resilience.retry_call(
                        handler, payload, retry=self._retry,
                        op=f"bus.remote.{topic}", stop=self._stop)
                except Exception as e:
                    logger.error("handler exhausted redeliveries on %s: %s",
                                 topic, e)
                    ok = False
        # Nack on final failure: the server requeues (charging an attempt)
        # so another consumer can take the frame.
        self._safe_ack(topic, delivery_id, ok)

    def start(self) -> None:
        return None  # threads start on subscribe

    def close(self) -> None:
        self._stop.set()
        if self.outbox is not None:
            # A brief chance for buffered publishes to land; the rest stay
            # in the outbox WAL (when it has one) for the next process.
            self.outbox.close(drain_s=2.0)
        self._client.close()
        for t in self._threads.values():
            t.join(timeout=2.0)

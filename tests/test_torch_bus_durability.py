"""The port's durable bus (`distributed_crawler_tpu_torch/bus/spool.py`,
`bus/outbox.py`, `bus/grpc_bus.py`, `bus/dlq.py`) against the reference's,
on the CPU.

- The reference's `tests/test_bus_durability.py`, case by case, run
  against the port's classes with the same frames: spool replay, torn
  tails, compaction and closed-spool refusal; the dead-letter spool; the
  outbox (buffering through an outage in order, the hard bound, WAL reload
  and compaction, the near-full and low-water marks, `OutboxBus`); broker
  restarts over the spool (queued and in-flight frames, attempt counts,
  DLQ replay, unrouted holds and their cap); `RemoteBus` reconnect; and
  duplicate delivery absorbed by the worker's idempotent writeback.
- Compatibility both ways: each package's `TopicSpool`,
  `DeadLetterSpool` and outbox WAL reader folds the other's files to the
  same frames; each package's `GrpcBusServer` resumes the other's spool
  (queued and in-flight frames with their attempts); the ``/dlq`` bodies
  are equal for the same spool; `tools/dlq.py` lists a port spool and the
  port's `bus.dlq` lists a reference spool, with the same output.
- The port's `TPUWorker` (a tiny encoder on the CPU) across a broker
  generation: the broker is killed mid-stream and restarted over its
  spool, and every row equals an undisturbed run's.

No fixed sleep is a waiting mechanism here: every wait polls against a
deadline of at least 20 s, ports are bound to 0 or taken free, and every
server, client and flusher is closed with a bounded join.
"""

import base64
import json
import os
import threading
import time

import pytest

pytest.importorskip("grpc")
torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

from distributed_crawler_tpu.bus import grpc_bus as jgrpc  # noqa: E402
from distributed_crawler_tpu.bus import outbox as joutbox  # noqa: E402
from distributed_crawler_tpu.bus import spool as jspool  # noqa: E402
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.bus import dlq as tdlq  # noqa: E402
from distributed_crawler_tpu_torch.bus import grpc_bus as tgrpc  # noqa: E402
from distributed_crawler_tpu_torch.bus import outbox as toutbox  # noqa: E402
from distributed_crawler_tpu_torch.bus.codec import RecordBatch  # noqa: E402
from distributed_crawler_tpu_torch.bus.grpc_bus import (  # noqa: E402
    GrpcBusClient,
    GrpcBusServer,
    RemoteBus,
)
from distributed_crawler_tpu_torch.bus.inmemory import (  # noqa: E402
    InMemoryBus,
)
from distributed_crawler_tpu_torch.bus.messages import (  # noqa: E402
    TOPIC_INFERENCE_BATCHES,
)
from distributed_crawler_tpu_torch.bus.outbox import (  # noqa: E402
    DurableOutbox,
    OutboxBus,
    OutboxConfig,
    OutboxFull,
)
from distributed_crawler_tpu_torch.bus.spool import (  # noqa: E402
    COMPACT_EVERY,
    BusSpool,
    DeadLetterSpool,
    TopicSpool,
)
from distributed_crawler_tpu_torch.utils import flight  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 30.0


def wait_until(pred, timeout_s=DEADLINE_S, poll_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return bool(pred())


def _counter_total(registry, name):
    return sum(v for _, v in registry.counter(name).series())


def _down(topic, payload):
    raise RuntimeError("down")


# ---------------------------------------------------------------------------
# spool: WAL replay, torn tails, compaction
# ---------------------------------------------------------------------------
class TestTopicSpool:
    def test_replay_deterministic_and_pure(self, tmp_path):
        spool = TopicSpool(str(tmp_path), "t")
        a = spool.enqueue(b"frame-a")
        spool.enqueue(b"frame-b")
        c = spool.enqueue(b"frame-c")
        spool.requeue(c, attempts=2)
        spool.ack(a)
        first = [(f.fid, f.payload, f.attempts) for f in spool.replay()]
        second = [(f.fid, f.payload, f.attempts) for f in spool.replay()]
        assert first == second
        spool.close()
        reopened = TopicSpool(str(tmp_path), "t")
        assert [(f.fid, f.payload, f.attempts)
                for f in reopened.replay()] == first
        # b stays at the head; the requeued c moved to the tail with its
        # bumped attempt count.
        assert [f.payload for f in reopened.replay()] == \
            [b"frame-b", b"frame-c"]
        assert reopened.replay()[1].attempts == 2
        reopened.close()

    def test_torn_tail_dropped_not_fatal(self, tmp_path):
        spool = TopicSpool(str(tmp_path), "t")
        spool.enqueue(b"one")
        spool.enqueue(b"two")
        spool.close()
        with open(spool.wal_path, "a", encoding="utf-8") as f:
            f.write('{"k": "enq", "id": "torn", "d": "AAA')  # mid-append
        reopened = TopicSpool(str(tmp_path), "t")
        assert [f.payload for f in reopened.replay()] == [b"one", b"two"]
        reopened.close()

    def test_corrupt_interior_line_skipped(self, tmp_path):
        spool = TopicSpool(str(tmp_path), "t")
        spool.enqueue(b"one", fid="f1")
        spool.close()
        with open(spool.wal_path, "a", encoding="utf-8") as f:
            f.write("NOT JSON AT ALL\n")
            f.write(json.dumps({"k": "enq", "id": "f2",
                                "d": base64.b64encode(b"two").decode()})
                    + "\n")
        reopened = TopicSpool(str(tmp_path), "t")
        assert [f.payload for f in reopened.replay()] == [b"one", b"two"]
        reopened.close()

    def test_compaction_rewrites_live_frames_only(self, tmp_path):
        spool = TopicSpool(str(tmp_path), "t")
        keep = spool.enqueue(b"keeper")
        pairs = COMPACT_EVERY // 2 + 4  # past one compaction threshold
        for i in range(pairs):
            spool.ack(spool.enqueue(f"gone-{i}".encode()))
        with open(spool.wal_path, encoding="utf-8") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        assert len(lines) < 1 + 2 * pairs
        assert [f.fid for f in spool.replay()] == [keep]
        spool.close(compact=True)
        with open(spool.wal_path, encoding="utf-8") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        assert len(lines) == 1 and json.loads(lines[0])["id"] == keep

    def test_topic_names_roundtrip_through_directories(self, tmp_path):
        spool = BusSpool(str(tmp_path))
        ugly = "weird topic/with:chars✓"
        spool.enqueue(ugly, b"payload")
        assert spool.existing_topics() == [ugly]
        assert [f.payload for f in spool.replay(ugly)] == [b"payload"]
        spool.close()

    def test_closed_spool_refuses_even_first_enqueue_topics(self, tmp_path):
        spool = BusSpool(str(tmp_path))
        spool.enqueue("seen", b"x")
        spool.close()
        with pytest.raises(RuntimeError):
            spool.enqueue("seen", b"y")
        with pytest.raises(RuntimeError):
            spool.enqueue("never-seen-before", b"z")


class TestDeadLetterSpool:
    def test_append_entries_and_replay_marking(self, tmp_path):
        dlq = DeadLetterSpool(str(tmp_path))
        dlq.append("t", "f1", b"poison", attempts=5, reason="max_attempts")
        dlq.append("t", "f2", b"other", attempts=3, reason="boom")
        entries = dlq.entries("t")
        assert [e.fid for e in entries] == ["f1", "f2"]
        assert entries[0].payload == b"poison"
        assert entries[0].reason == "max_attempts"
        assert not entries[0].replayed
        dlq.mark_replayed("t", "f1")
        entries = dlq.entries("t")
        assert entries[0].replayed and not entries[1].replayed
        snap = dlq.snapshot()
        assert snap["topics"]["t"]["count"] == 2
        assert snap["topics"]["t"]["pending"] == 1
        detail = dlq.snapshot(topic="t", fid="f2")
        assert base64.b64decode(detail["entry"]["payload_b64"]) == b"other"

    def test_replayed_entries_compact_past_retention(self, tmp_path):
        dlq = DeadLetterSpool(str(tmp_path), replayed_retention=2)
        for i in range(5):
            dlq.append("t", f"f{i}", b"x", attempts=1, reason="r")
        dlq.append("t", "pending", b"keep", attempts=1, reason="r")
        for i in range(5):
            dlq.mark_replayed("t", f"f{i}")
        entries = dlq.entries("t")
        assert [e.fid for e in entries if e.replayed] == ["f3", "f4"]
        assert [e.fid for e in entries if not e.replayed] == ["pending"]
        again = DeadLetterSpool(str(tmp_path), replayed_retention=2)
        assert [e.fid for e in again.entries("t")] == ["f3", "f4",
                                                      "pending"]


# ---------------------------------------------------------------------------
# outbox: buffer through an outage, the bound, WAL reload
# ---------------------------------------------------------------------------
def _outbox_cfg(tmp_path=None, **kw):
    base = dict(flush_wait_s=0.01, retry_base_s=0.01, retry_max_s=0.05,
                breaker_threshold=3, breaker_recovery_s=0.05)
    if tmp_path is not None:
        base["dir"] = str(tmp_path)
    base.update(kw)
    return OutboxConfig(**base)


class TestDurableOutbox:
    def test_buffers_through_outage_then_flushes_in_order(self):
        sent, tries, up = [], [], threading.Event()

        def send(topic, payload):
            tries.append(payload["n"])
            if not up.is_set():
                raise RuntimeError("broker down")
            sent.append((topic, payload["n"]))

        ob = DurableOutbox(send, _outbox_cfg(), registry=MetricsRegistry())
        try:
            for n in range(5):
                ob.publish("t", {"n": n})
            # The flusher has retried the head into an open circuit.
            assert wait_until(lambda: len(tries) >= 3)
            assert ob.depth() == 5 and not sent
            assert set(tries) == {0}  # head of line: never skipped
            up.set()
            assert ob.drain(timeout_s=DEADLINE_S)
            assert [n for _, n in sent] == [0, 1, 2, 3, 4]
        finally:
            ob.close()

    def test_bound_is_hard_and_counted(self):
        reg = MetricsRegistry()
        ob = DurableOutbox(_down, _outbox_cfg(max_frames=3), registry=reg)
        try:
            for n in range(3):
                ob.publish("t", {"n": n})
            with pytest.raises(OutboxFull):
                ob.publish("t", {"n": 99})
            assert ob.near_full()
            assert _counter_total(reg, "bus_outbox_rejected_total") == 1
        finally:
            ob.close(drain_s=0.0)

    def test_wal_reload_resends_after_publisher_restart(self, tmp_path):
        ob = DurableOutbox(_down, _outbox_cfg(tmp_path),
                           registry=MetricsRegistry())
        ob.publish("t", {"n": 1})
        ob.publish("t", {"n": 2})
        ob.close(drain_s=0.1)  # undelivered frames stay in the WAL
        sent = []
        ob2 = DurableOutbox(lambda t, p: sent.append(p["n"]),
                            _outbox_cfg(tmp_path), registry=MetricsRegistry())
        try:
            assert ob2.drain(timeout_s=DEADLINE_S)
            assert sent == [1, 2]
        finally:
            ob2.close()

    def test_wal_compacts_with_a_standing_queue_depth(self, tmp_path):
        ob = DurableOutbox(_down, _outbox_cfg(tmp_path),
                           registry=MetricsRegistry())
        try:
            ob.publish("t", {"n": 1})
            ob.publish("t", {"n": 2})
            with ob._lock:
                # As if many earlier frames had delivered: the done-prefix
                # dominates while two puts are still pending.
                ob._wal_puts = toutbox.COMPACT_EVERY + 2
                ob._wal_dones = toutbox.COMPACT_EVERY
                ob._wal_maybe_compact_locked()
            with open(ob.wal_path, encoding="utf-8") as f:
                lines = [json.loads(ln) for ln in f.read().splitlines()
                         if ln.strip()]
            assert [ln["k"] for ln in lines] == ["put", "put"]
        finally:
            ob.close(drain_s=0.0)
        sent = []
        ob2 = DurableOutbox(lambda t, p: sent.append(p["n"]),
                            _outbox_cfg(tmp_path), registry=MetricsRegistry())
        try:
            assert ob2.drain(timeout_s=DEADLINE_S)
            assert sent == [1, 2]
        finally:
            ob2.close()

    def test_near_full_and_low_water_are_distinct_marks(self):
        ob = DurableOutbox(_down, _outbox_cfg(max_frames=10),
                           registry=MetricsRegistry())
        try:
            for n in range(8):  # high mark 8, low mark 4
                ob.publish("t", {"n": n})
            assert ob.near_full() and not ob.below_low_water()
            with ob._lock:
                while len(ob._q) > 5:
                    ob._q.popleft()
            assert not ob.near_full() and not ob.below_low_water()
            with ob._lock:
                while len(ob._q) > 4:
                    ob._q.popleft()
            assert ob.below_low_water()
        finally:
            ob.close(drain_s=0.0)

    def test_outbox_bus_wrapper_delegates(self):
        inner = InMemoryBus(sync=True)
        got = []
        inner.subscribe("t", got.append)
        bus = OutboxBus(inner, _outbox_cfg(), registry=MetricsRegistry())
        bus.publish("t", {"n": 7})
        assert bus.outbox.drain(timeout_s=DEADLINE_S)
        assert got and got[0]["n"] == 7
        assert bus.stats()["published"]["t"] == 1  # __getattr__ delegation
        bus.close()


class TestCircuitBreaker:
    def test_transitions_equal_the_references(self):
        """One op sequence under one fake clock through both packages'
        breakers: the same states, gauge values, open counts and shed
        calls; `retry_call` sheds with `CircuitOpenError` only when no
        attempt ran."""
        from distributed_crawler_tpu.utils import resilience as jres

        from distributed_crawler_tpu_torch.utils import resilience as tres

        def drive(mod, reg):
            now = [0.0]
            br = mod.CircuitBreaker("bus", failure_threshold=2,
                                    recovery_timeout_s=1.0,
                                    clock=lambda: now[0], registry=reg)
            trace_ = []
            for step in ("fail", "fail", "allow", "tick", "probe", "fail",
                         "allow", "tick", "probe", "ok", "allow"):
                if step == "fail":
                    br.record_failure()
                elif step == "ok":
                    br.record_success()
                elif step == "tick":
                    now[0] += 1.0
                elif step == "probe":
                    trace_.append(br.allow())
                    trace_.append(br.allow())  # one probe slot only
                else:
                    trace_.append(br.allow())
                trace_.append((br.state, reg.gauge(
                    "resilience_circuit_state").labels(target="bus").value))
            opened = reg.counter("resilience_circuit_open_total").labels(
                target="bus").value
            shed = []
            for fn in (lambda: None, lambda: 1 / 0):
                now[0] += 5.0
                br.record_failure()
                br.record_failure()  # open again
                try:
                    mod.retry_call(fn, retry=mod.RetryPolicy(max_attempts=2),
                                   breaker=br, registry=reg)
                except Exception as e:
                    shed.append(type(e).__name__)
            return trace_, opened, shed

        mine = drive(tres, MetricsRegistry())
        ref = drive(jres, JaxRegistry())
        assert mine == ref
        # Shed without an attempt; then, recovery time past, the probe ran.
        assert mine[2] == ["CircuitOpenError", "ZeroDivisionError"]
        assert ("open", 1.0) in mine[0] and ("half_open", 0.5) in mine[0]


# ---------------------------------------------------------------------------
# broker restart over the spool
# ---------------------------------------------------------------------------
def _pull_n(client, topic, n, ack=True, ok=True, timeout_s=DEADLINE_S):
    """Pull n frames (acking each per ``ack``/``ok``); the payloads."""
    got = []
    deadline = time.monotonic() + timeout_s
    it = client.pull(topic)
    try:
        while len(got) < n and time.monotonic() < deadline:
            delivery_id, payload = next(it)
            got.append(json.loads(payload))
            if ack:
                client.ack(topic, delivery_id, ok=ok)
    finally:
        it.close()
    return got


def _server(spool=None, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return GrpcBusServer("127.0.0.1:0", spool_dir=spool, **kw)


class TestBrokerRestart:
    def test_queued_and_inflight_redelivered_across_generations(
            self, tmp_path):
        flight.RECORDER.reset()
        spool = str(tmp_path / "spool")
        gen1 = _server(spool, ack_timeout_s=60)
        gen1.enable_pull("t")
        gen1.start()
        for n in range(3):
            gen1.publish("t", {"n": n})
        c1 = GrpcBusClient(f"127.0.0.1:{gen1.bound_port}")
        # One frame goes in flight and is never acked; the broker dies.
        assert _pull_n(c1, "t", 1, ack=False) == [{"n": 0}]
        c1.close()
        gen1.kill()

        gen2 = _server(spool)
        gen2.start()
        assert gen2.pending_count("t") == 3
        c2 = GrpcBusClient(f"127.0.0.1:{gen2.bound_port}")
        assert sorted(p["n"] for p in _pull_n(c2, "t", 3)) == [0, 1, 2]
        c2.close()
        assert gen2.pending_count("t") == 0
        gen2.close()
        gen3 = _server(spool)
        assert gen3.pending_count("t") == 0
        gen3.close()
        kinds = [e["kind"] for e in flight.RECORDER.events()]
        assert "bus_kill" in kinds and "bus_resume" in kinds

    def test_attempt_counts_survive_restart_into_dead_letter(self, tmp_path):
        reg = MetricsRegistry()
        spool_dir = str(tmp_path / "spool")
        spool = BusSpool(spool_dir)
        fid = spool.enqueue("t", json.dumps({"poison": 1}).encode())
        spool.requeue("t", fid, attempts=1)
        spool.close()

        gen2 = _server(spool_dir, max_attempts=2, registry=reg)
        gen2.start()
        assert gen2.pending_count("t") == 1
        c2 = GrpcBusClient(f"127.0.0.1:{gen2.bound_port}")
        # 1 inherited + 1 nack >= 2: the budget crossed the restart.
        assert _pull_n(c2, "t", 1, ack=True, ok=False) == [{"poison": 1}]
        c2.close()
        assert wait_until(lambda: gen2.dead_letters >= 1)
        assert gen2.dead_letters == 1
        assert gen2.pending_count("t") == 0
        entries = DeadLetterSpool(spool_dir).entries("t")
        assert len(entries) == 1 and entries[0].attempts == 2
        assert json.loads(entries[0].payload) == {"poison": 1}
        assert _counter_total(reg, "bus_dead_letters_total") == 1
        assert _counter_total(reg, "bus_redeliveries_total") == 0
        gen2.close()

    def test_dlq_replay_re_enters_delivery(self, tmp_path):
        server = _server(str(tmp_path / "spool"), max_attempts=1)
        server.enable_pull("t")
        server.start()
        server.publish("t", {"n": 42})
        client = GrpcBusClient(f"127.0.0.1:{server.bound_port}")
        try:
            _pull_n(client, "t", 1, ack=True, ok=False)  # 1 attempt: dead
            assert wait_until(lambda: server.dead_letters >= 1)
            snap = server.dlq_snapshot()
            assert snap["enabled"] and snap["topics"]["t"]["pending"] == 1
            fid = snap["topics"]["t"]["entries"][0]["id"]
            assert server.dlq_replay("t", fid)["id"] == fid
            assert _pull_n(client, "t", 1) == [{"n": 42}]
            assert server.dlq_snapshot()["topics"]["t"]["pending"] == 0
        finally:
            client.close()
            server.close()

    def test_unrouted_counted_and_held_durable(self, tmp_path):
        reg = MetricsRegistry()
        server = _server(str(tmp_path / "spool"), registry=reg)
        server.start()
        server.publish("nobody-home", {"lost?": False})
        assert _counter_total(reg, "bus_dropped_no_route_total") == 1
        assert server.pending_count("nobody-home") == 0
        entry = server.dlq_snapshot()["topics"]["nobody-home"]["entries"][0]
        assert entry["reason"] == "no_route"
        server.close()

    def test_local_dead_letter_conjures_no_phantom_pull_topic(
            self, tmp_path):
        spool_dir = str(tmp_path / "spool")
        gen1 = _server(spool_dir, max_attempts=1)

        def boom(payload):
            raise RuntimeError("handler down")

        gen1.subscribe("fanout", boom)
        gen1.start()
        gen1.publish("fanout", {"n": 1})
        assert gen1.flush_local(timeout_s=DEADLINE_S)
        assert wait_until(lambda: gen1.dead_letters >= 1)
        assert gen1.dead_letters == 1
        gen1.close()
        entries = DeadLetterSpool(spool_dir).entries("fanout")
        assert len(entries) == 1 and entries[0].reason.startswith(
            "local_handler")
        gen2 = _server(spool_dir)
        assert "fanout" not in gen2._pull_queues
        assert gen2.pending_count("fanout") == 0
        gen2.close()

    def test_unrouted_hold_cap_survives_restart(self, tmp_path,
                                                monkeypatch):
        monkeypatch.setattr(tgrpc, "UNROUTED_SPOOL_CAP", 2)
        spool_dir = str(tmp_path / "spool")
        gen1 = _server(spool_dir)
        gen1.start()
        for i in range(3):
            gen1.publish("orphan", {"n": i})
        assert gen1.dlq_snapshot()["topics"]["orphan"]["pending"] == 2
        gen1.close()
        reg2 = MetricsRegistry()
        gen2 = _server(spool_dir, registry=reg2)
        gen2.start()
        gen2.publish("orphan", {"n": 99})
        assert _counter_total(reg2, "bus_dropped_no_route_total") == 1
        assert gen2.dlq_snapshot()["topics"]["orphan"]["pending"] == 2
        gen2.close()

    def test_dlq_replay_releases_unrouted_cap_slot(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setattr(tgrpc, "UNROUTED_SPOOL_CAP", 1)
        spool_dir = str(tmp_path / "spool")
        gen1 = _server(spool_dir)
        gen1.start()
        gen1.publish("orphan", {"n": 0})
        snap = gen1.dlq_snapshot()
        assert snap["topics"]["orphan"]["pending"] == 1
        fid = snap["topics"]["orphan"]["entries"][0]["id"]
        gen1.dlq_replay("orphan", fid)  # still unrouted: re-held in the cap
        assert gen1.dlq_snapshot()["topics"]["orphan"]["pending"] == 1
        gen1.close()
        gen2 = _server(spool_dir)
        assert gen2._unrouted_spooled.get("orphan", 0) == 1
        gen2.close()

    def test_unrouted_counted_and_dropped_without_spool(self):
        reg = MetricsRegistry()
        server = _server(registry=reg)
        server.start()
        server.publish("nobody-home", {"gone": True})
        assert _counter_total(reg, "bus_dropped_no_route_total") == 1
        assert server.dlq_snapshot()["topics"] == {}
        server.close()


# ---------------------------------------------------------------------------
# RemoteBus: reconnect backoff, and reconnect across generations
# ---------------------------------------------------------------------------
class TestRemoteBusReconnect:
    def test_backoff_schedule_is_jittered_exponential(self):
        bus = RemoteBus("127.0.0.1:1")  # never dialled
        try:
            flat = [bus._reconnect.delay_s(a, rng=lambda: 0.5)
                    for a in range(7)]
            assert flat == [0.1, 0.2, 0.4, 0.8, 1.6, 2.0, 2.0]
            lo = bus._reconnect.delay_s(3, rng=lambda: 0.0)
            hi = bus._reconnect.delay_s(3, rng=lambda: 1.0)
            assert lo == pytest.approx(0.8 * 0.75)
            assert hi == pytest.approx(0.8 * 1.25)
            assert bus._reconnect.delay_s(16, rng=lambda: 0.5) == 2.0
        finally:
            bus.close()

    def test_reconnects_to_a_new_broker_generation(self, tmp_path):
        spool = str(tmp_path / "spool")
        gen1 = _server(spool)
        gen1.enable_pull("t")
        gen1.start()
        addr = f"127.0.0.1:{gen1.bound_port}"
        got = []

        def handler(payload, ack):
            ack(True)  # returns once the broker has the ack
            got.append(payload["n"])

        worker = RemoteBus(addr)
        worker.subscribe("t", handler)
        gen2 = None
        try:
            gen1.publish("t", {"n": 1})
            assert wait_until(lambda: got == [1])
            gen1.kill()
            # Same port, same spool: the supervisor's restart.
            gen2 = GrpcBusServer(addr, spool_dir=spool,
                                 registry=MetricsRegistry())
            gen2.start()
            assert gen2.bound_port == gen1.bound_port
            gen2.publish("t", {"n": 2})
            assert wait_until(lambda: got == [1, 2]), \
                f"puller never reconnected: {got}"
        finally:
            worker.close()
            if gen2 is not None:
                gen2.close()


# ---------------------------------------------------------------------------
# consumer idempotence under broker-driven duplicate delivery
# ---------------------------------------------------------------------------
class _StubEngine:
    """Deterministic per-text results for `TPUWorker`."""

    class cfg:
        model = "stub"

    def run(self, texts, pack=False):
        return [{"label": 0, "score": 1.0} for _ in texts]


class _DictProvider:
    def __init__(self):
        self.files = {}

    def put_text(self, path, text):
        self.files[path] = text


class TestDuplicateDeliveryIdempotence:
    def test_ack_loses_race_with_sweeper_requeue(self):
        server = _server(ack_timeout_s=0.2)
        server.enable_pull("t")
        server.start()
        client = GrpcBusClient(f"127.0.0.1:{server.bound_port}")
        try:
            server.publish("t", {"n": 5})
            it = client.pull("t")
            delivery_id, _ = next(it)
            tq = server._pull_queues["t"]
            assert wait_until(lambda: delivery_id not in tq.inflight)
            late = client._ack(b"t\x00" + delivery_id.encode("ascii")
                               + b"\x00ok")
            assert late == b"unknown-delivery"  # the ack lost the race
            redelivery_id, payload = next(it)
            assert redelivery_id != delivery_id
            assert json.loads(payload) == {"n": 5}
            client.ack("t", redelivery_id, ok=True)
            it.close()
        finally:
            client.close()
            server.close()

    def test_worker_writeback_absorbs_redelivered_batch(self):
        """A redelivered batch overwrites its file with equal rows."""
        from distributed_crawler_tpu_torch.inference.worker import (
            TPUWorker,
            TPUWorkerConfig,
        )

        bus = InMemoryBus(sync=True)
        provider = _DictProvider()
        worker = TPUWorker(
            bus, _StubEngine(), provider=provider,
            cfg=TPUWorkerConfig(worker_id="t1", heartbeat_s=30.0,
                                stall_warn_s=0, coalesce_batches=1),
            registry=MetricsRegistry())
        worker.start()
        try:
            payload = RecordBatch.from_dict({
                "batch_id": "b-dup", "crawl_id": "c-dup",
                "records": [{"post_uid": "p1", "description": "hello"},
                            {"post_uid": "p2", "description": "world"}],
            }).to_dict()
            bus.publish(TOPIC_INFERENCE_BATCHES, payload)
            assert worker.drain(timeout_s=DEADLINE_S)
            first = dict(provider.files)
            bus.publish(TOPIC_INFERENCE_BATCHES, payload)  # the redelivery
            assert worker.drain(timeout_s=DEADLINE_S)
            assert list(provider.files) == ["inference/c-dup/batches/"
                                            "b-dup.jsonl"]
            rows = [json.loads(x) for x in
                    next(iter(provider.files.values())).splitlines()]
            assert sorted(r["post_uid"] for r in rows) == ["p1", "p2"]
            old = [json.loads(x) for x in
                   next(iter(first.values())).splitlines()]
            strip = [{k: v for k, v in r.items() if k != "trace_id"}
                     for r in rows]
            assert strip == [{k: v for k, v in r.items() if k != "trace_id"}
                             for r in old]
        finally:
            worker.stop(timeout_s=5.0)
            bus.close()

    def test_outbox_full_on_result_publish_nacks_the_batch(self):
        """`OutboxFull` raised by the result publish nacks the frame (the
        broker redelivers it) and writes nothing: the batch is not
        dropped."""
        from distributed_crawler_tpu_torch.inference.worker import (
            TPUWorker,
            TPUWorkerConfig,
        )

        class FullBus(InMemoryBus):
            def publish(self, topic, payload):
                if topic != TOPIC_INFERENCE_BATCHES:
                    raise OutboxFull(8, 8)
                super().publish(topic, payload)

        bus = FullBus(sync=True)
        provider = _DictProvider()
        worker = TPUWorker(
            bus, _StubEngine(), provider=provider,
            cfg=TPUWorkerConfig(worker_id="t2", heartbeat_s=3600.0,
                                stall_warn_s=0, coalesce_batches=1),
            registry=MetricsRegistry())
        acks = []
        worker.start()
        try:
            worker._handle_payload(RecordBatch.from_dict({
                "batch_id": "b-full", "crawl_id": "c",
                "records": [{"post_uid": "p1", "description": "x"}],
            }).to_dict(), lambda ok=True: acks.append(ok))
            assert worker.drain(timeout_s=DEADLINE_S)
            assert acks == [False] and provider.files == {}
        finally:
            worker.stop(timeout_s=5.0)
            bus.close()


# ---------------------------------------------------------------------------
# compatibility with the reference, both ways
# ---------------------------------------------------------------------------
PKGS = {"port": (TopicSpool, DeadLetterSpool, BusSpool),
        "ref": (jspool.TopicSpool, jspool.DeadLetterSpool, jspool.BusSpool)}
DIRECTIONS = [("port", "ref"), ("ref", "port")]


def _frames(spool):
    return [(f.fid, f.payload, f.attempts) for f in spool.replay()]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_topic_spool_folds_the_other_packages_wal(tmp_path, writer, reader):
    w = PKGS[writer][0](str(tmp_path), "tpu-inference-batches")
    ids = [w.enqueue(json.dumps({"n": n}).encode()) for n in range(5)]
    w.requeue(ids[1], attempts=3)
    w.ack(ids[0])
    w.remove_dead(ids[2])
    want = _frames(w)
    w.close()
    with open(w.wal_path, "a", encoding="utf-8") as f:
        f.write('{"k": "enq", "id": "torn"')  # a torn tail
    r = PKGS[reader][0](str(tmp_path), "tpu-inference-batches")
    assert _frames(r) == want
    assert [fid for fid, _, _ in want] == [ids[3], ids[4], ids[1]]
    r.close(compact=True)  # the reader's compaction reads back the same
    again = PKGS[writer][0](str(tmp_path), "tpu-inference-batches")
    assert _frames(again) == want
    again.close()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_dead_letter_spool_folds_the_other_packages_file(tmp_path, writer,
                                                        reader):
    w = PKGS[writer][1](str(tmp_path))
    w.append("t", "f1", b"\x00binary", attempts=5, reason="max_attempts")
    w.append("t", "f2", b'{"n": 2}', attempts=0, reason="no_route")
    w.mark_replayed("t", "f1")
    r = PKGS[reader][1](str(tmp_path))
    assert [(e.fid, e.topic, e.payload, e.attempts, e.reason, e.ts,
             e.replayed) for e in r.entries("t")] == \
        [(e.fid, e.topic, e.payload, e.attempts, e.reason, e.ts,
          e.replayed) for e in w.entries("t")]
    assert r.snapshot(topic="t", fid="f2") == w.snapshot(topic="t",
                                                        fid="f2")


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_outbox_wal_reloads_in_the_other_package(tmp_path, writer, reader):
    mods = {"port": (DurableOutbox, OutboxConfig, MetricsRegistry),
            "ref": (joutbox.DurableOutbox, joutbox.OutboxConfig,
                    JaxRegistry)}
    ob_cls, cfg_cls, reg_cls = mods[writer]
    cfg = dict(dir=str(tmp_path), flush_wait_s=0.01, retry_base_s=0.01,
               retry_max_s=0.05, breaker_threshold=3,
               breaker_recovery_s=0.05)
    ob = ob_cls(_down, cfg_cls(**cfg), registry=reg_cls())
    for n in range(3):
        ob.publish("t", {"n": n, "text": "ü"})
    ob.publish("u", {"n": 9})
    ob.close(drain_s=0.0)
    sent = []
    ob_cls, cfg_cls, reg_cls = mods[reader]
    ob2 = ob_cls(lambda t, p: sent.append((t, p)), cfg_cls(**cfg),
                 registry=reg_cls())
    try:
        assert ob2.drain(timeout_s=DEADLINE_S)
    finally:
        ob2.close()
    assert sent == [("t", {"n": n, "text": "ü"}) for n in range(3)] + \
        [("u", {"n": 9})]


SERVERS = {"port": (GrpcBusServer, GrpcBusClient, MetricsRegistry),
           "ref": (jgrpc.GrpcBusServer, jgrpc.GrpcBusClient, JaxRegistry)}


@pytest.mark.parametrize("first,second", DIRECTIONS)
def test_broker_resumes_the_other_packages_spool(tmp_path, first, second):
    """Queued and in-flight frames come back in the other package's
    broker, in the writer's own replay order and with their attempt
    counts; once they are acked, the writer's package finds nothing."""
    spool = str(tmp_path / "spool")
    srv_cls, cli_cls, reg_cls = SERVERS[first]
    gen1 = srv_cls("127.0.0.1:0", spool_dir=spool, registry=reg_cls())
    gen1.enable_pull("t")
    gen1.start()
    for n in range(4):
        gen1.publish("t", {"n": n})
    c1 = cli_cls(f"127.0.0.1:{gen1.bound_port}")
    assert _pull_n(c1, "t", 1, ack=True, ok=True) == [{"n": 0}]
    nacked = _pull_n(c1, "t", 1, ack=True, ok=False)[0]["n"]
    held = _pull_n(c1, "t", 1, ack=False)[0]["n"]  # stream dies unacked
    c1.close()
    assert wait_until(lambda: gen1.pending_count("t") == 3)
    gen1.kill()
    # What the dead generation journaled, folded by its own package.
    writer = PKGS[first][0](spool, "t")
    want = [(json.loads(f.payload)["n"], f.attempts)
            for f in writer.replay()]
    writer.close()
    assert sorted(n for n, _ in want) == [1, 2, 3]
    attempts = dict(want)
    assert attempts[nacked] >= 1 and attempts[held] >= 1

    srv_cls, cli_cls, reg_cls = SERVERS[second]
    gen2 = srv_cls("127.0.0.1:0", spool_dir=spool, registry=reg_cls())
    gen2.start()
    try:
        tq = gen2._pull_queues["t"]
        with tq.lock:
            queued = [(json.loads(f.payload)["n"], f.attempts)
                      for f in tq.q.queue]
        assert queued == want
        c2 = cli_cls(f"127.0.0.1:{gen2.bound_port}")
        assert sorted(p["n"] for p in _pull_n(c2, "t", 3)) == [1, 2, 3]
        c2.close()
        assert wait_until(lambda: gen2.pending_count("t") == 0)
    finally:
        gen2.close()
    srv_cls, _, reg_cls = SERVERS[first]
    gen3 = srv_cls("127.0.0.1:0", spool_dir=spool, registry=reg_cls())
    try:
        assert gen3.pending_count("t") == 0
    finally:
        gen3.close()


def test_dlq_bodies_equal_over_http(tmp_path):
    """Both packages' brokers over one spool, each behind its own metrics
    server: /dlq bodies equal, with and without ?topic=&id=."""
    from distributed_crawler_tpu.utils import metrics as jmetrics

    from distributed_crawler_tpu_torch.utils import metrics as tmetrics

    import urllib.request

    spool = str(tmp_path / "spool")
    dlq = DeadLetterSpool(spool)
    dlq.append("t", "f1", b'{"n": 1}', attempts=5, reason="max_attempts")
    dlq.append("u", "f2", b"\xffbin", attempts=0, reason="no_route")
    dlq.mark_replayed("t", "f1")
    port_srv = _server(spool)
    ref_srv = jgrpc.GrpcBusServer("127.0.0.1:0", spool_dir=spool,
                                  registry=JaxRegistry())
    http = {"port": tmetrics.serve_metrics(0, MetricsRegistry()),
            "ref": jmetrics.serve_metrics(0, JaxRegistry())}
    tmetrics.set_dlq_provider(port_srv.dlq_snapshot)
    jmetrics.set_dlq_provider(ref_srv.dlq_snapshot)
    try:
        for query in ("", "?topic=t&id=f1", "?topic=u"):
            bodies = [json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{h.server_address[1]}/dlq{query}",
                timeout=10).read()) for h in http.values()]
            assert bodies[0] == bodies[1], query
        assert bodies[0]["topics"]["u"]["entries"][0]["reason"] == \
            "no_route"
    finally:
        tmetrics.clear_dlq_provider(port_srv.dlq_snapshot)
        jmetrics.clear_dlq_provider(ref_srv.dlq_snapshot)
        for h in http.values():
            h.shutdown()
            h.server_close()
        port_srv.close()
        ref_srv.close()


def test_dlq_route_is_404_without_a_provider():
    import urllib.error
    import urllib.request

    from distributed_crawler_tpu_torch.utils import metrics as tmetrics

    http = tmetrics.serve_metrics(0, MetricsRegistry())
    try:
        for route in ("/dlq", "/shards"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{http.server_address[1]}{route}",
                    timeout=10)
            assert e.value.code == 404
    finally:
        http.shutdown()
        http.server_close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_dlq_tools_list_and_inspect_either_spool(tmp_path, capsys, writer):
    """`tools/dlq.py` and the port's `bus.dlq` print the same listing and
    the same entry, whichever package wrote the spool."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tools_dlq", os.path.join(ROOT, "tools", "dlq.py"))
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    dlq = PKGS[writer][1](str(tmp_path))
    dlq.append("tpu-inference-batches", "f1", b'{"batch_id": "b"}',
               attempts=2, reason="max_attempts")
    dlq.append("tpu-inference-batches", "f2", b"\x01\x02", attempts=0,
               reason="no_route")
    dlq.mark_replayed("tpu-inference-batches", "f2")
    outs = {}
    for name, tool in (("ref", ref_tool), ("port", tdlq)):
        got = []
        for argv in (["--spool-dir", str(tmp_path)],
                     ["--spool-dir", str(tmp_path), "--json"],
                     ["--spool-dir", str(tmp_path), "--topic",
                      "tpu-inference-batches", "--inspect", "f1"],
                     ["--spool-dir", str(tmp_path), "--topic",
                      "tpu-inference-batches", "--inspect", "f2"]):
            assert tool.main(argv) == 0
            got.append(capsys.readouterr().out)
        outs[name] = got
    assert outs["port"] == outs["ref"]
    assert "f1" in outs["port"][0] and "(replayed)" in outs["port"][0]


def test_dlq_tool_replay_all_through_a_live_port_broker(tmp_path, capsys):
    spool = str(tmp_path / "spool")
    server = _server(spool, max_attempts=1)
    server.enable_pull("t")
    server.start()
    addr = f"127.0.0.1:{server.bound_port}"
    client = GrpcBusClient(addr)
    try:
        for n in range(2):
            server.publish("t", {"n": n})
        _pull_n(client, "t", 2, ack=True, ok=False)
        assert wait_until(lambda: server.dead_letters == 2)
        assert tdlq.main(["--spool-dir", spool, "--topic", "t",
                          "--replay-all", "--bus-address", addr]) == 0
        assert "replayed 2 entries onto 't'" in capsys.readouterr().out
        assert sorted(p["n"] for p in _pull_n(client, "t", 2)) == [0, 1]
        assert all(e.replayed for e in DeadLetterSpool(spool).entries("t"))
        assert tdlq.main(["--selfcheck"]) == 0
    finally:
        client.close()
        server.close()


# ---------------------------------------------------------------------------
# the port's worker across a broker generation
# ---------------------------------------------------------------------------
def _batches(n_batches, per_batch, crawl_id):
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    out = []
    for b in range(n_batches):
        recs = [{"post_uid": f"{crawl_id}-{b}-{i}", "channel_name": "chan",
                 "description": " ".join(words[:(b + i) % 6 + 1]
                                         + [str(b * 100 + i)])}
                for i in range(per_batch)]
        out.append(RecordBatch.from_dict({
            "batch_id": f"{crawl_id}-b{b}", "crawl_id": crawl_id,
            "records": recs}).to_dict())
    return out


def _rows(store, crawl_id, batches):
    rows = {}
    for b in batches:
        path = os.path.join(store, "inference", crawl_id, "batches",
                            f"{b['batch_id']}.jsonl")
        with open(path, encoding="utf-8") as f:
            rows[b["batch_id"]] = [json.loads(x) for x in f]
    return rows


def _written(store, crawl_id):
    d = os.path.join(store, "inference", crawl_id, "batches")
    return len([n for n in os.listdir(d) if n.endswith(".jsonl")]) \
        if os.path.isdir(d) else 0


def test_worker_across_a_broker_generation_loses_nothing(tmp_path):
    """A tiny encoder on the CPU behind `RemoteBus(outbox=...)`; the
    broker is killed with frames queued and restarted over its spool on
    the same address.  Every batch is written once per post, equal to an
    undisturbed run of the same engine."""
    from distributed_crawler_tpu_torch.inference import engine as teng
    from distributed_crawler_tpu_torch.inference.worker import (
        TPUWorker,
        TPUWorkerConfig,
    )
    from distributed_crawler_tpu_torch.state.providers import (
        LocalStorageProvider,
    )

    torch.manual_seed(0)
    engine = teng.InferenceEngine(
        teng.EngineConfig(model="tiny", n_labels=3, batch_size=4,
                          buckets=(16, 32)),
        registry=MetricsRegistry(), device="cpu")
    batches = _batches(6, 4, "gen")
    wcfg = dict(worker_id="w-gen", heartbeat_s=0.5, stall_warn_s=0,
                coalesce_batches=1, span_export_interval_s=0)

    # Undisturbed: the in-memory bus.
    calm_store = str(tmp_path / "calm")
    bus = InMemoryBus(sync=False)
    worker = TPUWorker(bus, engine, provider=LocalStorageProvider(calm_store),
                       cfg=TPUWorkerConfig(**wcfg),
                       registry=MetricsRegistry())
    worker.start()
    bus.start()
    for b in batches:
        bus.publish(TOPIC_INFERENCE_BATCHES, b)
    assert wait_until(lambda: _written(calm_store, "gen") == 6)
    assert worker.drain(timeout_s=DEADLINE_S)
    worker.stop(timeout_s=5.0)
    bus.close()
    want = _rows(calm_store, "gen", batches)

    # Across a generation.
    spool = str(tmp_path / "spool")
    store = str(tmp_path / "store")
    ocfg = dict(flush_wait_s=0.02, retry_base_s=0.02, retry_max_s=0.2,
                breaker_threshold=3, breaker_recovery_s=0.2)
    gen1 = GrpcBusServer("127.0.0.1:0", spool_dir=spool,
                         registry=MetricsRegistry())
    gen1.enable_pull(TOPIC_INFERENCE_BATCHES)
    gen1.start()
    addr = f"127.0.0.1:{gen1.bound_port}"
    wreg = MetricsRegistry()
    wbus = RemoteBus(addr, outbox=OutboxConfig(
        dir=str(tmp_path / "outbox" / "w"), **ocfg), registry=wreg)
    pub = RemoteBus(addr, outbox=OutboxConfig(
        dir=str(tmp_path / "outbox" / "p"), **ocfg),
        registry=MetricsRegistry())
    worker = TPUWorker(wbus, engine, provider=LocalStorageProvider(store),
                       cfg=TPUWorkerConfig(**wcfg), registry=wreg)
    gen2 = None
    try:
        worker.start()
        for b in batches[:3]:
            pub.publish(TOPIC_INFERENCE_BATCHES, b)
        assert wait_until(lambda: _written(store, "gen") >= 1)
        gen1.kill()
        for b in batches[3:]:
            pub.publish(TOPIC_INFERENCE_BATCHES, b)  # buffers, never raises
        assert pub.outbox.depth() >= 1
        gen2 = GrpcBusServer(addr, spool_dir=spool,
                             registry=MetricsRegistry())
        gen2.enable_pull(TOPIC_INFERENCE_BATCHES)
        gen2.start()
        assert wait_until(lambda: _written(store, "gen") == 6
                          and pub.outbox.depth() == 0
                          and gen2.pending_count(TOPIC_INFERENCE_BATCHES)
                          == 0, timeout_s=60.0)
        assert worker.drain(timeout_s=DEADLINE_S)
        assert wait_until(lambda: wbus.outbox.depth() == 0)
        assert wbus.outbox.circuit_state == "closed"
    finally:
        worker.stop(timeout_s=5.0)
        wbus.close()
        pub.close()
        if gen2 is not None:
            gen2.close()
        gen1.close()
    got = _rows(store, "gen", batches)
    for b in batches:
        mine, ref = got[b["batch_id"]], want[b["batch_id"]]
        assert [r["post_uid"] for r in mine] == \
            [r["post_uid"] for r in b["records"]]
        assert [r["label"] for r in mine] == [r["label"] for r in ref]
        np.testing.assert_allclose(
            np.asarray([r["embedding"] for r in mine]),
            np.asarray([r["embedding"] for r in ref]), atol=1e-5, rtol=1e-4)

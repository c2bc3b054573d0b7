"""The port's partitioned bus (`distributed_crawler_tpu_torch/bus/
partition.py`), its ``/shards`` route and its client's channel rebuild,
against the reference's, on the CPU.

- The reference's `tests/test_bus_partition.py`, case by case, against
  the port's classes with the same frames: the ring (stable, roughly
  uniform, about 1/N of the keys moving when a shard is added or
  removed), routing keys, the shared-WAL rejections and the CLI's shard
  validation, routing to exactly one shard, broadcast with dedupe, a dead
  shard's frames parked in order and never re-hashed, per-shard breakers,
  the ``/shards`` body over HTTP, in a postmortem bundle and in
  `tools/watch.py`'s panel, two real gRPC shards with one killed and
  restarted, and the rebuild of a wedged channel.
- Compatibility both ways: `ShardMap.shard_for` equal on 4096 keys for 2,
  3 and 4 shards; `routing_key` equal over a payload corpus; the
  ``/shards`` bodies equal for the same state; a reference client
  publishing through a port shard ring reaches a port consumer, and the
  other way round.

Every wait polls against a deadline of at least 20 s; ports are bound to
0; every bus, server and client is closed with a bounded join.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("grpc")
pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu.bus import grpc_bus as jgrpc  # noqa: E402
from distributed_crawler_tpu.bus import partition as jpart  # noqa: E402
from distributed_crawler_tpu.bus.outbox import (  # noqa: E402
    OutboxConfig as JaxOutboxConfig,
)
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.bus.grpc_bus import (  # noqa: E402
    GrpcBusClient,
    GrpcBusServer,
    RemoteBus,
)
from distributed_crawler_tpu_torch.bus.messages import (  # noqa: E402
    TOPIC_INFERENCE_BATCHES,
    TOPIC_RESULTS,
    TOPIC_WORK_QUEUE,
    TOPIC_WORKER_STATUS,
)
from distributed_crawler_tpu_torch.bus.outbox import (  # noqa: E402
    OutboxConfig,
    OutboxFull,
)
from distributed_crawler_tpu_torch.bus.partition import (  # noqa: E402
    BROADCAST_TOPICS,
    PartitionedBus,
    ShardMap,
    channel_of,
    default_shard_ids,
    routing_key,
    shard_spool_dirs,
    validate_shard_spool_dirs,
)
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)

DEADLINE_S = 30.0


def wait_until(pred, timeout_s=DEADLINE_S, poll_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return bool(pred())


class _FakeEndpoint:
    """Bus-shaped endpoint: records publishes, dispatches to local
    subscribers, and can be 'killed' (publish raises)."""

    def __init__(self):
        self.published = []
        self.subs = {}
        self.down = False
        self.address = "fake:0"
        self.generation = 1
        self.server = object()

    def publish(self, topic, payload):
        if self.down:
            raise RuntimeError("bus is down")
        self.published.append((topic, payload))
        for h in self.subs.get(topic, []):
            h(payload)

    def subscribe(self, topic, handler):
        self.subs.setdefault(topic, []).append(handler)

    def pending_count(self, topic):
        return 0

    def kill(self):
        self.down = True
        self.server = None

    def restart(self):
        self.down = False
        self.server = object()
        self.generation += 1

    def count(self, topic):
        return sum(1 for t, _ in self.published if t == topic)


def _pbus(n=3, registry=None, **kw):
    eps = {sid: _FakeEndpoint() for sid in default_shard_ids(n)}
    bus = PartitionedBus(eps, registry=registry or MetricsRegistry(), **kw)
    return bus, eps


# ---------------------------------------------------------------------------
# ShardMap: the ring
# ---------------------------------------------------------------------------
class TestShardMap:
    KEYS = [f"key-{i}" for i in range(4000)]

    def test_same_key_same_shard_across_instances(self):
        a = ShardMap(default_shard_ids(4))
        b = ShardMap(default_shard_ids(4))
        assert [a.shard_for(k) for k in self.KEYS] == \
            [b.shard_for(k) for k in self.KEYS]

    def test_spread_is_roughly_uniform(self):
        spread = ShardMap(default_shard_ids(4)).spread(self.KEYS)
        assert set(spread) == set(default_shard_ids(4))
        ideal = len(self.KEYS) / 4
        for n in spread.values():
            assert 0.5 * ideal < n < 1.7 * ideal, spread

    def test_adding_one_shard_moves_about_one_nth(self):
        m4 = ShardMap(default_shard_ids(4))
        m5 = ShardMap(default_shard_ids(5))
        moved = [k for k in self.KEYS if m4.shard_for(k) != m5.shard_for(k)]
        assert 0.05 < len(moved) / len(self.KEYS) < 0.40
        assert all(m5.shard_for(k) == "bus-4" for k in moved)

    def test_removing_one_shard_only_redistributes_its_keys(self):
        m4 = ShardMap(default_shard_ids(4))
        m3 = ShardMap(default_shard_ids(3))
        for k in self.KEYS:
            if m4.shard_for(k) != "bus-3":
                assert m3.shard_for(k) == m4.shard_for(k)

    def test_duplicate_and_empty_ids_rejected(self):
        with pytest.raises(ValueError):
            ShardMap(["a", "a"])
        with pytest.raises(ValueError):
            ShardMap([])


# ---------------------------------------------------------------------------
# routing keys
# ---------------------------------------------------------------------------
class TestRoutingKey:
    def test_work_queue_routes_by_channel(self):
        assert routing_key(TOPIC_WORK_QUEUE, {"item": {
            "id": "work_1", "url": "https://t.me/SomeChannel/123"}}) == "123"
        assert routing_key(TOPIC_WORK_QUEUE, {"item": {
            "id": "work_1", "url": "https://t.me/SomeChannel"}}) == \
            "somechannel"
        assert channel_of("https://youtube.com/@Handle") == "handle"

    def test_result_routes_by_work_item_id(self):
        assert routing_key(TOPIC_RESULTS,
                           {"result": {"work_item_id": "w9"}}) == "w9"

    def test_batches_route_by_batch_id_and_uid(self):
        assert routing_key(TOPIC_INFERENCE_BATCHES,
                           {"batch_id": "b7", "records": []}) == "b7"
        assert routing_key("t", {"post_uid": "c1_5"}) == "c1_5"

    def test_stable_for_objects_and_redeliveries(self):
        from distributed_crawler_tpu_torch.bus.codec import RecordBatch

        batch = RecordBatch.from_dict({"batch_id": "b-obj", "records": [
            {"post_uid": "p1", "description": "x"}]})
        # An object and its dict form (a redelivered frame) key alike.
        assert routing_key(TOPIC_INFERENCE_BATCHES, batch) == \
            routing_key(TOPIC_INFERENCE_BATCHES, batch.to_dict()) == "b-obj"

    def test_unknown_payload_falls_back_to_topic(self):
        assert routing_key("weird-topic", {"x": 1}) == "weird-topic"
        assert routing_key("weird-topic", "not-a-dict") == "weird-topic"


# ---------------------------------------------------------------------------
# the shared-WAL rejection and the CLI's shard validation
# ---------------------------------------------------------------------------
class _Resolver:
    """The resolver calls `_parse_shard_addresses` and `_make_bus` make."""

    def __init__(self, addrs, shards=0, address=""):
        self._a, self._s, self._addr = addrs, shards, address

    def get(self, key, default=None):
        return self._a if key == "bus.shard_addresses" else default

    def get_int(self, key, default=0):
        return self._s if key == "bus.shards" else default

    def get_str(self, key, default=""):
        return self._addr if key == "distributed.bus_address" else default


class TestSpoolDirValidation:
    def test_derived_dirs_are_distinct(self, tmp_path):
        dirs = shard_spool_dirs(str(tmp_path), default_shard_ids(3))
        assert len(set(dirs.values())) == 3

    def test_shared_dir_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="share one spool"):
            validate_shard_spool_dirs({"bus-0": str(tmp_path),
                                       "bus-1": str(tmp_path)})

    def test_empty_dir_rejected(self):
        with pytest.raises(ValueError, match="no spool directory"):
            validate_shard_spool_dirs({"bus-0": "/x", "bus-1": ""})

    def test_partitioned_bus_rejects_shared_outbox_wal(self, tmp_path):
        eps = {sid: _FakeEndpoint() for sid in default_shard_ids(2)}
        with pytest.raises(ValueError, match="share one spool"):
            PartitionedBus(eps, registry=MetricsRegistry(),
                           outbox=lambda sid: OutboxConfig(dir=str(tmp_path)))

    def test_partitioned_bus_rejects_partial_durability(self, tmp_path):
        eps = {sid: _FakeEndpoint() for sid in default_shard_ids(2)}
        with pytest.raises(ValueError, match="every shard or none"):
            PartitionedBus(eps, registry=MetricsRegistry(),
                           outbox=lambda sid: OutboxConfig(
                               dir=str(tmp_path / sid) if sid == "bus-0"
                               else ""))

    def test_cli_shard_address_validation(self):
        from distributed_crawler_tpu_torch.cli import (
            CliConfigError,
            _parse_shard_addresses,
        )

        assert _parse_shard_addresses(_Resolver("a:1,b:2")) == ["a:1", "b:2"]
        assert _parse_shard_addresses(_Resolver(["a:1", "b:2"], 2)) == \
            ["a:1", "b:2"]
        with pytest.raises(CliConfigError, match="mismatched"):
            _parse_shard_addresses(_Resolver("a:1,b:2", shards=3))
        with pytest.raises(CliConfigError, match="duplicate"):
            _parse_shard_addresses(_Resolver("a:1,a:1"))
        with pytest.raises(CliConfigError, match="needs"):
            _parse_shard_addresses(_Resolver("", shards=3))

    def test_cli_rejects_bus_address_plus_shard_addresses(self):
        from distributed_crawler_tpu_torch.cli import (
            CliConfigError,
            _make_bus,
        )

        with pytest.raises(CliConfigError, match="mutually exclusive"):
            _make_bus(_Resolver("a:1,b:2", address="c:3"))


# ---------------------------------------------------------------------------
# PartitionedBus: routing, broadcast dedupe, failover parking
# ---------------------------------------------------------------------------
class TestPartitionedBus:
    def test_routed_topic_lands_on_exactly_one_shard(self):
        bus, eps = _pbus(3)
        try:
            for i in range(30):
                bus.publish(TOPIC_INFERENCE_BATCHES,
                            {"batch_id": f"b{i}", "records": []})
            assert bus.drain_outboxes(DEADLINE_S)
            assert sum(len(ep.published) for ep in eps.values()) == 30
            counts = bus.routed_counts(TOPIC_INFERENCE_BATCHES)
            assert sum(counts.values()) == 30
            assert len([c for c in counts.values() if c]) >= 2, counts
        finally:
            bus.close()

    def test_same_key_always_same_shard(self):
        bus, eps = _pbus(3)
        try:
            for _ in range(5):
                bus.publish(TOPIC_INFERENCE_BATCHES,
                            {"batch_id": "stable", "records": []})
            assert bus.drain_outboxes(DEADLINE_S)
            landed = [sid for sid, ep in eps.items()
                      for t, _ in ep.published
                      if t == TOPIC_INFERENCE_BATCHES]
            assert len(set(landed)) == 1 and len(landed) == 5
        finally:
            bus.close()

    def test_broadcast_reaches_every_shard_but_delivers_once(self):
        bus, eps = _pbus(3)
        try:
            got = []
            bus.subscribe(TOPIC_WORKER_STATUS, got.append)
            bus.publish(TOPIC_WORKER_STATUS, {"worker_id": "w1"})
            assert bus.drain_outboxes(DEADLINE_S)
            # Every copy has been dispatched (the fakes deliver inline), so
            # a would-be duplicate would already be in `got`.
            assert all(ep.count(TOPIC_WORKER_STATUS) == 1
                       for ep in eps.values())
            assert got == [{"worker_id": "w1"}]
        finally:
            bus.close()

    def test_broadcast_topics_cover_the_fanout_set(self):
        assert BROADCAST_TOPICS == jpart.BROADCAST_TOPICS
        assert TOPIC_WORKER_STATUS in BROADCAST_TOPICS
        assert TOPIC_WORK_QUEUE not in BROADCAST_TOPICS
        assert TOPIC_INFERENCE_BATCHES not in BROADCAST_TOPICS

    def test_dead_shard_parks_frames_in_order_no_rehash(self):
        bus, eps = _pbus(3)
        try:
            sid = bus.shard_for_key("stable")
            eps[sid].kill()
            for i in range(4):
                bus.publish(TOPIC_INFERENCE_BATCHES,
                            {"batch_id": "stable", "records": [], "seq": i})
            ob = bus._outboxes[sid]
            assert wait_until(lambda: ob.circuit_state == "open")
            assert bus.outbox_depth() == 4
            for other, ep in eps.items():
                if other != sid:
                    assert ep.count(TOPIC_INFERENCE_BATCHES) == 0
            eps[sid].restart()
            assert bus.drain_outboxes(DEADLINE_S)
            assert [p.get("seq") for t, p in eps[sid].published
                    if t == TOPIC_INFERENCE_BATCHES] == [0, 1, 2, 3]
        finally:
            bus.close()

    def test_per_shard_breaker_targets(self):
        registry = MetricsRegistry()
        bus, eps = _pbus(2, registry=registry)
        sid = bus.shard_for_key("k")
        other = next(s for s in eps if s != sid)
        gauge = registry.gauge("resilience_circuit_state")

        def states():
            return {lbl.get("target"): v for lbl, v in gauge.series() if lbl}

        try:
            eps[sid].down = True
            bus.publish(TOPIC_INFERENCE_BATCHES,
                        {"batch_id": "k", "records": []})
            assert wait_until(lambda: states().get(sid) == 1.0), states()
            assert states().get(other) in (None, 0.0), states()
        finally:
            for ep in eps.values():
                ep.down = False
            bus.close()

    def test_snapshot_shape_and_json_safety(self):
        bus, eps = _pbus(2)
        try:
            bus.enable_pull(TOPIC_INFERENCE_BATCHES)
            bus.publish(TOPIC_INFERENCE_BATCHES,
                        {"batch_id": "b", "records": []})
            bus.publish(TOPIC_WORKER_STATUS, {"worker_id": "w"})
            assert bus.drain_outboxes(DEADLINE_S)
            snap = json.loads(json.dumps(bus.snapshot()))
            assert set(snap["shards"]) == {"bus-0", "bus-1"}
            row = snap["shards"]["bus-0"]
            for key in ("address", "generation", "alive", "outbox_depth",
                        "breaker", "routed_frames", "pending"):
                assert key in row, row
            assert snap["ring"]["replicas"] >= 1
            assert snap["broadcast_frames"] == 1
            assert TOPIC_INFERENCE_BATCHES in snap["pull_topics"]
        finally:
            bus.close()

    def test_broadcast_survives_minority_outbox_failure(self):
        eps = {sid: _FakeEndpoint() for sid in default_shard_ids(3)}
        bus = PartitionedBus(eps, registry=MetricsRegistry(),
                             outbox=lambda sid: OutboxConfig(max_frames=1))
        try:
            got = []
            bus.subscribe(TOPIC_WORKER_STATUS, got.append)
            eps["bus-1"].kill()
            bus.publish(TOPIC_WORKER_STATUS, {"worker_id": "a"})  # fills
            assert wait_until(lambda: len(got) == 1)
            bus.publish(TOPIC_WORKER_STATUS, {"worker_id": "b"})  # full
            assert wait_until(lambda: len(got) == 2)
            assert bus._outboxes["bus-0"].drain(DEADLINE_S)
            assert bus._outboxes["bus-2"].drain(DEADLINE_S)
            assert [p["worker_id"] for p in got] == ["a", "b"], got
        finally:
            bus.close(drain_s=0.0)

    def test_broadcast_skips_open_breaker_shard_no_stale_parking(self):
        registry = MetricsRegistry()
        bus, eps = _pbus(2, registry=registry)
        try:
            eps["bus-1"].kill()
            key = next(k for k in (f"k{i}" for i in range(64))
                       if bus.shard_for_key(k) == "bus-1")
            bus.publish(TOPIC_INFERENCE_BATCHES,
                        {"batch_id": key, "records": []})
            ob1 = bus._outboxes["bus-1"]
            assert wait_until(lambda: ob1.circuit_state == "open")
            depth_before = ob1.depth()
            for i in range(5):
                bus.publish(TOPIC_WORKER_STATUS, {"worker_id": f"w{i}"})
            assert ob1.depth() == depth_before  # no broadcast parking
            assert wait_until(
                lambda: eps["bus-0"].count(TOPIC_WORKER_STATUS) == 5)
        finally:
            eps["bus-1"].restart()
            bus.close()

    def test_broadcast_raises_only_when_every_shard_rejects(self):
        eps = {sid: _FakeEndpoint() for sid in default_shard_ids(2)}
        bus = PartitionedBus(eps, registry=MetricsRegistry(),
                             outbox=lambda sid: OutboxConfig(max_frames=1))
        try:
            for ep in eps.values():
                ep.kill()
            bus.publish(TOPIC_WORKER_STATUS, {"worker_id": "a"})
            # With every breaker open the next copy is offered to every
            # shard, and every outbox is full.
            assert wait_until(lambda: all(
                ob.circuit_state == "open" for ob in bus.shard_outboxes()))
            with pytest.raises(OutboxFull):
                bus.publish(TOPIC_WORKER_STATUS, {"worker_id": "b"})
        finally:
            for ep in eps.values():
                ep.restart()
            bus.close()

    def test_dlq_snapshot_merges_topics_across_shards(self):
        bus, eps = _pbus(2)
        try:
            bodies = {
                "bus-0": {"enabled": True, "dead_letters_total": 2,
                          "topics": {"t": {"count": 2, "pending": 1,
                                           "entries": [{"id": "a"}]}}},
                "bus-1": {"enabled": True, "dead_letters_total": 1,
                          "topics": {"t": {"count": 1, "pending": 1,
                                           "entries": [{"id": "b"}]}}},
            }
            for sid, ep in eps.items():
                ep.dlq_snapshot = \
                    lambda topic=None, id=None, _b=bodies[sid]: _b
            body = bus.dlq_snapshot()
            assert body["dead_letters_total"] == 3
            assert body["topics"]["t"]["count"] == 3
            assert body["topics"]["t"]["pending"] == 2
            assert {e["shard"] for e in body["topics"]["t"]["entries"]} == \
                {"bus-0", "bus-1"}
        finally:
            bus.close()

    def test_manual_ack_rejected_on_broadcast(self):
        bus, _ = _pbus(2)
        try:
            # The port reads manual ack from the handler's signature.
            with pytest.raises(ValueError, match="auto-ack"):
                bus.subscribe(TOPIC_WORKER_STATUS, lambda p, a: None)
        finally:
            bus.close()


# ---------------------------------------------------------------------------
# /shards over HTTP, in the postmortem bundle, in tools/watch.py
# ---------------------------------------------------------------------------
class TestShardsSurface:
    def test_shards_endpoint_over_http(self):
        from distributed_crawler_tpu_torch.utils.metrics import (
            clear_shards_provider,
            serve_metrics,
            set_shards_provider,
        )

        bus, _ = _pbus(2)
        server = serve_metrics(0, MetricsRegistry())
        url = f"http://127.0.0.1:{server.server_address[1]}/shards"
        try:
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(url, timeout=10)
            set_shards_provider(bus.snapshot)
            body = json.load(urllib.request.urlopen(url, timeout=10))
            assert set(body["shards"]) == {"bus-0", "bus-1"}
        finally:
            clear_shards_provider(bus.snapshot)
            server.shutdown()
            server.server_close()
            bus.close()

    def test_bundle_embeds_shards(self):
        from distributed_crawler_tpu_torch.utils import flight
        from distributed_crawler_tpu_torch.utils.metrics import (
            clear_shards_provider,
            set_shards_provider,
        )

        bus, _ = _pbus(2)
        set_shards_provider(bus.snapshot)
        try:
            bundle = flight.RECORDER.bundle("test")
            assert set(bundle["bus_shards"]["shards"]) == {"bus-0", "bus-1"}
        finally:
            clear_shards_provider(bus.snapshot)
            bus.close()
        assert "bus_shards" not in flight.RECORDER.bundle("test")

    def test_watch_renders_shards_panel(self):
        import tools.watch as watch

        bus, eps = _pbus(2)
        try:
            eps["bus-1"].kill()
            out = watch.render_dashboard(None, None, None, now=1000.0,
                                         shards=bus.snapshot())
            assert "bus shards — 2 shard(s)" in out
            assert "DOWN" in out and "bus-0" in out
        finally:
            bus.close()


# ---------------------------------------------------------------------------
# gRPC end to end: two real shards, one killed and restarted
# ---------------------------------------------------------------------------
class _ShardHandle:
    """One broker shard at a fixed address: ``kill`` drops the live server
    as a SIGKILL would, ``restart`` serves a new generation over the same
    spool and port."""

    def __init__(self, spool):
        self.spool = spool
        self.address = "127.0.0.1:0"
        self.server = None
        self.generation = 0
        self.start()

    def start(self):
        server = GrpcBusServer(self.address, spool_dir=self.spool,
                               ack_timeout_s=5.0, registry=MetricsRegistry())
        assert server.bound_port, f"could not bind {self.address}"
        server.enable_pull(TOPIC_INFERENCE_BATCHES)
        server.start()
        self.address = f"127.0.0.1:{server.bound_port}"
        self.server = server
        self.generation += 1

    def kill(self):
        server, self.server = self.server, None
        server.kill()

    def publish(self, topic, payload):
        server = self.server
        if server is None:
            raise RuntimeError("bus is down")
        server.publish(topic, payload)

    def close(self):
        if self.server is not None:
            self.server.close()


class TestGrpcShardFailover:
    def test_kill_one_shard_park_and_replay(self, tmp_path):
        sids = default_shard_ids(2)
        spools = shard_spool_dirs(str(tmp_path / "spool"), sids)
        handles = {sid: _ShardHandle(spools[sid]) for sid in sids}
        ring = ShardMap(sids)
        local = PartitionedBus(
            handles, ring,
            outbox=lambda sid: OutboxConfig(
                dir=str(tmp_path / "outbox" / sid), max_frames=64,
                breaker_recovery_s=0.2),
            registry=MetricsRegistry())
        worker = PartitionedBus(
            {sid: RemoteBus(handles[sid].address) for sid in sids}, ring,
            registry=MetricsRegistry())
        got = []
        lock = threading.Lock()

        def handler(payload, ack):
            with lock:
                got.append(payload["batch_id"])
            ack(True)

        def seen():
            with lock:
                return list(got)

        worker.subscribe(TOPIC_INFERENCE_BATCHES, handler)
        try:
            keys = [f"b{i}" for i in range(10)]
            victim = sids[0]
            victim_keys = [k for k in keys if ring.shard_for(k) == victim]
            live_keys = [k for k in keys if ring.shard_for(k) != victim]
            assert victim_keys and live_keys
            for k in keys[:5]:
                local.publish(TOPIC_INFERENCE_BATCHES,
                              {"batch_id": k, "records": []})
            assert local.drain_outboxes(DEADLINE_S)
            assert wait_until(lambda: set(keys[:5]) <= set(seen()))
            handles[victim].kill()
            for k in keys[5:]:
                local.publish(TOPIC_INFERENCE_BATCHES,
                              {"batch_id": k, "records": []})
            # The live shard's share flows while the victim's parks.
            assert wait_until(lambda: set(live_keys) <= set(seen()),
                              timeout_s=60.0), (seen(), live_keys)
            parked = [k for k in keys[5:] if k in victim_keys]
            assert local._outboxes[victim].depth() == len(parked)
            handles[victim].start()
            assert wait_until(lambda: set(seen()) == set(keys),
                              timeout_s=60.0), seen()
            # Zero lost, zero duplicated, across the generation boundary;
            # the parked frames arrive in their publish order.
            assert sorted(seen()) == sorted(keys)
            after = [k for k in seen() if k in parked]
            assert after == parked
            assert handles[victim].generation == 2
            assert handles[sids[1]].generation == 1
        finally:
            worker.close()
            local.close()  # closes the shard handles too


# ---------------------------------------------------------------------------
# the wedged-channel rebuild
# ---------------------------------------------------------------------------
class TestChannelSelfHealing:
    def test_rebuild_after_sustained_failures_with_cooldown(self):
        import grpc

        cli = GrpcBusClient("127.0.0.1:1")  # nothing listens here
        try:
            for _ in range(GrpcBusClient.REBUILD_AFTER_FAILURES):
                with pytest.raises(grpc.RpcError):
                    cli.publish("t", {"x": 1})
            assert cli.rebuilds == 1
            # The cooldown: another burst inside the window rebuilds not.
            for _ in range(GrpcBusClient.REBUILD_AFTER_FAILURES):
                with pytest.raises(grpc.RpcError):
                    cli.publish("t", {"x": 1})
            assert cli.rebuilds == 1
        finally:
            cli.close()

    def test_success_resets_the_failure_count(self):
        server = GrpcBusServer("127.0.0.1:0", registry=MetricsRegistry())
        server.enable_pull(TOPIC_INFERENCE_BATCHES)
        server.start()
        cli = GrpcBusClient(f"127.0.0.1:{server.bound_port}")
        try:
            cli._consecutive_failures = 3
            cli.publish(TOPIC_INFERENCE_BATCHES, {"batch_id": "b"})
            assert cli._consecutive_failures == 0
            assert cli.rebuilds == 0
        finally:
            cli.close()
            server.close()


# ---------------------------------------------------------------------------
# compatibility with the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_shard_map_equals_the_references(n_shards):
    keys = [f"post-{i}" for i in range(2048)] + \
        [f"batch-{i:05d}" for i in range(2048)]
    mine = ShardMap(default_shard_ids(n_shards))
    ref = jpart.ShardMap(jpart.default_shard_ids(n_shards))
    assert [mine.shard_for(k) for k in keys] == \
        [ref.shard_for(k) for k in keys]
    assert mine.spread(keys) == ref.spread(keys)


def test_routing_key_equals_the_references():
    from distributed_crawler_tpu.bus.codec import RecordBatch as JBatch

    from distributed_crawler_tpu_torch.bus.codec import RecordBatch

    batch = {"batch_id": "b1", "crawl_id": "c", "records": [
        {"post_uid": "p1", "description": "x"}]}
    corpus = [
        (TOPIC_WORK_QUEUE, {"item": {"id": "w", "url": "https://t.me/A/1"}}),
        (TOPIC_WORK_QUEUE, {"work_item": {"id": "w2", "url": ""}}),
        (TOPIC_WORK_QUEUE, {"item": {"url": "youtube.com/@Chan?x=1"}}),
        (TOPIC_RESULTS, {"result": {"work_item_id": "w9"}}),
        (TOPIC_RESULTS, {"work_result": {"work_item_id": "w8"}}),
        ("t", {"work_item_id": "w7"}), ("t", {"post_uid": "p"}),
        ("t", {"media_id": "m"}), ("t", {"batch_id": ""}),
        ("t", {"x": 1}), ("t", "text"), ("t", 7), ("t", None),
        ("t", b"\x00raw"), ("t", bytearray(b"raw")),
        (TOPIC_INFERENCE_BATCHES, batch),
    ]
    for topic, payload in corpus:
        assert routing_key(topic, payload) == \
            jpart.routing_key(topic, payload), (topic, payload)
    assert routing_key(TOPIC_INFERENCE_BATCHES,
                       RecordBatch.from_dict(batch)) == \
        jpart.routing_key(TOPIC_INFERENCE_BATCHES, JBatch.from_dict(batch))


def test_shards_bodies_equal_the_references():
    """The same endpoints, frames and outage through both packages'
    `PartitionedBus`: equal ``/shards`` bodies, served over HTTP."""
    from distributed_crawler_tpu.utils import metrics as jmetrics

    from distributed_crawler_tpu_torch.utils import metrics as tmetrics

    def drive(cls, cfg_cls, reg):
        eps = {sid: _FakeEndpoint() for sid in default_shard_ids(2)}
        eps["bus-1"].address = "10.0.0.2:50551"
        bus = cls(eps, registry=reg, name="w14",
                  outbox=lambda sid: cfg_cls(max_frames=16,
                                             flush_wait_s=0.01,
                                             retry_base_s=0.01,
                                             retry_max_s=0.02,
                                             breaker_threshold=2,
                                             breaker_recovery_s=60.0))
        bus.enable_pull(TOPIC_INFERENCE_BATCHES)
        for i in range(12):
            bus.publish(TOPIC_INFERENCE_BATCHES,
                        {"batch_id": f"b{i}", "records": []})
        bus.publish(TOPIC_WORKER_STATUS, {"worker_id": "w"})
        assert bus.drain_outboxes(DEADLINE_S)
        eps["bus-0"].kill()
        for i in range(12, 20):
            bus.publish(TOPIC_INFERENCE_BATCHES,
                        {"batch_id": f"b{i}", "records": []})
        ob = bus._outboxes["bus-0"]
        assert wait_until(lambda: ob.circuit_state == "open")
        assert bus._outboxes["bus-1"].drain(DEADLINE_S)
        return bus

    buses = [drive(PartitionedBus, OutboxConfig, MetricsRegistry()),
             drive(jpart.PartitionedBus, JaxOutboxConfig, JaxRegistry())]
    http = [tmetrics.serve_metrics(0, MetricsRegistry()),
            jmetrics.serve_metrics(0, JaxRegistry())]
    tmetrics.set_shards_provider(buses[0].snapshot)
    jmetrics.set_shards_provider(buses[1].snapshot)
    try:
        bodies = [json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{h.server_address[1]}/shards", timeout=10))
            for h in http]
        assert bodies[0] == bodies[1]
        assert bodies[0]["shards"]["bus-0"]["breaker"] == "open"
        assert bodies[0]["shards"]["bus-0"]["alive"] is False
        assert bodies[0]["shards"]["bus-0"]["outbox_depth"] > 0
    finally:
        tmetrics.clear_shards_provider(buses[0].snapshot)
        jmetrics.clear_shards_provider(buses[1].snapshot)
        for h in http:
            h.shutdown()
            h.server_close()
        for b in buses:
            b.close(drain_s=0.0)


@pytest.mark.parametrize("publisher", ["ref", "port"])
def test_publish_through_the_other_packages_shard_ring(tmp_path, publisher):
    """Two broker shards of one package; a `PartitionedBus` of the other
    package's `RemoteBus` clients (with durable outboxes) publishes, and a
    consumer of the brokers' package pulls every batch from the shard the
    ring names."""
    pub_pkg = {"ref": (jpart, jgrpc, JaxOutboxConfig, JaxRegistry),
               "port": (None, None, OutboxConfig, MetricsRegistry)}
    sids = default_shard_ids(2)
    srv_cls, reg_cls = ((GrpcBusServer, MetricsRegistry)
                        if publisher == "ref"
                        else (jgrpc.GrpcBusServer, JaxRegistry))
    servers = {}
    for sid in sids:
        srv = srv_cls("127.0.0.1:0", spool_dir=str(tmp_path / sid),
                      registry=reg_cls())
        srv.enable_pull(TOPIC_INFERENCE_BATCHES)
        srv.start()
        servers[sid] = srv
    addrs = {sid: f"127.0.0.1:{s.bound_port}" for sid, s in servers.items()}
    part_mod, grpc_mod, cfg_cls, preg = pub_pkg[publisher]
    if publisher == "ref":
        bus_cls, remote = part_mod.PartitionedBus, grpc_mod.RemoteBus
    else:
        bus_cls, remote = PartitionedBus, RemoteBus
    pub = bus_cls({sid: remote(a) for sid, a in addrs.items()},
                  registry=preg(),
                  outbox=lambda sid: cfg_cls(dir=str(tmp_path / "ob" / sid)))
    keys = [f"x{i}" for i in range(8)]
    ring = ShardMap(sids)
    try:
        for k in keys:
            pub.publish(TOPIC_INFERENCE_BATCHES,
                        {"batch_id": k, "records": []})
        assert pub.drain_outboxes(DEADLINE_S)
        for sid, srv in servers.items():
            want = [k for k in keys if ring.shard_for(k) == sid]
            assert srv.pending_count(TOPIC_INFERENCE_BATCHES) == len(want)
            cli = (GrpcBusClient if publisher == "ref"
                   else jgrpc.GrpcBusClient)(addrs[sid])
            it = cli.pull(TOPIC_INFERENCE_BATCHES)
            got = []
            try:
                for _ in want:
                    delivery, frame = next(it)
                    got.append(json.loads(frame)["batch_id"])
                    cli.ack(TOPIC_INFERENCE_BATCHES, delivery, True)
            finally:
                it.close()
                cli.close()
            assert got == want
    finally:
        pub.close()
        for srv in servers.values():
            srv.close()

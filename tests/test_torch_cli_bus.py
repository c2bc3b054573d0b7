"""The port's gRPC bus (`bus/grpc_bus.py`) against the JAX package's, on the
CPU, and the two packages' ``tpu-worker --bus-serve`` talking to each other
over it.

- A scripted sequence on one pull topic (publish, pull, ack, nack, an ack
  left to time out, a frame past ``max_attempts``), an unrouted publish
  and a local subscriber that always fails must give the same deliveries,
  redeliveries, dead letters and ``bus_*_total`` series as the reference's
  `GrpcBusServer`, for every pairing of the two packages' servers and
  clients (the wire format is shared).
- `RemoteBus`: a one-argument handler that fails is retried inline, then
  nacked; the broker redelivers and dead-letters it, across the packages.
- ``tpu-worker --bus-serve``: the reference's `RemoteBus` publishes into
  the port's worker, and the port's `RemoteBus` into the reference's; the
  results rows compare as in `tests/test_torch_cli.py` (embeddings within
  1e-2, labels equal off a 2e-2 margin).

Every port comes from binding port 0.
"""

import json
import time

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("grpc")

from distributed_crawler_tpu import cli as jcli  # noqa: E402
from distributed_crawler_tpu.bus import grpc_bus as jbus  # noqa: E402
from distributed_crawler_tpu.utils import metrics as jmet  # noqa: E402
from distributed_crawler_tpu_torch import cli as tcli  # noqa: E402
from distributed_crawler_tpu_torch.bus import grpc_bus as tbus  # noqa: E402
from distributed_crawler_tpu_torch.utils import metrics as tmet  # noqa: E402
from tests.test_torch_cli import (  # noqa: E402, F401
    TOPIC_INFERENCE_BATCHES,
    _logging_restored,
    assert_rows_match,
    free_port,
    resolve,
    serve_batch,
    text_batch,
    worker_env,
    xlmr_ckpt,
)

PACKAGES = {"port": (tbus, tmet), "ref": (jbus, jmet)}
PAIRS = [(s, c) for s in PACKAGES for c in PACKAGES]
BUS_SERIES = ("bus_dead_letters_total", "bus_redeliveries_total",
              "bus_dropped_no_route_total")


def bus_series(registry):
    """The bus counters' labelled series, as exposed."""
    return sorted(line for line in registry.expose().splitlines()
                  if line.startswith(BUS_SERIES) and "{" in line)


def scripted_sequence(server_pkg, client_pkg):
    sbus, smet = PACKAGES[server_pkg]
    cbus, _ = PACKAGES[client_pkg]
    registry = smet.MetricsRegistry()
    server = sbus.GrpcBusServer("127.0.0.1:0", ack_timeout_s=0.4,
                                max_attempts=3, registry=registry)
    server.enable_pull("t")
    local_calls = []

    def failing(payload):
        local_calls.append(payload["n"])
        raise RuntimeError("handler down")

    server.subscribe("fan", failing)
    server.start()
    client = cbus.GrpcBusClient(f"127.0.0.1:{server.bound_port}")
    stream = client.pull("t")
    deliveries = []

    def take():
        delivery_id, frame = next(stream)
        deliveries.append(json.loads(frame)["n"])
        return delivery_id

    try:
        client.publish("t", {"n": 1})
        client.ack("t", take(), True)
        client.publish("t", {"n": 2})
        client.ack("t", take(), False)   # nack: attempt 1
        take()                           # left unacked: the deadline
        client.ack("t", take(), False)   # requeues it; a third nack dead-
        client.publish("t", {"n": 3})    # letters it (max_attempts 3)
        client.ack("t", take(), True)
        client.publish("nobody", {"n": 4})
        client.publish("fan", {"n": 5})
        assert server.flush_local(timeout_s=10)
        pending = server.pending_count("t")
    finally:
        stream.close()
        client.close()
        server.close()
    return {"deliveries": deliveries, "local_calls": local_calls,
            "dead_letters": server.dead_letters, "pending": pending,
            "series": bus_series(registry)}


EXPECTED = {
    "deliveries": [1, 2, 2, 2, 3],
    "local_calls": [5, 5, 5],
    "dead_letters": 2,
    "pending": 0,
    "series": sorted([
        'bus_dead_letters_total{topic="fan"} 1.0',
        'bus_dead_letters_total{topic="t"} 1.0',
        'bus_dropped_no_route_total{topic="nobody"} 1.0',
        'bus_redeliveries_total{topic="t"} 2.0',
    ]),
}


@pytest.mark.parametrize("server_pkg, client_pkg", PAIRS)
def test_scripted_sequence_equals_the_references(server_pkg, client_pkg):
    """(ref, ref) shows EXPECTED is the reference's behaviour."""
    assert scripted_sequence(server_pkg, client_pkg) == EXPECTED


@pytest.mark.parametrize("server_pkg, client_pkg", PAIRS)
def test_remote_bus_nacks_then_the_broker_dead_letters(server_pkg,
                                                       client_pkg):
    sbus, smet = PACKAGES[server_pkg]
    cbus, _ = PACKAGES[client_pkg]
    registry = smet.MetricsRegistry()
    server = sbus.GrpcBusServer("127.0.0.1:0", max_attempts=2,
                                registry=registry)
    server.enable_pull("work")
    server.start()
    address = f"127.0.0.1:{server.bound_port}"
    consumer = cbus.RemoteBus(address, max_redeliveries=1)
    producer = cbus.RemoteBus(address)
    calls, done = [], []

    def handler(payload):
        calls.append(payload["n"])
        if payload["n"] == 1:
            raise RuntimeError("poison")
        done.append(payload["n"])

    try:
        consumer.subscribe("work", handler)
        producer.publish("work", {"n": 1})
        producer.publish("work", {"n": 2})
        deadline = time.monotonic() + 20
        while (server.dead_letters < 1 or not done) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        deadline = time.monotonic() + 5
        while server.pending_count("work") and time.monotonic() < deadline:
            time.sleep(0.02)
        pending = server.pending_count("work")
    finally:
        producer.close()
        consumer.close()
        server.close()
    # Two inline attempts per delivery, two deliveries, then the dead
    # letter; the good frame once.
    assert sorted(calls) == [1, 1, 1, 1, 2]
    assert done == [2] and pending == 0
    assert server.dead_letters == 1
    assert bus_series(registry) == sorted([
        'bus_dead_letters_total{topic="work"} 1.0',
        'bus_redeliveries_total{topic="work"} 1.0'])


def test_drain_waits_for_the_pull_topics():
    server = tbus.GrpcBusServer("127.0.0.1:0",
                                registry=tmet.MetricsRegistry())
    server.enable_pull("q")
    server.start()
    try:
        server.publish("q", {"n": 1})
        assert server.pending_count("q") == 1
        assert server.drain(timeout_s=0.3, poll_s=0.05) is False
        client = tbus.GrpcBusClient(f"127.0.0.1:{server.bound_port}")
        stream = client.pull("q")
        try:
            delivery_id, frame = next(stream)
            assert json.loads(frame)["n"] == 1
            client.ack("q", delivery_id, True)
            assert server.drain(timeout_s=5, poll_s=0.05) is True
        finally:
            stream.close()
            client.close()
    finally:
        server.close()


def test_envelope_is_the_references():
    frame = tbus._encode_envelope("tpu-inference-batches", b'{"a": 1}')
    assert frame == jbus._encode_envelope("tpu-inference-batches",
                                          b'{"a": 1}')
    assert tbus._decode_envelope(frame) == jbus._decode_envelope(frame)
    assert tbus.SERVICE_NAME == jbus.SERVICE_NAME


# -- tpu-worker --bus-serve, across the packages ------------------------------
def test_tpu_worker_bus_serve_both_ways(xlmr_ckpt, tmp_path):
    batch = text_batch(batch_id="b-grpc")
    rows = {}
    for worker_name, cli, kw, producer_bus in (
            ("port", tcli, {"device": "cpu"}, jbus),
            ("ref", jcli, {}, tbus)):
        root = str(tmp_path / worker_name)
        address = f"127.0.0.1:{free_port()}"
        cfg, r = resolve(cli, ["--mode", "tpu-worker", "--bus-serve",
                               "--bus-address", address,
                               "--infer-batch-size", "4",
                               "--storage-root", root],
                         worker_env(xlmr_ckpt))
        worker = cli._build_tpu_worker(cfg, r, **kw)
        producer = producer_bus.RemoteBus(address)
        try:
            rows[worker_name] = serve_batch(worker, batch, root,
                                            publish=producer.publish)
        finally:
            producer.close()
    assert_rows_match(rows["port"], rows["ref"])
    assert len(rows["port"]) == len(batch["records"])


def test_bus_mode_brokers_between_processes(tmp_path):
    """``--mode bus`` as a process of its own: a frame the port's client
    publishes before any consumer is queued (the pull topics are enabled
    up front) and the reference's client pulls it; SIGTERM drains, closes
    and exits 130."""
    import os
    import signal
    import subprocess
    import sys

    from tests.test_torch_cli import ROOT

    address = f"127.0.0.1:{free_port()}"
    code = ("import sys; from distributed_crawler_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--mode", "bus", "--bus-address",
         address, "--bus-ack-timeout-s", "30"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    producer = tbus.RemoteBus(address)
    consumer = jbus.RemoteBus(address)
    got = []
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                producer.publish(TOPIC_INFERENCE_BATCHES, {"n": 1})
                break
            except Exception:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        consumer.subscribe(TOPIC_INFERENCE_BATCHES, got.append)
        deadline = time.monotonic() + 30
        while not got and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)  # the consumer's ack lands before the drain
    finally:
        producer.close()
        consumer.close()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    assert [p["n"] for p in got] == [1]
    assert rc == 130

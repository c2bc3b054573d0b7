"""The port's worker over the port's in-memory bus, on the CPU.

RecordBatches go in on the inference topic; one result frame per batch
must come out, results in record order, coalesced or not, with the
per-batch fallback when the coalesced step raises — and equal to the JAX
package's `TPUWorker` on the same params and batches (labels equal,
embeddings and scores within 1e-5 abs / 1e-4 rel, f32 throughout).
"""

import dataclasses
import json
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from distributed_crawler_tpu.bus.codec import (  # noqa: E402
    RecordBatch as JaxRecordBatch,
)
from distributed_crawler_tpu.bus.inmemory import (  # noqa: E402
    InMemoryBus as JaxBus,
)
from distributed_crawler_tpu.datamodel import Post  # noqa: E402
from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.inference import worker as jwork  # noqa: E402
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.bus import (  # noqa: E402
    TOPIC_INFERENCE_BATCHES,
    TOPIC_INFERENCE_RESULTS,
    InMemoryBus,
    RecordBatch,
)
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.inference.worker import (  # noqa: E402
    TPUWorker,
    TPUWorkerConfig,
)
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = dict(model="tiny", n_labels=3, batch_size=4, buckets=(16, 32, 64))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    je = jeng.InferenceEngine(jeng.EngineConfig(**CFG),
                              registry=JaxRegistry())
    return je, jax.tree.map(np.asarray, je.params)


def _port_engine(params, cls=teng.InferenceEngine):
    return cls(teng.EngineConfig(**CFG), params=params,
               registry=MetricsRegistry(), device="cpu")


def _posts(n, start=0):
    return [Post(post_uid=f"p{start + i}", channel_name="chan",
                 description=" ".join(["message", "text"] * (i % 9 + 1)
                                      + [str(start + i)]))
            for i in range(n)]


def _jax_batches(sizes):
    out, start = [], 0
    for i, n in enumerate(sizes):
        out.append(JaxRecordBatch.from_posts(_posts(n, start),
                                             crawl_id=f"c{i}"))
        start += n
    return out


def _run_port(engine, batch_dicts, coalesce=4, pack=True, provider=None,
              **cfg):
    """Enqueue every batch before the feed thread starts, so one dequeue
    coalesces them deterministically; returns (frames, acks, worker)."""
    bus = InMemoryBus()
    frames, acks = [], []
    bus.subscribe(TOPIC_INFERENCE_RESULTS, frames.append)
    worker = TPUWorker(bus, engine, provider=provider,
                       cfg=TPUWorkerConfig(worker_id="w1",
                                           coalesce_batches=coalesce,
                                           pack=pack, **cfg),
                       registry=MetricsRegistry())
    for d in batch_dicts:
        worker._handle_payload(
            d, (lambda bid: lambda ok=True: acks.append((bid, ok)))(
                d["batch_id"]))
    worker.start()
    assert worker.drain(timeout_s=30.0)
    worker.stop()
    bus.close()
    return frames, acks, worker


def _run_jax(engine, batch_dicts, coalesce=4, pack=True):
    bus = JaxBus()
    frames, acks = [], []
    bus.subscribe(jwork.TOPIC_INFERENCE_RESULTS, frames.append)
    worker = jwork.TPUWorker(bus, engine, cfg=jwork.TPUWorkerConfig(
        worker_id="w1", heartbeat_s=3600, coalesce_batches=coalesce,
        pack=pack, span_export_interval_s=0), registry=JaxRegistry())
    for d in batch_dicts:
        worker._handle_payload(
            d, (lambda bid: lambda ok=True: acks.append((bid, ok)))(
                d["batch_id"]))
    worker.start()
    assert worker.drain(timeout_s=30.0)
    worker.stop()
    bus.close()
    return frames


def _by_batch(frames):
    out = {}
    for f in frames:
        assert f["batch_id"] not in out, "duplicate result frame"
        out[f["batch_id"]] = f
    return out


def _assert_same(ra, rb):
    assert [r["label"] for r in ra] == [r["label"] for r in rb]
    np.testing.assert_allclose([r["embedding"] for r in ra],
                               [r["embedding"] for r in rb], **TOL)
    np.testing.assert_allclose([r["scores"] for r in ra],
                               [r["scores"] for r in rb], **TOL)


@pytest.mark.parametrize("coalesce, pack", [(4, True), (4, False),
                                            (1, True), (1, False)])
def test_one_frame_per_batch_in_record_order(jax_params, coalesce, pack):
    _, params = jax_params
    engine = _port_engine(params)
    dicts = [b.to_dict() for b in _jax_batches([3, 5, 1])]
    frames, acks, worker = _run_port(engine, dicts, coalesce, pack)
    by_id = _by_batch(frames)
    assert sorted(by_id) == sorted(d["batch_id"] for d in dicts)
    assert sorted(acks) == sorted((d["batch_id"], True) for d in dicts)
    assert worker.get_status()["processed_batches"] == 3
    for d in dicts:
        rb = RecordBatch.from_dict(by_id[d["batch_id"]])
        assert [r["post_uid"] for r in rb.records] == \
            [r["post_uid"] for r in d["records"]]
        want = engine.run(RecordBatch.from_dict(d).texts())
        _assert_same(rb.results, want)
    if coalesce > 1:
        assert worker.m_coalesce.count == 1


def test_results_equal_jax_worker(jax_params):
    je, params = jax_params
    dicts = [b.to_dict() for b in _jax_batches([4, 2, 6, 3])]
    port = _by_batch(_run_port(_port_engine(params), dicts)[0])
    ref = _by_batch(_run_jax(je, dicts))
    assert sorted(port) == sorted(ref)
    for bid, frame in port.items():
        assert frame["records"] == ref[bid]["records"]
        _assert_same(frame["results"], ref[bid]["results"])


class _FailsWhenCoalesced(teng.InferenceEngine):
    """Raises on any stream longer than one batch: the coalesced step
    fails, the per-batch retries succeed."""

    limit = 5

    def run_tokenized(self, token_lists, pack=False):
        if len(token_lists) > self.limit:
            raise RuntimeError("coalesced step failed")
        return super().run_tokenized(token_lists, pack=pack)


def test_per_batch_fallback(jax_params):
    _, params = jax_params
    engine = _port_engine(params, cls=_FailsWhenCoalesced)
    dicts = [b.to_dict() for b in _jax_batches([3, 4, 2])]
    frames, acks, worker = _run_port(engine, dicts)
    by_id = _by_batch(frames)
    assert len(by_id) == 3
    assert sorted(acks) == sorted((d["batch_id"], True) for d in dicts)
    assert worker.get_status()["error_batches"] == 0
    plain = _port_engine(params)
    for d in dicts:
        _assert_same(by_id[d["batch_id"]]["results"],
                     plain.run(RecordBatch.from_dict(d).texts(), pack=True))


def test_poisoned_batch_fails_alone(jax_params):
    _, params = jax_params
    engine = _port_engine(params)
    dicts = [b.to_dict() for b in _jax_batches([2, 2, 2])]
    poisoned = dicts[1]["batch_id"]
    inner = engine.tokenizer

    class Gate:
        vocab_size = inner.vocab_size

        def encode_batch(self, texts):
            if any(t.endswith(" 2") for t in texts):
                raise ValueError("poisoned record")
            return inner.encode_batch(texts)

    engine.tokenizer = Gate()
    frames, acks, worker = _run_port(engine, dicts)
    assert sorted(_by_batch(frames)) == sorted(
        d["batch_id"] for d in dicts if d["batch_id"] != poisoned)
    assert (poisoned, False) in acks
    assert worker.get_status()["error_batches"] == 1


def test_writeback_and_embedding_knobs(jax_params):
    _, params = jax_params

    class Provider:
        def __init__(self):
            self.files = {}

        def put_text(self, path, text):
            self.files[path] = text

    provider = Provider()
    dicts = [b.to_dict() for b in _jax_batches([3, 2])]
    frames, _, _ = _run_port(_port_engine(params), dicts, provider=provider,
                             publish_embeddings=False, write_embeddings=True)
    assert all("embedding" not in r for f in frames for r in f["results"])
    assert len(provider.files) == 2
    for d in dicts:
        text = provider.files[f"inference/{d['crawl_id']}/batches/"
                              f"{d['batch_id']}.jsonl"]
        lines = [json.loads(x) for x in text.splitlines()]
        assert [x["post_uid"] for x in lines] == \
            [r["post_uid"] for r in d["records"]]
        assert all(len(x["embedding"]) == 64 and x["trace_id"]
                   for x in lines)


def test_end_to_end_through_async_bus(jax_params):
    _, params = jax_params
    bus = InMemoryBus(sync=False)
    frames = []
    bus.subscribe(TOPIC_INFERENCE_RESULTS, frames.append)
    worker = TPUWorker(bus, _port_engine(params),
                       cfg=TPUWorkerConfig(worker_id="w2"),
                       registry=MetricsRegistry())
    worker.start()
    bus.start()
    batches = [RecordBatch.from_records(
        [p.to_dict() for p in _posts(4, 10 * i)], crawl_id="e2e")
        for i in range(3)]
    for b in batches:
        bus.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
    deadline = time.monotonic() + 20
    while len(frames) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert worker.drain(timeout_s=20.0)
    worker.stop()
    bus.close()
    assert sorted(_by_batch(frames)) == sorted(b.batch_id for b in batches)
    assert worker.m_batches.value == 3


class TestCodecAndBus:
    def test_record_batch_round_trips_with_jax(self):
        jb = _jax_batches([3])[0]
        jb.results = [{"label": 1}] * 3
        pb = RecordBatch.from_dict(jb.to_dict())
        assert pb.to_dict() == jb.to_dict()
        assert JaxRecordBatch.from_dict(pb.to_dict()).to_dict() == \
            jb.to_dict()
        assert pb.texts() == jb.texts() and len(pb) == len(jb)

    @pytest.mark.parametrize("fields", [
        {"all_text": "a", "searchable_text": "b", "description": "c"},
        {"searchable_text": "b", "description": "c"},
        {"description": "c", "transcript_text": "t"},
        {"transcript_text": "t", "image_text": "i"},
        {"image_text": "i"},
        {},
    ])
    def test_texts_follow_text_for_inference(self, fields):
        post = Post(post_uid="x", **fields)
        assert RecordBatch(records=[post.to_dict()]).texts() == \
            [post.text_for_inference()]
        assert RecordBatch(records=[fields]).texts() == \
            [post.text_for_inference()]

    def test_topics_and_tenant(self):
        from distributed_crawler_tpu.bus import messages as jmsg

        assert tmsg.TOPIC_INFERENCE_BATCHES == jmsg.TOPIC_INFERENCE_BATCHES
        assert tmsg.TOPIC_INFERENCE_RESULTS == jmsg.TOPIC_INFERENCE_RESULTS
        assert tmsg.DEFAULT_TENANT == jmsg.DEFAULT_TENANT
        for v in (None, "", "  ", 3, " acme "):
            assert tmsg.normalize_tenant(v) == jmsg.normalize_tenant(v)
        tid = tmsg.new_trace_id()
        assert tid.startswith("trace_") and len(tid) == \
            len(jmsg.new_trace_id())

    def test_json_round_trip_rejects_numpy_scalars(self):
        bus = InMemoryBus()
        with pytest.raises(TypeError):
            bus.publish("t", {"x": np.float32(1.0)})

    def test_retry_then_dead_letter(self):
        bus = InMemoryBus(max_redeliveries=2)
        calls = []

        def flaky(payload):
            calls.append(payload)
            if len(calls) < 3:
                raise RuntimeError("transient")

        def broken(payload):
            raise RuntimeError("always")

        bus.subscribe("a", flaky)
        bus.subscribe("b", broken)
        bus.publish("a", {"n": 1})
        bus.publish("b", {"n": 2})
        assert len(calls) == 3
        assert [(t, p) for t, p, _ in bus.dead_letters] == [("b", {"n": 2})]
        assert bus.stats() == {"published": {"a": 1, "b": 1},
                               "delivered": {"a": 1},
                               "dead_lettered": {"total": 1}}

    @pytest.mark.parametrize("hints, redeliveries, delay", [
        ([0.05, 5.0], 3, 0.0),        # a hint, then one past the 2 s cap
        ([0.05, None, 5.0], 2, 0.3),  # no hint: the fixed delay; dead-letter
        ([None, None], 3, 0.0),       # no hint, no delay: no sleep at all
    ])
    def test_retry_after_hints_match_reference(self, monkeypatch, hints,
                                               redeliveries, delay):
        """A handler raising with ``retry_after_s`` through both buses,
        ``time.sleep`` recorded: the same waits, deliveries, dead letters
        and ``resilience_retries_total`` increments."""
        from distributed_crawler_tpu.utils.metrics import REGISTRY as JREG

        from distributed_crawler_tpu_torch.utils.metrics import REGISTRY

        class Hinted(RuntimeError):
            def __init__(self, hint):
                super().__init__(f"retry after {hint}")
                if hint is not None:
                    self.retry_after_s = hint

        def run(bus_cls, registry):
            topic = f"hinted-{len(hints)}-{redeliveries}"
            counter = registry.counter("resilience_retries_total").labels(
                op=f"bus.inmemory.{topic}")
            before = counter.value
            sleeps, calls = [], []
            monkeypatch.setattr(time, "sleep", sleeps.append)

            def handler(payload):
                calls.append(payload)
                if len(calls) <= len(hints):
                    raise Hinted(hints[len(calls) - 1])

            bus = bus_cls(max_redeliveries=redeliveries, retry_delay_s=delay)
            bus.subscribe(topic, handler)
            bus.publish(topic, {"n": 1})
            monkeypatch.undo()
            return (sleeps, len(calls), bus.stats(),
                    [(t, p) for t, p, _ in bus.dead_letters],
                    counter.value - before)

        got, want = run(InMemoryBus, REGISTRY), run(JaxBus, JREG)
        assert got == want
        assert max(got[0], default=0.0) <= 2.0
        assert got[4] == min(len(hints), redeliveries)

    @pytest.mark.parametrize("policy, attempt, hint", [
        ({}, 0, None),
        ({}, 5, None),                                  # capped at 2 s
        ({"jitter": 0.0, "multiplier": 1.0}, 3, None),
        ({}, 1, 7.5),                                   # a hint wins
        ({"retry_after_cap_s": 2.0}, 0, 45.0),          # ... capped
        ({}, 0, "soon"),                                # unreadable hint
    ])
    def test_retry_policy_delays_match_reference(self, policy, attempt,
                                                 hint):
        from distributed_crawler_tpu.utils import resilience as jres

        from distributed_crawler_tpu_torch.utils import resilience as tres

        exc = RuntimeError("x")
        if hint is not None:
            exc.retry_after_s = hint
        ours, ref = tres.RetryPolicy(**policy), jres.RetryPolicy(**policy)
        assert ours.delay_s(attempt, exc, rng=lambda: 0.25) == \
            ref.delay_s(attempt, exc, rng=lambda: 0.25)
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(tres.RetryPolicy()) == \
            dataclasses.asdict(jres.RetryPolicy())

    def test_undecodable_dropped_and_async_drain(self):
        bus = InMemoryBus(sync=False)
        got = []
        bus.subscribe("t", got.append)
        bus.start()
        bus.publish("t", b"\xff not json")
        bus.publish("t", {"ok": True})
        assert bus.drain(timeout_s=5.0)
        bus.close()
        assert got == [{"ok": True}]

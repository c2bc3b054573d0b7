"""The port's `ClusterWorker` (`cluster/worker.py`) and `ClusterUpdateMessage`
against the JAX package's, on the CPU.

The worker cases mirror the reference's `tests/test_cluster_serve.py`
``TestClusterWorker`` (ack after writeback, idempotent redelivery, no
refold, poison isolation, checkpoint cadence, kill and resume) over the
port's in-memory bus and the reference's in-memory storage provider.  The
end-to-end case runs both packages' pipelines (`TPUWorker` on the ``tiny``
encoder with the reference's params, the bus, `ClusterWorker` resumed from
one shared checkpoint) over the same record batches: every post's cluster
must be equal, and the final centroids within 1e-5 (the embeddings differ
by f32 rounding, ~1e-6).
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from distributed_crawler_tpu.bus import messages as jmsg  # noqa: E402
from distributed_crawler_tpu.bus.codec import (  # noqa: E402
    RecordBatch as JaxRecordBatch,
)
from distributed_crawler_tpu.bus.codec import decode_message  # noqa: E402
from distributed_crawler_tpu.bus.inmemory import (  # noqa: E402
    InMemoryBus as JaxBus,
)
from distributed_crawler_tpu.cluster import worker as jcw  # noqa: E402
from distributed_crawler_tpu.datamodel import Post  # noqa: E402
from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.inference import worker as jwork  # noqa: E402
from distributed_crawler_tpu.state.providers import (  # noqa: E402
    InMemoryStorageProvider,
)
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.bus import (  # noqa: E402
    TOPIC_CLUSTERS,
    ClusterUpdateMessage,
    InMemoryBus,
    RecordBatch,
)
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.cluster import (  # noqa: E402
    ClusterWorker,
    ClusterWorkerConfig,
    iter_assignments,
)
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.inference.worker import (  # noqa: E402
    TPUWorker,
    TPUWorkerConfig,
)
from distributed_crawler_tpu_torch.utils import trace  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the envelope -----------------------------------------------------------
def test_constants_match_reference():
    assert tmsg.MSG_CLUSTER_UPDATE == jmsg.MSG_CLUSTER_UPDATE
    assert tmsg.TOPIC_CLUSTERS == jmsg.TOPIC_CLUSTERS


def test_cluster_update_roundtrip_equals_reference():
    msg = ClusterUpdateMessage.new(
        "cluster-1", k=8, step=12, vectors=300,
        sizes=[40, 30, 50, 60, 30, 40, 30, 20], inertia=0.41,
        underpopulated=[7], channel_clusters={"chanA": 7, "chanB": 2})
    msg.validate()
    d = json.loads(json.dumps(msg.to_dict()))
    ref = jmsg.ClusterUpdateMessage.from_dict(d)
    ref.validate()
    assert ref.to_dict() == d
    assert isinstance(decode_message(d), jmsg.ClusterUpdateMessage)
    back = ClusterUpdateMessage.from_dict(ref.to_dict())
    assert back.to_dict() == d
    assert back.channel_clusters == {"chanA": 7, "chanB": 2}
    assert back.inertia == pytest.approx(0.41)
    assert back.trace_id.startswith("trace_")
    # And the reference's own envelope decodes in the port unchanged.
    theirs = jmsg.ClusterUpdateMessage.new(
        "w", k=2, step=1, vectors=3, sizes=[2, 1], inertia=None)
    assert ClusterUpdateMessage.from_dict(
        theirs.to_dict()).to_dict() == theirs.to_dict()


@pytest.mark.parametrize("kw, match", [
    ({"k": 4}, "worker_id"),
    ({"worker_id": "w"}, "k must be positive"),
    ({"worker_id": "w", "k": 4, "sizes": [1, 2]}, "sizes"),
    ({"worker_id": "w", "k": 4, "underpopulated": [4]}, "out of range"),
    ({"worker_id": "w", "k": 4, "message_type": "x"}, "message type"),
])
def test_cluster_update_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        ClusterUpdateMessage(**kw).validate()
    with pytest.raises(ValueError, match=match):
        jmsg.ClusterUpdateMessage(**kw).validate()


# -- the worker -------------------------------------------------------------
def _result_batch(n=6, crawl_id="c1", dim=16, seed=0, channel="chanA"):
    """An embedding-carrying result batch, as TPUWorker publishes it."""
    rng = np.random.RandomState(seed)
    batch = RecordBatch.from_dict({
        "batch_id": f"b{seed}", "crawl_id": crawl_id,
        "records": [{"post_uid": f"p{seed}-{i}", "channel_name": channel,
                     "description": "t"} for i in range(n)],
        "results": [{"embedding": rng.randn(dim).tolist(),
                     "label": "x"} for _ in range(n)],
    })
    batch.trace_id = f"trace_test_{seed}"
    return batch


def _worker(provider, bus=None, **kw):
    bus = bus if bus is not None else InMemoryBus(sync=True)
    kw = {"checkpoint_every_batches": 1, **kw}
    cfg = ClusterWorkerConfig(worker_id="cluster-1", k=4, buckets=(8, 32),
                              **kw)
    return ClusterWorker(bus, provider=provider, cfg=cfg,
                         registry=MetricsRegistry(), device="cpu")


def _ledger_counts(provider, crawl="c1"):
    counts = {}
    for r in iter_assignments(provider, crawl):
        counts[r["post_uid"]] = counts.get(r["post_uid"], 0) + 1
    return counts


def test_batch_acked_after_writeback():
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    acks = []
    w._handle_payload(_result_batch(seed=1).to_dict(),
                      ack=lambda ok: acks.append(ok))
    w.start()
    try:
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    assert acks == [True]
    rows = list(iter_assignments(provider, "c1"))
    assert len(rows) == 6
    assert {r["post_uid"] for r in rows} == {f"p1-{i}" for i in range(6)}
    assert all(0 <= r["cluster"] < 4 for r in rows)
    assert all(r["trace_id"] == "trace_test_1" for r in rows)
    # The reference's row keys, and its reader sees the same rows.
    assert sorted(rows[0]) == ["batch_id", "channel_name", "cluster",
                               "post_uid", "tenant", "trace_id"]
    assert list(jcw.iter_assignments(provider, "c1")) == rows


def test_redelivery_overwrites_not_duplicates():
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    w.start()
    try:
        payload = _result_batch(seed=2).to_dict()
        w._handle_payload(payload, ack=None)
        assert w.drain(timeout_s=10)
        w._handle_payload(payload, ack=None)  # broker redelivery
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    counts = _ledger_counts(provider)
    assert counts and all(c == 1 for c in counts.values())


def test_redelivery_does_not_refold_the_model():
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    w.start()
    try:
        payload = _result_batch(seed=20).to_dict()
        w._handle_payload(payload, ack=None)
        assert w.drain(timeout_s=10)
        vectors_after_first = w.engine.vectors
        centroids_after_first = w.engine.centroids.clone()
        w._handle_payload(payload, ack=None)
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    assert w.engine.vectors == vectors_after_first
    assert torch.equal(w.engine.centroids, centroids_after_first)
    counts = _ledger_counts(provider)
    assert counts and all(c == 1 for c in counts.values())


def test_duplicate_in_one_coalesced_group_folds_once():
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    payload = _result_batch(seed=25).to_dict()
    acks = []
    # Both copies queued before start(): one coalesced group.
    w._handle_payload(payload, ack=lambda ok: acks.append(ok))
    w._handle_payload(payload, ack=lambda ok: acks.append(ok))
    w.start()
    try:
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    assert acks == [True, True]
    assert w.engine.vectors == 6
    counts = _ledger_counts(provider)
    assert counts and all(c == 1 for c in counts.values())


def test_failed_writeback_nack_then_redelivery_single_fold():
    provider = InMemoryStorageProvider()
    real_put = provider.put_text
    fails = {"n": 1}

    def flaky_put(rel, text):
        if rel.startswith("cluster/") and "batches" in rel \
                and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient store wedge")
        real_put(rel, text)

    provider.put_text = flaky_put
    w = _worker(provider)
    acks = []
    w.start()
    try:
        payload = _result_batch(seed=21).to_dict()
        w._handle_payload(payload, ack=lambda ok: acks.append(ok))
        assert w.drain(timeout_s=10)
        assert acks == [False]
        vectors_after = w.engine.vectors
        w._handle_payload(payload, ack=lambda ok: acks.append(ok))
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    assert acks == [False, True]
    assert w.engine.vectors == vectors_after
    counts = _ledger_counts(provider)
    assert counts and all(c == 1 for c in counts.values())


def test_folded_window_survives_checkpoint_resume():
    provider = InMemoryStorageProvider()
    w1 = _worker(provider)
    w1.start()
    payload = _result_batch(seed=22).to_dict()
    w1._handle_payload(payload, ack=None)
    assert w1.drain(timeout_s=10)
    w1.kill()
    w2 = _worker(provider)
    assert payload["batch_id"] in w2._folded
    w2.start()
    try:
        vectors_resumed = w2.engine.vectors
        w2._handle_payload(payload, ack=None)  # requeued frame
        assert w2.drain(timeout_s=10)
        assert w2.engine.vectors == vectors_resumed
    finally:
        w2.stop()


def test_checkpoint_failure_retries_next_batch():
    provider = InMemoryStorageProvider()
    real_save = provider.save_json
    fails = {"n": 1}

    def flaky_save(rel, data):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient store wedge")
        real_save(rel, data)

    provider.save_json = flaky_save
    w = _worker(provider)
    w.start()
    try:
        w._handle_payload(_result_batch(seed=23).to_dict(), ack=None)
        assert w.drain(timeout_s=10)
        assert not provider.exists("cluster/centroids.json")
        assert w._batches_since_ckpt >= 1
        w._handle_payload(_result_batch(seed=24).to_dict(), ack=None)
        assert w.drain(timeout_s=10)
        assert provider.exists("cluster/centroids.json")
    finally:
        w.stop()


def test_no_embedding_batch_skipped_and_acked(caplog):
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    acks = []
    for seed in (3, 4):
        batch = _result_batch(seed=seed)
        for r in batch.results:
            r.pop("embedding")
        w._handle_payload(batch.to_dict(), ack=lambda ok: acks.append(ok))
    with caplog.at_level("WARNING"):
        w.start()
        try:
            assert w.drain(timeout_s=10)
        finally:
            w.stop()
    assert acks == [True, True]
    assert w.get_status()["skipped_batches"] == 2
    assert not list(iter_assignments(provider, "c1"))
    assert sum("carries no embeddings" in r.message
               for r in caplog.records) == 1


def test_malformed_embedding_nacks_only_that_batch():
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    bad = _result_batch(seed=4)
    bad.results[2]["embedding"] = ["not-a-number"]
    acks = {}
    w._handle_payload(bad.to_dict(),
                      ack=lambda ok: acks.setdefault("bad", ok))
    w._handle_payload(_result_batch(seed=5).to_dict(),
                      ack=lambda ok: acks.setdefault("good", ok))
    w.start()
    try:
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    assert acks["bad"] is False and acks["good"] is True
    uids = {r["post_uid"] for r in iter_assignments(provider, "c1")}
    assert uids == {f"p5-{i}" for i in range(6)}
    assert w.get_status()["error_batches"] == 1


def test_failed_group_step_isolates_per_batch():
    """The coalesced step raises once; each batch then folds alone."""
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    real = w.engine.observe
    calls = {"n": 0}

    def flaky(vectors):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("group step failed")
        return real(vectors)

    w.engine.observe = flaky
    acks = []
    for seed in (30, 31):
        w._handle_payload(_result_batch(seed=seed).to_dict(),
                          ack=lambda ok: acks.append(ok))
    w.start()
    try:
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    assert acks == [True, True] and calls["n"] == 3
    assert w.engine.vectors == 12
    assert len(_ledger_counts(provider)) == 12


def test_kill_then_restart_resumes_checkpoint():
    provider = InMemoryStorageProvider()
    w1 = _worker(provider)
    w1.start()
    w1._handle_payload(_result_batch(seed=6).to_dict(), ack=None)
    assert w1.drain(timeout_s=10)
    step_at_kill = w1.engine.step
    centroids_at_kill = w1.engine.centroids.clone()
    w1.kill()
    assert step_at_kill > 0
    w2 = _worker(provider)
    assert w2.resumed
    assert w2.engine.resumed_from_step == step_at_kill
    assert torch.equal(w2.engine.centroids, centroids_at_kill)
    w2.start()
    try:
        w2._handle_payload(_result_batch(seed=7).to_dict(), ack=None)
        assert w2.drain(timeout_s=10)
        assert w2.engine.step > step_at_kill
        body = w2.get_clusters()
        assert body["resumed"] is True
        assert body["resume_step"] == step_at_kill
    finally:
        w2.stop()


def test_kill_skips_the_final_checkpoint():
    provider = InMemoryStorageProvider()
    w = _worker(provider, checkpoint_every_batches=0)
    w.start()
    w._handle_payload(_result_batch(seed=8).to_dict(), ack=None)
    assert w.drain(timeout_s=10)
    w.kill()
    w.stop()  # after a kill: no checkpoint
    assert not provider.exists("cluster/centroids.json")
    w2 = _worker(provider, checkpoint_every_batches=0)
    w2.start()
    w2._handle_payload(_result_batch(seed=9).to_dict(), ack=None)
    assert w2.drain(timeout_s=10)
    w2.stop()  # graceful: the final checkpoint
    assert provider.load_json("cluster/centroids.json")["step"] == 1


def test_incompatible_checkpoint_rejected_loudly():
    provider = InMemoryStorageProvider()
    w1 = _worker(provider)
    w1.start()
    w1._handle_payload(_result_batch(seed=8).to_dict(), ack=None)
    assert w1.drain(timeout_s=10)
    w1.stop()
    with pytest.raises(ValueError, match="incompatible"):
        ClusterWorker(InMemoryBus(sync=True), provider=provider,
                      cfg=ClusterWorkerConfig(k=16, buckets=(8,)),
                      registry=MetricsRegistry(), device="cpu")


def test_reference_worker_resumes_port_checkpoint():
    """The port worker's checkpoint (with its folded window) resumes in the
    reference's worker, and the reverse."""
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    w.start()
    w._handle_payload(_result_batch(seed=40).to_dict(), ack=None)
    assert w.drain(timeout_s=10)
    w.stop()
    ref = jcw.ClusterWorker(
        JaxBus(sync=True), provider=provider,
        cfg=jcw.ClusterWorkerConfig(worker_id="ref", k=4, buckets=(8, 32),
                                    heartbeat_s=3600,
                                    span_export_interval_s=0),
        registry=JaxRegistry())
    assert ref.resumed and "b40" in ref._folded
    assert ref.engine.step == w.engine.step
    np.testing.assert_array_equal(np.asarray(ref.engine.centroids),
                                  w.engine.centroids.numpy())
    ref.checkpoint()
    back = _worker(provider)
    assert back.resumed and "b40" in back._folded
    assert back.engine.step == w.engine.step


def test_clusters_body_and_update_messages():
    provider = InMemoryStorageProvider()
    bus = InMemoryBus(sync=True)
    updates = []
    bus.subscribe(TOPIC_CLUSTERS, updates.append)
    w = _worker(provider, bus=bus)
    w.start()
    try:
        w._handle_payload(_result_batch(seed=9).to_dict(), ack=None)
        assert w.drain(timeout_s=10)
        status = w.get_status()
        assert status["is_running"] and status["processed_batches"] == 1
    finally:
        w.stop()
    body = w.get_clusters()
    assert body["k"] == 4 and body["nonempty"] >= 1
    assert body["vectors"] == 6
    assert body["checkpoint"]["written"] >= 1
    assert isinstance(body["inertia"], list)
    assert body["assign_vectors_per_s"] > 0
    assert updates, "a checkpoint announces a ClusterUpdateMessage"
    msg = decode_message(updates[-1])
    assert isinstance(msg, jmsg.ClusterUpdateMessage)
    msg.validate()
    assert msg.channel_clusters.get("chanA") is not None
    assert w.m_checkpoints.value >= 1


def test_spans_carry_the_batch_trace():
    trace.TRACER.reset()
    provider = InMemoryStorageProvider()
    w = _worker(provider)
    w._handle_payload(_result_batch(seed=12).to_dict(), ack=None)
    w.start()
    try:
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    names = {s.name for s in trace.TRACER.spans()
             if s.trace_id == "trace_test_12"}
    assert {"cluster_worker.queue_wait", "cluster_worker.process",
            "cluster_worker.commit"} <= names


# -- end to end: TPUWorker -> bus -> ClusterWorker, both packages -----------
CFG = dict(model="tiny", n_labels=3, batch_size=4, buckets=(16, 32, 64))


def _posts(n, start):
    return [Post(post_uid=f"e2e-{start + i}", channel_name=f"chan{i % 3}",
                 description=" ".join(["post", "number", str(start + i)]
                                      * (i % 4 + 1)))
            for i in range(n)]


def _seed_state(dim, k=4):
    c = np.random.default_rng(7).standard_normal((k, dim))
    c = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    return {"schema": "dct-cluster-v1", "k": k, "dim": dim,
            "spherical": True, "step": 0, "vectors": 0,
            "centroids": c.tolist(), "counts": [0.0] * k,
            "inertia_window": []}


def _pipeline(tpu, cw, bus, batch_dicts):
    """Queue every record batch in the TPU worker, start both, wait for
    every post's assignment."""
    for d in batch_dicts:
        tpu._handle_payload(d)
    cw.start()
    tpu.start()
    try:
        assert tpu.drain(timeout_s=60)
        deadline = time.monotonic() + 60
        while cw._processed < len(batch_dicts) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cw.drain(timeout_s=60)
    finally:
        tpu.stop()
        cw.stop()
        bus.close()


def test_end_to_end_matches_reference_pipeline():
    je = jeng.InferenceEngine(jeng.EngineConfig(**CFG),
                              registry=JaxRegistry())
    params = jax.tree.map(np.asarray, je.params)
    dim = je.ecfg.hidden
    batches = [JaxRecordBatch.from_posts(_posts(n, s), crawl_id="e2e")
               for n, s in ((6, 0), (5, 6), (7, 11))]
    dicts = [b.to_dict() for b in batches]
    n_posts = sum(len(b.records) for b in batches)

    # The reference pipeline.
    ref_store = InMemoryStorageProvider()
    ref_store.save_json("cluster/centroids.json", _seed_state(dim))
    ref_bus = JaxBus(sync=True)
    ref_tpu = jwork.TPUWorker(ref_bus, je, cfg=jwork.TPUWorkerConfig(
        worker_id="t", heartbeat_s=3600, span_export_interval_s=0,
        publish_embeddings=True), registry=JaxRegistry())
    ref_cw = jcw.ClusterWorker(ref_bus, provider=ref_store,
                               cfg=jcw.ClusterWorkerConfig(
                                   worker_id="c", k=4, buckets=(8, 32),
                                   heartbeat_s=3600,
                                   span_export_interval_s=0,
                                   coalesce_batches=1),
                               registry=JaxRegistry())
    _pipeline(ref_tpu, ref_cw, ref_bus, dicts)

    # The port's, from the same params and the same checkpoint.
    store = InMemoryStorageProvider()
    store.save_json("cluster/centroids.json", _seed_state(dim))
    bus = InMemoryBus(sync=True)
    engine = teng.InferenceEngine(teng.EngineConfig(**CFG), params=params,
                                  registry=MetricsRegistry(), device="cpu")
    tpu = TPUWorker(bus, engine, cfg=TPUWorkerConfig(
        worker_id="t", publish_embeddings=True), registry=MetricsRegistry())
    cw = ClusterWorker(bus, provider=store, cfg=ClusterWorkerConfig(
        worker_id="c", k=4, buckets=(8, 32), coalesce_batches=1),
        registry=MetricsRegistry(), device="cpu")
    assert cw.resumed and ref_cw.resumed
    _pipeline(tpu, cw, bus, dicts)

    got = {r["post_uid"]: r for r in iter_assignments(store, "e2e")}
    want = {r["post_uid"]: r for r in jcw.iter_assignments(ref_store, "e2e")}
    assert len(got) == len(want) == n_posts
    assert {u: r["cluster"] for u, r in got.items()} == \
        {u: r["cluster"] for u, r in want.items()}
    assert {u: r["trace_id"] for u, r in got.items()} == \
        {u: r["trace_id"] for u, r in want.items()}
    assert cw.engine.step == ref_cw.engine.step == len(batches)
    np.testing.assert_allclose(cw.engine.centroids.numpy(),
                               np.asarray(ref_cw.engine.centroids),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(cw.engine.counts.numpy(),
                                  np.asarray(ref_cw.engine.counts))

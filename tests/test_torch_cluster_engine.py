"""The port's `ClusterEngine` (`cluster/engine.py`) against the JAX
package's, on the CPU, at small sizes (D 16-64, k 2-8, buckets 8-32).

Where both engines start from the same state (loaded from one checkpoint
dict) and observe the same seeded numpy rows, assignments must be equal
and centroids, counts and inertia within 1e-5; a checkpoint written by
either engine resumes in the other.  The first observe seeds with
``torch.Generator`` (JAX's PRNG cannot be reproduced), so that step is held
against the reference's batch kernels applied to the port's own seeds, as
the reference's `tests/test_cluster_serve.py` holds its engine.

The reference is imported inside the fixtures that need it, so the test
marked ``gpu`` collects on the card's machine, which has no JAX; it skips
without a card.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_crawler_tpu_torch.cluster.engine import (  # noqa: E402
    ClusterEngine,
    ClusterEngineConfig,
    cluster_step,
)
from distributed_crawler_tpu_torch.models import clustering as tc  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _ref(name):
    """A module of the JAX package (skips where JAX is missing)."""
    pytest.importorskip("jax")
    return importlib.import_module(f"distributed_crawler_tpu.{name}")


def _blob_data(n=40, dim=16, seed=0):
    """Two well-separated unit-sphere blobs (the reference test's data)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n // 2, dim) * 0.05 + np.eye(dim)[0]
    b = rng.randn(n - n // 2, dim) * 0.05 + np.eye(dim)[1]
    return np.concatenate([a, b]).astype(np.float32)


def _norm(x):
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _port(**kw):
    return ClusterEngine(ClusterEngineConfig(**kw),
                         registry=MetricsRegistry(), device="cpu")


def _jax_engine(**kw):
    eng = _ref("cluster.engine")
    jm = _ref("utils.metrics")
    return eng.ClusterEngine(eng.ClusterEngineConfig(**kw),
                             registry=jm.MetricsRegistry())


def _state(k, dim, seed, step=3, vectors=40):
    """A checkpoint dict in the shared layout: unit centroids drawn from
    numpy, non-zero counts."""
    rng = np.random.default_rng(seed)
    c = _norm(rng.standard_normal((k, dim)))
    counts = rng.integers(1, 20, size=k).astype(np.float32)
    return {"schema": "dct-cluster-v1", "k": k, "dim": dim,
            "spherical": True, "step": step, "vectors": vectors,
            "centroids": c.tolist(), "counts": counts.tolist(),
            "inertia_window": [0.5, 0.25]}


def _assert_same_model(port, ref):
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), **TOL)
    np.testing.assert_array_equal(port.counts.numpy(),
                                  np.asarray(ref.counts))
    assert (port.step, port.vectors) == (ref.step, ref.vectors)
    np.testing.assert_allclose(list(port._inertia), list(ref._inertia),
                               **TOL)


@pytest.mark.parametrize("k, dim, buckets, sizes", [
    (4, 16, (8, 32), (20, 8, 45)),
    (8, 64, (16,), (16, 3, 40)),
    (3, 32, (8, 32), (1, 32, 33)),
])
def test_online_steps_match_reference_from_one_state(k, dim, buckets, sizes):
    """Both engines load one state, then observe the same mini-batches
    (including chunked ones): equal assignments, same model."""
    state = _state(k, dim, seed=k)
    port = _port(k=k, buckets=buckets)
    ref = _jax_engine(k=k, buckets=buckets)
    port.load_state(state)
    ref.load_state(state)
    rng = np.random.default_rng(dim)
    for n in sizes:
        x = rng.standard_normal((n, dim)).astype(np.float32)
        assert port.observe(x) == ref.observe(x)
        _assert_same_model(port, ref)


def test_step_matches_reference_step():
    """`cluster_step` against the reference's compiled step on one padded
    bucket (pad rows carry id k)."""
    ref = _jax_engine(k=5, buckets=(16,))
    state = _state(5, 32, seed=1)
    c = np.asarray(state["centroids"], np.float32)
    n = np.asarray(state["counts"], np.float32)
    x = np.random.default_rng(2).standard_normal((16, 32)).astype(np.float32)
    mask = (np.arange(16) < 11).astype(np.float32)
    want = ref._step_fn(16)(c, n, x, mask)
    got = cluster_step(torch.from_numpy(c), torch.from_numpy(n),
                       torch.from_numpy(x), torch.from_numpy(mask), 5, True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[2].numpy()[11:] == 5).all()
    assert got[3].item() == pytest.approx(float(want[3]), rel=1e-5)


def test_first_observe_is_the_batch_kernels_on_its_seeds():
    """ONE observe() == the reference's batch kernels (assign + one-hot
    update + running mean + renorm) on the port's k-means++ seeds."""
    jc = _ref("models.clustering")
    import jax.numpy as jnp

    k, x = 4, _blob_data(n=32)
    eng = _port(k=k, buckets=(32,), seed=5)
    assigns = eng.observe(x)
    xh = _norm(x)
    seeded = tc.kmeans_plus_plus_init(torch.from_numpy(xh), k,
                                      torch.Generator().manual_seed(5))
    seeded = _norm(seeded.numpy())
    expected = np.asarray(jc.assign(jnp.asarray(xh), jnp.asarray(seeded)))
    assert assigns == [int(a) for a in expected]
    sums, counts = jc.update(jnp.asarray(xh), jnp.asarray(expected), k)
    sums, counts = np.asarray(sums), np.asarray(counts)
    want = _norm(np.where((counts > 0)[:, None],
                          sums / np.maximum(counts, 1.0)[:, None], seeded))
    np.testing.assert_allclose(eng.centroids.numpy(), want, **TOL)
    np.testing.assert_array_equal(eng.counts.numpy(), counts)
    assert eng.counts.dtype == torch.float32


def test_pad_rows_do_not_perturb():
    x = _blob_data(n=10)
    padded = _port(k=3, buckets=(64,), seed=2)
    exact = _port(k=3, buckets=(10,), seed=2)
    assert padded.observe(x) == exact.observe(x)
    np.testing.assert_allclose(padded.centroids.numpy(),
                               exact.centroids.numpy(), rtol=1e-5, atol=1e-6)
    assert int(padded.counts.sum().item()) == 10


def test_oversized_minibatch_chunks_by_largest_bucket():
    eng = _port(k=2, buckets=(8,))
    assert len(eng.observe(_blob_data(n=20))) == 20
    assert eng.step == 3  # 8 + 8 + 4
    assert eng.vectors == 20
    assert eng.compile_cache_stats()["programs_cluster"] == [8]
    assert eng.compile_cache_stats()["misses_total"] == 1.0
    assert eng.timeline.snapshot()["batches_total"] == 3


def test_dim_mismatch_raises():
    eng = _port(k=2, buckets=(8,))
    eng.observe(_blob_data(n=4, dim=16))
    with pytest.raises(ValueError, match="dim"):
        eng.observe(np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError, match="matrix"):
        eng.observe(np.zeros((2, 2, 16), np.float32))


def test_loaded_dim_mismatch_raises():
    eng = _port(k=4, buckets=(8,))
    eng.load_state(_state(4, 16, seed=0))
    with pytest.raises(ValueError, match="dim"):
        eng.observe(np.zeros((3, 32), np.float32))


def test_checkpoint_roundtrip_continues_identically():
    x = _blob_data(n=48)
    a = _port(k=4, buckets=(24,), seed=1)
    a.observe(x[:24])
    state = json.loads(json.dumps(a.state_dict()))
    b = _port(k=4, buckets=(24,), seed=1)
    b.load_state(state)
    assert b.step == a.step and b.vectors == a.vectors
    assert b.resumed_from_step == a.step
    assert a.observe(x[24:]) == b.observe(x[24:])
    np.testing.assert_allclose(a.centroids.numpy(), b.centroids.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(writer):
    """A checkpoint written by either engine resumes in the other and both
    continue identically (within 1e-5)."""
    x = _blob_data(n=72, dim=32, seed=3)
    make = {"reference": _jax_engine, "port": _port}
    first = make[writer](k=4, buckets=(8, 32), seed=1)
    first.observe(x[:24])
    state = json.loads(json.dumps(first.state_dict()))
    assert state["schema"] == "dct-cluster-v1"
    port, ref = _port(k=4, buckets=(8, 32)), _jax_engine(k=4, buckets=(8, 32))
    port.load_state(state)
    ref.load_state(state)
    assert port.resumed_from_step == ref.resumed_from_step == first.step
    _assert_same_model(port, ref)
    for lo, hi in ((24, 30), (30, 72)):
        assert port.observe(x[lo:hi]) == ref.observe(x[lo:hi])
        _assert_same_model(port, ref)
    # And the port's state_dict has the reference's keys and types.
    mine, theirs = port.state_dict(), ref.state_dict()
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert type(mine[key]) is type(theirs[key]), key


def test_observe_is_atomic_across_chunks():
    eng = _port(k=2, buckets=(8,), seed=0)
    eng.observe(_blob_data(n=8))
    step0, vectors0 = eng.step, eng.vectors
    centroids0 = eng.centroids.clone()
    counts0 = eng.counts.clone()
    real_dispatch = eng._dispatch_chunk
    calls = {"n": 0}

    def flaky(centroids, counts, x):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device wedge on chunk 2")
        return real_dispatch(centroids, counts, x)

    eng._dispatch_chunk = flaky
    with pytest.raises(RuntimeError, match="chunk 2"):
        eng.observe(_blob_data(n=16, seed=9))  # 2 chunks of 8
    assert (eng.step, eng.vectors) == (step0, vectors0)
    assert torch.equal(eng.centroids, centroids0)
    assert torch.equal(eng.counts, counts0)
    eng._dispatch_chunk = real_dispatch
    assert len(eng.observe(_blob_data(n=16, seed=9))) == 16


def test_assign_only_matches_assignment_no_fold():
    jc = _ref("models.clustering")
    import jax.numpy as jnp

    eng = _port(k=3, buckets=(16,), seed=4)
    x = _blob_data(n=16)
    eng.observe(x)
    vectors0 = eng.vectors
    centroids0 = eng.centroids.clone()
    expected = [int(a) for a in np.asarray(jc.assign(
        jnp.asarray(_norm(x)), jnp.asarray(centroids0.numpy())))]
    assert eng.assign_only(x) == expected
    assert eng.vectors == vectors0
    assert torch.equal(eng.centroids, centroids0)
    with pytest.raises(ValueError, match="seeded"):
        _port(k=3).assign_only(x)


def test_checkpoint_wrong_spherical_rejected():
    a = _port(k=4, buckets=(8,), spherical=True)
    a.observe(_blob_data(n=8))
    b = _port(k=4, buckets=(8,), spherical=False)
    with pytest.raises(ValueError, match="spherical"):
        b.load_state(a.state_dict())


def test_checkpoint_wrong_k_rejected():
    a = _port(k=4, buckets=(8,))
    a.observe(_blob_data(n=8))
    b = _port(k=8, buckets=(8,))
    with pytest.raises(ValueError, match="k"):
        b.load_state(a.state_dict())


def test_underpopulated_matches_reference():
    state = _state(4, 16, seed=0)
    state["counts"] = [30.0, 2.0, 7.0, 1.0]
    state["vectors"] = 40
    port, ref = _port(k=4), _jax_engine(k=4)
    port.load_state(state)
    ref.load_state(state)
    # Floor: 0.5 * 40 / 4 = 5 -> clusters 1 and 3.
    assert port.underpopulated(0.5) == ref.underpopulated(0.5) == [1, 3]
    assert port.underpopulated(0.2) == ref.underpopulated(0.2) == [3]
    assert _port(k=4).underpopulated() == []


def test_snapshot_keys_and_values_match_reference():
    state = _state(4, 16, seed=2)
    port, ref = _port(k=4, buckets=(8, 32)), _jax_engine(k=4, buckets=(8, 32))
    assert sorted(port.snapshot()) == sorted(ref.snapshot())
    assert port.snapshot()["seeded"] is False
    port.load_state(state)
    ref.load_state(state)
    x = _blob_data(n=12)
    port.observe(x)
    ref.observe(x)
    mine, theirs = port.snapshot(), ref.snapshot()
    assert sorted(mine) == sorted(theirs)
    for key in ("k", "dim", "spherical", "buckets", "n_devices", "step",
                "vectors", "seeded", "sizes", "nonempty",
                "resumed_from_step"):
        assert mine[key] == theirs[key], key
    np.testing.assert_allclose(mine["centroid_norms"],
                               theirs["centroid_norms"], atol=2e-6)
    np.testing.assert_allclose(mine["inertia"], theirs["inertia"],
                               atol=2e-6)


def test_warmup_never_seeds():
    eng = _port(k=3, buckets=(8, 16))
    eng.warmup(16)
    assert eng.centroids is None and eng.dim is None and eng.step == 0
    assert eng.compile_cache_stats()["programs_cluster"] == [8, 16]
    eng.observe(_blob_data(n=8))
    assert eng.compile_cache_stats()["misses_total"] == 2.0


def test_entry_point_defaults():
    with pytest.raises(NotImplementedError, match="multi-device"):
        ClusterEngine(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        ClusterEngine(ClusterEngineConfig(k=0), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClusterEngine()


# -- on the card ------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _top2_gap(scores):
    s = np.sort(scores, axis=1)
    return s[:, 1] - s[:, 0]


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    """The same stream through an engine on the card and one on the CPU,
    both loaded from one state: centroids within 1e-5, assignments equal
    off near-ties (top-2 gap under 1e-4), with TF32 on outside."""
    state = _state(16, 1024, seed=0)
    card = ClusterEngine(ClusterEngineConfig(k=16),
                         registry=MetricsRegistry())
    cpu = _port(k=16)
    card.load_state(state)
    cpu.load_state(state)
    assert card.device.type == "cuda"
    rng = np.random.default_rng(1)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        for n in (256, 64, 300):
            x = _norm(rng.standard_normal((n, 1024)))
            c_before = cpu.centroids.numpy().copy()
            got, want = card.observe(x), cpu.observe(x)
            scores = -2.0 * x @ c_before.T + (c_before ** 2).sum(1)
            decided = _top2_gap(scores) > 1e-4
            assert (np.asarray(got)[decided]
                    == np.asarray(want)[decided]).all()
            np.testing.assert_allclose(card.centroids.cpu().numpy(),
                                       cpu.centroids.numpy(), **TOL)
    finally:
        flags.allow_tf32 = before

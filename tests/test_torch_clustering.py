"""The port's k-means (`models/clustering.py`) against the JAX package's, on
the CPU, at small sizes (D 16-64, k 3-8).

The same seeded numpy inputs go through both.  Tolerances: scores and
per-cluster sums within 1e-5 (f32 products summed in another order);
counts and assignments exact, except assignments whose top-2 score gap is
under ``TIE_MARGIN`` (counted, and few); Lloyd iterations from the
reference's seeded centroids: centroids within 1e-5, inertia within 1e-5
relative.  JAX's PRNG cannot be reproduced with ``torch.Generator``, so
the seeding is held to its properties instead.

The reference is imported inside the fixtures that need it, so the test
marked ``gpu`` collects on the card's machine, which has no JAX; it skips
without a card.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_crawler_tpu_torch.models import clustering as tc  # noqa: E402
from distributed_crawler_tpu_torch.utils import costmodel  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
TIE_MARGIN = 1e-4


@pytest.fixture(scope="module")
def jc():
    pytest.importorskip("jax")
    return importlib.import_module("distributed_crawler_tpu.models.clustering")


@pytest.fixture(scope="module")
def jnp():
    jax = pytest.importorskip("jax")
    return jax.numpy


def _blobs(n, dim, k, seed, spread=0.05):
    """``k`` well-separated unit-sphere blobs (one axis each)."""
    rng = np.random.default_rng(seed)
    centers = np.eye(dim, dtype=np.float32)[rng.permutation(dim)[:k]]
    ids = rng.integers(0, k, size=n)
    return (centers[ids] + rng.standard_normal((n, dim)) * spread
            ).astype(np.float32)


def _top2_gap(scores):
    s = np.sort(scores, axis=1)
    return s[:, 1] - s[:, 0]


@pytest.mark.parametrize("n, dim, k, seed", [(64, 16, 3, 0), (200, 32, 5, 1),
                                             (97, 64, 8, 2)])
def test_scores_assign_update_match(jc, jnp, n, dim, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    c = rng.standard_normal((k, dim)).astype(np.float32)
    ref_scores = np.asarray(jc._pairwise_neg_scores(jnp.asarray(x),
                                                    jnp.asarray(c)))
    scores = tc._pairwise_neg_scores(torch.from_numpy(x),
                                     torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(scores, ref_scores, **TOL)
    ref_a = np.asarray(jc.assign(jnp.asarray(x), jnp.asarray(c)))
    a = tc.assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert a.dtype == np.int32 and ref_a.dtype == np.int32
    decided = _top2_gap(ref_scores) > TIE_MARGIN
    assert decided.sum() >= n - 2, "too many near-ties in the inputs"
    np.testing.assert_array_equal(a[decided], ref_a[decided])
    # Some rows carry the padding id k.
    ids = ref_a.copy()
    ids[::7] = k
    ref_sums, ref_counts = jc.update(jnp.asarray(x), jnp.asarray(ids), k)
    sums, counts = tc.update(torch.from_numpy(x), torch.from_numpy(ids), k)
    assert sums.dtype == torch.float32 and counts.dtype == torch.float32
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), **TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))


def test_id_k_gives_a_zero_row(jc, jnp):
    """Every row on id ``k``: zero sums and counts, as jax.nn.one_hot gives
    (F.one_hot would raise on it)."""
    k = 4
    x = np.random.default_rng(3).standard_normal((10, 16)).astype(np.float32)
    ids = np.full((10,), k, np.int32)
    sums, counts = tc.update(torch.from_numpy(x), torch.from_numpy(ids), k)
    ref_sums, ref_counts = jc.update(jnp.asarray(x), jnp.asarray(ids), k)
    assert not sums.any() and not counts.any()
    np.testing.assert_array_equal(sums.numpy(), np.asarray(ref_sums))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.from_numpy(ids).long(), k)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
@pytest.mark.parametrize("n, dim, k, iters, seed", [(120, 16, 3, 5, 0),
                                                    (300, 32, 6, 25, 4)])
def test_lloyd_matches_reference_fit(jc, jnp, init, n, dim, k, iters, seed):
    """`_lloyd` from the reference's seeded centroids against the
    reference's whole `fit` with the same key."""
    import jax

    x = _blobs(n, dim, k, seed)
    key = jax.random.PRNGKey(seed)
    if init == "kmeans++":
        seeded = jc.kmeans_plus_plus_init(jnp.asarray(x), k, key)
    else:
        idx = jax.random.choice(key, n, (k,), replace=False)
        seeded = jnp.asarray(x)[idx]
    ref = jc.fit(jnp.asarray(x), k, iters=iters, rng=key, init=init)
    got = tc._lloyd(torch.from_numpy(x),
                    torch.from_numpy(np.array(seeded, np.float32)), k, iters)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(ref.centroids), **TOL)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(ref.assignments))
    assert got.inertia.item() == pytest.approx(float(ref.inertia), rel=1e-5)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_fit_is_seeded_and_consistent(init):
    x = torch.from_numpy(_blobs(150, 16, 4, 7))
    a = tc.fit(x, 4, iters=10, generator=torch.Generator().manual_seed(3),
               init=init)
    b = tc.fit(x, 4, iters=10, generator=torch.Generator().manual_seed(3),
               init=init)
    assert torch.equal(a.centroids, b.centroids)
    assert a.assignments.dtype == torch.int32
    assert torch.equal(a.assignments, tc.assign(x, a.centroids))
    diff = x - a.centroids[a.assignments.long()]
    assert a.inertia.item() == pytest.approx((diff * diff).sum().item(),
                                             rel=1e-6)
    with pytest.raises(ValueError, match="init"):
        tc.fit(x, 4, init="bogus")


@pytest.mark.parametrize("seed", range(6))
def test_kmeans_plus_plus_picks_rows_and_skips_zero_distance(seed):
    """Each pick is a row of x; with 5 distinct rows repeated and k = 5, a
    zero-distance row is never picked while others remain, so the picks
    are the 5 distinct rows."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((5, 16)).astype(np.float32)
    x = base[rng.integers(0, 5, size=40)]
    x[:5] = base  # every distinct row present
    c = tc.kmeans_plus_plus_init(torch.from_numpy(x), 5,
                                 torch.Generator().manual_seed(seed)).numpy()
    rows = {tuple(r) for r in x}
    assert all(tuple(r) in rows for r in c)
    assert len({tuple(r) for r in c}) == 5


def test_all_zero_probabilities_pick_row_zero(jc, jnp):
    """Fewer distinct rows than k: once every distance is 0 the reference's
    jax.random.choice returns index 0, and so does the port (without
    raising, where torch.multinomial would)."""
    import jax

    x = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 1, 0, 0], [1, 0, 0, 0]],
                 np.float32)
    k = 4
    for seed in range(4):
        ref = np.asarray(jc.kmeans_plus_plus_init(
            jnp.asarray(x), k, jax.random.PRNGKey(seed)))
        got = tc.kmeans_plus_plus_init(
            torch.from_numpy(x), k, torch.Generator().manual_seed(seed)
        ).numpy()
        for c in (ref, got):
            assert {tuple(r) for r in c[:2]} == {(1, 0, 0, 0), (0, 1, 0, 0)}
            np.testing.assert_array_equal(c[2:], np.stack([x[0], x[0]]))
    zeros = torch.zeros(7)
    assert tc._choice(zeros, torch.Generator().manual_seed(0)) == 0
    with pytest.raises(RuntimeError):
        torch.multinomial(zeros, 1)


def test_choice_never_draws_a_zero_probability():
    probs = torch.tensor([0.0, 0.25, 0.0, 0.5, 0.25, 0.0])
    gen = torch.Generator().manual_seed(11)
    drawn = {tc._choice(probs, gen) for _ in range(300)}
    assert drawn == {1, 3, 4}


def test_full_f32_leaves_cpu_alone():
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    with tc.full_f32(torch.device("cpu")):
        assert flags.allow_tf32 == before
    assert flags.allow_tf32 == before


def test_kmeans_step_flops_matches_reference():
    jcost = pytest.importorskip("distributed_crawler_tpu.utils.costmodel")
    for k, d, r in ((16, 1024, 256), (8, 64, 8), (3, 16, 1)):
        assert costmodel.kmeans_step_flops(k, d, r) == \
            jcost.kmeans_step_flops(k, d, r)


# -- on the card ------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_fit_on_card_matches_cpu(cuda):
    """`fit` on the card against the CPU from the same generator: the
    k-means++ picks and the Lloyd iterations agree (centroids within
    1e-5, assignments equal off near-ties), with TF32 switched on outside
    to show the products ignore it."""
    x = _blobs(4096, 64, 8, 5)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        card = tc.fit(torch.from_numpy(x).to(cuda), 8, iters=10,
                      generator=torch.Generator().manual_seed(1))
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = before
    cpu = tc.fit(torch.from_numpy(x), 8, iters=10,
                 generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(card.centroids.cpu().numpy(),
                               cpu.centroids.numpy(), **TOL)
    scores = tc._pairwise_neg_scores(torch.from_numpy(x),
                                     cpu.centroids).numpy()
    decided = _top2_gap(scores) > TIE_MARGIN
    np.testing.assert_array_equal(card.assignments.cpu().numpy()[decided],
                                  cpu.assignments.numpy()[decided])
    assert card.inertia.item() == pytest.approx(cpu.inertia.item(),
                                                rel=1e-4)

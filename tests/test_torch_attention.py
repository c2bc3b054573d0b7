"""The port's plain attention against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the reference's `attend`
and `flash_attention(..., interpret=True)` and through the port's `attend`.
Cases mirror tests/test_ops.py: padded, no mask, bf16 at seq 128 / head
dim 32, fully masked rows giving zeros, packed segments.

Tolerances: f32 1e-5 abs/rel (the reference's own flash-vs-attend bound;
the port sums in torch's order); bf16 2e-2 abs/rel (the output is bf16,
2^-8 relative, and the two frameworks round p at different points).
"""

import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import numpy as np  # noqa: E402

from distributed_crawler_tpu.ops.attention import (  # noqa: E402
    attend as jax_attend,
    flash_attention as jax_flash,
)
from distributed_crawler_tpu_torch.ops.attention import (  # noqa: E402
    attend,
    flash_attention,
    mha,
)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_inputs(b=2, l=64, h=2, d=16, seed=1):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, l), dtype=bool)
    mask[0, l // 2:] = False
    return q, k, v, mask


def _packed_np():
    """Two rows: row 0 packs segments of 6 and 6 tokens, row 1 one
    segment of 10; padding after (the shape of tests/test_ops.py's)."""
    q, k, v, _ = _np_inputs(b=2, l=16, h=2, d=16, seed=3)
    seg = np.zeros((2, 16), dtype=np.int32)
    seg[0, :6], seg[0, 6:12], seg[1, :10] = 1, 2, 1
    return q, k, v, seg > 0, seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


class TestAgainstJax:
    def test_padded(self):
        q, k, v, mask = _np_inputs()
        ref = np.asarray(jax_attend(*_j(q, k, v, mask)))
        flash = np.asarray(jax_flash(*_j(q, k, v, mask), block_q=32,
                                     interpret=True))
        out = attend(*_t(q, k, v, mask)).numpy()
        np.testing.assert_allclose(out, ref, **F32_TOL)
        np.testing.assert_allclose(out, flash, **F32_TOL)

    def test_no_mask(self):
        q, k, v, _ = _np_inputs()
        ref = np.asarray(jax_attend(*_j(q, k, v)))
        flash = np.asarray(jax_flash(*_j(q, k, v), block_q=32,
                                     interpret=True))
        out = attend(*_t(q, k, v)).numpy()
        np.testing.assert_allclose(out, ref, **F32_TOL)
        np.testing.assert_allclose(out, flash, **F32_TOL)

    def test_bf16_bench_shape(self):
        q, k, v, mask = _np_inputs(b=3, l=128, h=4, d=32, seed=7)
        jq, jk, jv = (x.astype(jnp.bfloat16) for x in _j(q, k, v))
        ref = np.asarray(jax_attend(jq, jk, jv, jnp.asarray(mask)),
                         np.float32)
        flash = np.asarray(jax_flash(jq, jk, jv, jnp.asarray(mask),
                                     block_q=128, interpret=True),
                           np.float32)
        tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
        out = attend(tq, tk, tv, torch.from_numpy(mask))
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref, **BF16_TOL)
        np.testing.assert_allclose(out.float().numpy(), flash, **BF16_TOL)

    def test_fully_masked_row_zeros(self):
        q, k, v, mask = _np_inputs()
        mask[1, :] = False
        flash = np.asarray(jax_flash(*_j(q, k, v, mask), block_q=32,
                                     interpret=True))
        out = attend(*_t(q, k, v, mask)).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out[1], 0.0)
        np.testing.assert_allclose(out, flash, **F32_TOL)

    def test_packed_segments(self):
        q, k, v, mask, seg = _packed_np()
        ref = np.asarray(jax_attend(*_j(q, k, v, mask), segment_ids=seg))
        flash = np.asarray(jax_flash(*_j(q, k, v, mask), block_q=8,
                                     interpret=True,
                                     segment_ids=jnp.asarray(seg)))
        out = attend(*_t(q, k, v, mask),
                     segment_ids=torch.from_numpy(seg)).numpy()
        np.testing.assert_allclose(out, ref, **F32_TOL)
        np.testing.assert_allclose(out, flash, **F32_TOL)

    def test_masked_keys_ignored(self):
        q, k, v, mask = _np_inputs()
        k2, v2 = k.copy(), v.copy()
        k2[0, 40:], v2[0, 40:] = 99.0, -99.0
        np.testing.assert_allclose(attend(*_t(q, k, v, mask)).numpy(),
                                   attend(*_t(q, k2, v2, mask)).numpy(),
                                   atol=1e-6)

    def test_packed_matches_each_segment_alone(self):
        q, k, v, mask, seg = _packed_np()
        packed = attend(*_t(q, k, v, mask),
                        segment_ids=torch.from_numpy(seg)).numpy()
        for row, sl in ((0, slice(0, 6)), (0, slice(6, 12)),
                        (1, slice(0, 10))):
            alone = attend(*_t(q[row:row + 1, sl], k[row:row + 1, sl],
                               v[row:row + 1, sl]))
            np.testing.assert_allclose(packed[row, sl], alone.numpy()[0],
                                       atol=1e-6)


class TestDispatchOnCpu:
    @pytest.mark.parametrize("packed", [False, True])
    def test_mha_takes_attend(self, packed):
        if packed:
            q, k, v, mask, seg = _packed_np()
            kw = {"segment_ids": torch.from_numpy(seg)}
        else:
            q, k, v, mask = _np_inputs()
            kw = {}
        tq, tk, tv, tm = _t(q, k, v, mask)
        before = flash_attention.launches
        out = mha(tq, tk, tv, tm, **kw)
        assert torch.equal(out, attend(tq, tk, tv, tm, **kw))
        assert flash_attention.launches == before

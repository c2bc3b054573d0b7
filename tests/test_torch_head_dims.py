"""Every head dim from 1 to 256 on the port's attention routes, on the CPU.

- `check_operands` and `choose_path` at head dims 8-256 in bf16 and f32:
  bf16 goes to the generic wgmma kernel (``mma_sync``) unless it is a
  TMA-legal head dim of 32/64, f32 to the 3xTF32 kernel (``simt``);
  TinyBERT-4L-312D's fused QKV view (12 heads of 26, a head stride of 52
  bytes) goes to ``mma_sync``; 257 raises, naming the limit.
- The 3xTF32 arithmetic of the f32 kernel in plain PyTorch
  (`attend_3xtf32`): `tf32_round` against an independent numpy rounding,
  the split's residual, and the whole function against the port's `attend`
  in f32 (1e-5 abs/rel: the split keeps about 22 mantissa bits, so each
  product is within about 2^-21 of f32's) and against the JAX package's
  `attend` (1e-5 abs/rel, the tolerance of `test_torch_attention_paths`).
- The tile width of the f32 kernel at padded width 256 (16 keys):
  `key_tile_plan` at that width skips only keys no row may see.
- The port's encoder at TinyBERT's widths (head dim 26, 2 layers, vocab
  cut to 1024) against the JAX package's, unpacked and packed: f32 within
  1e-5 abs / 1e-4 rel (`test_torch_encoder.py`'s tolerance), bf16 within
  2e-2 abs (`test_torch_moe.py`'s: XLA and PyTorch round bf16 at other
  places); and which kernel each attention call of the model would take on
  the card.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distributed_crawler_tpu.models import encoder as jenc  # noqa: E402
from distributed_crawler_tpu.ops.attention import (  # noqa: E402
    attend as jax_attend,
)
from distributed_crawler_tpu.ops.padding import pack_rows  # noqa: E402
from distributed_crawler_tpu_torch.models import encoder as tenc  # noqa: E402
from distributed_crawler_tpu_torch.models.from_jax import (  # noqa: E402
    load_flax_params,
)
from distributed_crawler_tpu_torch.ops import attention  # noqa: E402
from distributed_crawler_tpu_torch.ops.attention import (  # noqa: E402
    attend,
    attend_3xtf32,
    check_operands,
    choose_path,
    key_tile_plan,
    split_tf32,
    tf32_round,
)

# TinyBERT-4L-312D's published widths (huawei-noah/TinyBERT_General_4L_312D).
TINYBERT = dict(hidden=312, n_heads=12, mlp_dim=1200, max_len=512)
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=0)
N_SEG = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused(b, l, h, d, dtype):
    """q, k, v as the encoder hands them over: views of one [b, l, 3, h, d]
    projection."""
    proj = torch.zeros(b * l * 3 * h * d, dtype=dtype).view(b, l, 3, h, d)
    return proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]


class TestHeadDims:
    @pytest.mark.parametrize("dtype, path", [(torch.bfloat16, "mma_sync"),
                                             (torch.float32, "simt")])
    @pytest.mark.parametrize("d", [8, 26, 48, 80, 128, 256])
    def test_every_head_dim_has_a_kernel(self, d, dtype, path):
        q, k, v = _fused(2, 40, 3, d, dtype)
        assert choose_path(q, k, v) == path
        assert check_operands(q, k, v) == path
        mask = torch.ones(2, 40, dtype=torch.bool)
        seg = torch.ones(2, 40, dtype=torch.int32)
        assert check_operands(q, k, v, mask, seg) == path
        assert d in attention.HEAD_DIMS

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_tinybert_fused_qkv_view(self, dtype):
        """12 heads of 26: a head stride of 26 elements (52 bytes in bf16),
        which TMA cannot address."""
        q, k, v = _fused(4, 64, 12, 26, dtype)
        assert q.stride() == (64 * 3 * 312, 3 * 312, 26, 1)
        want = "mma_sync" if dtype == torch.bfloat16 else "simt"
        assert choose_path(q, k, v) == want
        assert check_operands(q, k, v, path=want) == want
        with pytest.raises(ValueError):
            check_operands(q, k, v, path="sm90")

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_above_256_raises_naming_the_limit(self, dtype):
        q, k, v = _fused(1, 8, 1, 257, dtype)
        with pytest.raises(ValueError, match="256"):
            check_operands(q, k, v)
        assert 257 not in attention.HEAD_DIMS

    def test_aligned_32_and_64_stay_on_sm90(self):
        for d in (32, 64):
            assert check_operands(*_fused(2, 40, 3, d, torch.bfloat16)) \
                == "sm90"

    @pytest.mark.parametrize("make, err", [
        (lambda q: (q.float(), q, q), ValueError),         # dtypes differ
        (lambda q: (q.half(),) * 3, TypeError),            # no f16 kernel
        (lambda q: (q[..., ::2],) * 3, ValueError),        # strided head dim
        (lambda q: (q[0],) * 3, ValueError),               # not 4-D
    ], ids=["mixed", "f16", "strided", "3d"])
    def test_refusals(self, make, err):
        q = torch.zeros(2, 8, 2, 26, dtype=torch.bfloat16)
        with pytest.raises(err):
            check_operands(*make(q))

    def test_mask_shape_and_dtype_are_checked(self):
        q, k, v = _fused(2, 16, 2, 26, torch.bfloat16)
        with pytest.raises(ValueError):
            check_operands(q, k, v, kv_mask=torch.ones(2, 8, dtype=bool))
        with pytest.raises(TypeError):
            check_operands(q, k, v, kv_mask=torch.ones(2, 16))

    def test_block_n(self):
        assert attention.block_n("simt", 200) == attention.F32_WIDE_BLOCK_N
        assert attention.block_n("simt", 128) == attention.SM90_BLOCK_N
        assert attention.block_n("mma_sync", 256) == attention.SM90_BLOCK_N


def _tf32_numpy(x):
    """TF32 rounding written independently: the value's binade, its spacing
    at 10 mantissa bits, and round-half-away-from-zero on the quotient."""
    x = np.asarray(x, np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    e = np.floor(np.log2(np.abs(x[nz])))
    e = np.maximum(e, -126)  # subnormals share the smallest binade's step
    step = 2.0 ** (e - 10)
    q = np.abs(x[nz]) / step
    out[nz] = np.sign(x[nz]) * np.floor(q + 0.5) * step
    return out.astype(np.float32)


class TestTf32:
    def test_round_matches_independent_rounding(self):
        rng = np.random.default_rng(0)
        x = np.concatenate([
            rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, size=4000),
            # exact ties at 10 bits: ties go away from zero
            np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      2 ** -130, 0.0]),
        ]).astype(np.float32)
        got = tf32_round(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, _tf32_numpy(x))
        assert got[-5] == np.float32(1 + 2 ** -10)
        assert got[-4] == np.float32(1 + 2 ** -9)

    def test_round_keeps_ten_mantissa_bits(self):
        x = torch.randn(10000) * 1e3
        bits = tf32_round(x).view(torch.int32)
        assert int((bits & 0x1FFF).abs().max()) == 0

    def test_split_residual(self):
        x = torch.from_numpy(np.random.default_rng(1).normal(
            size=10000).astype(np.float32))
        hi, lo = split_tf32(x)
        assert torch.equal(tf32_round(hi), hi)
        assert torch.equal(tf32_round(lo), lo)
        # hi + lo holds about 22 of f32's 24 bits.
        rel = ((x.double() - hi.double() - lo.double()).abs()
               / x.double().abs())
        assert float(rel.max()) < 2 ** -20

    @pytest.mark.parametrize("d", [16, 26, 32, 48, 64, 80, 128])
    @pytest.mark.parametrize("kind", ["padded", "packed", "unmasked"])
    def test_3xtf32_attention_matches_f32(self, d, kind):
        rng = np.random.default_rng(d)
        b, l, h = 3, 70, 2
        q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32)
                   for _ in range(3))
        lens = np.array([70, 33, 1])
        mask = np.arange(l)[None, :] < lens[:, None]
        mask[2] = False  # a fully masked row
        seg = None
        if kind == "packed":
            seg = np.zeros((b, l), np.int32)
            seg[:, :20], seg[:, 20:50], seg[:, 50:65] = 1, 2, 3
            mask = seg > 0
        elif kind == "unmasked":
            mask = None
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        tm = None if mask is None else torch.from_numpy(mask)
        ts = None if seg is None else torch.from_numpy(seg)
        got = attend_3xtf32(tq, tk, tv, tm, segment_ids=ts).numpy()
        want = attend(tq, tk, tv, tm, segment_ids=ts).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        jwant = np.asarray(jax_attend(
            *map(jnp.asarray, (q, k, v)),
            None if mask is None else jnp.asarray(mask),
            segment_ids=None if seg is None else jnp.asarray(seg)))
        np.testing.assert_allclose(got, jwant, atol=1e-5, rtol=1e-5)
        if kind == "padded":
            assert not got[2].any()

    def test_3xtf32_is_closer_than_one_tf32_product(self):
        """The split is what holds the f32 tolerance: one TF32 product of
        rounded operands misses it at head dim 128."""
        rng = np.random.default_rng(3)
        q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 2, 128)).astype(
            np.float32)) for _ in range(3))
        want = attend(q, k, v)
        one = attend(tf32_round(q), tf32_round(k), tf32_round(v))
        three = attend_3xtf32(q, k, v)
        assert float((three - want).abs().max()) < 1e-5
        assert float((one - want).abs().max()) > 1e-4


def _plan_keys(plan, block_n, t):
    """(query rows, flat key tokens never loaded for them) per warpgroup."""
    out = []
    for i, tiles in enumerate(plan):
        for w in range(2):
            r0 = i * 128 + 64 * w
            if r0 >= t:
                continue
            seen = np.zeros(t, bool)
            for k0, bits in tiles:
                if bits >> w & 1:
                    seen[k0:min(k0 + block_n, t)] = True
            out.append((np.arange(r0, min(r0 + 64, t)),
                        np.flatnonzero(~seen)))
    return out


@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_wide_f32_tiles_skip_only_unseen_keys(kind):
    """At the f32 kernel's 16-key tiles (padded width 256), poisoning every
    key a warpgroup never loads leaves its rows bitwise equal."""
    rng = np.random.default_rng(7)
    b, l, h, d = 3, 96, 1, 200
    bn = attention.block_n("simt", d)
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(l)[None, :] < np.array([96, 40, 7])[:, None]
    seg = None
    if kind == "packed":
        seg = np.zeros((b, l), np.int32)
        seg[:, :30], seg[:, 30:70] = 1, 2
        mask = seg > 0
    tm = torch.from_numpy(mask)
    ts = None if seg is None else torch.from_numpy(seg)
    plan = key_tile_plan(tm, ts, b, l, block_n=bn)
    assert all(k0 % bn == 0 for tiles in plan for k0, _ in tiles)
    base = attend(*map(torch.from_numpy, (q, k, v)), tm,
                  segment_ids=ts).numpy().reshape(b * l, -1)
    skipped_any = 0
    for rows, skipped in _plan_keys(plan, bn, b * l):
        skipped_any += skipped.size
        kp, vp = k.copy(), v.copy()
        kp[skipped // l, skipped % l] = 3.0e4
        vp[skipped // l, skipped % l] = -3.0e4
        out = attend(torch.from_numpy(q), torch.from_numpy(kp),
                     torch.from_numpy(vp), tm,
                     segment_ids=ts).numpy().reshape(b * l, -1)
        np.testing.assert_array_equal(out[rows], base[rows])
    assert skipped_any > 0


# -- the encoder at TinyBERT's widths ----------------------------------------
def _tinybert_pair(dtype):
    jcfg = jenc.EncoderConfig(vocab_size=1024, n_layers=2, n_labels=8,
                              dtype=dtype, **TINYBERT)
    jcfg.validate()
    jmodel = jenc.EmbedderClassifier(jcfg)
    ids = jnp.zeros((1, 32), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), ids, jnp.ones((1, 32), bool))
    tcfg = tenc.EncoderConfig(**dataclasses.asdict(jcfg))
    assert tcfg.head_dim == 26
    tmodel = tenc.EmbedderClassifier(tcfg)
    load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def tinybert(request):
    return (request.param,) + _tinybert_pair(request.param)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_tinybert_unpacked_matches_flax(tinybert):
    dtype, jmodel, params, tmodel = tinybert
    rng = np.random.default_rng(0)
    b, l = 4, 64
    ids = rng.integers(4, 1024, size=(b, l)).astype(np.int32)
    mask = np.arange(l)[None, :] < np.array([64, 30, 7, 1])[:, None]
    ids[~mask] = 0
    jemb, jlog = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        temb, tlog = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(temb.float().numpy(), _f32(jemb),
                               **_tol(dtype))
    np.testing.assert_allclose(tlog.float().numpy(), _f32(jlog),
                               **_tol(dtype))


def test_tinybert_packed_matches_flax(tinybert):
    dtype, jmodel, params, tmodel = tinybert
    rng = np.random.default_rng(1)
    seqs = [list(rng.integers(4, 1024, size=int(n)))
            for n in rng.integers(1, 20, size=11)]
    p = pack_rows(seqs, 32, max_segments=N_SEG)
    jemb, jlog = jmodel.apply(
        params, jnp.asarray(p.ids), jnp.asarray(p.mask),
        segment_ids=jnp.asarray(p.segment_ids),
        positions=jnp.asarray(p.positions), n_segments=N_SEG)
    with torch.inference_mode():
        temb, tlog = tmodel(
            torch.from_numpy(p.ids), torch.from_numpy(p.mask),
            segment_ids=torch.from_numpy(p.segment_ids),
            positions=torch.from_numpy(p.positions), n_segments=N_SEG)
    assert tuple(temb.shape) == (p.n_rows, N_SEG, 312)
    np.testing.assert_allclose(temb.float().numpy(), _f32(jemb),
                               **_tol(dtype))
    np.testing.assert_allclose(tlog.float().numpy(), _f32(jlog),
                               **_tol(dtype))


def test_tinybert_attention_routes(tinybert, monkeypatch):
    """Each of the model's attention calls hands the wrapper operands that
    the generic kernels take (bf16: ``mma_sync``; f32: ``simt``)."""
    dtype, _, _, tmodel = tinybert
    seen = []
    real = tenc.mha

    def spy(q, k, v, *args, **kw):
        seen.append((check_operands(q, k, v), q.shape[-1], q.stride(2)))
        return real(q, k, v, *args, **kw)

    monkeypatch.setattr(tenc, "mha", spy)
    ids = np.full((2, 32), 7, np.int32)
    with torch.inference_mode():
        tmodel(torch.from_numpy(ids), torch.ones(2, 32, dtype=torch.bool))
    want = "mma_sync" if dtype == "bfloat16" else "simt"
    assert seen == [(want, 26, 26)] * 2


@pytest.mark.parametrize("name", ["kernel", "no_copy", "consumers_idle",
                                  "stages_8", "no_fence", "no_split",
                                  "one_product"])
def test_generic_ablation_variants_apply_to_the_source(name):
    """ops/generic_ablation.py times the generic kernels with one piece of
    work taken out per variant; a substitution that no longer matches the
    source must fail here, not silently time the unmodified kernel."""
    from distributed_crawler_tpu_torch.ops import generic_ablation

    source = generic_ablation.SOURCE.read_text()
    changed = generic_ablation.variant_source(name, source)
    assert (changed != source) == bool(generic_ablation.VARIANTS[name])
    assert set(generic_ablation.VARIANTS) == {
        "kernel", "no_copy", "consumers_idle", "stages_8", "no_fence",
        "no_split", "one_product"}
    with pytest.raises(ValueError):
        generic_ablation.variant_source("no_copy", "no kernel here")

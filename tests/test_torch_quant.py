"""The port's int8 serving against the JAX package's, on the CPU.

Same numpy inputs through both packages.  Tolerances:

- the int8 grid (values and f32 scales) and the int32 accumulators:
  exact — both round half to even on the same f32 quotient;
- dequantized outputs: f32 within 1e-6 relative (the same products in the
  same order; XLA may contract the bias add into a fused multiply-add),
  bf16 within one bf16 ulp (the f32 values round to bf16 on both sides);
- calibrated abs-max: 1e-5 relative (an f32 forward on each side);
- the int8 model at ``TINY_TEST``: embeddings within 1e-2 absolute, since
  a LayerNorm rounding can move one activation across an int8 step, which
  moves every later layer; labels equal wherever the top score leads the
  second by more than 2e-2.

The card tests (``-m gpu``) hold the card's int8 product against the
CPU's int32 matmul; they skip without a card.  They need no JAX, so this
file also runs on the card's machine, which has none: there the parity
tests skip, deciding in a fixture.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distributed_crawler_tpu_torch.models import encoder as tenc  # noqa: E402
from distributed_crawler_tpu_torch.models import quant as tmq  # noqa: E402
from distributed_crawler_tpu_torch.models.from_jax import (  # noqa: E402
    flax_tree,
    load_flax_params,
)
from distributed_crawler_tpu_torch.ops import quant as tq  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from distributed_crawler_tpu.models import encoder as jenc
    from distributed_crawler_tpu.models import quant as jmq
    from distributed_crawler_tpu.ops import quant as jq
except ImportError:  # the card's machine: only the card tests run there
    jax = None

EMB_ATOL = 1e-2
LABEL_MARGIN = 2e-2


@pytest.fixture(autouse=True)
def _reference(request):
    """The parity tests need the JAX package; the card tests do not."""
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs JAX and the JAX package (the reference)")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype, k
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _kernel(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w[..., 0] = 0.0                       # a zero output channel
    w.reshape(w.shape[0], -1)[:, 1] *= 1e4  # a wide one
    return w


class TestGrid:
    @pytest.mark.parametrize("shape", [(64, 48), (32, 3, 32), (7, 5)])
    def test_quantize_weights_bitwise(self, shape):
        w = _kernel(sum(shape), shape)
        jw, js = jq.quantize_weights(jnp.asarray(w), contract_axis=0)
        tw, ts = tq.quantize_weights(torch.from_numpy(w), contract_axis=0)
        assert tw.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))

    def test_ties_round_half_to_even(self):
        """Quotients that land on .5 exactly: 127 * k / 254 for odd k."""
        w = np.zeros((254, 2), np.float32)
        w[:, 0] = np.arange(254, dtype=np.float32)
        w[253, 0] = 254.0                 # amax 254 -> scale 2.0
        w[:, 1] = -w[:, 0]
        jw, _ = jq.quantize_weights(jnp.asarray(w))
        tw, _ = tq.quantize_weights(torch.from_numpy(w))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert tw[1, 0] == 0 and tw[3, 0] == 2  # 0.5 -> 0, 1.5 -> 2

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_quantize_activations_bitwise(self, dtype):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, 9, 64)).astype(np.float32) * 3
        x[0, 0] = 0.0                     # an all-zero token
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        jxq, js = jq.quantize_activations(jx)
        txq, ts = tq.quantize_activations(tx)
        np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
        a = np.float32(0.0271)
        np.testing.assert_array_equal(
            tq.quantize_activations_static(
                tx, torch.tensor(a)).numpy(),
            np.asarray(jq.quantize_activations_static(jx, jnp.asarray(a))))


def _ref_acc(x, a_scale):
    """The reference's activation quantization and int32 product inputs."""
    if a_scale is None:
        xq, _ = jq.quantize_activations(x)
    else:
        xq = jq.quantize_activations_static(x, a_scale)
    return xq


class TestProducts:
    @pytest.mark.parametrize("static", [False, True])
    @pytest.mark.parametrize("bias", [False, True])
    @pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
    def test_int8_dense(self, static, bias, out_dtype):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 11, 64)).astype(np.float32)
        w = _kernel(3, (64, 40))
        b = rng.standard_normal(40).astype(np.float32) if bias else None
        jw, js = jq.quantize_weights(jnp.asarray(w))
        a = jnp.asarray(np.float32(0.025)) if static else None
        ref = jq.int8_dense(jnp.asarray(x), jw, js,
                            None if b is None else jnp.asarray(b),
                            out_dtype=getattr(jnp, out_dtype), a_scale=a)
        tw = torch.from_numpy(np.array(jw).T.copy())  # [out, in]
        ts = torch.from_numpy(np.array(js))
        tb = None if b is None else torch.from_numpy(b)
        ta = None if a is None else torch.tensor(np.asarray(a))
        out = tq.int8_dense(torch.from_numpy(x), tw, ts, tb,
                            out_dtype=getattr(torch, out_dtype), a_scale=ta)
        # The int32 accumulators, exactly.
        jxq = _ref_acc(jnp.asarray(x), a)
        jacc = jax.lax.dot_general(jxq, jw, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        tacc = tq.int8_matmul(torch.from_numpy(np.array(jxq)).view(-1, 64),
                              tw)
        np.testing.assert_array_equal(tacc.view(2, 11, 40).numpy(),
                                      np.asarray(jacc))
        _assert_out_close(out, ref, out_dtype)

    @pytest.mark.parametrize("static", [False, True])
    @pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
    def test_int8_qkv(self, static, out_dtype):
        rng = np.random.default_rng(4)
        h = 32
        x = rng.standard_normal((3, 8, h)).astype(np.float32)
        w = _kernel(5, (h, 3, h))
        b = rng.standard_normal((3, h)).astype(np.float32)
        jw, js = jq.quantize_weights(jnp.asarray(w))
        a = jnp.asarray(np.float32(0.02)) if static else None
        ref = jq.int8_qkv(jnp.asarray(x), jw, js, jnp.asarray(b),
                          out_dtype=getattr(jnp, out_dtype), a_scale=a)
        tw = torch.from_numpy(np.array(jw).reshape(h, 3 * h).T.copy())
        out = tq.int8_qkv(torch.from_numpy(x), tw,
                          torch.from_numpy(np.array(js)),
                          torch.from_numpy(b),
                          out_dtype=getattr(torch, out_dtype),
                          a_scale=None if a is None
                          else torch.tensor(np.asarray(a)))
        assert tuple(out.shape) == (3, 8, 3, h) and out.is_contiguous()
        jxq = _ref_acc(jnp.asarray(x), a)
        jacc = jax.lax.dot_general(jxq, jw, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        tacc = tq.int8_matmul(torch.from_numpy(np.array(jxq)).view(-1, h),
                              tw)
        np.testing.assert_array_equal(tacc.view(3, 8, 3, h).numpy(),
                                      np.asarray(jacc))
        _assert_out_close(out, ref, out_dtype)

    @pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
    def test_int8_experts_up_and_down(self, out_dtype):
        """The MoE expert products: the int32 accumulators exactly, the
        dequantized outputs as `_assert_out_close` states."""
        rng = np.random.default_rng(6)
        e, h, m = 4, 32, 48
        x = rng.standard_normal((2, 9, h)).astype(np.float32)
        w_up = np.stack([_kernel(10 + i, (h, m)) for i in range(e)])
        w_dn = np.stack([_kernel(20 + i, (m, h)) for i in range(e)])
        jup, sup = jq.quantize_weights(jnp.asarray(w_up), contract_axis=1)
        jdn, sdn = jq.quantize_weights(jnp.asarray(w_dn), contract_axis=1)
        dt_j, dt_t = getattr(jnp, out_dtype), getattr(torch, out_dtype)
        # The port's expert layout: [E, out, in].
        tup = torch.from_numpy(np.array(jup).transpose(0, 2, 1).copy())
        tdn = torch.from_numpy(np.array(jdn).transpose(0, 2, 1).copy())
        ref_up = jq.int8_experts_up(jnp.asarray(x), jup, sup, out_dtype=dt_j)
        got_up = tq.int8_experts_up(torch.from_numpy(x), tup,
                                    torch.from_numpy(np.array(sup)),
                                    out_dtype=dt_t)
        assert tuple(got_up.shape) == (2, 9, e, m)
        _assert_out_close(got_up, ref_up, out_dtype)
        # The down product from the same (reference) input on both sides.
        hid = np.array(ref_up.astype(jnp.float32))
        ref_dn = jq.int8_experts_down(jnp.asarray(hid).astype(dt_j), jdn,
                                      sdn, out_dtype=dt_j)
        got_dn = tq.int8_experts_down(torch.from_numpy(hid).to(dt_t), tdn,
                                      torch.from_numpy(np.array(sdn)),
                                      out_dtype=dt_t)
        assert tuple(got_dn.shape) == (2, 9, e, h)
        _assert_out_close(got_dn, ref_dn, out_dtype)
        # The int32 accumulators of both products.
        jxq, _ = jq.quantize_activations(jnp.asarray(x))
        jacc = jnp.einsum("blh,ehm->blem", jxq, jup,
                          preferred_element_type=jnp.int32)
        tacc = tq.int8_matmul(torch.from_numpy(np.array(jxq)).view(-1, h),
                              tup.reshape(e * m, h))
        np.testing.assert_array_equal(tacc.view(2, 9, e, m).numpy(),
                                      np.asarray(jacc))
        jhq, _ = jq.quantize_activations(jnp.asarray(hid).astype(dt_j))
        jacc = jnp.einsum("blem,emh->bleh", jhq, jdn,
                          preferred_element_type=jnp.int32)
        thq = torch.from_numpy(np.array(jhq)).view(-1, e, m)
        for i in range(e):
            np.testing.assert_array_equal(
                tq.int8_matmul(thq[:, i], tdn[i]).view(2, 9, h).numpy(),
                np.asarray(jacc)[:, :, i])

    def test_int8_matmul_rejects(self):
        a = torch.zeros((4, 8), dtype=torch.int8)
        with pytest.raises(TypeError):
            tq.int8_matmul(a.float(), a)
        with pytest.raises(ValueError):
            tq.int8_matmul(a, torch.zeros((8, 16), dtype=torch.int8))
        with pytest.raises(ValueError):
            tq.int8_matmul(a[None], a)


def _assert_out_close(out, ref, out_dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    got = out.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:
        # One bf16 ulp of the larger magnitude: 2^-7 relative (8 bits of
        # mantissa, 7 stored).
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= ulp)


# -- the quantized tree and the model ----------------------------------------
@pytest.fixture(scope="module")
def tiny():
    if jax is None:
        pytest.skip("needs JAX and the JAX package (the reference)")
    cfg = dataclasses.replace(jenc.TINY_TEST, n_labels=5)
    ids = np.array(jax.random.randint(jax.random.PRNGKey(3), (4, 16), 4,
                                        cfg.vocab_size), dtype=np.int32)
    lens = np.array([16, 9, 3, 12])
    mask = np.arange(16)[None, :] < lens[:, None]
    ids[~mask] = 0
    model = jenc.EmbedderClassifier(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                        jnp.asarray(mask))
    calib_model = jenc.EmbedderClassifier(
        dataclasses.replace(cfg, calibrate=True))
    calib = jmq.calibrate_activation_scales(
        calib_model, params, jnp.asarray(ids), jnp.ones(ids.shape, bool))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, np_params, calib, ids, mask


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class TestTree:
    @pytest.mark.parametrize("wrapped", [True, False])
    def test_quantize_encoder_params_equal(self, tiny, wrapped):
        _, params, np_params, _, _, _ = tiny
        src = np_params if wrapped else np_params["params"]
        ref = jmq.quantize_encoder_params(params if wrapped
                                          else params["params"])
        got = tmq.quantize_encoder_params(src)
        assert_trees_equal(got, _np(ref))
        # Idempotent, and the source tree is left as it was.
        assert_trees_equal(tmq.quantize_encoder_params(got), got)
        assert any(k.endswith("qkv/kernel") for k in _flat(np_params))

    def test_static_layout_equal(self, tiny):
        _, params, np_params, calib, _, _ = tiny
        ref = _np(jmq.quantize_encoder_params(params, act_scales=calib))
        got = tmq.quantize_encoder_params(np_params, act_scales=_np(calib))
        assert_trees_equal(got, ref)
        layer = got["params"]["encoder"]["layers_0"]
        for a in (layer["attn"]["qkv/a_scale"],
                  layer["attn"]["attn_out"]["a_scale"],
                  layer["mlp"]["mlp_up"]["a_scale"],
                  layer["mlp"]["mlp_down"]["a_scale"]):
            assert a.shape == () and a.dtype == np.float32 and a > 0

    def test_size_bytes_equal(self, tiny):
        _, params, np_params, _, _, _ = tiny
        q = tmq.quantize_encoder_params(np_params)
        assert tmq.quantized_size_bytes(q) == jmq.quantized_size_bytes(
            jmq.quantize_encoder_params(params))
        assert tmq.quantized_size_bytes(np_params) == \
            jmq.quantized_size_bytes(params)

    @pytest.mark.parametrize("static", [False, True])
    def test_moe_tree_equal(self, static):
        """The MoE branch: expert kernels per (expert, output channel), the
        router untouched; under ``int8_static`` only the attention takes
        calibrated scales (the reference's experts sow no abs-max)."""
        cfg = dataclasses.replace(jenc.TINY_TEST, n_experts=4, n_labels=5)
        ids = np.arange(4, 4 + 2 * 16, dtype=np.int32).reshape(2, 16)
        mask = np.ones(ids.shape, bool)
        params = jenc.EmbedderClassifier(cfg).init(
            jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask))
        calib = None
        if static:
            calib = jmq.calibrate_activation_scales(
                jenc.EmbedderClassifier(dataclasses.replace(
                    cfg, calibrate=True)), params, jnp.asarray(ids),
                jnp.asarray(mask))
        ref = _np(jmq.quantize_encoder_params(params, act_scales=calib))
        got = tmq.quantize_encoder_params(
            _np(params), act_scales=None if calib is None else _np(calib))
        assert_trees_equal(got, ref)
        moe = got["params"]["encoder"]["layers_1"]["moe"]
        assert sorted(moe) == ["experts_down/kernel_q", "experts_down/scale",
                               "experts_up/kernel_q", "experts_up/scale",
                               "router"]
        assert moe["experts_up/scale"].shape == (4, cfg.mlp_dim)
        assert moe["experts_down/scale"].shape == (4, cfg.hidden)
        attn = got["params"]["encoder"]["layers_1"]["attn"]
        assert ("qkv/a_scale" in attn) == static

    def test_calibration_agrees(self, tiny):
        cfg, _, np_params, calib, ids, _ = tiny
        model = tenc.EmbedderClassifier(dataclasses.replace(
            tenc.TINY_TEST, n_labels=5, calibrate=True))
        load_flax_params(model, np_params)
        got = tmq.calibrate_activation_scales(
            model.eval(), torch.from_numpy(ids),
            torch.ones(ids.shape, dtype=torch.bool))
        ref = _np(calib)
        assert sorted(_flat(got)) == sorted(_flat(ref))
        for k, v in _flat(ref).items():
            np.testing.assert_allclose(_flat(got)[k], v, rtol=1e-5,
                                       err_msg=k)
        # Two calls record the same values (the dicts are reset first).
        again = tmq.calibrate_activation_scales(
            model, torch.from_numpy(ids),
            torch.ones(ids.shape, dtype=torch.bool))
        for k, v in _flat(got).items():
            np.testing.assert_array_equal(_flat(again)[k], v)

    def test_calibration_needs_calibrate(self, tiny):
        model = tenc.EmbedderClassifier(dataclasses.replace(
            tenc.TINY_TEST, n_labels=5))
        with pytest.raises(ValueError):
            tmq.calibrate_activation_scales(
                model, torch.zeros((1, 4), dtype=torch.int64),
                torch.ones((1, 4), dtype=torch.bool))


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
class TestModel:
    def _pair(self, tiny, mode):
        cfg, params, np_params, calib, _, _ = tiny
        scales = calib if mode == "int8_static" else None
        jparams = jmq.quantize_encoder_params(params, act_scales=scales)
        jmodel = jenc.EmbedderClassifier(dataclasses.replace(cfg,
                                                             quant=mode))
        tree = tmq.quantize_encoder_params(
            np_params, act_scales=None if scales is None else _np(scales))
        tmodel = tenc.EmbedderClassifier(dataclasses.replace(
            tenc.TINY_TEST, n_labels=5, quant=mode))
        load_flax_params(tmodel, tree)
        return jmodel, jparams, tmodel.eval(), tree

    def _assert_close(self, temb, tlog, jemb, jlog):
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb),
                                   atol=EMB_ATOL, rtol=0)
        ref = np.asarray(jax.nn.softmax(jlog, axis=-1))
        top2 = np.sort(ref, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > LABEL_MARGIN
        assert clear.any()
        np.testing.assert_array_equal(
            tlog.numpy().argmax(-1)[clear], ref.argmax(-1)[clear])

    def test_unpacked_matches_flax(self, tiny, mode):
        _, _, _, _, ids, mask = tiny
        jmodel, jparams, tmodel, _ = self._pair(tiny, mode)
        jemb, jlog = jmodel.apply(jparams, jnp.asarray(ids),
                                  jnp.asarray(mask))
        with torch.inference_mode():
            temb, tlog = tmodel(torch.from_numpy(ids),
                                torch.from_numpy(mask))
        self._assert_close(temb, tlog, jemb, jlog)

    def test_packed_matches_flax(self, tiny, mode):
        from distributed_crawler_tpu.ops.padding import pack_rows

        rng = np.random.default_rng(6)
        seqs = [list(rng.integers(4, 1024, size=int(n)))
                for n in rng.integers(1, 14, size=9)]
        p = pack_rows(seqs, 32, max_segments=4)
        jmodel, jparams, tmodel, _ = self._pair(tiny, mode)
        jemb, jlog = jmodel.apply(
            jparams, jnp.asarray(p.ids), jnp.asarray(p.mask),
            segment_ids=jnp.asarray(p.segment_ids),
            positions=jnp.asarray(p.positions), n_segments=4)
        with torch.inference_mode():
            temb, tlog = tmodel(
                torch.from_numpy(p.ids), torch.from_numpy(p.mask),
                segment_ids=torch.from_numpy(p.segment_ids),
                positions=torch.from_numpy(p.positions), n_segments=4)
        self._assert_close(temb, tlog, jemb, jlog)

    def test_tree_roundtrip(self, tiny, mode):
        """`flax_tree` gives back the quantized tree that was loaded."""
        _, _, _, tree = self._pair(tiny, mode)
        _, _, tmodel, _ = self._pair(tiny, mode)
        assert_trees_equal(flax_tree(tmodel), tree)

    def test_float_leaf_for_int8_raises(self, tiny, mode):
        _, _, _, tree = self._pair(tiny, mode)
        _, _, tmodel, _ = self._pair(tiny, mode)
        attn = tree["params"]["encoder"]["layers_1"]["attn"]
        attn["qkv/kernel_q"] = attn["qkv/kernel_q"].astype(np.float32)
        with pytest.raises(ValueError, match="dtype"):
            load_flax_params(tmodel, tree)


@pytest.mark.gpu
class TestOnCard:
    @pytest.fixture
    def cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return torch.device("cuda", 0)

    @pytest.mark.parametrize("m, k, n", [(64, 768, 2304), (17, 3072, 768),
                                         (4096, 768, 3072)])
    def test_int8_product_equals_cpu(self, cuda, m, k, n):
        gen = torch.Generator().manual_seed(m + k + n)
        x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
        got = tq.int8_matmul(x.to(cuda), w.to(cuda))
        torch.cuda.synchronize()
        want = x.to(torch.int32) @ w.to(torch.int32).t()
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)

    def test_int8_dense_on_card_matches_cpu(self, cuda):
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((4, 32, 768), generator=gen).to(torch.bfloat16)
        w_q, scale = tq.quantize_weights(
            torch.randn((768, 2304), generator=gen) * 0.05)
        w_q = w_q.t().contiguous()
        bias = torch.randn(2304, generator=gen)
        cpu = tq.int8_dense(x, w_q, scale, bias)
        card = tq.int8_dense(x.to(cuda), w_q.to(cuda), scale.to(cuda),
                             bias.to(cuda))
        assert torch.equal(card.cpu(), cpu)

    def test_refused_shape_raises(self, cuda):
        x = torch.zeros((16, 64), dtype=torch.int8, device=cuda)
        with pytest.raises(ValueError, match="m > 16"):
            tq.int8_matmul(x, torch.zeros((64, 64), dtype=torch.int8,
                                          device=cuda))
        with pytest.raises(ValueError, match="multiples of 8"):
            tq.int8_matmul(torch.zeros((32, 12), dtype=torch.int8,
                                       device=cuda),
                           torch.zeros((64, 12), dtype=torch.int8,
                                       device=cuda))

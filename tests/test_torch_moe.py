"""The port's Switch-MoE against the JAX package's, on the CPU.

`TINY_TEST` widths with 4 experts.  Inputs come from numpy seeds, and the
reference's flax params go through the port's loader.  Tolerances:

- `SwitchMoE` alone: f32 within 1e-5 absolute (the same products, summed
  in another order); bf16 within 2e-2 (XLA and PyTorch round the bf16
  products and the GELU at other places);
- dropped tokens (capacity dispatch): equal token by token, and equal to a
  plain Python count of each expert's queue per group;
- the whole `EmbedderClassifier`: f32 as `tests/test_torch_encoder.py`
  (1e-5 abs / 1e-4 rel); int8 and ``int8_static`` as
  `tests/test_torch_quant.py` (embeddings within 1e-2, labels equal where
  the top score leads by more than 2e-2);
- `TPUWorker` over a capacity-dispatch engine: as `tests/test_torch_worker.py`
  (f32, 1e-5 abs / 1e-4 rel), the batch layouts being equal.

The card test (``-m gpu``) holds the MoE layer on the card against its CPU
run; it needs no JAX, so this file also collects on the card's machine.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distributed_crawler_tpu_torch.models import encoder as tenc  # noqa: E402
from distributed_crawler_tpu_torch.models import quant as tmq  # noqa: E402
from distributed_crawler_tpu_torch.models.from_jax import (  # noqa: E402
    _moe,
    flax_tree,
    load_flax_params,
    load_leaves,
)

try:
    import jax
    import jax.numpy as jnp

    from distributed_crawler_tpu.models import encoder as jenc
    from distributed_crawler_tpu.models import quant as jmq
except ImportError:  # the card's machine: only the card test runs there
    jax = None

N_EXPERTS = 4
F32_TOL = dict(atol=1e-5, rtol=0)
BF16_TOL = dict(atol=2e-2, rtol=0)
MODEL_TOL = dict(atol=1e-5, rtol=1e-4)
EMB_ATOL = 1e-2
LABEL_MARGIN = 2e-2


@pytest.fixture(autouse=True)
def _reference(request):
    """The parity tests need the JAX package; the card test does not."""
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs JAX and the JAX package (the reference)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(module, **change):
    return dataclasses.replace(module.TINY_TEST, n_experts=N_EXPERTS,
                               **change)


def _x(seed, shape, dtype="float32"):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, jnp.asarray(x).astype(dtype)


def _pair(seed, x, **change):
    """A reference `SwitchMoE` with its params, and the port's loaded with
    them (the reference's f32 tree through `models/from_jax`)."""
    jmoe = jenc.SwitchMoE(_cfg(jenc, **change))
    params = jmoe.init(jax.random.PRNGKey(seed), x)
    tmoe = tenc.SwitchMoE(_cfg(tenc, **change))
    load_leaves({"moe": jax.tree.map(np.asarray, params["params"])},
                _moe("moe", tmoe))
    return jmoe, params, tmoe.eval()


def _run_both(jmoe, params, tmoe, x, tx, mask=None):
    jout = jmoe.apply(params, x, mask=None if mask is None
                      else jnp.asarray(mask))
    with torch.inference_mode():
        tout = tmoe(tx, None if mask is None else torch.from_numpy(mask))
    return (np.asarray(jout.astype(jnp.float32)),
            tout.float().numpy())


def _tx(x_np, dtype):
    return torch.from_numpy(x_np).to(getattr(torch, dtype))


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_switch_moe_matches(dispatch, dtype):
    x_np, x = _x(0, (3, 24, 64), dtype)
    mask = np.arange(24)[None, :] < np.array([24, 17, 5])[:, None]
    jmoe, params, tmoe = _pair(1, x, moe_dispatch=dispatch, dtype=dtype)
    jout, tout = _run_both(jmoe, params, tmoe, x, _tx(x_np, dtype), mask)
    assert tout.shape == jout.shape == x_np.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tout, jout, **tol)


def test_router_matches_and_ties_pick_the_first_expert():
    x_np, x = _x(2, (2, 16, 64))
    jmoe, params, tmoe = _pair(0, x)
    gate = x_np @ np.asarray(params["params"]["router"]["kernel"])
    want = np.argmax(gate, axis=-1)
    with torch.inference_mode():
        probs, top = tmoe.route(torch.from_numpy(x_np))
    np.testing.assert_array_equal(top.numpy(), want)
    # Equal logits on experts 1 and 3: the first wins, as in jnp.argmax.
    with torch.no_grad():
        tmoe.router.weight.zero_()
        tmoe.router.bias.copy_(torch.tensor([0.0, 2.0, 1.0, 2.0]))
        _, top = tmoe.route(torch.from_numpy(x_np))
    assert bool((top == 1).all())
    assert int(jnp.argmax(jnp.asarray([0.0, 2.0, 1.0, 2.0]))) == 1


def _plain_keep(top, valid, n_experts, cf, group=4096):
    """Which tokens capacity dispatch keeps: a plain Python count of each
    expert's queue within each group of ``group`` tokens."""
    n = len(top)
    g = min(n, group)
    cap = max(1, int(math.ceil(g / n_experts * cf)))
    keep = np.zeros(n, bool)
    for start in range(0, n, g):
        seen = [0] * n_experts
        for i in range(start, min(start + g, n)):
            if valid[i]:
                keep[i] = seen[top[i]] < cap
                seen[top[i]] += 1
    return keep


@pytest.mark.parametrize("shape, cf, padded", [
    ((2, 16, 64), 0.25, False),    # guaranteed drops
    ((4, 32, 64), 0.25, True),     # drops, and padding never routes
    ((72, 125, 64), 1.25, True),   # 9000 tokens: three groups, the last
    ((72, 125, 64), 0.25, False),  #   padded to 4096
])
def test_capacity_drops_match_token_by_token(shape, cf, padded):
    x_np, x = _x(3, shape)
    b, l, _ = shape
    mask = None
    if padded:
        lens = np.random.default_rng(4).integers(1, l + 1, size=b)
        mask = np.arange(l)[None, :] < lens[:, None]
    jmoe, params, tmoe = _pair(2, x, moe_dispatch="capacity",
                               moe_capacity_factor=cf)
    jout, tout = _run_both(jmoe, params, tmoe, x, torch.from_numpy(x_np),
                           mask)
    np.testing.assert_allclose(tout, jout, **F32_TOL)
    jdrop = ~np.asarray(jout).reshape(b * l, -1).any(axis=1)
    tdrop = ~tout.reshape(b * l, -1).any(axis=1)
    np.testing.assert_array_equal(tdrop, jdrop)
    with torch.inference_mode():
        _, top = tmoe.route(torch.from_numpy(x_np))
    valid = np.ones(b * l, bool) if mask is None else mask.reshape(-1)
    keep = _plain_keep(top.numpy().reshape(-1), valid, N_EXPERTS, cf)
    np.testing.assert_array_equal(tdrop, ~keep)
    if cf < 1:
        assert tdrop.any()
    if padded:
        assert tdrop[~valid].all()


def test_capacity_equals_dense_when_nothing_overflows():
    x_np, x = _x(5, (3, 24, 64))
    _, _, dense = _pair(0, x)
    _, _, cap = _pair(0, x, moe_dispatch="capacity", moe_capacity_factor=8.0)
    with torch.inference_mode():
        a = dense(torch.from_numpy(x_np))
        b = cap(torch.from_numpy(x_np))
    np.testing.assert_allclose(b.numpy(), a.numpy(), **F32_TOL)


# -- the whole model ---------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_moe():
    if jax is None:
        pytest.skip("needs JAX and the JAX package (the reference)")
    cfg = _cfg(jenc, n_labels=5)
    rng = np.random.default_rng(7)
    ids = rng.integers(4, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    lens = np.array([32, 19, 3, 26])
    mask = np.arange(32)[None, :] < lens[:, None]
    ids[~mask] = 0
    params = jenc.EmbedderClassifier(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    calib = jmq.calibrate_activation_scales(
        jenc.EmbedderClassifier(dataclasses.replace(cfg, calibrate=True)),
        params, jnp.asarray(ids), jnp.ones(ids.shape, bool))
    return cfg, params, calib, ids, mask


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("mode", ["dense", "capacity", "int8",
                                  "int8_static"])
def test_model_matches_flax(tiny_moe, mode):
    cfg, params, calib, ids, mask = tiny_moe
    change = ({"moe_dispatch": mode} if mode in ("dense", "capacity")
              else {"quant": mode})
    scales = calib if mode == "int8_static" else None
    jparams = (jmq.quantize_encoder_params(params, act_scales=scales)
               if "quant" in change else params)
    tree = (tmq.quantize_encoder_params(
        _np(params), act_scales=None if scales is None else _np(scales))
        if "quant" in change else _np(params))
    tmodel = tenc.EmbedderClassifier(_cfg(tenc, n_labels=5, **change))
    load_flax_params(tmodel, tree)
    jemb, jlog = jenc.EmbedderClassifier(
        dataclasses.replace(cfg, **change)).apply(
        jparams, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        temb, tlog = tmodel.eval()(torch.from_numpy(ids),
                                   torch.from_numpy(mask))
    if "quant" not in change:
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb),
                                   **MODEL_TOL)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **MODEL_TOL)
        return
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb),
                               atol=EMB_ATOL, rtol=0)
    ref = np.asarray(jax.nn.softmax(jlog, axis=-1))
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LABEL_MARGIN
    np.testing.assert_array_equal(tlog.numpy().argmax(-1)[clear],
                                  ref.argmax(-1)[clear])
    # The loaded model gives back the quantized tree it was given.
    got = flax_tree(tmodel)["params"]["encoder"]["layers_0"]["moe"]
    want = tree["params"]["encoder"]["layers_0"]["moe"]
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_moe_layers_calibrate_their_attention_only(tiny_moe):
    cfg, params, calib, ids, _ = tiny_moe
    model = tenc.EmbedderClassifier(_cfg(tenc, n_labels=5, calibrate=True))
    load_flax_params(model, _np(params))
    got = tmq.calibrate_activation_scales(
        model.eval(), torch.from_numpy(ids),
        torch.ones(ids.shape, dtype=torch.bool))
    ref = _np(calib)
    for layer in ("layers_0", "layers_1"):
        assert sorted(got["encoder"][layer]) == \
            sorted(ref["encoder"][layer]) == ["attn"]
        for k, v in ref["encoder"][layer]["attn"].items():
            v = v[0] if isinstance(v, tuple) else v
            np.testing.assert_allclose(got["encoder"][layer]["attn"][k], v,
                                       rtol=1e-5)


def test_seeded_tree_has_the_reference_layout_and_scale(tiny_moe):
    """`engine.random_tree` draws the experts as flax's ``lecun_normal``
    does: the reference's keys and shapes, std sqrt(1/fan_in)."""
    from distributed_crawler_tpu_torch.inference.engine import random_tree

    _, params, _, _, _ = tiny_moe
    tree = random_tree(_cfg(tenc, n_labels=5), 0)["params"]
    want = _np(params)["params"]
    for layer in ("layers_0", "layers_1"):
        got, ref = tree["encoder"][layer]["moe"], want["encoder"][layer][
            "moe"]
        assert sorted(got) == sorted(ref)
        for k in ("experts_up/kernel", "experts_down/kernel"):
            assert got[k].shape == ref[k].shape and got[k].dtype == np.float32
            fan_in = got[k].shape[1]
            assert abs(got[k].std() - fan_in ** -0.5) < 0.02 * fan_in ** -0.5
        assert not got["router"]["bias"].any()


# -- the worker ---------------------------------------------------------------
def test_worker_serves_capacity_moe_as_the_reference(monkeypatch):
    from distributed_crawler_tpu.inference import engine as jeng
    from distributed_crawler_tpu.utils.metrics import (
        MetricsRegistry as JaxRegistry,
    )

    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.inference import engine as teng
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry
    from tests.test_torch_worker import (
        _assert_same,
        _by_batch,
        _jax_batches,
        _run_jax,
        _run_port,
    )

    monkeypatch.setitem(jeng.MODEL_REGISTRY, "tiny_moe", _cfg(jenc))
    monkeypatch.setitem(teng.MODEL_REGISTRY, "tiny_moe", _cfg(tenc))
    cfg = dict(model="tiny_moe", n_labels=3, batch_size=4,
               buckets=(16, 32, 64), moe_dispatch="capacity")
    je = jeng.InferenceEngine(jeng.EngineConfig(**cfg),
                              registry=JaxRegistry())
    te = teng.InferenceEngine(teng.EngineConfig(**cfg),
                              params=_np(je.params),
                              registry=MetricsRegistry(), device="cpu")
    assert te.ecfg.moe_dispatch == "capacity"
    dicts = [b.to_dict() for b in _jax_batches([4, 2, 6, 3])]
    frames, acks, worker = _run_port(te, dicts)
    port, ref = _by_batch(frames), _by_batch(_run_jax(je, dicts))
    assert sorted(port) == sorted(ref)
    assert sorted(acks) == sorted((d["batch_id"], True) for d in dicts)
    assert worker.get_status()["error_batches"] == 0
    for bid, frame in port.items():
        assert frame["records"] == ref[bid]["records"]
        assert len(RecordBatch.from_dict(frame).results) == \
            len(frame["records"])
        _assert_same(frame["results"], ref[bid]["results"])


# -- on the card -------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["dense", "capacity", "int8"])
def test_moe_layer_on_card_matches_cpu(dispatch):
    """XLM-R-base's MoE layer (hidden 768, 8 experts of 3072) on 2 x 512
    tokens, bf16 on the card against the same layer in f32 on the CPU,
    tokens whose f32 top-1 margin is under 1e-3 left out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_crawler_tpu_torch.inference.engine import random_tree

    quant = "int8" if dispatch == "int8" else "none"
    cfg = dataclasses.replace(
        tenc.XLMR_BASE, n_experts=8, n_layers=1, vocab_size=64,
        moe_dispatch="capacity" if dispatch == "capacity" else "dense")
    tree = random_tree(cfg, 0)
    if quant == "int8":
        tree = tmq.quantize_encoder_params(tree)
    moe_tree = {"moe": tree["params"]["encoder"]["layers_0"]["moe"]}
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 512, cfg.hidden), generator=gen)
    mask = torch.ones((2, 512), dtype=torch.int32)
    mask[1, 300:] = 0
    outs = {}
    for name, dtype, device in (("cpu", "float32", "cpu"),
                                ("card", "bfloat16", "cuda")):
        c = dataclasses.replace(cfg, dtype=dtype, quant=quant)
        moe = tenc.SwitchMoE(c)
        load_leaves(moe_tree, _moe("moe", moe))
        moe = moe.to(device).eval()
        with torch.inference_mode():
            xin = x.to(device=device, dtype=c.adtype)
            probs, top = moe.route(xin)
            outs[name] = (moe(xin, mask.to(device)).float().cpu(),
                          probs.float().cpu(), top.cpu())
    out_c, probs_c, top_c = outs["cpu"]
    out_g, _, top_g = outs["card"]
    top2 = probs_c.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) >= 1e-3
    assert bool((top_g[clear] == top_c[clear]).all())
    # Capacity: a flipped near-tie can move a later token of its group
    # past capacity, so compare the tokens both kept, and allow as many
    # other drops as there are near-ties.
    kept_c, kept_g = out_c.abs().sum(-1) > 0, out_g.abs().sum(-1) > 0
    assert int((kept_c != kept_g).sum()) <= int((~clear).sum())
    both = clear & mask.bool() & kept_c & kept_g
    cos = torch.nn.functional.cosine_similarity(out_g[both], out_c[both],
                                                dim=-1)
    assert float(cos.min()) > (0.98 if quant == "int8" else 0.99)

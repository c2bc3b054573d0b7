"""The port's LoRA fine-tune (`models/lora.py`) against the JAX package's,
on the CPU.

`TINY_TEST` in f32 with the reference's params.  The reference draws its
adapters from JAX's PRNG and the port from a ``torch.Generator``, so the
parity cases feed the reference's adapters in (``finetune_lora(lora=...)``).
Tolerances: merged trees 1e-6 (one f32 product per kernel in both);
`finetune_lora`'s per-epoch loss and final params 1e-4 abs + 1e-3 rel, as
`tests/test_torch_train.py`'s fine-tune loops.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.models import encoder as jenc  # noqa: E402
from distributed_crawler_tpu.models import lora as jlora  # noqa: E402
from distributed_crawler_tpu.models import train as jtrain  # noqa: E402
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.models import encoder as tenc  # noqa: E402
from distributed_crawler_tpu_torch.models import lora as tlora  # noqa: E402
from distributed_crawler_tpu_torch.models import train as ttrain  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)
from tests.test_torch_train import (  # noqa: E402
    FIT,
    assert_trees_close,
    dataset,
    leaves,
    np_tree,
)

TARGETS = {"attn/qkv/kernel", "attn/attn_out/kernel", "mlp/mlp_up/kernel",
           "mlp/mlp_down/kernel"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_params(n_experts=0, seed=0):
    cfg = dataclasses.replace(jenc.TINY_TEST, n_labels=2,
                              n_experts=n_experts)
    model = jenc.Classifier(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    return cfg, np_tree(model.init(jax.random.PRNGKey(seed), ids,
                                   jnp.ones((1, 8), bool)))


def tcfg(n_experts=0):
    return dataclasses.replace(tenc.TINY_TEST, n_labels=2,
                               n_experts=n_experts)


def ref_adapters(params, rank, seed=0):
    return np_tree(jlora.init_lora_params(jax.random.PRNGKey(seed), params,
                                          rank))


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_adapters_cover_the_references_targets(n_experts):
    """The same kernels get adapters (MoE experts none), with the same
    shapes; ``a`` is scaled normal, ``b`` zero."""
    _, params = ref_params(n_experts)
    want = ref_adapters(params, 4)
    got = tlora.init_lora_params(torch.Generator().manual_seed(0), params, 4)
    assert got.keys() == want.keys()
    for lname in want:
        assert got[lname].keys() == want[lname].keys()
        assert set(got[lname]) <= TARGETS
        for key, ab in want[lname].items():
            for part in ("a", "b"):
                assert got[lname][key][part].shape == ab[part].shape
            assert not got[lname][key]["b"].any()
            a = got[lname][key]["a"]
            assert abs(float(a.std()) * np.sqrt(a.shape[0]) - 1.0) < 0.5
    assert tlora.lora_rank_of(got) == jlora.lora_rank_of(want) == 4


def test_init_from_a_model_equals_init_from_its_tree():
    _, params = ref_params()
    model = tenc.Classifier(tcfg())
    from distributed_crawler_tpu_torch.models.from_jax import (
        load_flax_params,
    )

    load_flax_params(model, params)
    a = tlora.init_lora_params(torch.Generator().manual_seed(3), model, 2)
    b = tlora.init_lora_params(torch.Generator().manual_seed(3), params, 2)
    assert_trees_close(a, b, atol=0, rtol=0)


def test_merge_equals_the_references():
    """Non-zero adapters folded into the kernels: the merged trees agree
    within 1e-6, and the base tree is left as it was."""
    _, params = ref_params()
    lora = ref_adapters(params, 4)
    rng = np.random.default_rng(0)
    for adapters in lora.values():
        for ab in adapters.values():
            ab["b"] = rng.standard_normal(ab["b"].shape).astype(np.float32)
    before = {k: v.copy() for k, v in leaves(params).items()}
    got = tlora.merge_lora(params, lora, rank=4)
    want = np_tree(jlora.merge_lora(params, lora, rank=4))
    assert_trees_close(got, want, atol=1e-6, rtol=0)
    for k, v in leaves(params).items():
        np.testing.assert_array_equal(v, before[k])
    assert not np.allclose(
        got["params"]["encoder"]["layers_0"]["attn"]["qkv/kernel"],
        params["params"]["encoder"]["layers_0"]["attn"]["qkv/kernel"])


def test_merge_with_zero_b_is_identity():
    _, params = ref_params()
    merged = tlora.merge_lora(
        params, tlora.init_lora_params(torch.Generator(), params, 4))
    assert_trees_close(merged, params, atol=0, rtol=0)


def test_rank_mismatch_rejected_as_the_reference():
    _, params = ref_params()
    lora = ref_adapters(params, 4)
    for merge in (jlora.merge_lora, tlora.merge_lora):
        with pytest.raises(ValueError, match="does not match"):
            merge(params, lora, rank=2)


@pytest.mark.parametrize("case, message", [
    ("rank", "rank must be"), ("negative", "negative"),
    ("overflow", "exceeds head width")])
def test_validation_equals_the_references(case, message):
    jcfg, params = ref_params()
    rank, labels = (0, [0]) if case == "rank" else (
        2, [-1] if case == "negative" else [7])
    with pytest.raises(ValueError, match=message):
        jlora.finetune_lora(jcfg, params, [[1, 2]], labels, rank=rank)
    with pytest.raises(ValueError, match=message):
        tlora.finetune_lora(tcfg(), params, [[1, 2]], labels, rank=rank,
                            device="cpu")


@pytest.fixture(scope="module")
def ref_engine():
    return jeng.InferenceEngine(
        jeng.EngineConfig(model="tiny", n_labels=2, batch_size=8,
                          buckets=(16,)), registry=JaxRegistry())


@pytest.mark.parametrize("rank", [2, 4])
def test_finetune_lora_equals_the_references(ref_engine, rank):
    """The reference's adapters fed in: per-epoch loss and the merged
    params within 1e-4 abs + 1e-3 rel."""
    texts, labels = dataset(n_per_class=8)
    toks = ref_engine.tokenizer.encode_batch(texts)
    params = np_tree(ref_engine.params)
    tc = dict(learning_rate=5e-3, warmup_steps=3)
    want_p, want_h = jlora.finetune_lora(
        ref_engine.ecfg, ref_engine.params, toks, labels, rank=rank,
        tc=jtrain.TrainConfig(**tc), epochs=3, batch_size=8)
    got_p, got_h = tlora.finetune_lora(
        tcfg(), params, toks, labels, rank=rank,
        tc=ttrain.TrainConfig(**tc), epochs=3, batch_size=8,
        lora=ref_adapters(params, rank), device="cpu")
    for g, w in zip(got_h, want_h):
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(g[key], w[key], **FIT)
    assert_trees_close(got_p, np_tree(want_p), **FIT)
    k0 = params["params"]["encoder"]["layers_0"]["attn"]["qkv/kernel"]
    k1 = got_p["params"]["encoder"]["layers_0"]["attn"]["qkv/kernel"]
    assert not np.allclose(k0, k1)


def test_lora_on_moe_leaves_the_experts(ref_engine):
    """On a Switch-MoE encoder the experts and the router stay as they
    were; the adapted projections and the head move; equal to the
    reference's run."""
    jcfg, params = ref_params(n_experts=4)
    rng = np.random.default_rng(0)
    toks = [[1 + int(rng.integers(0, 50))] * 12 for _ in range(16)]
    labels = [i % 2 for i in range(16)]
    tc = dict(learning_rate=5e-3, warmup_steps=2)
    want_p, _ = jlora.finetune_lora(jcfg, params, toks, labels, rank=2,
                                    tc=jtrain.TrainConfig(**tc), epochs=2,
                                    batch_size=8)
    got_p, _ = tlora.finetune_lora(tcfg(4), params, toks, labels, rank=2,
                                   tc=ttrain.TrainConfig(**tc), epochs=2,
                                   batch_size=8,
                                   lora=ref_adapters(params, 2),
                                   device="cpu")
    assert_trees_close(got_p, np_tree(want_p), **FIT)
    moe = got_p["params"]["encoder"]["layers_0"]["moe"]
    base = params["params"]["encoder"]["layers_0"]["moe"]
    for k, v in leaves(base).items():
        np.testing.assert_array_equal(leaves(moe)[k], v)


def test_merged_tree_serves_in_the_engine(ref_engine):
    texts, labels = dataset(n_per_class=6)
    toks = ref_engine.tokenizer.encode_batch(texts)
    params = np_tree(ref_engine.params)
    merged, _ = tlora.finetune_lora(
        tcfg(), params, toks, labels, rank=2,
        tc=ttrain.TrainConfig(learning_rate=5e-3, warmup_steps=2),
        epochs=2, batch_size=8, device="cpu")
    eng = teng.InferenceEngine(
        teng.EngineConfig(model="tiny", n_labels=2, batch_size=8,
                          buckets=(16,)), params=merged,
        registry=MetricsRegistry(), device="cpu")
    out = eng.run(texts[:4])
    assert len(out) == 4 and all(np.isfinite(r["scores"]).all()
                                 for r in out)

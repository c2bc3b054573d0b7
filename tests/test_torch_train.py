"""The port's training path (`models/train.py`, the encoder's training
additions, the attention repair) against the JAX package's, on the CPU.

`TINY_TEST` in f32 with the reference's params (flax ``.init`` -> numpy),
inputs from numpy seeds.  Tolerances, each stated where it is used:

- `cross_entropy`, the MoE aux loss and the optimizer's updates (optax's
  ``chain(clip_by_global_norm, adamw(linear_schedule))`` against the
  port's on ``torch.optim.AdamW``): 1e-6;
- gradients of the full loss against ``jax.value_and_grad``, per leaf:
  ``||g_port - g_ref|| <= 1e-4 * ||g_ref||``, with and without ``remat``;
- gradient accumulation 2 against 1 on the same batch: 1e-5;
- `encode_cls_features`: 1e-5;
- `finetune_head` and `finetune_full` against the reference, per-epoch loss
  and final params: 1e-4 abs + 1e-3 rel (f32 throughout; the two packages'
  LayerNorm variance formulas and summation orders differ by ~1e-7 per
  op, and Adam carries that over the run);
- a resumed `finetune_full` equal to an uninterrupted one: exactly.

The kernel's grad refusal on the card is tested in
`tests/test_torch_kernel.py` (``gpu``), which collects without JAX.
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.models import encoder as jenc  # noqa: E402
from distributed_crawler_tpu.models import train as jtrain  # noqa: E402
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.models import encoder as tenc  # noqa: E402
from distributed_crawler_tpu_torch.models import train as ttrain  # noqa: E402
from distributed_crawler_tpu_torch.models.from_jax import (  # noqa: E402
    flax_grads,
    load_flax_params,
)

FIT = dict(atol=1e-4, rtol=1e-3)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_trees_close(got, want, **tol):
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def tiny_cfg(**kw):
    return dataclasses.replace(jenc.TINY_TEST, n_labels=2, **kw), \
        dataclasses.replace(tenc.TINY_TEST, n_labels=2, **kw)


def init_params(jcfg, seed=0):
    model = jenc.Classifier(jcfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    return model.init(jax.random.PRNGKey(seed), ids,
                      jnp.ones((1, 8), bool))


def batch(seed=0, b=8, l=16, vocab=1024, n_labels=2, pad=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(b, l)).astype(np.int32)
    lens = rng.integers(l // 2, l + 1, size=b) if pad else np.full(b, l)
    mask = np.arange(l)[None, :] < lens[:, None]
    ids[~mask] = 0
    return ids, mask, rng.integers(0, n_labels, size=b).astype(np.int32)


CLASS_WORDS = (["alpha", "beta", "gamma", "delta"],
               ["omega", "sigma", "kappa", "zeta"])


def dataset(n_per_class=12, seed=0):
    """tests/test_train_head.py's two token-disjoint "languages"."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for label, words in enumerate(CLASS_WORDS):
        for _ in range(n_per_class):
            texts.append(" ".join(rng.choice(words, size=6)))
            labels.append(label)
    order = rng.permutation(len(texts))
    return [texts[i] for i in order], [labels[i] for i in order]


@pytest.fixture(scope="module")
def ref_engine():
    return jeng.InferenceEngine(
        jeng.EngineConfig(model="tiny", n_labels=2, batch_size=8,
                          buckets=(16,)), registry=JaxRegistry())


# -- the loss and the optimizer ------------------------------------------------
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_equals_the_references(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, size=6).astype(np.int32)
    want = float(jtrain.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), smoothing))
    got = float(ttrain.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), smoothing))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_learning_rate_is_optax_linear_schedule(warmup):
    tc = ttrain.TrainConfig(learning_rate=3e-4, warmup_steps=warmup)
    sched = optax.linear_schedule(0.0, 3e-4, warmup)
    for count in range(15):
        assert abs(ttrain.learning_rate(tc, count)
                   - float(sched(count))) <= 1e-10


def _opt_leaves(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 3), "b": (3,), "ln/scale": (5,)}
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in arrays.items()}
    return arrays, params


@pytest.mark.parametrize("grad_scale", [0.05, 10.0],
                         ids=["norm_below_max", "norm_above_max"])
def test_updates_equal_optax(grad_scale):
    """Three updates from the same params and gradients, the first at
    count 0 (lr 0: nothing moves), at a global norm below and above
    ``max_grad_norm``: every leaf within 1e-6."""
    tc = ttrain.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                            weight_decay=0.01, max_grad_norm=1.0)
    arrays, params = _opt_leaves(0)
    opt = ttrain.make_optimizer(tc, {k: (p, tuple(p.shape), "plain")
                                     for k, p in params.items()})
    joptim = jtrain.make_optimizer(jtrain.TrainConfig(
        learning_rate=1e-2, warmup_steps=2, weight_decay=0.01,
        max_grad_norm=1.0))
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jstate = joptim.init(jparams)
    rng = np.random.default_rng(7)
    norms = []
    for i in range(3):
        grads = {k: (rng.standard_normal(v.shape) * grad_scale)
                 .astype(np.float32) for k, v in arrays.items()}
        norms.append(float(np.sqrt(sum((g ** 2).sum()
                                       for g in grads.values()))))
        upd, jstate = joptim.update({k: jnp.asarray(g)
                                     for k, g in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"update {i}: {k}")
        if i == 0:
            for k, p in params.items():
                np.testing.assert_array_equal(p.detach().numpy(), arrays[k])
    assert all((n < 1.0) == (grad_scale < 1) for n in norms)


def test_optimizer_state_round_trips_exactly():
    tc = ttrain.TrainConfig(learning_rate=1e-2, warmup_steps=1)
    _, params = _opt_leaves(1)
    lv = {k: (p, tuple(p.shape), "plain") for k, p in params.items()}
    opt = ttrain.make_optimizer(tc, lv)
    for k, p in params.items():
        p.grad = torch.ones_like(p)
    opt.step()
    opt.step()
    tree = opt.state_tree()
    assert int(tree["count"]) == int(tree["step"]) == 2
    _, params2 = _opt_leaves(1)
    for k in params2:
        params2[k].data.copy_(params[k].data)
    opt2 = ttrain.make_optimizer(
        tc, {k: (p, tuple(p.shape), "plain") for k, p in params2.items()})
    opt2.load_state_tree(tree)
    for ps in (params, params2):
        for p in ps.values():
            p.grad = torch.full_like(p, 0.5)
    opt.step()
    opt2.step()
    for k in params:
        assert torch.equal(params[k], params2[k]), k


# -- the model's training additions ------------------------------------------
@pytest.mark.parametrize("case", ["dense", "moe", "remat", "moe_remat"])
def test_gradients_equal_jax_value_and_grad(case):
    """The full loss (cross entropy + 0.01 x MoE aux) differentiated by
    both packages from the same params and batch: per leaf ||dg|| <=
    1e-4 ||g||; the loss within 1e-5."""
    kw = {"n_experts": 4} if "moe" in case else {}
    if "remat" in case:
        kw["remat"] = True
    jcfg, tcfg = tiny_cfg(**kw)
    params = init_params(jcfg, seed=3)
    ids, mask, labels = batch(seed=4)
    model = jenc.Classifier(jcfg)

    def loss_fn(p):
        logits, mods = model.apply({"params": p}, ids, mask,
                                   mutable=["losses"])
        aux = jax.tree_util.tree_reduce(jnp.add, mods.get("losses", {}),
                                        jnp.float32(0))
        return jtrain.cross_entropy(logits, labels) + 0.01 * aux

    want_loss, want = jax.value_and_grad(loss_fn)(params["params"])
    step = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), np_tree(params),
                                  device=CPU)
    m = step.grads(ids, mask, labels)
    assert abs(float(m["loss"]) - float(want_loss)) <= 1e-5
    got = leaves(flax_grads(step.model)["params"])
    for k, w in leaves(np_tree(want)).items():
        err = np.linalg.norm(got[k] - w)
        assert err <= 1e-4 * max(np.linalg.norm(w), 1e-12), (k, err)


def test_remat_recomputes_in_backward_only():
    """With ``remat`` each layer runs under torch.utils.checkpoint when
    gradients are recorded; without them the forward is the plain one,
    and both give the same logits."""
    _, tcfg = tiny_cfg(remat=True)
    model = tenc.Classifier(tcfg)
    model.encoder.ln_embed.weight.data.fill_(1.0)
    gen = torch.Generator().manual_seed(0)
    tenc.init_weights_(model, gen)
    for p in (model.encoder.embed_tokens, model.encoder.embed_positions):
        p.data.normal_(0, 0.02, generator=gen)
    ids, mask, _ = batch(seed=5)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    calls = []
    hook = model.encoder.layers[0].register_forward_pre_hook(
        lambda *a: calls.append(1))
    with torch.no_grad():
        plain = model(ids_t, mask_t)
    assert len(calls) == 1
    out = model(ids_t, mask_t)
    out.sum().backward()
    hook.remove()
    assert len(calls) == 3  # forward, then the recomputation
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


@pytest.mark.parametrize("pad", [True, False])
def test_moe_aux_equals_the_references_sown_value(pad):
    jcfg, tcfg = tiny_cfg(n_experts=4)
    params = init_params(jcfg, seed=6)
    ids, mask, _ = batch(seed=7, pad=pad)
    _, mods = jenc.Classifier(jcfg).apply(params, ids, mask,
                                          mutable=["losses"])
    want = float(jax.tree_util.tree_reduce(jnp.add, mods["losses"],
                                           jnp.float32(0)))
    model = tenc.Classifier(tcfg)
    load_flax_params(model, np_tree(params))
    with torch.no_grad():
        _, aux = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       with_aux=True)
    assert want > 0 and abs(float(aux) - want) <= 1e-6


def test_dense_aux_is_zero_and_inference_returns_no_aux():
    _, tcfg = tiny_cfg()
    model = tenc.Classifier(tcfg)
    load_flax_params(model, np_tree(init_params(tiny_cfg()[0])))
    ids, mask, _ = batch(seed=8)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask), with_aux=True)
        plain = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert float(aux) == 0.0 and torch.equal(logits, plain)


def test_grad_accumulation_equals_one_step():
    """accum 2 against 1 on the same batch: gradients, metrics and the
    params after two updates within 1e-5."""
    jcfg, tcfg = tiny_cfg()
    params = np_tree(init_params(jcfg, seed=9))
    ids, mask, labels = batch(seed=10)
    out = {}
    for a in (1, 2):
        step = ttrain.make_train_step(
            tcfg, ttrain.TrainConfig(warmup_steps=1, grad_accum_steps=a),
            params, device=CPU)
        m = step.grads(ids, mask, labels)
        g = leaves(flax_grads(step.model)["params"])
        step.optimizer.step()
        step(ids, mask, labels)
        out[a] = ({k: float(v) for k, v in m.items()}, g,
                  leaves(step.params()))
    for k in out[1][0]:
        assert abs(out[1][0][k] - out[2][0][k]) <= 1e-5, k
    for i in (1, 2):
        for k, v in out[1][i].items():
            np.testing.assert_allclose(out[2][i][k], v, atol=1e-5, rtol=0,
                                       err_msg=k)


def test_indivisible_batch_rejected():
    jcfg, tcfg = tiny_cfg()
    step = ttrain.make_train_step(
        tcfg, ttrain.TrainConfig(grad_accum_steps=3),
        np_tree(init_params(jcfg)), device=CPU)
    ids, mask, labels = batch(b=8)
    with pytest.raises(ValueError, match="not divisible"):
        step(ids, mask, labels)


# -- the fine-tune loops -------------------------------------------------------
def test_encode_cls_features_equal_the_references(ref_engine):
    texts, _ = dataset(n_per_class=6)
    toks = ref_engine.tokenizer.encode_batch(texts + ["x " * 40])
    want = jtrain.encode_cls_features(ref_engine.ecfg, ref_engine.params,
                                      toks, batch_size=4, buckets=(16, 64))
    _, tcfg = tiny_cfg()
    got = ttrain.encode_cls_features(tcfg, np_tree(ref_engine.params), toks,
                                     batch_size=4, buckets=(16, 64),
                                     device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_finetune_head_equals_the_references(ref_engine):
    texts, labels = dataset()
    toks = ref_engine.tokenizer.encode_batch(texts)
    tc = dict(learning_rate=5e-3, warmup_steps=5)
    want_p, want_h = jtrain.finetune_head(
        ref_engine.ecfg, ref_engine.params, toks, labels,
        tc=jtrain.TrainConfig(**tc), epochs=6, batch_size=8)
    _, tcfg = tiny_cfg()
    got_p, got_h = ttrain.finetune_head(
        tcfg, np_tree(ref_engine.params), toks, labels,
        tc=ttrain.TrainConfig(**tc), epochs=6, batch_size=8, device=CPU)
    for g, w in zip(got_h, want_h):
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(g[key], w[key], **FIT)
    assert_trees_close(got_p, np_tree(want_p), **FIT)
    assert want_h[-1]["loss"] < want_h[0]["loss"]


@pytest.mark.parametrize("accum", [1, 2])
def test_finetune_full_equals_the_references(ref_engine, accum):
    texts, labels = dataset(n_per_class=8)
    toks = ref_engine.tokenizer.encode_batch(texts)
    tc = dict(learning_rate=5e-4, warmup_steps=3, grad_accum_steps=accum)
    want_p, want_h = jtrain.finetune_full(
        ref_engine.ecfg, ref_engine.params, toks, labels,
        tc=jtrain.TrainConfig(**tc), epochs=2, batch_size=8)
    _, tcfg = tiny_cfg()
    got_p, got_h = ttrain.finetune_full(
        tcfg, np_tree(ref_engine.params), toks, labels,
        tc=ttrain.TrainConfig(**tc), epochs=2, batch_size=8, device=CPU)
    for g, w in zip(got_h, want_h):
        for key in ("loss", "accuracy", "moe_aux"):
            np.testing.assert_allclose(g[key], w[key], **FIT)
    assert_trees_close(got_p, np_tree(want_p), **FIT)


@pytest.mark.parametrize("case, message", [
    ("mismatch", "texts vs"), ("empty", "empty training set"),
    ("epochs", "epochs must be"), ("negative", "negative label"),
    ("overflow", "exceeds head width")])
def test_dataset_errors_equal_the_references(ref_engine, case, message):
    toks, labels, epochs = [[5, 6], [7]], [0, 1], 1
    if case == "mismatch":
        labels = [0]
    elif case == "empty":
        toks, labels = [], []
    elif case == "epochs":
        epochs = 0
    elif case == "negative":
        labels = [0, -1]
    else:
        labels = [0, 5]
    _, tcfg = tiny_cfg()
    for fn, cfg, kw in (
            (jtrain.finetune_full, ref_engine.ecfg, {}),
            (ttrain.finetune_full, tcfg, {"device": CPU}),
            (jtrain.finetune_head, ref_engine.ecfg, {}),
            (ttrain.finetune_head, tcfg, {"device": CPU})):
        with pytest.raises(ValueError, match=message):
            fn(cfg, np_tree(ref_engine.params), toks, labels, epochs=epochs,
               **kw)


# -- resume --------------------------------------------------------------------
@pytest.fixture(scope="module")
def full_setup(ref_engine):
    texts, labels = dataset(n_per_class=8)
    toks = ref_engine.tokenizer.encode_batch(texts)
    _, tcfg = tiny_cfg()
    return tcfg, np_tree(ref_engine.params), toks, labels, \
        ttrain.TrainConfig(learning_rate=5e-4, warmup_steps=3)


def test_resume_matches_uninterrupted_exactly(full_setup, tmp_path):
    tcfg, params, toks, labels, tc = full_setup
    kw = dict(tc=tc, batch_size=8, device=CPU)
    ref_p, ref_h = ttrain.finetune_full(tcfg, params, toks, labels,
                                        epochs=3, **kw)
    sd = str(tmp_path / "state")
    ttrain.finetune_full(tcfg, params, toks, labels, epochs=1,
                         state_dir=sd, **kw)
    got_p, got_h = ttrain.finetune_full(tcfg, params, toks, labels,
                                        epochs=3, state_dir=sd, **kw)
    assert got_h == ref_h
    g, w = leaves(got_p), leaves(ref_p)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_completed_run_is_a_noop_and_fewer_epochs_refused(full_setup,
                                                          tmp_path):
    from distributed_crawler_tpu_torch.inference.checkpoint import (
        latest_train_state,
    )

    tcfg, params, toks, labels, tc = full_setup
    kw = dict(tc=tc, batch_size=8, device=CPU)
    sd = str(tmp_path / "state")
    _, h1 = ttrain.finetune_full(tcfg, params, toks, labels, epochs=2,
                                 state_dir=sd, **kw)
    _, h2 = ttrain.finetune_full(tcfg, params, toks, labels, epochs=2,
                                 state_dir=sd, **kw)
    assert h2 == h1
    assert sorted(d for d in os.listdir(sd)
                  if d.startswith("epoch_")) == ["epoch_1"]
    os.makedirs(os.path.join(sd, "epoch_5"))   # a crash before its marker
    assert latest_train_state(sd).endswith("epoch_1")
    with pytest.raises(ValueError, match="completed epochs"):
        ttrain.finetune_full(tcfg, params, toks, labels, epochs=1,
                             state_dir=sd, **kw)


def test_resume_from_a_state_the_reference_layout_names(full_setup,
                                                        tmp_path):
    """The saved state holds each AdamW moment under its param's flax
    path, plus the step and schedule counts."""
    from distributed_crawler_tpu_torch.inference.checkpoint import (
        latest_train_state,
        load_train_state,
    )

    tcfg, params, toks, labels, tc = full_setup
    sd = str(tmp_path / "state")
    ttrain.finetune_full(tcfg, params, toks, labels, tc=tc, epochs=1,
                         batch_size=8, state_dir=sd, device=CPU)
    epoch, p, opt, hist = load_train_state(latest_train_state(sd))
    assert epoch == 0 and len(hist) == 1
    assert set(opt) == {"exp_avg", "exp_avg_sq", "step", "count"}
    assert int(opt["count"]) == int(opt["step"]) == -(-len(toks) // 8)
    for moment in ("exp_avg", "exp_avg_sq"):
        assert leaves(opt[moment]).keys() == leaves(params["params"]).keys()
        for k, v in leaves(opt[moment]).items():
            assert v.shape == leaves(params["params"])[k].shape, k

"""The port's engine against the JAX package's, on the CPU.

Both engines serve the tiny model with the same params (the reference's,
converted to numpy).  Labels must be equal; embeddings and scores agree
within 1e-5 abs / 1e-4 rel (f32 throughout; LayerNorm's variance formula
and the summation order differ, ~1e-7 observed).  The host side — padding,
packing and the tokenizer — must be exactly equal.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.inference import tokenizer as jtok  # noqa: E402
from distributed_crawler_tpu.ops import padding as jpad  # noqa: E402
from distributed_crawler_tpu.utils.costmodel import (  # noqa: E402
    encoder_forward_flops as jax_flops,
)
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.inference import tokenizer as ttok  # noqa: E402
from distributed_crawler_tpu_torch.ops import padding as tpad  # noqa: E402
from distributed_crawler_tpu_torch.utils.costmodel import (  # noqa: E402
    encoder_forward_flops,
)
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = dict(model="tiny", n_labels=5, batch_size=4, buckets=(16, 32, 64))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    je = jeng.InferenceEngine(jeng.EngineConfig(**CFG),
                              registry=JaxRegistry())
    params = jax.tree.map(np.asarray, je.params)
    te = teng.InferenceEngine(teng.EngineConfig(**CFG), params=params,
                              registry=MetricsRegistry(), device="cpu")
    return je, te


def _texts(seed=0, n=13):
    rng = np.random.default_rng(seed)
    words = ["crawl", "Channel", "post!", "видео", "naïve", "x" * 30,
             "https://t.me/some_channel/123", "42", "e5", "ｆｕｌｌ"]
    return [" ".join(rng.choice(words, size=int(rng.integers(1, 40))))
            for _ in range(n)]


def _token_lists(seed=0):
    rng = np.random.default_rng(seed)
    out = [list(rng.integers(4, 1024, size=int(n)))
           for n in rng.integers(1, 70, size=17)]
    return [[int(t) for t in toks] for toks in out]


def _assert_results_match(a, b):
    assert len(a) == len(b)
    assert [r["label"] for r in a] == [r["label"] for r in b]
    np.testing.assert_allclose([r["embedding"] for r in a],
                               [r["embedding"] for r in b], **TOL)
    np.testing.assert_allclose([r["scores"] for r in a],
                               [r["scores"] for r in b], **TOL)


@pytest.mark.parametrize("pack", [False, True])
def test_run_tokenized_matches(engines, pack):
    je, te = engines
    toks = _token_lists()
    _assert_results_match(te.run_tokenized(toks, pack=pack),
                          je.run_tokenized(toks, pack=pack))


@pytest.mark.parametrize("pack", [False, True])
def test_run_with_empties_matches(engines, pack):
    je, te = engines
    toks = _token_lists(1)
    toks[0:0] = [[]]
    toks[5] = []
    a, b = te.run_tokenized(toks, pack=pack), je.run_tokenized(toks,
                                                              pack=pack)
    _assert_results_match(a, b)
    assert a[0] == b[0] == {"embedding": [0.0] * 64, "label": 0,
                            "scores": [0.2] * 5}
    assert te.run_tokenized([[]], pack=pack) == je.run_tokenized([[]],
                                                                pack=pack)


@pytest.mark.parametrize("pack", [False, True])
def test_run_texts_matches(engines, pack):
    je, te = engines
    texts = _texts() + [""]
    _assert_results_match(te.run(texts, pack=pack), je.run(texts, pack=pack))


def test_packed_equals_unpacked(engines):
    _, te = engines
    toks = _token_lists(2)
    a, b = te.run_tokenized(toks, pack=True), te.run_tokenized(toks)
    _assert_results_match(a, b)


def test_embed_and_warmup(engines):
    je, te = engines
    texts = _texts(3, n=5)
    np.testing.assert_allclose(te.embed(texts), je.embed(texts), **TOL)
    te.warmup()
    stats = te.compile_cache_stats()
    assert stats["programs_unpacked"] == [16, 32, 64]
    assert stats["programs_packed"] == [16, 32, 64]
    assert stats["misses_total"] == 6.0


def test_metrics_names_and_counts():
    reg = MetricsRegistry()
    te = teng.InferenceEngine(teng.EngineConfig(**CFG), registry=reg,
                              device="cpu")
    te.run_tokenized(_token_lists(4), pack=True)
    # The reference's metric names, registered in the engine's registry.
    assert reg.histogram("tpu_inference_batch_seconds") is te.m_latency
    for name, metric in (
            ("tpu_inference_posts_total", te.m_posts),
            ("tpu_inference_pad_slots_total", te.m_padding),
            ("tpu_inference_packed_segments_total", te.m_packed),
            ("tpu_inference_bucket_posts_total", te.m_bucket_posts),
            ("tpu_engine_compile_cache_misses_total", te.m_compile_miss)):
        assert reg.counter(name) is metric
    assert reg.gauge("tpu_engine_device_busy_fraction").labels(
        path="text") is te.timeline.m_busy
    assert te.m_posts.value == 17 == te.m_packed.value
    assert te.timeline.snapshot()["batches_total"] == te.m_latency.count


def test_softmax_np_matches():
    x = np.random.default_rng(0).normal(size=(4, 7)).astype(np.float32)
    np.testing.assert_array_equal(teng._softmax_np(x), jeng._softmax_np(x))


class TestHostSideExact:
    def test_tokenizer_ids_equal(self):
        a = ttok.HashingTokenizer(250037)
        b = jtok.HashingTokenizer(250037)
        texts = _texts(5, n=40) + ["", "  ", "ÅNGSTRÖM ﬁne", "a" * 200]
        assert a.encode_batch(texts) == b.encode_batch(texts)
        assert a.encode_batch(texts) == b.encode_batch(texts)  # memo path
        assert (ttok.PAD_ID, ttok.CLS_ID, ttok.SEP_ID, ttok.UNK_ID) == \
            (jtok.PAD_ID, jtok.CLS_ID, jtok.SEP_ID, jtok.UNK_ID)

    def test_bucketing_equal(self):
        spec_t, spec_j = tpad.BucketSpec((8, 16, 32)), jpad.BucketSpec(
            (8, 16, 32))
        for n in range(0, 40):
            assert tpad.bucket_for(n, spec_t) == jpad.bucket_for(n, spec_j)
        toks = _token_lists(6)
        assert tpad.group_by_bucket(toks, spec_t) == \
            jpad.group_by_bucket(toks, spec_j)
        for a, b in zip(tpad.pack_batch(toks, spec_t, batch_pad_to=20),
                        jpad.pack_batch(toks, spec_j, batch_pad_to=20)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tpad.pad_to_bucket(toks[0], 64),
                        jpad.pad_to_bucket(toks[0], 64)):
            np.testing.assert_array_equal(a, b)
        assert tpad.DEFAULT_BUCKETS == jpad.DEFAULT_BUCKETS
        assert tpad.DEFAULT_MAX_SEGMENTS_PER_ROW == \
            jpad.DEFAULT_MAX_SEGMENTS_PER_ROW

    @pytest.mark.parametrize("bucket, max_segments", [(16, 8), (64, 3),
                                                      (32, 1)])
    def test_pack_rows_equal(self, bucket, max_segments):
        toks = _token_lists(7) + [[5] * 3] * 6 + [[9] * 80]
        idx = [100 + i for i in range(len(toks))]
        a = tpad.pack_rows(toks, bucket, max_segments=max_segments,
                           indices=idx)
        b = jpad.pack_rows(toks, bucket, max_segments=max_segments,
                           indices=idx)
        assert a.assignments == b.assignments
        assert a.bucket == b.bucket and a.n_rows == b.n_rows
        for f in ("ids", "mask", "segment_ids", "positions"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))

    def test_flops_formula_equal(self):
        from distributed_crawler_tpu.models.encoder import E5_SMALL
        from distributed_crawler_tpu_torch.models.encoder import (
            E5_SMALL as T_E5_SMALL,
        )

        for b, s in ((256, 32), (256, 512), (1, 1)):
            assert encoder_forward_flops(T_E5_SMALL, b, s) == \
                jax_flops(E5_SMALL, b, s)


class TestConfig:
    def test_engine_config_fields_equal(self):
        import dataclasses

        assert ([(f.name, f.default) for f in
                 dataclasses.fields(teng.EngineConfig)] ==
                [(f.name, f.default) for f in
                 dataclasses.fields(jeng.EngineConfig)])
        assert sorted(teng.MODEL_REGISTRY) == sorted(jeng.MODEL_REGISTRY)

    @pytest.mark.parametrize("field, value", [
        ("pretrained_dir", "/nonexistent"), ("checkpoint_dir", "/x"),
        ("param_dtype", "no_such_dtype"), ("quantize", "int4"),
        ("moe_dispatch", "sparse")])
    def test_waiting_fields_raise(self, field, value):
        """A field set wrong raises the exception type the reference's
        engine raises for the same config (``checkpoint_dir`` at a path
        holding no checkpoint: ``FileNotFoundError``)."""
        cfg = {**CFG, field: value}
        with pytest.raises(Exception) as ref:
            jeng.InferenceEngine(jeng.EngineConfig(**cfg),
                                 registry=JaxRegistry())
        expected = type(ref.value)
        assert expected is not NotImplementedError
        with pytest.raises(Exception) as got:
            teng.InferenceEngine(teng.EngineConfig(**cfg),
                                 registry=MetricsRegistry(), device="cpu")
        assert type(got.value) is expected

    @pytest.mark.parametrize("pretrained", [False, True])
    def test_capacity_with_quantize_raises_before_any_load(
            self, monkeypatch, pretrained):
        """The reference refuses ``capacity`` with ``quantize`` from the
        config alone; so does the port, before reading a checkpoint or
        drawing a weight."""
        cfg = {**CFG, "moe_dispatch": "capacity", "quantize": "int8"}
        if pretrained:
            cfg["pretrained_dir"] = "/nonexistent"
        with pytest.raises(ValueError, match="capacity"):
            jeng.InferenceEngine(jeng.EngineConfig(**cfg),
                                 registry=JaxRegistry())

        def no_weights(*a, **k):
            raise AssertionError("weights were loaded")

        monkeypatch.setattr(teng, "random_tree", no_weights)
        monkeypatch.setattr(teng, "_load_pretrained", no_weights)
        with pytest.raises(ValueError, match="capacity"):
            teng.InferenceEngine(teng.EngineConfig(**cfg),
                                 registry=MetricsRegistry(), device="cpu")

    def test_mesh_raises(self):
        with pytest.raises(NotImplementedError):
            teng.InferenceEngine(teng.EngineConfig(**CFG), mesh=object(),
                                 registry=MetricsRegistry(), device="cpu")

    def test_unknown_attention_and_model_raise(self):
        with pytest.raises(ValueError):
            teng.InferenceEngine(teng.EngineConfig(**CFG, attention="fast"),
                                 registry=MetricsRegistry(), device="cpu")
        with pytest.raises(ValueError):
            teng.EngineConfig(model="nope").encoder_config()

    def test_seeded_init_is_deterministic(self):
        a = teng.InferenceEngine(teng.EngineConfig(**CFG, seed=3),
                                 registry=MetricsRegistry(), device="cpu")
        b = teng.InferenceEngine(teng.EngineConfig(**CFG, seed=3),
                                 registry=MetricsRegistry(), device="cpu")
        c = teng.InferenceEngine(teng.EngineConfig(**CFG, seed=4),
                                 registry=MetricsRegistry(), device="cpu")
        sa, sb, sc = (e.model.state_dict() for e in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not torch.equal(sa["encoder.embed_tokens"],
                               sc["encoder.embed_tokens"])
        w = sa["encoder.layers.0.attn.qkv.weight"]
        std = (1.0 / 64) ** 0.5 / 0.87962566103423978
        assert w.abs().max() <= 2 * std + 1e-6
        assert abs(float(w.std()) - (1.0 / 64) ** 0.5) < 0.02
        assert not sa["encoder.layers.0.attn.qkv.bias"].any()
        assert torch.equal(sa["encoder.ln_embed.weight"],
                           torch.ones(64))


# -- pretrained checkpoints, param_dtype, int8 -------------------------------
# Tolerances as `tests/test_torch_quant.py` states them for the int8 model:
# embeddings within 1e-2 absolute, labels equal wherever the top score
# leads by more than 2e-2.  The same bound holds the bf16 checkpoints
# (XLA and PyTorch round bf16 products at other places).
MODE_EMB_ATOL = 1e-2
MODE_LABEL_MARGIN = 2e-2
MODE_CFG = dict(batch_size=4, buckets=(16, 32, 64))


def _assert_mode_results_match(a, b):
    assert len(a) == len(b)
    np.testing.assert_allclose([r["embedding"] for r in a],
                               [r["embedding"] for r in b],
                               atol=MODE_EMB_ATOL, rtol=0)
    scores = np.asarray([r["scores"] for r in b])
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MODE_LABEL_MARGIN
    assert clear.any()
    assert ([r["label"] for r, c in zip(a, clear) if c]
            == [r["label"] for r, c in zip(b, clear) if c])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    import tests.test_hf_convert as hf_tests
    from tests.test_hf_convert import make_roberta_state, write_checkpoint
    from tests.test_torch_hf_convert import write_bf16_checkpoint

    # The states draw from test_hf_convert's module RNG (seed 42, `:33`):
    # start it where a fresh process has it, so the checkpoints do not
    # depend on which test files ran before in this process.
    saved = hf_tests.RNG.bit_generator.state
    hf_tests.RNG.bit_generator.state = \
        np.random.default_rng(42).bit_generator.state
    try:
        return {
            "head": write_checkpoint(tmp_path_factory.mktemp("head"),
                                     make_roberta_state(True, "roberta.")),
            "encoder_only": write_checkpoint(
                tmp_path_factory.mktemp("enc"), make_roberta_state(False),
                fmt="bin"),
            # Every tensor stored as BF16, as many published checkpoints
            # ship.
            "bf16": write_bf16_checkpoint(
                tmp_path_factory.mktemp("bf16"),
                make_roberta_state(True, "roberta.")),
        }
    finally:
        hf_tests.RNG.bit_generator.state = saved


def _ref_probe(jcfg, je):
    """The reference engine's calibration ids, as numpy."""
    return np.asarray(jax.random.randint(
        jax.random.PRNGKey(jcfg.seed + 1),
        (min(jcfg.batch_size, 64), je.bucket_spec.lengths[-1]), 0,
        je.ecfg.vocab_size))


@pytest.mark.parametrize("name, extra", [
    ("pretrained", dict(pretrained_dir="head")),
    ("pretrained_encoder_only", dict(pretrained_dir="encoder_only")),
    ("pretrained_bf16_checkpoint", dict(pretrained_dir="bf16")),
    ("pretrained_int8", dict(pretrained_dir="head", quantize="int8")),
    ("pretrained_bf16_int8_static",
     dict(pretrained_dir="encoder_only", param_dtype="bfloat16",
          quantize="int8_static")),
    ("param_dtype", dict(model="tiny", param_dtype="bfloat16")),
    ("int8", dict(model="tiny", quantize="int8")),
    ("int8_static", dict(model="tiny", quantize="int8_static")),
])
def test_serving_modes_match(checkpoints, monkeypatch, caplog, name, extra):
    """Port engine against reference engine on the same weights and texts.
    Random weights: the port is given the reference's f32 tree.  The two
    draws that follow JAX's PRNG (an encoder-only checkpoint's head, the
    int8_static probe) are fed from the reference."""
    cfg = {**MODE_CFG, **extra}
    if "pretrained_dir" in cfg:
        cfg["pretrained_dir"] = checkpoints[cfg["pretrained_dir"]]
    jcfg = jeng.EngineConfig(**cfg)
    je = jeng.InferenceEngine(jcfg, registry=JaxRegistry())
    params = None
    if "pretrained_dir" not in cfg:
        float_cfg = {k: v for k, v in cfg.items()
                     if k not in ("quantize", "param_dtype")}
        params = jax.tree.map(np.asarray, jeng.InferenceEngine(
            jeng.EngineConfig(**float_cfg), registry=JaxRegistry()).params)
    else:
        ref_float = jeng.InferenceEngine(
            jeng.EngineConfig(**{**cfg, "quantize": None,
                                 "param_dtype": None}),
            registry=JaxRegistry())
        head = jax.tree.map(np.asarray,
                            ref_float.params["params"]["cls_head"])
        monkeypatch.setattr(teng, "init_head", lambda ecfg, seed: head)
    monkeypatch.setattr(teng, "calibration_probe",
                        lambda *a, **k: _ref_probe(jcfg, je))
    with caplog.at_level("WARNING", logger=teng.__name__):
        te = teng.InferenceEngine(teng.EngineConfig(**cfg), params=params,
                                  registry=MetricsRegistry(), device="cpu")
    if "pretrained_dir" in cfg:
        assert isinstance(te.tokenizer, ttok.HashingTokenizer)
        assert "falling back to HashingTokenizer" in caplog.text
    import dataclasses

    assert dataclasses.asdict(te.ecfg) == dataclasses.asdict(je.ecfg)
    if cfg.get("quantize") == "int8_static":
        # Calibrated in f32 (tiny): 1e-5 relative.  In bf16 (the HF
        # checkpoints' activations) an abs-max may land one bf16 ulp away,
        # 2^-7 relative at most.
        rtol = 1e-5 if te.ecfg.dtype == "float32" else 2.0 ** -7
        for layer in ("layers_0", "layers_1"):
            ta = te.model.encoder.layers[int(layer[-1])].mlp.mlp_down.a_scale
            ja = je.params["params"]["encoder"][layer]["mlp"]["mlp_down"][
                "a_scale"]
            np.testing.assert_allclose(float(ta), float(ja), rtol=rtol)
    texts = _texts(8, n=11)
    for pack in (False, True):
        _assert_mode_results_match(te.run(texts, pack=pack),
                                   je.run(texts, pack=pack))


@pytest.mark.parametrize("extra", [
    dict(moe_dispatch="dense"),
    dict(moe_dispatch="capacity"),
    dict(moe_dispatch="capacity", param_dtype="bfloat16"),
    dict(moe_dispatch="dense", quantize="int8"),
    dict(quantize="int8_static", param_dtype="bfloat16"),
], ids=lambda d: "-".join(f"{v}" for v in d.values()))
def test_moe_serving_matches(monkeypatch, extra):
    """A Switch-MoE config (TINY_TEST widths, 4 experts) added to both
    packages' registries, as a deployment adds one: the port's engine on
    the reference's f32 tree against the reference's engine.  Under
    ``param_dtype`` the router's f32 weights are rounded as the
    reference's cast rounds them."""
    import dataclasses

    from distributed_crawler_tpu.models import encoder as jenc
    from distributed_crawler_tpu_torch.models import encoder as tenc

    monkeypatch.setitem(jeng.MODEL_REGISTRY, "tiny_moe", dataclasses.replace(
        jenc.TINY_TEST, n_experts=4))
    monkeypatch.setitem(teng.MODEL_REGISTRY, "tiny_moe", dataclasses.replace(
        tenc.TINY_TEST, n_experts=4))
    cfg = {**MODE_CFG, "model": "tiny_moe", "n_labels": 5, **extra}
    jcfg = jeng.EngineConfig(**cfg)
    je = jeng.InferenceEngine(jcfg, registry=JaxRegistry())
    float_cfg = {k: v for k, v in cfg.items()
                 if k not in ("quantize", "param_dtype")}
    params = jax.tree.map(np.asarray, jeng.InferenceEngine(
        jeng.EngineConfig(**float_cfg), registry=JaxRegistry()).params)
    monkeypatch.setattr(teng, "calibration_probe",
                        lambda *a, **k: _ref_probe(jcfg, je))
    te = teng.InferenceEngine(teng.EngineConfig(**cfg), params=params,
                              registry=MetricsRegistry(), device="cpu")
    assert dataclasses.asdict(te.ecfg) == dataclasses.asdict(je.ecfg)
    assert te.ecfg.moe_dispatch == cfg.get("moe_dispatch", "dense")
    router = te.model.encoder.layers[0].moe.router.weight
    assert router.dtype == torch.float32
    if "param_dtype" in cfg:
        assert torch.equal(router, router.to(torch.bfloat16).float())
        jr = je.params["params"]["encoder"]["layers_0"]["moe"]["router"][
            "kernel"]
        np.testing.assert_array_equal(
            router.detach().numpy().T, np.asarray(jr.astype(np.float32)))
    texts = _texts(9, n=11)
    for pack in (False, True):
        _assert_mode_results_match(te.run(texts, pack=pack),
                                   je.run(texts, pack=pack))


def test_param_dtype_keeps_embeddings_narrow():
    te = teng.InferenceEngine(teng.EngineConfig(**CFG, param_dtype="bfloat16"),
                              registry=MetricsRegistry(), device="cpu")
    enc = te.model.encoder
    assert enc.embed_tokens.dtype == torch.bfloat16
    ln = enc.ln_embed.weight
    assert ln.dtype == torch.float32
    assert torch.equal(ln, ln.to(torch.bfloat16).float())


def test_int8_engine_quantizes_the_f32_source():
    """A seeded random int8 engine quantizes the f32 tree `random_tree`
    draws, not weights rounded to the activation dtype first."""
    cfg = dict(CFG, model="xlmr_base")
    ecfg = teng.EngineConfig(**cfg).encoder_config()
    small = dict(vocab_size=64, hidden=32, n_layers=1, n_heads=2,
                 mlp_dim=64, max_len=64)
    import dataclasses

    ecfg = dataclasses.replace(ecfg, **small)
    tree = teng.random_tree(ecfg, 0)
    from distributed_crawler_tpu_torch.models.quant import (
        quantize_encoder_params,
    )

    q = quantize_encoder_params(tree)
    model = teng.EmbedderClassifier(dataclasses.replace(ecfg, quant="int8"))
    teng.load_flax_params(model, q)
    want = q["params"]["encoder"]["layers_0"]["mlp"]["mlp_up"]["kernel_q"]
    assert torch.equal(model.encoder.layers[0].mlp.mlp_up.kernel_q,
                       torch.from_numpy(want.T.copy()))

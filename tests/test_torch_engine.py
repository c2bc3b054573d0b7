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
        ("param_dtype", "bfloat16"), ("quantize", "int8"),
        ("moe_dispatch", "capacity")])
    def test_waiting_fields_raise(self, field, value):
        cfg = teng.EngineConfig(**{**CFG, field: value})
        with pytest.raises(NotImplementedError):
            teng.InferenceEngine(cfg, registry=MetricsRegistry(),
                                 device="cpu")

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

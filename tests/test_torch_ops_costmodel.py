"""The port's cost accounting against the JAX package's, on the CPU.

- `EfficiencyMeter`: the same records (seeded durations, FLOPs, token
  splits, tenant weights) on an injected peak and a fake monotonic clock
  give equal snapshots, tenant ledgers and gauges.
- `CostModel`: a dense config's row equals the reference's analytic
  fallback exactly (its capture with a lowering that fails).
- `moe_forward_flops` on a small MoE config served by both engines (4
  experts, dense and capacity dispatch) agrees with two independent counts:
  the reference engine's XLA `cost_analysis()` row, which also counts the
  elementwise ops and, for capacity dispatch, the one-hot pack and unpack
  products the port replaces with a scatter and a gather; and the products
  the port's own forward runs, counted by `torch.utils.flop_counter`.  At
  XLM-R-base with 8 experts it still gives the counts the smoke run's
  TFLOP/s divide (a pin of its move out of `chip_smoke.py`), and the
  engine prices a MoE config with it.
- `peak_flops` resolves the three H100 names and nothing else.
- Each engine's `cost_snapshot()` has the reference engine's keys, and on
  the same inputs its meter counts the same real and slot tokens.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_crawler_tpu_torch.cluster.engine import (  # noqa: E402
    ClusterEngine,
    ClusterEngineConfig,
)
from distributed_crawler_tpu_torch.inference import asr as tasr  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.models import encoder as tenc  # noqa: E402
from distributed_crawler_tpu_torch.models import whisper as tw  # noqa: E402
from distributed_crawler_tpu_torch.utils import costmodel as tcost  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)

jax = pytest.importorskip("jax")

from distributed_crawler_tpu.cluster import engine as jceng  # noqa: E402
from distributed_crawler_tpu.inference import asr as jasr  # noqa: E402
from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.models import whisper as jw  # noqa: E402
from distributed_crawler_tpu.utils import costmodel as jcost  # noqa: E402
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)

# The MoE FLOP counts at XLM-R-base's widths and full 12-layer depth (8
# experts, capacity factor 1.25, batch 256), which PERF.md's full-depth
# TFLOP/s figures divide.
MOE_FLOPS = {
    (32, "dense"): 7896431591424, (32, "capacity"): 1634369273856,
    (64, "dense"): 15812190535680, (64, "capacity"): 3288065900544,
    (128, "dense"): 31701690482688, (128, "capacity"): 6653441212416,
    (256, "dense"): 63712618610688, (256, "capacity"): 13616120070144,
    (512, "dense"): 128662187802624, (512, "capacity"): 28469190721536,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both packages' meters."""
    now = [1000.0]
    import time as _time

    fake = types.SimpleNamespace(monotonic=lambda: now[0], time=_time.time)
    monkeypatch.setattr(jcost, "time", fake)
    monkeypatch.setattr(tcost, "time", fake)
    return now


@pytest.mark.parametrize("path,peak", [("", 1e12), ("cluster", 5e11),
                                        ("", 0.0)])
def test_efficiency_meter_snapshots_equal(clock, path, peak):
    rng = np.random.default_rng(3)
    regs = [JaxRegistry(), MetricsRegistry()]
    meters = [mod.EfficiencyMeter(registry=reg, window_s=5.0, peak=peak,
                                  peak_source="injected", path=path)
              for mod, reg in ((jcost, regs[0]), (tcost, regs[1]))]
    assert meters[1].snapshot() == meters[0].snapshot() == {}
    for i in range(40):
        clock[0] += float(rng.exponential(0.4))
        if i % 7 == 0:
            weights = {t: float(rng.integers(1, 50))
                       for t in ("a", "b", "c")[:int(rng.integers(1, 4))]}
            for m in meters:
                m.set_tenants(weights)
        rec = (float(rng.exponential(0.05)), float(rng.uniform(1e9, 1e11)),
               int(rng.integers(1, 4096)), 4096)
        for m in meters:
            m.record(*rec)
        assert meters[1].snapshot() == meters[0].snapshot()
        if i % 5 == 0:
            for m in meters:
                m.tenants.observe_queue_wait("a", rec[0])
    clock[0] += 60.0  # idle past the window: MFU decays to 0
    assert meters[1].snapshot() == meters[0].snapshot()
    assert meters[1].tenants.snapshot() == meters[0].tenants.snapshot()
    assert regs[1].expose() == regs[0].expose()


def test_meter_reset_forgets_warmup(clock):
    m = tcost.EfficiencyMeter(registry=MetricsRegistry(), peak=1e12)
    m.record(0.1, 1e9, 10, 20)
    m.reset()
    assert m.snapshot() == {}


@pytest.mark.parametrize("model", ["tiny", "e5_small", "e5_large",
                                   "xlmr_base"])
@pytest.mark.parametrize("bucket", [32, 512])
def test_dense_cost_rows_equal_the_reference_fallback(model, bucket):
    def fails():
        raise RuntimeError("no lowering here")

    ref = jcost.CostModel(registry=JaxRegistry()).capture(
        bucket, "packed", fails,
        jcost.encoder_forward_flops(jeng.MODEL_REGISTRY[model], 256, bucket),
        batch=256, seq=bucket)
    ecfg = teng.MODEL_REGISTRY[model]
    port = tcost.CostModel(registry=MetricsRegistry()).capture(
        bucket, "packed", tcost.forward_flops(ecfg, 256, bucket),
        batch=256, seq=bucket)
    ref.pop("captured_at")
    port.pop("captured_at")
    assert port == ref
    assert port["source"] == "analytic" and port["bytes_accessed"] is None


def test_cost_model_first_capture_wins_and_gauges():
    reg = MetricsRegistry()
    cm = tcost.CostModel(registry=reg)
    cm.capture(64, "asr", 5.0, batch=2, seq=3)
    cm.capture(64, "asr", 9.0)
    assert cm.flops_for(64, "asr") == 5.0 and cm.has(64, "asr")
    assert cm.flops_for(32, "asr", default=1.5) == 1.5
    assert 'tpu_engine_bucket_flops{bucket="64",path="asr"} 5.0' in \
        reg.expose()


def _moe8(dispatch="dense"):
    return dataclasses.replace(tenc.XLMR_BASE, n_experts=8,
                               moe_capacity_factor=1.25,
                               moe_dispatch=dispatch)


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_forward_flops_against_xla_and_the_ports_own_products(
        monkeypatch, dispatch):
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_crawler_tpu.models import encoder as jenc

    widths = dict(hidden=128, mlp_dim=512, n_layers=2, n_experts=4,
                  moe_capacity_factor=1.25)
    monkeypatch.setitem(jeng.MODEL_REGISTRY, "tiny_moe",
                        dataclasses.replace(jenc.TINY_TEST, **widths))
    monkeypatch.setitem(teng.MODEL_REGISTRY, "tiny_moe",
                        dataclasses.replace(tenc.TINY_TEST, **widths))
    cfg = dict(model="tiny_moe", n_labels=3, batch_size=4, buckets=(64,),
               moe_dispatch=dispatch)
    toks = _tokens(4, 4, 60)
    ref = jeng.InferenceEngine(jeng.EngineConfig(**cfg),
                               registry=JaxRegistry())
    ref.run_tokenized(toks, pack=False)
    (row,) = ref.costs.snapshot()
    assert row["source"] == "xla"
    port = teng.InferenceEngine(
        teng.EngineConfig(**cfg), params=jax.tree.map(np.asarray, ref.params),
        registry=MetricsRegistry(), device="cpu")
    with FlopCounterMode(display=False) as counter:
        port.run_tokenized(toks, pack=False)
    (port_row,) = port.costs.snapshot()
    flops = tcost.moe_forward_flops(port.ecfg, 4, 64, dispatch)
    assert port_row["flops"] == flops
    # The products the port runs: within the classifier head's share.
    assert flops == pytest.approx(counter.get_total_flops(), rel=5e-3)
    # XLA's count adds the elementwise ops (a few percent at these
    # widths) and the reference's one-hot pack and unpack products,
    # 2·g·E·cap·h each per group and layer.
    e, h, n = 4, 128, 4 * 64
    cap = int(np.ceil(n / e * 1.25))
    one_hot = (2 * 2 * n * e * cap * h * 2) if dispatch == "capacity" else 0
    assert 0.97 * row["flops"] <= flops + one_hot <= row["flops"]


@pytest.mark.parametrize("bucket,dispatch", sorted(MOE_FLOPS))
def test_moe_forward_flops_matches_the_smoke_counts(bucket, dispatch):
    got = tcost.moe_forward_flops(_moe8(), 256, bucket, dispatch)
    assert got == MOE_FLOPS[(bucket, dispatch)]
    assert tcost.forward_flops(_moe8(dispatch), 256, bucket) == got
    # The reference's analytic fallback leaves the experts out.
    dense = jcost.encoder_forward_flops(_moe8(), 256, bucket)
    assert dispatch != "dense" or got > 5 * dense


def test_engine_prices_moe_with_its_experts(monkeypatch):
    cfg = dataclasses.replace(tenc.TINY_TEST, n_experts=4)
    monkeypatch.setitem(teng.MODEL_REGISTRY, "tiny_moe", cfg)
    eng = teng.InferenceEngine(
        teng.EngineConfig(model="tiny_moe", n_labels=3, batch_size=4,
                          buckets=(16,), moe_dispatch="capacity"),
        registry=MetricsRegistry(), device="cpu")
    eng.run_tokenized([[5, 6, 7]], pack=False)
    (row,) = eng.costs.snapshot()
    assert row["flops"] == tcost.moe_forward_flops(eng.ecfg, 4, 16,
                                                   "capacity")


@pytest.mark.parametrize("name,peak,source", [
    ("NVIDIA H100 80GB HBM3", 989e12, "cuda:h100-sxm"),
    ("NVIDIA H100 SXM5 80GB", 989e12, "cuda:h100-sxm"),
    ("NVIDIA H100 NVL", 835e12, "cuda:h100-nvl"),
    ("NVIDIA H100 PCIe", 756e12, "cuda:h100-pcie"),
    ("NVIDIA A100-SXM4-80GB", 0.0, "unknown"),
    ("", 0.0, "unknown")])
def test_peak_flops_by_card_name(name, peak, source):
    assert tcost.peak_flops(name, "cuda") == (peak, source)
    assert tcost.peak_flops(name, "cuda", n_devices=4) == (4 * peak, source)


def test_peak_flops_other_platforms():
    assert tcost.peak_flops("", "cpu") == jcost.peak_flops("", "cpu")
    assert tcost.peak_flops("v5e", "tpu") == (0.0, "unknown")
    assert tcost.default_peak_flops(device="cpu") == \
        (tcost.CPU_PEAK_FLOPS_ESTIMATE, "cpu_estimate")
    if not torch.cuda.is_initialized():  # never creates a context
        assert tcost.default_peak_flops() == (0.0, "unknown")


# -- the engines -------------------------------------------------------------
def _tokens(seed, n, hi):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(5, 90, size=int(rng.integers(1, hi))))
            for _ in range(n)]


@pytest.mark.parametrize("pack", [False, True])
def test_text_engine_costs_match_the_reference(pack):
    cfg = dict(model="tiny", n_labels=3, batch_size=4, buckets=(16, 32, 64))
    je = jeng.InferenceEngine(jeng.EngineConfig(**cfg),
                              registry=JaxRegistry())
    params = jax.tree.map(np.asarray, je.params)
    te = teng.InferenceEngine(teng.EngineConfig(**cfg), params=params,
                              registry=MetricsRegistry(), device="cpu")
    toks = _tokens(1, 11, 60)
    for e in (je, te):
        e.run_tokenized(toks, pack=pack)
    rs, ps = je.cost_snapshot(), te.cost_snapshot()
    assert sorted(ps) == sorted(rs)
    for key in ("batches", "real_tokens", "slot_tokens", "padding_density"):
        assert ps["efficiency"][key] == rs["efficiency"][key], key
    assert [(r["bucket"], r["path"], r["batch"], r["seq"])
            for r in ps["costs"]] == [(r["bucket"], r["path"], r["batch"],
                                       r["seq"]) for r in rs["costs"]]
    for r in ps["costs"]:
        assert r["flops"] == jcost.encoder_forward_flops(
            je.ecfg, 4, r["bucket"])
    assert ps["efficiency"]["peak_source"] == "cpu_estimate"
    assert 0 < ps["efficiency"]["mfu"] <= ps["efficiency"]["mfu_busy"]
    assert sorted(te.efficiency_snapshot()) == \
        sorted(je.efficiency_snapshot())
    assert sorted(te.occupancy_snapshot()) == sorted(je.occupancy_snapshot())


def test_asr_pipeline_costs_match_the_reference():
    cfg = jw.WHISPER_TEST
    params = jax.tree.map(np.asarray, jw.Whisper(cfg).init(
        jax.random.PRNGKey(0),
        np.zeros((1, cfg.n_audio_ctx * 2, cfg.n_mels), np.float32),
        np.zeros((1, 4), np.int32)))
    ref = jasr.ASRPipeline(jw.Whisper(cfg), params, batch_size=2, max_len=4,
                           registry=JaxRegistry())
    port = tasr.ASRPipeline(tw.Whisper(tw.WHISPER_TEST), params,
                            batch_size=2, max_len=4,
                            registry=MetricsRegistry(), device="cpu")
    audio = np.random.default_rng(0).normal(
        size=(2, port.window_samples)).astype(np.float32) * 0.1
    for p in (ref, port):
        p.transcribe_audio(audio, real_windows=1)
    rs, ps = ref.cost_snapshot(), port.cost_snapshot()
    assert sorted(ps) == sorted(rs)
    for key in ("batches", "real_tokens", "slot_tokens", "padding_density"):
        assert ps["efficiency"][key] == rs["efficiency"][key], key
    (row,) = ps["costs"]
    assert (row["bucket"], row["path"], row["seq"]) == (2, "asr",
                                                        cfg.n_audio_ctx)
    assert row["flops"] == jcost.whisper_forward_flops(cfg, 2, 4)
    assert sorted(port.efficiency_snapshot()) == \
        sorted(ref.efficiency_snapshot())


def test_cluster_engine_costs_match_the_reference():
    x = np.random.default_rng(2).normal(size=(40, 16)).astype(np.float32)
    kw = dict(k=4, buckets=(8, 32))
    ref = jceng.ClusterEngine(jceng.ClusterEngineConfig(**kw),
                              registry=JaxRegistry())
    port = ClusterEngine(ClusterEngineConfig(**kw),
                         registry=MetricsRegistry(), device="cpu")
    for e in (ref, port):
        e.observe(x[:30])
        e.observe(x[30:36])
    rs, ps = ref.cost_snapshot(), port.cost_snapshot()
    assert sorted(ps) == sorted(rs)
    for key in ("batches", "real_tokens", "slot_tokens", "padding_density"):
        assert ps["efficiency"][key] == rs["efficiency"][key], key
    assert [(r["bucket"], r["flops"]) for r in ps["costs"]] == [
        (b, jcost.kmeans_step_flops(4, 16, b)) for b in (8, 32)]
    assert sorted(port.efficiency_snapshot()) == \
        sorted(ref.efficiency_snapshot())


def test_asr_meter_charges_the_decode_steps_that_ran(monkeypatch):
    """A decode that stops early at EOT: the cost row keeps the full
    ``max_len`` price (the reference's row), the meter is charged only
    the steps that ran."""
    cfg = tw.WHISPER_TEST
    torch.manual_seed(0)
    port = tasr.ASRPipeline(tw.Whisper(cfg), batch_size=2,
                            max_len=cfg.n_text_ctx,
                            registry=MetricsRegistry(), device="cpu")
    step = port.model.decode_step

    def eot_step(token, pos, cache, cross_kvs):
        logits, cache = step(token, pos, cache, cross_kvs)
        logits = logits.clone()
        logits[..., cfg.eot_token] = 1e9
        return logits, cache

    charged = []
    record = port.meter.record
    monkeypatch.setattr(port.meter, "record",
                        lambda dt, flops, *a: (charged.append(flops),
                                               record(dt, flops, *a)))
    audio = np.zeros((2, port.window_samples), np.float32)
    port.transcribe_audio(audio)                  # full length, no EOT stop
    monkeypatch.setattr(tw, "_FINISHED_CHECK_STEPS", 4)
    monkeypatch.setattr(port.model, "decode_step", eot_step)
    tokens = port.transcribe_audio(audio)
    # Prompt at steps 1-2, EOT from step 3, the stop seen at step 4.
    assert (tokens[:, 3:] == cfg.eot_token).all()
    (row,) = port.costs.snapshot()
    assert row["flops"] == tcost.whisper_forward_flops(cfg, 2, cfg.n_text_ctx)
    assert charged == [row["flops"], tcost.whisper_forward_flops(cfg, 2, 5)]
    assert charged[1] < charged[0]

"""The port's Whisper (`distributed_crawler_tpu_torch/models/whisper.py`) and
its loaders against the JAX package's, on the CPU.

`Whisper(WHISPER_TEST)` is built in JAX from ``PRNGKey(0)``; its params go
to numpy and into the port's model with `load_whisper_params`; the same
seeded numpy waveforms and mels go through both.  f32 throughout.

Tolerances (abs): log-mel 1e-5 (the FFTs of two libraries in f32, then
log10).  For a pure tone, the bins whose power lies within two decades of
the clamp at the example's peak - 8 (power 1e-8 to 1e-6 of the peak) are
set by f32 FFT rounding: there each package is up to 4e-5 from an f64
evaluation of the same formula, and they differ by up to 3.5e-5.  So the
tone is held to 1e-5 above those two decades, and to 5e-5 everywhere, with
both packages within 5e-5 of the f64 evaluation.  Conv stem 1e-5 (two f32
convolutions); encoder output and teacher-forced logits 1e-4 (f32 matmuls,
LayerNorm statistics and softmax sums in another order, through two
layers).  Greedy tokens must be equal;
the one allowed exception is the first step where they part, if there the
reference's own top-2 logit margin is below 1e-4 (a near-tie that f32
rounding may decide either way).  The tests count such steps and report
them; the seed is not chosen to avoid them.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from distributed_crawler_tpu.models import hf_convert as jhf  # noqa: E402
from distributed_crawler_tpu.models import whisper as jw  # noqa: E402
from distributed_crawler_tpu.utils import costmodel as jcost  # noqa: E402
from distributed_crawler_tpu_torch.models import from_jax  # noqa: E402
from distributed_crawler_tpu_torch.models import hf_convert as thf  # noqa: E402
from distributed_crawler_tpu_torch.models import whisper as tw  # noqa: E402
from distributed_crawler_tpu_torch.utils import costmodel as tcost  # noqa: E402
import tests.test_hf_convert as hf_tests  # noqa: E402
from tests.test_hf_convert import WH_CFG, make_whisper_state  # noqa: E402
from tests.test_torch_hf_convert import assert_trees_equal  # noqa: E402

MEL_TOL = 1e-5
MEL_FLOOR_TOL = 5e-5  # a tone's bins near the clamp: f32 FFT rounding
STEM_TOL = 1e-5
MODEL_TOL = 1e-4
NEAR_TIE = 1e-4

CFG = tw.WHISPER_TEST
PRESETS = ("WHISPER_TINY", "WHISPER_BASE", "WHISPER_SMALL", "WHISPER_TEST")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: small ops, beside timing-sensitive tests in
    other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """(reference model, its params, the params as a numpy tree)."""
    model = jw.Whisper(jw.WHISPER_TEST)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, CFG.n_audio_ctx * 2, CFG.n_mels)),
                        jnp.zeros((1, 4), jnp.int32))
    return model, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port(ref):
    model = tw.Whisper(CFG)
    from_jax.load_whisper_params(model, ref[2])
    return model.eval()


def _waves(batch, seed, n=None):
    rng = np.random.default_rng(seed)
    n = n or tw.audio_window_samples(CFG)
    return (rng.standard_normal((batch, n)) * 0.1).astype(np.float32)


def _mels(batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- configs and the frontend ------------------------------------------------
@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal(name):
    assert dataclasses.asdict(getattr(tw, name)) == \
        dataclasses.asdict(getattr(jw, name))


def test_constants_equal():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_SECONDS",
                 "N_SAMPLES", "N_FRAMES"):
        assert getattr(tw, name) == getattr(jw, name), name
    assert tw.audio_window_samples(CFG) == jw.audio_window_samples(CFG)


@pytest.mark.parametrize("n_mels", [8, 80])
def test_mel_filterbank_equal(n_mels):
    a, b = tw._mel_filterbank(n_mels), jw._mel_filterbank(n_mels)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("length,channels", [(16, 32), (1500, 768)])
def test_sinusoids_equal(length, channels):
    np.testing.assert_array_equal(tw._sinusoids(length, channels),
                                  jw._sinusoids(length, channels))


@pytest.mark.parametrize("n", [100, 5120, 6000])
def test_pad_or_trim(n):
    x = _waves(2, 0, n)
    want = np.asarray(jw.pad_or_trim(jnp.asarray(x), 5120))
    got = tw.pad_or_trim(_t(x), 5120).numpy()
    assert got.shape == (2, 5120)
    np.testing.assert_array_equal(got, want)


def _tone(n, freq=440.0):
    t = np.arange(n) / tw.SAMPLE_RATE
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None]


def _log_mel_f64(x, n_mels):
    """The reference's log-mel formula in f64 numpy."""
    x = x.astype(np.float64)
    t, pad = x.shape[-1], tw.N_FFT // 2
    xp = np.pad(x, [(0, 0), (pad, pad)], mode="reflect")
    idx = (np.arange(t // tw.HOP_LENGTH) * tw.HOP_LENGTH)[:, None] \
        + np.arange(tw.N_FFT)[None]
    frames = xp[..., idx] * np.hanning(tw.N_FFT + 1)[:-1]
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = power @ jw._mel_filterbank(n_mels).astype(np.float64).T
    log = np.log10(np.maximum(mel, 1e-10))
    log = np.maximum(log, log.max(axis=(-2, -1), keepdims=True) - 8.0)
    return (log + 4.0) / 4.0


@pytest.mark.parametrize("signal", ["noise", "tone"])
@pytest.mark.parametrize("n,n_mels", [(5120, 8), (5150, 8), (4001, 80)])
def test_log_mel_matches(signal, n, n_mels):
    x = _waves(2, 1, n) if signal == "noise" else _tone(n)
    want = np.asarray(jw.log_mel_spectrogram(jnp.asarray(x), n_mels=n_mels))
    got = tw.log_mel_spectrogram(_t(x), n_mels=n_mels).numpy()
    assert got.shape == want.shape == (x.shape[0], n // tw.HOP_LENGTH,
                                       n_mels)
    assert got.dtype == np.float32
    if signal == "noise":
        np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)
        return
    # Above the two decades of power next to the clamp: 1e-5.
    floor = want.max(axis=(-2, -1), keepdims=True) - 2.0
    clear = want > floor + 0.5
    assert clear.any()
    np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                               atol=MEL_TOL)
    exact = _log_mel_f64(x, n_mels)
    for name, a in (("port", got), ("reference", want), ("diff", want)):
        b = exact if name != "diff" else got
        assert np.abs(a - b).max() <= MEL_FLOOR_TOL, name


# -- the model ----------------------------------------------------------------
def test_conv_stem_matches(ref, port):
    model, params, _ = ref
    mel = _mels(2, 2)
    _, state = model.apply(params, jnp.asarray(mel), method=jw.Whisper.encode,
                           capture_intermediates=True,
                           mutable=["intermediates"])
    inter = state["intermediates"]["encoder"]
    want1 = np.asarray(inter["conv1"]["__call__"][0])
    want2 = np.asarray(inter["conv2"]["__call__"][0])
    with torch.no_grad():
        x1 = port.encoder.conv1(_t(mel).transpose(1, 2))
        x2 = port.encoder.conv2(F.gelu(x1))
    assert x2.shape[-1] == CFG.n_audio_ctx
    np.testing.assert_allclose(x1.transpose(1, 2).numpy(), want1, rtol=0,
                               atol=STEM_TOL)
    np.testing.assert_allclose(x2.transpose(1, 2).numpy(), want2, rtol=0,
                               atol=STEM_TOL)


def test_conv2_padding_is_the_references_not_the_published():
    """flax's ``padding="SAME"`` pads a stride-2, 3-tap conv over an even
    length (0, 1); the published Whisper's ``Conv1d(padding=1)`` pads
    (1, 1).  The port follows the reference; this pins the difference."""
    import flax.linen as nn

    x = np.arange(10, dtype=np.float32)
    conv = nn.Conv(features=1, kernel_size=(3,), strides=(2,))
    ref_out = np.asarray(conv.apply(
        {"params": {"kernel": jnp.ones((3, 1, 1)), "bias": jnp.zeros(1)}},
        jnp.asarray(x)[None, :, None]))[0, :, 0]
    port_conv = tw.Conv1d(1, 1, 3, stride=2)
    with torch.no_grad():
        port_conv.weight.fill_(1.0)
        port_conv.bias.zero_()
        port_out = port_conv(_t(x)[None, None])[0, 0].numpy()
    published = F.conv1d(_t(x)[None, None], torch.ones(1, 1, 3), stride=2,
                         padding=1)[0, 0].numpy()
    np.testing.assert_array_equal(ref_out, [3, 9, 15, 21, 17])
    np.testing.assert_array_equal(port_out, ref_out)
    np.testing.assert_array_equal(published, [1, 6, 12, 18, 24])


def test_encoder_matches(ref, port):
    model, params, _ = ref
    mel = _mels(3, 3)
    want = np.asarray(model.apply(params, jnp.asarray(mel),
                                  method=jw.Whisper.encode))
    with torch.no_grad():
        got = port.encode(_t(mel)).numpy()
    assert got.shape == want.shape == (3, CFG.n_audio_ctx, CFG.n_audio_state)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL)


def _teacher(ref, mel, tokens):
    model, params, _ = ref
    xa = model.apply(params, jnp.asarray(mel), method=jw.Whisper.encode)
    return np.asarray(model.apply(params, jnp.asarray(tokens), xa,
                                  method=jw.Whisper.decode_teacher))


def test_teacher_forcing_logits_match(ref, port):
    mel = _mels(2, 4)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, CFG.n_vocab, size=(2, CFG.n_text_ctx),
                          dtype=np.int32)
    want = _teacher(ref, mel, tokens)
    with torch.no_grad():
        got = port(_t(mel), _t(tokens)).numpy()
    assert got.shape == want.shape == (2, CFG.n_text_ctx, CFG.n_vocab)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL)


def test_kv_cached_step_matches_teacher_forcing(ref, port):
    """Every decode step's logits against teacher forcing on the same
    tokens, position by position: the port's own and the reference's."""
    mel = _mels(2, 5)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, CFG.n_vocab, size=(2, CFG.n_text_ctx),
                          dtype=np.int32)
    want = _teacher(ref, mel, tokens)
    with torch.no_grad():
        xa = port.encode(_t(mel))
        teacher = port.decode_teacher(_t(tokens), xa).numpy()
        cache, cross = port.decode_init(2, xa)
        for pos in range(CFG.n_text_ctx):
            logits, cache = port.decode_step(_t(tokens[:, pos:pos + 1]),
                                             pos, cache, cross)
            np.testing.assert_allclose(logits.numpy(), teacher[:, pos],
                                       rtol=0, atol=MODEL_TOL,
                                       err_msg=f"pos {pos}")
            np.testing.assert_allclose(logits.numpy(), want[:, pos],
                                       rtol=0, atol=MODEL_TOL,
                                       err_msg=f"pos {pos}")
    # The cache holds every position's keys once the steps have run.
    assert all(bool(k.abs().sum(dim=(0, 2, 3)).gt(0).all())
               for k, _ in cache)


def test_attend_fully_masked_row_is_uniform():
    """Whisper's `_attend` fills masked logits with the finite -1e30, so a
    row with no allowed key averages every value, as the reference's."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 2, 2, 4)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((1, 1, 2, 2), bool)
    mask[..., 0, 0] = True
    got = tw._attend(_t(q), _t(k), _t(v), _t(mask)).numpy()
    want = np.asarray(jw._attend(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, 1], v[0].mean(axis=0), atol=1e-6)


def _compare_tokens(got, want, ref_logits):
    """Rows equal, but for a near-tie of the reference at the first step
    where they part.  Returns the number of such near-ties."""
    assert got.shape == want.shape
    near_ties = 0
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if not len(diff):
            continue
        t = int(diff[0])
        top2 = np.sort(ref_logits[row, t - 1])[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < NEAR_TIE, (
            f"row {row} parts at step {t} with margin {margin}: "
            f"{got[row].tolist()} vs {want[row].tolist()}")
        near_ties += 1
    return near_ties


@pytest.mark.parametrize("batch", [1, 3])
def test_greedy_decode_tokens_equal(ref, port, batch):
    model, params, _ = ref
    mel = _mels(batch, 10 + batch)
    want = np.asarray(jw.greedy_decode(model, params, jnp.asarray(mel)))
    got = tw.greedy_decode(port, _t(mel)).numpy()
    assert got.dtype == np.int32 and got.shape == (batch, CFG.n_text_ctx)
    assert (got[:, :3] == [CFG.sot_token, CFG.transcribe_token,
                           CFG.no_timestamps_token]).all()
    near = _compare_tokens(got, want, _teacher(ref, mel, want))
    print(f"greedy_decode batch {batch}: {near} near-ties")


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("max_len", [None, 7])
def test_transcribe_features_tokens_equal(ref, port, batch, max_len):
    model, params, _ = ref
    audio = _waves(batch, 20 + batch, 4800)  # shorter than the window
    want = np.asarray(jw.transcribe_features(model, params,
                                             jnp.asarray(audio),
                                             max_len=max_len))
    got = tw.transcribe_features(port, _t(audio), max_len=max_len).numpy()
    assert got.shape == (batch, max_len or CFG.n_text_ctx)
    mel = np.asarray(jw.log_mel_spectrogram(
        jw.pad_or_trim(jnp.asarray(audio), jw.audio_window_samples(CFG)),
        n_mels=CFG.n_mels))
    near = _compare_tokens(got, want, _teacher(ref, mel, want))
    print(f"transcribe_features batch {batch}: {near} near-ties")


def test_tokens_after_eot_are_eot(port):
    """A model whose logits always pick EOT: every token after the prompt
    is EOT, and the loop's early stop leaves the output as the full-length
    run would."""
    cfg = dataclasses.replace(CFG, n_text_ctx=40)
    model = tw.Whisper(cfg).eval()
    with torch.no_grad():
        model.decoder.embed_tokens.zero_()
        model.decoder.embed_tokens[cfg.eot_token] = 1.0
        model.decoder.ln_post.bias.fill_(1.0)
    out = tw.greedy_decode(model, _t(_mels(2, 7))).numpy()
    assert out.shape == (2, 40)
    assert (out[:, 3:] == cfg.eot_token).all()


# -- weights ------------------------------------------------------------------
def test_from_jax_round_trip(ref):
    tree = ref[2]
    model = from_jax.load_whisper_params(tw.Whisper(CFG), tree)
    assert_trees_equal(from_jax.whisper_flax_tree(model), tree)


def test_load_bf16_keeps_tables_f32(ref):
    """In bf16, Dense and conv weights take the compute dtype; LayerNorms
    and the decoder's tables stay f32."""
    tree = ref[2]
    model = from_jax.load_whisper_params(
        tw.Whisper(dataclasses.replace(CFG, dtype="bfloat16")), tree)
    assert model.encoder.conv1.weight.dtype == torch.bfloat16
    assert model.encoder.layers[0].attn.q.weight.dtype == torch.bfloat16
    assert model.decoder.layers[0].cross_attn.k.bias is None
    assert model.encoder.ln_post.weight.dtype == torch.float32
    assert model.decoder.embed_tokens.dtype == torch.float32
    back = from_jax.whisper_flax_tree(model)["params"]
    np.testing.assert_array_equal(back["decoder"]["embed_tokens"],
                                  tree["params"]["decoder"]["embed_tokens"])
    want = np.asarray(jnp.asarray(
        tree["params"]["encoder"]["conv1"]["kernel"]).astype(jnp.bfloat16)
        .astype(jnp.float32))
    np.testing.assert_array_equal(back["encoder"]["conv1"]["kernel"], want)


def test_load_rejects_mismatched_tree(ref):
    tree = jax.tree.map(np.copy, ref[2])
    enc = tree["params"]["encoder"]
    enc["layers_0"]["attn"]["k"]["bias"] = np.zeros(CFG.n_audio_state,
                                                    np.float32)
    with pytest.raises(ValueError, match="unknown"):
        from_jax.load_whisper_params(tw.Whisper(CFG), tree)
    del enc["layers_0"]["attn"]["k"]["bias"]
    enc["conv1"]["kernel"] = enc["conv1"]["kernel"][:2]
    with pytest.raises(ValueError, match="shape"):
        from_jax.load_whisper_params(tw.Whisper(CFG), tree)


def whisper_state():
    """`make_whisper_state()` without moving the module RNG it draws from:
    other files' checkpoints come from that RNG, so their values must not
    depend on whether these tests ran first in the process."""
    saved = hf_tests.RNG.bit_generator.state
    try:
        return make_whisper_state()
    finally:
        hf_tests.RNG.bit_generator.state = saved


def _write_whisper_checkpoint(path, state, hf_cfg=WH_CFG):
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    save_file(state, os.path.join(path, "model.safetensors"))
    return str(path)


def test_convert_whisper_trees_equal():
    state = whisper_state()
    state["proj_out.weight"] = state["model.decoder.embed_tokens.weight"]
    jcfg = jhf.whisper_config_from_hf(WH_CFG)
    tcfg = thf.whisper_config_from_hf(WH_CFG)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(thf.convert_whisper(state, tcfg),
                       jhf.convert_whisper(state, jcfg))


def test_load_hf_whisper_trees_equal(tmp_path):
    path = _write_whisper_checkpoint(tmp_path / "ckpt", whisper_state())
    tcfg, tparams = thf.load_hf_whisper(path)
    jcfg, jparams = jhf.load_hf_whisper(path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(tparams, jparams)
    # The converted tree loads into the port's model.
    model = tw.Whisper(dataclasses.replace(tcfg, dtype="float32"))
    from_jax.load_whisper_params(model, tparams)


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("batch,decode_len", [(1, 448), (8, 448), (3, 6)])
def test_whisper_forward_flops_equal(name, batch, decode_len):
    cfg = getattr(tw, name)
    assert tcost.whisper_forward_flops(cfg, batch, decode_len) == \
        jcost.whisper_forward_flops(getattr(jw, name), batch, decode_len)

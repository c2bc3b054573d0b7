"""The port's ASR serving (`inference/asr.py`, `media/chunker.py`,
`media/worker.py`, the media envelopes of `bus/messages.py`) against the
JAX package's, on the CPU.

Both pipelines run `WHISPER_TEST` in f32 (0.32 s windows) on the same params
(the reference's ``PRNGKey(0)`` init, loaded into the port with
`load_whisper_params`), over the same generated WAV files.  Host code (WAV
decoding, resampling, chunking, envelopes) must give equal results; tokens
must be equal (the model's own parity, with its near-tie rule, is in
`tests/test_torch_whisper.py`; these inputs have none).

The reference is imported inside the fixtures that need it, so the tests
marked ``gpu`` collect on the card's machine, which has no JAX; they skip
without a card.
"""

import dataclasses
import importlib
import json
import time
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_crawler_tpu_torch.bus import InMemoryBus  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.inference import asr as tasr  # noqa: E402
from distributed_crawler_tpu_torch.media import chunker as tchunk  # noqa: E402
from distributed_crawler_tpu_torch.media.worker import (  # noqa: E402
    ASRWorker,
    ASRWorkerConfig,
    iter_transcripts,
)
from distributed_crawler_tpu_torch.models import from_jax  # noqa: E402
from distributed_crawler_tpu_torch.models import whisper as tw  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)

MAX_LEN = 6
WINDOW_S = tw.audio_window_samples(tw.WHISPER_TEST) / tw.SAMPLE_RATE  # 0.32


def _ref_module(name):
    """A module of the JAX package (skips where JAX is missing)."""
    pytest.importorskip("jax")
    return importlib.import_module(f"distributed_crawler_tpu.{name}")


def _detok(tokens):
    return " ".join(str(t) for t in tokens)


def write_wav(path, seconds, rate=16_000, channels=1, freq=440.0, seed=0):
    """PCM16 WAV: a tone plus seeded noise."""
    n = int(round(seconds * rate))
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    sig = 0.3 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.standard_normal(n)
    pcm = (np.clip(sig, -1, 1) * 32767).astype(np.int16)
    if channels > 1:
        pcm = np.stack([pcm] + [(pcm // (c + 2)).astype(np.int16)
                                for c in range(channels - 1)], axis=1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return str(path)


class DictProvider:
    """``put_text`` / ``get_text`` / ``list_dir`` over a dict."""

    def __init__(self):
        self.files = {}
        self.puts = 0

    def put_text(self, rel, text):
        self.puts += 1
        self.files[rel] = text

    def get_text(self, rel):
        return self.files.get(rel)

    def list_dir(self, rel):
        prefix = rel.rstrip("/") + "/"
        return sorted(k[len(prefix):] for k in self.files
                      if k.startswith(prefix) and "/" not in k[len(prefix):])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The reference's WHISPER_TEST params as a numpy tree."""
    jax = pytest.importorskip("jax")
    jw = _ref_module("models.whisper")
    cfg = jw.WHISPER_TEST
    p = jw.Whisper(cfg).init(
        jax.random.PRNGKey(0),
        np.zeros((1, cfg.n_audio_ctx * 2, cfg.n_mels), np.float32),
        np.zeros((1, 4), np.int32))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def ref_pipeline(params):
    jasr = _ref_module("inference.asr")
    jw = _ref_module("models.whisper")
    jut = _ref_module("utils.metrics")
    return jasr.ASRPipeline(jw.Whisper(jw.WHISPER_TEST), params,
                            batch_size=2, max_len=MAX_LEN,
                            detokenize=_detok,
                            registry=jut.MetricsRegistry())


def port_pipeline(params, **kw):
    return tasr.ASRPipeline(tw.Whisper(tw.WHISPER_TEST), params,
                            batch_size=2, max_len=MAX_LEN, detokenize=_detok,
                            registry=MetricsRegistry(), device="cpu", **kw)


@pytest.fixture(scope="module")
def pipeline(params):
    return port_pipeline(params)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Generated inputs: short, multi-window, 48 kHz stereo, 8 kHz, a
    non-WAV file and a missing one."""
    d = tmp_path_factory.mktemp("wavs")
    corrupt = d / "corrupt.wav"
    corrupt.write_bytes(b"this is not a RIFF file" * 10)
    return {
        "short": write_wav(d / "short.wav", 0.1, seed=1),
        "long": write_wav(d / "long.wav", 0.8, freq=300.0, seed=2),
        "stereo48k": write_wav(d / "stereo48k.wav", 0.4, rate=48_000,
                               channels=2, seed=3),
        "rate8k": write_wav(d / "rate8k.wav", 0.25, rate=8_000, seed=4),
        "corrupt": str(corrupt),
        "missing": str(d / "missing.wav"),
    }


# -- WAV decoding -------------------------------------------------------------
@pytest.mark.parametrize("name", ["short", "long", "stereo48k", "rate8k"])
def test_read_wav_equal(wavs, name):
    jasr = _ref_module("inference.asr")
    got = tasr.read_wav_mono_16k(wavs[name])
    want = jasr.read_wav_mono_16k(wavs[name])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_wav_resamples_to_16k(wavs):
    assert len(tasr.read_wav_mono_16k(wavs["stereo48k"])) == 6400
    assert len(tasr.read_wav_mono_16k(wavs["rate8k"])) == 4000


@pytest.mark.parametrize("name", ["corrupt", "missing"])
def test_read_wav_errors_equal(wavs, name):
    jasr = _ref_module("inference.asr")
    with pytest.raises(Exception) as got:
        tasr.read_wav_mono_16k(wavs[name])
    with pytest.raises(Exception) as want:
        jasr.read_wav_mono_16k(wavs[name])
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# -- the chunker --------------------------------------------------------------
def test_window_bucket_helpers_equal():
    jasr = _ref_module("inference.asr")
    jch = _ref_module("media.chunker")
    assert tchunk.DEFAULT_WINDOW_BUCKETS == jch.DEFAULT_WINDOW_BUCKETS
    for b in range(1, 11):
        assert tasr.default_window_buckets(b) == \
            jasr.default_window_buckets(b)
    for n in range(0, 12):
        assert tchunk.bucket_for_windows(n, (1, 2, 4, 8)) == \
            jch.bucket_for_windows(n, (1, 2, 4, 8))


@pytest.mark.parametrize("buckets,cap", [((1, 2, 4), 0), ((1, 2, 4, 8), 0),
                                         ((3, 1), 2)])
def test_chunker_plans_batches_reassembly_equal(buckets, cap):
    jch = _ref_module("media.chunker")
    rng = np.random.default_rng(7)
    audios = [rng.standard_normal(n).astype(np.float32)
              for n in (250, 0, 100, 999, 37)]
    audios.insert(2, None)
    errors = {2: "decode failed: boom"}
    tc = tchunk.AudioChunker(100, buckets=buckets, max_windows_per_file=cap,
                             reader=lambda p: None)
    jc = jch.AudioChunker(100, buckets=buckets, max_windows_per_file=cap,
                          reader=lambda p: None)
    tp, jp = tc.chunk(audios, errors=errors), jc.chunk(audios, errors=errors)
    np.testing.assert_array_equal(tp.windows, jp.windows)
    for f in ("segment_map", "errors", "real_samples", "n_files",
              "window_samples"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.windows_per_file() == jp.windows_per_file()
    tb, jb = tc.batches(tp), jc.batches(jp)
    assert [(b.bucket, b.window_indices, b.real_windows, b.pad_windows)
            for b in tb] == [(b.bucket, b.window_indices, b.real_windows,
                              b.pad_windows) for b in jb]
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.audio, b.audio)
    assert tc.padding_stats(tp, tb) == jc.padding_stats(jp, jb)
    per_window = [[w, w + 1] for w in range(tp.n_windows)]
    assert tc.reassemble(tp, per_window) == jc.reassemble(jp, per_window)
    with pytest.raises(ValueError, match="window outputs"):
        tc.reassemble(tp, per_window[:-1])


def test_chunk_files_equal(wavs):
    jch = _ref_module("media.chunker")
    paths = [wavs[k] for k in ("long", "missing", "corrupt", "short")]
    tp = tchunk.AudioChunker(5120, buckets=(1, 2)).chunk_files(paths)
    jp = jch.AudioChunker(5120, buckets=(1, 2)).chunk_files(paths)
    assert tp.errors == jp.errors and set(tp.errors) == {1, 2}
    assert tp.segment_map == jp.segment_map
    np.testing.assert_array_equal(tp.windows, jp.windows)


def test_chunker_rejects_bad_config():
    with pytest.raises(ValueError):
        tchunk.AudioChunker(window_samples=0)
    with pytest.raises(ValueError):
        tchunk.AudioChunker(window_samples=10, buckets=())


# -- the pipeline -------------------------------------------------------------
def test_transcribe_files_equal(pipeline, ref_pipeline, wavs):
    order = ["long", "corrupt", "short", "stereo48k", "missing", "rate8k"]
    paths = [wavs[k] for k in order]
    got = pipeline.transcribe_files(paths)
    want = ref_pipeline.transcribe_files(paths)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    by = dict(zip(order, got))
    assert by["long"].windows == 3 and len(by["long"].tokens) == \
        3 * (MAX_LEN - 3)
    assert by["corrupt"].error and by["missing"].error
    assert by["corrupt"].tokens == [] and by["corrupt"].windows == 0
    assert by["short"].text == _detok(by["short"].tokens)


def test_transcribe_audio_and_counters_equal(params, ref_pipeline):
    registry = MetricsRegistry()
    pipe = tasr.ASRPipeline(tw.Whisper(tw.WHISPER_TEST), params,
                            batch_size=2, max_len=MAX_LEN, registry=registry,
                            device="cpu")
    audio = (np.random.default_rng(8).standard_normal(
        (2, pipe.window_samples)) * 0.1).astype(np.float32)
    got = pipe.transcribe_audio(audio, real_windows=1)
    want = ref_pipeline.transcribe_audio(audio, real_windows=1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert pipe.strip_special(got[0]) == ref_pipeline.strip_special(want[0])
    assert registry.counter("asr_windows_total").value == 1
    assert registry.counter("asr_pad_window_slots_total").value == 1
    pipe.warmup()
    stats = pipe.compile_cache_stats()
    assert stats == {"programs_asr": [1, 2], "misses_total": 2.0,
                     "misses": {"asr:2": 1.0, "asr:1": 1.0}}
    # Warmup counts no windows and no busy time.
    assert registry.counter("asr_windows_total").value == 1
    assert pipe.timeline.snapshot()["batches_total"] == 1


def _write_hf_whisper(path, vocab=None):
    """The reference tests' tiny HF Whisper checkpoint; ``vocab`` resizes
    its token table (the special tokens of the published vocabulary need
    51865 rows)."""
    from tests.test_hf_convert import WH_CFG
    from tests.test_torch_whisper import (
        _write_whisper_checkpoint,
        whisper_state,
    )

    state = whisper_state()
    cfg = dict(WH_CFG)
    if vocab:
        cfg["vocab_size"] = vocab
        state["model.decoder.embed_tokens.weight"] = (
            np.random.default_rng(10).standard_normal(
                (vocab, cfg["d_model"])) * 0.02).astype(np.float32)
    return _write_whisper_checkpoint(path, state, cfg), cfg


def test_from_pretrained_equal(tmp_path, wavs, caplog):
    pytest.importorskip("safetensors")
    jasr = _ref_module("inference.asr")
    jut = _ref_module("utils.metrics")
    ckpt, hf_cfg = _write_hf_whisper(tmp_path / "ckpt", vocab=51_865)
    # Capture at the module's own logger: the JAX package's
    # `setup_logging`, which other tests in this process may have run,
    # stops the "dct" logger tree from propagating to the root logger,
    # where caplog listens.
    tasr.logger.addHandler(caplog.handler)
    try:
        with caplog.at_level("INFO", logger="dct.torch.inference.asr"):
            got = tasr.ASRPipeline.from_pretrained(
                ckpt, batch_size=2, max_len=MAX_LEN, dtype="float32",
                registry=MetricsRegistry(), device="cpu")
    finally:
        tasr.logger.removeHandler(caplog.handler)
    assert got.detokenize is None
    assert "token-id output only" in caplog.text
    assert got.model.cfg.n_vocab == hf_cfg["vocab_size"]
    want = jasr.ASRPipeline.from_pretrained(
        ckpt, batch_size=2, max_len=MAX_LEN, dtype="float32",
        registry=jut.MetricsRegistry())
    paths = [wavs["long"], wavs["short"]]
    got_r, want_r = got.transcribe_files(paths), want.transcribe_files(paths)
    assert [r.tokens for r in got_r] == [r.tokens for r in want_r]
    assert [r.windows for r in got_r] == [3, 1]


def test_special_tokens_outside_the_vocab_clamp_as_the_reference(tmp_path,
                                                                  wavs):
    """A checkpoint whose vocabulary is smaller than the special tokens'
    ids: both gathers clamp ``sot`` (50258) to the table's last row, so the
    port decodes the reference's tokens."""
    pytest.importorskip("safetensors")
    jasr = _ref_module("inference.asr")
    jut = _ref_module("utils.metrics")
    ckpt, hf_cfg = _write_hf_whisper(tmp_path / "ckpt")
    assert hf_cfg["vocab_size"] < tw.WHISPER_SMALL.sot_token
    want = jasr.ASRPipeline.from_pretrained(
        ckpt, batch_size=1, max_len=MAX_LEN, dtype="float32",
        registry=jut.MetricsRegistry()).transcribe_files([wavs["short"]])
    assert want[0].windows == 1 and not want[0].error
    got = tasr.ASRPipeline.from_pretrained(
        ckpt, batch_size=1, max_len=MAX_LEN, dtype="float32",
        registry=MetricsRegistry(), device="cpu").transcribe_files(
            [wavs["short"]])
    assert got[0].windows == 1 and not got[0].error
    assert got[0].tokens == want[0].tokens


def test_entry_points_need_a_card(monkeypatch, tmp_path, params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tasr.ASRPipeline(tw.Whisper(tw.WHISPER_TEST))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tasr.ASRPipeline.from_pretrained(str(tmp_path))


# -- envelopes ----------------------------------------------------------------
def test_media_constants_equal():
    jm = _ref_module("bus.messages")
    for name in ("MSG_AUDIO_BATCH", "MSG_TRANSCRIPT", "TOPIC_MEDIA_BATCHES",
                 "TOPIC_TRANSCRIPTS"):
        assert getattr(tmsg, name) == getattr(jm, name), name


def _ref_pair():
    jm = _ref_module("bus.messages")
    refs = [jm.AudioRef(media_id="m1", path="/a.wav", channel_name="c",
                        post_uid="p1", duration_s=2.5),
            jm.AudioRef(media_id="m2", path="/b.wav")]
    audio = jm.AudioBatchMessage.new(refs, crawl_id="c1", tenant="t1")
    tr = jm.TranscriptMessage.new("m9", crawl_id="c1", batch_id="b",
                                  worker_id="w", text="hello",
                                  tokens=[1, 2], windows=2, duration_s=60.0,
                                  trace_id="trace_x", path="/a.wav")
    err = jm.TranscriptMessage.new("m1", error="decode failed")
    return [(tmsg.AudioBatchMessage, audio), (tmsg.TranscriptMessage, tr),
            (tmsg.TranscriptMessage, err)]


def test_envelopes_decode_the_references_dicts():
    for cls, ref_msg in _ref_pair():
        d = json.loads(json.dumps(ref_msg.to_dict()))
        msg = cls.from_dict(d)
        assert msg.to_dict() == d
        msg.validate()
        # And the reference decodes the port's dict to the same dict.
        assert type(ref_msg).from_dict(msg.to_dict()).to_dict() == d


def test_envelopes_round_trip():
    msg = tmsg.AudioBatchMessage.new(
        [tmsg.AudioRef(media_id="m1", path="/a.wav", duration_s=1.5)],
        crawl_id="c")
    back = tmsg.AudioBatchMessage.from_dict(
        json.loads(json.dumps(msg.to_dict())))
    assert back == msg and len(back) == 1
    assert back.trace_id.startswith("trace_")
    t = tmsg.TranscriptMessage.new("m9", tokens=[3, 4], trace_id="trace_y")
    assert t.post_uid == "media:m9" and t.trace_id == "trace_y"
    assert tmsg.TranscriptMessage.from_dict(t.to_dict()) == t


def test_envelope_validation():
    with pytest.raises(ValueError, match="refs"):
        tmsg.AudioBatchMessage.new([], crawl_id="c").validate()
    with pytest.raises(ValueError, match="media_id"):
        tmsg.AudioBatchMessage.new([tmsg.AudioRef(path="/a")]).validate()
    with pytest.raises(ValueError, match="path"):
        tmsg.AudioBatchMessage.new([tmsg.AudioRef(media_id="m")]).validate()
    with pytest.raises(ValueError, match="media_id"):
        tmsg.TranscriptMessage.new("").validate()


# -- the worker ---------------------------------------------------------------
def _batch(wavs, names, crawl="c1"):
    return tmsg.AudioBatchMessage.new(
        [tmsg.AudioRef(media_id=n, path=wavs[n], channel_name="ch")
         for n in names], crawl_id=crawl)


def _worker(pipeline, provider=None, **cfg):
    bus = InMemoryBus(sync=True)
    got = []
    bus.subscribe(tmsg.TOPIC_TRANSCRIPTS, got.append)
    worker = ASRWorker(bus, pipeline, provider=provider,
                       cfg=ASRWorkerConfig(worker_id="asr-t", **cfg),
                       registry=MetricsRegistry())
    return bus, worker, got


class _Counting:
    """The pipeline, with its ``transcribe_plan`` calls counted and,
    optionally, poisoned."""

    def __init__(self, pipeline, poison=lambda plan: False):
        self._p = pipeline
        self.calls = []
        self.poison = poison

    def __getattr__(self, name):
        return getattr(self._p, name)

    def transcribe_plan(self, plan):
        self.calls.append(plan.n_windows)
        if self.poison(plan):
            raise RuntimeError("poisoned plan")
        return self._p.transcribe_plan(plan)


def test_worker_serves_coalesced_batches(pipeline, wavs):
    """Two batches queued before the feed starts: one group, one
    transcribe_plan over both batches' windows, each batch its own
    transcripts, writeback and ack; tokens equal to transcribe_files."""
    provider = DictProvider()
    counting = _Counting(pipeline)
    bus, worker, got = _worker(counting, provider, coalesce_batches=2)
    b1 = _batch(wavs, ["long", "short"])
    b2 = _batch(wavs, ["stereo48k", "corrupt"])
    acks = {b1.batch_id: [], b2.batch_id: []}
    worker._handle_payload(b1.to_dict(), acks[b1.batch_id].append)
    worker._handle_payload(b2.to_dict(), acks[b2.batch_id].append)
    worker.start()
    try:
        assert worker.drain(timeout_s=60)
    finally:
        worker.stop(timeout_s=5)
        bus.close()
    assert acks == {b1.batch_id: [True], b2.batch_id: [True]}
    assert counting.calls == [3 + 1 + 2]
    assert worker.m_coalesce.count == 1
    status = worker.get_status()
    assert status["processed_batches"] == 2 and status["error_batches"] == 0
    by_media = {d["media_id"]: tmsg.TranscriptMessage.from_dict(d)
                for d in got}
    assert set(by_media) == {"long", "short", "stereo48k", "corrupt"}
    files = pipeline.transcribe_files(
        [wavs[m] for m in ("long", "short", "stereo48k")])
    for media, res in zip(("long", "short", "stereo48k"), files):
        t = by_media[media]
        assert t.tokens == res.tokens and t.windows == res.windows
        assert t.text == _detok(res.tokens) and not t.error
        assert t.duration_s == pytest.approx(res.windows * WINDOW_S)
        assert t.post_uid == f"media:{media}"
    assert by_media["corrupt"].error and by_media["corrupt"].tokens == []
    assert by_media["long"].trace_id == b1.trace_id
    assert by_media["corrupt"].batch_id == b2.batch_id
    rows = {r["media_id"]: r for r in iter_transcripts(provider, "c1")}
    assert set(rows) == set(by_media)
    for media, t in by_media.items():
        assert rows[media]["tokens"] == t.tokens
        assert rows[media]["error"] == t.error
        assert rows[media]["batch_id"] == t.batch_id


def test_worker_isolates_a_poisoned_batch(pipeline, wavs):
    """The combined step fails on the poisoned batch's windows; each batch
    then runs alone: the good one commits, the poisoned one is nacked."""
    provider = DictProvider()
    good = _batch(wavs, ["short"])
    bad = _batch(wavs, ["long"])
    counting = _Counting(pipeline, poison=lambda plan: plan.n_windows >= 3)
    bus, worker, got = _worker(counting, provider)
    acks_good, acks_bad = [], []
    worker._process_group([
        (good, acks_good.append, time.monotonic()),
        (bad, acks_bad.append, time.monotonic()),
    ])
    bus.close()
    assert counting.calls == [4, 1, 3]
    assert acks_good == [True] and acks_bad == [False]
    assert [d["media_id"] for d in got] == ["short"]
    assert list(provider.files) == [f"asr/c1/batches/{good.batch_id}.jsonl"]
    assert worker.get_status()["error_batches"] == 1
    assert worker.m_outcomes.labels(outcome="error").value == 1


def test_worker_writeback_is_idempotent(pipeline, wavs):
    provider = DictProvider()
    bus, worker, got = _worker(pipeline, provider, write_tokens=False)
    msg = _batch(wavs, ["short", "missing"], crawl="")
    for _ in range(2):  # a redelivery
        worker._process_group([(tmsg.AudioBatchMessage.from_dict(
            msg.to_dict()), None, time.monotonic())])
    bus.close()
    rel = f"asr/adhoc/batches/{msg.batch_id}.jsonl"
    assert list(provider.files) == [rel] and provider.puts == 2
    rows = list(iter_transcripts(provider, "adhoc"))
    assert len(rows) == 2 and "tokens" not in rows[0]
    assert rows[1]["media_id"] == "missing" and rows[1]["error"]
    assert len(got) == 4


def test_worker_handler_nacks_undecodable_and_acks_empty(pipeline):
    bus, worker, _ = _worker(pipeline)
    acks = []
    worker._handle_payload({"message_type": "audio_batch",
                            "refs": "garbage"}, acks.append)
    assert acks == [True]  # no refs: trivially done
    acks.clear()
    worker._handle_payload(
        {"refs": [{"media_id": "m", "path": "/a",
                   "duration_s": "not-a-float"}], "batch_id": "b"},
        acks.append)
    assert acks == [False]
    assert worker.get_status()["inflight"] == 0
    bus.close()


def test_worker_from_the_bus(pipeline, wavs):
    """Published on the in-memory bus (async delivery), served, and every
    transcript back on the transcripts topic."""
    bus = InMemoryBus(sync=False)
    got = []
    bus.subscribe(tmsg.TOPIC_TRANSCRIPTS, got.append)
    worker = ASRWorker(bus, pipeline, cfg=ASRWorkerConfig(worker_id="w"),
                       registry=MetricsRegistry())
    worker.start()
    bus.start()
    try:
        msgs = [_batch(wavs, ["short"]), _batch(wavs, ["rate8k", "long"])]
        for m in msgs:
            bus.publish(tmsg.TOPIC_MEDIA_BATCHES, m.to_dict())
        deadline = time.monotonic() + 60
        while len(got) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert worker.drain(timeout_s=30)
    finally:
        worker.stop(timeout_s=5)
        bus.close()
    assert sorted(d["media_id"] for d in got) == ["long", "rate8k", "short"]
    assert worker.m_batches.value == 2


# -- on the card ------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# Whisper-tiny's widths (6 heads of 64, so the kernel takes the encoder's
# attention) at two layers and a 64-token vocabulary; the full 1500-frame
# audio context.
CARD_CFG = dataclasses.replace(tw.WHISPER_TINY, n_audio_layer=2,
                               n_text_layer=2, n_vocab=64, n_text_ctx=16,
                               sot_token=1, eot_token=2,
                               no_timestamps_token=3, transcribe_token=4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_on_card_matches_cpu(cuda, dtype):
    """One window on the card against the same weights on the CPU in f32:
    the encoder output and the teacher-forced logits within 2e-3 (f32,
    card kernels against plain) or 5e-2 (bf16), and the encoder's attention
    launched on the kernel, once per layer."""
    from distributed_crawler_tpu_torch.ops import attention

    torch.manual_seed(0)
    cpu = tw.Whisper(dataclasses.replace(CARD_CFG, dtype="float32")).eval()
    tree = from_jax.whisper_flax_tree(cpu)
    card = tasr.ASRPipeline(tw.Whisper(dataclasses.replace(
        CARD_CFG, dtype=dtype)), tree, batch_size=1, max_len=8,
        registry=MetricsRegistry())
    assert card.device.type == "cuda"
    audio = (np.random.default_rng(9).standard_normal(
        (1, card.window_samples)) * 0.1).astype(np.float32)
    mel = tw.log_mel_spectrogram(torch.from_numpy(audio),
                                 n_mels=CARD_CFG.n_mels)
    tokens = torch.tensor([[1, 4, 3, 10, 11, 12]])
    path = "simt" if dtype == "float32" else "sm90"
    before = attention.flash_attention.launches_by_path[path]
    with torch.inference_mode():
        xa_cpu = cpu.encode(mel)
        logits_cpu = cpu.decode_teacher(tokens, xa_cpu)
        xa = card.model.encode(mel.to(cuda))
        logits = card.model.decode_teacher(tokens.to(cuda), xa)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches_by_path[path] == before + 2
    tol = 2e-3 if dtype == "float32" else 5e-2
    assert (xa.float().cpu() - xa_cpu).abs().max().item() <= tol
    assert (logits.cpu() - logits_cpu).abs().max().item() <= tol
    out = card.transcribe_audio(audio)
    assert out.shape == (1, 8) and out.dtype == np.int32
    assert list(out[0, :3]) == [1, 4, 3]

"""The port's transcript re-entry against the JAX package's, on the CPU.

- `datamodel/post.py`: ``to_dict`` and ``to_json`` byte-equal to the
  reference's for seeded posts with every field set and for default
  posts; ``from_dict`` reads each package's dicts.
- `bus/codec.BatchAccumulator` and `RecordBatch.from_posts`: the same
  ``add``/``poll``/``flush`` sequence gives the same records and sizes.
- `state/local.py`: the post sink writes the reference's bytes and path.
- `inference/bridge.InferenceBridge`: the ``post_uid`` dedupe window, the
  deadline flush, delegation, and a publish failure logged, not raised.
- `media/bridge.TranscriptReentry`: the same transcript payloads through
  both packages' re-entry, each into its own sink, give byte-equal
  ``posts.jsonl`` trees and equal published records.
- The loop: the reference's `MediaBridge` publishes onto the port's bus;
  the port's `ASRWorker` (tiny Whisper), re-entry, bridge and `TPUWorker`
  (a tiny encoder on the reference's params) give ``media:<id>`` result
  rows whose embeddings equal the reference engine's on the same texts
  within the engine tests' tolerance (1e-5 abs, 1e-4 rel).

Every check is exact unless a tolerance is stated.  No test sleeps for a
result: bridges are flushed and workers drained, and every bridge is
closed in ``finally`` so that no deadline thread outlives its test.
"""

import dataclasses
import datetime
import json
import logging
import os
import time
import typing

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from distributed_crawler_tpu.bus import codec as jcodec  # noqa: E402
from distributed_crawler_tpu.bus.inmemory import (  # noqa: E402
    InMemoryBus as JaxBus,
)
from distributed_crawler_tpu.datamodel import post as jpost  # noqa: E402
from distributed_crawler_tpu.inference.bridge import (  # noqa: E402
    InferenceBridge as JaxBridge,
)
from distributed_crawler_tpu.media.bridge import (  # noqa: E402
    TranscriptReentry as JaxReentry,
)
from distributed_crawler_tpu.state.interface import (  # noqa: E402
    LocalConfig,
    StateConfig,
)
from distributed_crawler_tpu.state.local import (  # noqa: E402
    LocalStateManager as JaxLocalStateManager,
)
from distributed_crawler_tpu_torch.bus import InMemoryBus  # noqa: E402
from distributed_crawler_tpu_torch.bus import codec as tcodec  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.datamodel import post as tpost  # noqa: E402
from distributed_crawler_tpu_torch.inference import bridge as tbridge  # noqa: E402
from distributed_crawler_tpu_torch.media.bridge import (  # noqa: E402
    TranscriptReentry,
)
from distributed_crawler_tpu_torch.state.interface import (  # noqa: E402
    StateConfig as TorchStateConfig,
)
from distributed_crawler_tpu_torch.state.local import (  # noqa: E402
    LocalStateManager,
)
from distributed_crawler_tpu_torch.utils import trace  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
NESTED = ("EngagementData", "ChannelData", "Comment", "OCRData",
          "PerformanceScores", "InnerLink", "MediaData", "Post")


# -- Post -----------------------------------------------------------------
def _text(rng):
    words = ["crawl", "Channel", "видео", "naïve", "日本語", "e5", "\"q\"",
             "a\\b", "tab\there", "line\nbreak", "emoji 🎙"]
    return " ".join(rng.choice(words, size=int(rng.integers(1, 6))))


def _value(mod, type_str, rng):
    """A seeded value of a `Post` field's annotated type, built from the
    classes of ``mod`` (either package's post module)."""
    t = type_str.replace("Optional[", "")[:-1] \
        if type_str.startswith("Optional[") else type_str
    if t == "str":
        return _text(rng)
    if t == "int":
        return int(rng.integers(-5, 10**9))
    if t == "bool":
        return bool(rng.integers(0, 2))
    if t == "float":
        return float(rng.integers(0, 10**6)) / 7.0
    if t == "datetime":
        base = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc)
        return base + datetime.timedelta(
            seconds=int(rng.integers(0, 10**8)),
            microseconds=int(rng.integers(0, 10**6)))
    if t == "List[Any]":
        return [_text(rng), int(rng.integers(0, 100))]
    if t == "List[str]":
        return [_text(rng) for _ in range(int(rng.integers(1, 3)))]
    if t == "Dict[str, int]":
        return {_text(rng): int(rng.integers(0, 100)) for _ in range(2)}
    if t.startswith("List["):
        return [_filled(mod, t[5:-1], rng)
                for _ in range(int(rng.integers(1, 3)))]
    return _filled(mod, t, rng)


def _filled(mod, cls_name, rng):
    cls = getattr(mod, cls_name)
    return cls(**{f.name: _value(mod, f.type, rng)
                  for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("name", NESTED)
def test_post_records_have_the_references_fields(name):
    mine = [(f.name, f.type) for f in dataclasses.fields(getattr(tpost, name))]
    ref = [(f.name, f.type) for f in dataclasses.fields(getattr(jpost, name))]
    assert mine == ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_post_json_is_the_references_bytes(seed):
    """Every field set, from the same seed in each package."""
    mine = _filled(tpost, "Post", np.random.default_rng(seed))
    ref = _filled(jpost, "Post", np.random.default_rng(seed))
    assert mine.to_dict() == ref.to_dict()
    assert mine.to_json() == ref.to_json()
    assert "\\u" not in mine.to_json()  # ensure_ascii=False
    # from_dict reads each package's dicts.
    assert tpost.Post.from_dict(ref.to_dict()).to_json() == ref.to_json()
    assert jpost.Post.from_dict(mine.to_dict()).to_json() == mine.to_json()
    assert tpost.Post.from_dict(json.loads(ref.to_json())) == mine
    assert mine.text_for_inference() == ref.text_for_inference()


def test_default_post_json_is_the_references_bytes():
    mine, ref = tpost.Post(), jpost.Post()
    assert mine.to_json() == ref.to_json()
    assert json.loads(mine.to_json())["published_at"] == \
        tpost.ZERO_TIME_STR == "0001-01-01T00:00:00Z"
    assert tpost.Post.from_dict(ref.to_dict()) == mine


@pytest.mark.parametrize("fields", [
    {}, {"description": "d"}, {"all_text": "a", "description": "d"},
    {"searchable_text": "s", "transcript_text": "t"},
    {"transcript_text": "t", "image_text": "i"}, {"image_text": "i"}])
def test_text_for_inference_is_the_references(fields):
    mine, ref = tpost.Post(**fields), jpost.Post(**fields)
    assert mine.text_for_inference() == ref.text_for_inference()
    # The batch's dict reader agrees with the record class.
    assert tcodec.text_for_inference(mine.to_dict()) == \
        mine.text_for_inference()


def test_time_helpers_live_in_one_place():
    assert tcodec.format_time is tpost.format_time
    assert tcodec.parse_time is tpost.parse_time
    assert tmsg.format_time is tpost.format_time
    for s in ("2024-05-06T07:08:09.123456789Z", "2024-05-06T07:08:09Z",
              "0001-01-01T00:00:00Z", "", "garbage.1+zz"):
        assert tpost.parse_time(s) == jpost.parse_time(s)


# -- BatchAccumulator ---------------------------------------------------------
def _posts(mod, n, start=0):
    return [mod.Post(post_uid=f"p{start + i}", channel_name="chan",
                     description=f"post {start + i}") for i in range(n)]


# (op, argument): add a post at time t, poll at time t, or flush.
ACC_STEPS = [("add", 0.0), ("add", 0.01), ("poll", 0.02), ("add", 0.03),
             ("poll", 0.06), ("add", 0.07), ("add", 0.08), ("add", 0.09),
             ("add", 0.10), ("poll", 0.5), ("flush", None), ("add", 1.0),
             ("poll", 1.01), ("flush", None), ("flush", None)]


@pytest.mark.parametrize("size,deadline", [(3, 0.05), (1, 0.05),
                                           (100, 0.2)])
def test_batch_accumulator_emits_as_the_references(size, deadline):
    mine = tcodec.BatchAccumulator(size, deadline, crawl_id="c1")
    ref = jcodec.BatchAccumulator(batch_size=size, deadline_s=deadline,
                                  crawl_id="c1")
    t_posts, j_posts = iter(_posts(tpost, 20)), iter(_posts(jpost, 20))
    emitted = 0
    for op, t in ACC_STEPS:
        if op == "add":
            got = (mine.add(next(t_posts), t), ref.add(next(j_posts), t))
        elif op == "poll":
            got = (mine.poll(t), ref.poll(t))
        else:
            got = (mine.flush(), ref.flush())
        assert (got[0] is None) == (got[1] is None), (op, t)
        if got[0] is not None:
            emitted += 1
            a, b = got[0].to_dict(), got[1].to_dict()
            assert a["records"] == b["records"]
            assert (a["crawl_id"], a["tenant"]) == \
                (b["crawl_id"], b["tenant"]) == ("c1", "default")
            assert a["batch_id"] and a["trace_id"]
    assert emitted >= 2


def test_record_batch_from_posts_decodes_in_the_reference():
    batch = tcodec.RecordBatch.from_posts(_posts(tpost, 3), crawl_id="c2")
    ref = jcodec.RecordBatch.from_dict(batch.to_dict())
    assert ref.to_dict() == batch.to_dict()
    assert [p.post_uid for p in ref.posts()] == ["p0", "p1", "p2"]
    assert batch.texts() == ref.texts()


# -- the post sink --------------------------------------------------------------
def _jax_sink(root, crawl_id):
    return JaxLocalStateManager(StateConfig(
        crawl_id=crawl_id, storage_root=root,
        local=LocalConfig(base_path=root)))


def _sink(root, crawl_id, cls=LocalStateManager):
    """The port's post sink for ``crawl_id`` under ``root``."""
    return cls(TorchStateConfig(storage_root=root, crawl_id=crawl_id))


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_post_sink_writes_the_references_bytes(tmp_path):
    mine = _sink(str(tmp_path / "port"), "c3")
    ref = _jax_sink(str(tmp_path / "ref"), "c3")
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(3):
        chan = f"ch{i % 2}"
        mine.store_post(chan, _filled(tpost, "Post", rng_a))
        ref.store_post(chan, _filled(jpost, "Post", rng_b))
    mine.close()
    ref.close()
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "ref"))
    assert got == want
    assert sorted(got) == [os.path.join("c3", "ch0", "posts", "posts.jsonl"),
                           os.path.join("c3", "ch1", "posts", "posts.jsonl")]


# -- InferenceBridge ----------------------------------------------------------
def _collect(bus, topic):
    got = []
    bus.subscribe(topic, got.append)
    return got


def test_bridge_post_uid_window_absorbs_recrawl(tmp_path):
    """A re-stored post (a redelivered transcript, a re-crawl) lands in
    the sink twice and ships once."""
    bus = InMemoryBus(sync=True)
    shipped = _collect(bus, tmsg.TOPIC_INFERENCE_BATCHES)
    bridge = tbridge.InferenceBridge(
        _sink(str(tmp_path), "d1"), bus, crawl_id="d1",
        batch_size=100, deadline_s=60.0)
    try:
        post = tpost.Post(post_uid="p1", channel_id="chan",
                          searchable_text="hello")
        bridge.store_post("chan", post)
        bridge.store_post("chan", post)  # the duplicate
        bridge.flush()
        uids = [r.get("post_uid")
                for b in shipped for r in b.get("records", [])]
        assert uids == ["p1"]
        assert bridge.posts_deduped == 1 and bridge.posts_bridged == 1
        assert bridge.batches_published == 1
    finally:
        bridge.close()
        bus.close()
    lines = (tmp_path / "d1" / "chan" / "posts" / "posts.jsonl"
             ).read_text(encoding="utf-8").splitlines()
    assert lines == [post.to_json()] * 2


def test_bridge_full_batch_ships_at_once(tmp_path):
    bus = InMemoryBus(sync=True)
    shipped = _collect(bus, tmsg.TOPIC_INFERENCE_BATCHES)
    bridge = tbridge.InferenceBridge(
        _sink(str(tmp_path), "d0"), bus, crawl_id="d0",
        batch_size=3, deadline_s=60.0)
    try:
        for p in _posts(tpost, 7):
            bridge.store_post("chan", p)
        assert [len(b["records"]) for b in shipped] == [3, 3]
        bridge.flush()
        assert [len(b["records"]) for b in shipped] == [3, 3, 1]
        assert {b["crawl_id"] for b in shipped} == {"d0"}
    finally:
        bridge.close()
        bus.close()


def test_bridge_deadline_flush(tmp_path):
    """A partial batch ships from the deadline thread, without flush()."""
    bus = InMemoryBus(sync=True)
    shipped = _collect(bus, tmsg.TOPIC_INFERENCE_BATCHES)
    bridge = tbridge.InferenceBridge(
        _sink(str(tmp_path), "d1"), bus, crawl_id="d1",
        batch_size=100, deadline_s=0.05)
    try:
        bridge.store_post("chan", tpost.Post(post_uid="p1", channel_id="chan",
                                             searchable_text="hello"))
        deadline = time.monotonic() + 5
        while not shipped and time.monotonic() < deadline:
            time.sleep(0.01)
        assert shipped and len(shipped[0]["records"]) == 1
    finally:
        bridge.close()
        bus.close()
    assert not bridge._thread.is_alive()


def test_bridge_delegates_everything_else(tmp_path):
    inner = _sink(str(tmp_path), "d2")
    bus = InMemoryBus(sync=True)
    bridge = tbridge.InferenceBridge(inner, bus, crawl_id="d2",
                                     batch_size=4, deadline_s=1.0)
    try:
        assert bridge.crawl_id == "d2"
        assert bridge.provider is inner.provider
        # The channel crawl's state call, on the wrapped manager.
        assert bridge.update_message == inner.update_message
        with pytest.raises(AttributeError):
            bridge.no_such_method  # noqa: B018 (no manager has it)
    finally:
        bridge.close()
        bus.close()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


class _DeadBus:
    def publish(self, topic, payload):
        raise ConnectionError("bus down")


def test_bridge_publish_failure_is_logged_not_raised(tmp_path):
    """The post is in the crawl's sink already; a dead bus costs the
    batch, logged, and never the crawl's write path."""
    log = logging.getLogger("dct.inference.bridge")
    handler = _Records()
    log.addHandler(handler)
    closed = []

    class Sink(LocalStateManager):
        def close(self):
            closed.append(True)
            super().close()

    bridge = tbridge.InferenceBridge(_sink(str(tmp_path), "d3", Sink),
                                     _DeadBus(),
                                     crawl_id="d3", batch_size=2,
                                     deadline_s=60.0)
    try:
        for p in _posts(tpost, 3):
            bridge.store_post("chan", p)  # the second one fills a batch
        bridge.close()  # flushes the third: fails again, logged again
    finally:
        log.removeHandler(handler)
    failures = [r for r in handler.records
                if r.getMessage() == "failed to publish record batch"]
    assert len(failures) == 2
    assert failures[0].levelno == logging.ERROR
    assert failures[0].records == 2 and "bus down" in failures[0].error
    assert bridge.batches_published == 0 and bridge.posts_bridged == 3
    assert closed == [True]
    assert len((tmp_path / "d3" / "chan" / "posts" / "posts.jsonl")
               .read_text(encoding="utf-8").splitlines()) == 3


# -- TranscriptReentry ----------------------------------------------------------
def _payloads():
    """Transcript payloads as the ASR worker publishes them, and the two
    kinds it never sends but a bus may carry."""
    def t(media_id, **kw):
        return tmsg.TranscriptMessage.new(media_id, crawl_id="r1",
                                          batch_id="ab1", worker_id="asr",
                                          **kw).to_dict()
    first = t("m-text", path="chan_a/v1.wav", channel_name="chan_a",
              text="hello видео", tokens=[1, 2], windows=1, duration_s=3.5)
    return [
        first,
        t("m-tokens", path="chan_a/v2.wav", channel_name="chan_a",
          tokens=[50258, 7, 99, 4]),
        t("m-error", path="chan_b/bad.wav", channel_name="chan_b",
          error="not a RIFF file"),
        t("m-empty", path="chan_b/silence.wav", channel_name="chan_b"),
        t("m-nochan", path="dir_c/sub/v3.wav", text="from the path"),
        t("m-nodir", path="v4.wav", tokens=[5]),
        {"message_type": "transcript", "media_id": ""},   # fails validate
        {"message_type": "audio_batch", "media_id": "x"},  # wrong type
        dict(first),                                       # redelivered
    ]


def test_reentry_writes_and_ships_what_the_reference_does(tmp_path):
    payloads = _payloads()
    trace.configure(capacity=8192)
    results = {}
    for name, bus, sink, bridge_cls, reentry_cls, kw in (
            ("port", InMemoryBus(sync=True), _sink(
                str(tmp_path / "port"), "r1"), tbridge.InferenceBridge,
             TranscriptReentry, {}),
            ("ref", JaxBus(sync=True), _jax_sink(str(tmp_path / "ref"), "r1"),
             JaxBridge, JaxReentry, {})):
        shipped = _collect(bus, tmsg.TOPIC_INFERENCE_BATCHES)
        bridge = bridge_cls(sink, bus, crawl_id="r1", batch_size=100,
                            deadline_s=60.0, **kw)
        try:
            reentry = reentry_cls(bridge, bus)
            for p in payloads:
                bus.publish(tmsg.TOPIC_TRANSCRIPTS, p)
            bridge.flush()
        finally:
            bridge.close()
            bus.close()
        results[name] = (shipped, reentry.posts_reentered,
                         reentry.errors_skipped, bridge.posts_deduped)
    port, ref = results["port"], results["ref"]
    assert port[1:] == ref[1:] == (5, 2, 1)
    assert len(port[0]) == len(ref[0]) == 1
    records = port[0][0]["records"]
    assert records == ref[0][0]["records"]
    assert [r["post_uid"] for r in records] == [
        "media:m-text", "media:m-tokens", "media:m-nochan", "media:m-nodir"]
    assert [r["description"] for r in records] == [
        "hello видео", "50258 7 99 4", "from the path", "5"]
    assert [r["channel_name"] for r in records] == [
        "chan_a", "chan_a", "dir_c/sub", "transcripts"]
    tree = _tree(str(tmp_path / "port"))
    assert tree == _tree(str(tmp_path / "ref"))
    assert sorted(tree) == [
        os.path.join("r1", *p, "posts", "posts.jsonl")
        for p in (("chan_a",), ("dir_c", "sub"), ("transcripts",))]
    # The redelivered transcript is stored twice, shipped once.
    assert tree[os.path.join("r1", "chan_a", "posts", "posts.jsonl")
                ].decode("utf-8").count("media:m-text") == 2
    # The re-entry hop joins the transcript's trace.
    tid = payloads[0]["trace_id"]
    hops = [s for s in trace.TRACER.spans()
            if s.name == "media.reentry" and s.trace_id == tid]
    assert len(hops) == 2 and hops[0].attrs["post_uid"] == "media:m-text"


# -- the loop on the CPU ----------------------------------------------------------
def _write_wav(path, seconds, rate=16_000, freq=440.0):
    import wave

    t = np.arange(int(seconds * rate)) / rate
    pcm = (np.sin(2 * np.pi * freq * t) * 0.3 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return str(path)


class _DictProvider:
    """``put_text`` / ``get_text`` / ``list_dir`` / ``flush`` over a dict."""

    def __init__(self):
        self.files: typing.Dict[str, str] = {}

    def put_text(self, rel, text):
        self.files[rel] = text

    def get_text(self, rel):
        return self.files.get(rel)

    def list_dir(self, rel):
        prefix = rel.rstrip("/") + "/"
        return sorted({k[len(prefix):].split("/", 1)[0] for k in self.files
                       if k.startswith(prefix)})

    def flush(self):
        pass


def test_crawl_audio_reenters_the_ports_text_path(tmp_path):
    """The crawl half's `MediaBridge` (the reference's) onto the port's
    bus; the port's ASR worker, re-entry, bridge and text worker."""
    import jax.numpy as jnp

    from distributed_crawler_tpu.inference import engine as jeng
    from distributed_crawler_tpu.inference.worker import iter_results
    from distributed_crawler_tpu.media.bridge import MediaBridge
    from distributed_crawler_tpu.models import whisper as jw
    from distributed_crawler_tpu.utils.metrics import (
        MetricsRegistry as JaxRegistry,
    )
    from distributed_crawler_tpu_torch.inference import asr as tasr
    from distributed_crawler_tpu_torch.inference import engine as teng
    from distributed_crawler_tpu_torch.inference.worker import (
        TPUWorker,
        TPUWorkerConfig,
    )
    from distributed_crawler_tpu_torch.media.worker import (
        ASRWorker,
        ASRWorkerConfig,
        iter_transcripts,
    )
    from distributed_crawler_tpu_torch.models import whisper as tw
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    wcfg = jw.WHISPER_TEST
    wparams = jax.tree.map(np.asarray, jw.Whisper(wcfg).init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, wcfg.n_audio_ctx * 2, wcfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32)))
    pipeline = tasr.ASRPipeline(
        tw.Whisper(tw.WHISPER_TEST), wparams, batch_size=2, max_len=6,
        detokenize=lambda t: " ".join(str(x) for x in t),
        registry=MetricsRegistry(), device="cpu")
    ecfg = dict(model="tiny", n_labels=2, batch_size=4, buckets=(32,))
    ref_engine = jeng.InferenceEngine(jeng.EngineConfig(**ecfg),
                                      registry=JaxRegistry())
    engine = teng.InferenceEngine(
        teng.EngineConfig(**ecfg),
        params=jax.tree.map(np.asarray, ref_engine.params),
        registry=MetricsRegistry(), device="cpu")

    class NullSM:
        def close(self):
            pass

    bus = InMemoryBus(sync=True)
    provider = _DictProvider()
    registry = MetricsRegistry()
    tpu = TPUWorker(bus, engine, provider=provider,
                    cfg=TPUWorkerConfig(worker_id="tpu-e2e",
                                        heartbeat_s=60.0, stall_warn_s=0.0),
                    registry=registry)
    asr = ASRWorker(bus, pipeline, provider=provider,
                    cfg=ASRWorkerConfig(worker_id="asr-e2e",
                                        heartbeat_s=60.0),
                    registry=registry)
    ibridge = tbridge.InferenceBridge(
        _sink(str(tmp_path / "crawl"), "e2e"), bus,
        crawl_id="e2e", batch_size=4, deadline_s=60.0)
    mbridge = MediaBridge(NullSM(), bus, crawl_id="e2e", batch_size=2,
                          deadline_s=0.05)
    tpu.start()
    asr.start()
    try:
        reentry = TranscriptReentry(ibridge, bus)
        wav_a = _write_wav(tmp_path / "va.wav", 0.5)
        wav_b = _write_wav(tmp_path / "vb.wav", 0.2, freq=880.0)
        for media_id, path in (("med-a", wav_a), ("med-b", wav_b),
                               ("med-a", wav_a)):
            mbridge.notify_media_stored(media_id, path, channel_name="chan")
        mbridge.flush()
        assert asr.drain(timeout_s=60)
        ibridge.flush()
        assert tpu.drain(timeout_s=60)
    finally:
        asr.stop(timeout_s=5)
        tpu.stop(timeout_s=5)
        mbridge.close()
        ibridge.close()
        bus.close()
        torch.set_num_threads(n_threads)
    assert mbridge.refs_deduped == 1
    transcripts = {r["media_id"]: r for r in iter_transcripts(provider, "e2e")}
    assert set(transcripts) == {"med-a", "med-b"}
    assert transcripts["med-a"]["windows"] == 2
    assert reentry.posts_reentered == 2 and reentry.errors_skipped == 0
    rows = {r["post_uid"]: r for r in iter_results(provider, "e2e")}
    assert set(rows) == {"media:med-a", "media:med-b"}
    texts = [transcripts[m]["text"] for m in ("med-a", "med-b")]
    assert all(texts)
    want = ref_engine.run(texts)
    for uid, w in zip(("media:med-a", "media:med-b"), want):
        np.testing.assert_allclose(rows[uid]["embedding"], w["embedding"],
                                   **TOL)
        np.testing.assert_allclose(rows[uid]["scores"], w["scores"], **TOL)
        assert rows[uid]["label"] == w["label"]
    posts = (tmp_path / "crawl" / "e2e" / "chan" / "posts" / "posts.jsonl"
             ).read_text(encoding="utf-8").splitlines()
    assert sorted(json.loads(p)["post_uid"] for p in posts) == \
        ["media:med-a", "media:med-b"]

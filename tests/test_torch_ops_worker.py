"""The port's three workers with their operations layer on, against the
JAX package's workers, on the CPU at tiny widths.

The same batches go through the reference's and the port's worker on each
package's in-memory bus, with fast heartbeats and span exports:

- their heartbeats carry the same keys (top level and telemetry) and the
  same task counts, decode with the reference's `StatusMessage.from_dict`
  and fold into the reference's `FleetView`;
- ``get_status()`` and ``get_costs()`` have the same keys;
- the text worker's span batches fold into one trace per batch in the
  reference's `TraceCollector`, and `tools/perfreport.py` renders the
  port worker's ``/costs``, ``/metrics`` and ``/traces`` (rc 0);
- ``stop()`` announces ``worker_stopping`` and ``kill()`` publishes
  nothing;
- the stall watchdog counts a step that blocks past ``stall_warn_s`` and,
  past ``stall_exit_s``, writes a ``stall_exit`` bundle and reaches the
  exit seam with code 17.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from distributed_crawler_tpu.bus import messages as jmsg  # noqa: E402
from distributed_crawler_tpu.bus.inmemory import (  # noqa: E402
    InMemoryBus as JaxBus,
)
from distributed_crawler_tpu.cluster import worker as jcw  # noqa: E402
from distributed_crawler_tpu.datamodel import Post  # noqa: E402
from distributed_crawler_tpu.inference import asr as jasr  # noqa: E402
from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.inference import worker as jwork  # noqa: E402
from distributed_crawler_tpu.media import worker as jmw  # noqa: E402
from distributed_crawler_tpu.models import whisper as jw  # noqa: E402
from distributed_crawler_tpu.orchestrator.fleet import FleetView  # noqa: E402
from distributed_crawler_tpu.orchestrator.tracecollect import (  # noqa: E402
    TraceCollector,
)
from distributed_crawler_tpu.state.providers import (  # noqa: E402
    InMemoryStorageProvider,
)
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu.bus.codec import (  # noqa: E402
    RecordBatch as JaxRecordBatch,
)
from distributed_crawler_tpu_torch.bus import InMemoryBus  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.bus.codec import RecordBatch  # noqa: E402
from distributed_crawler_tpu_torch.cluster import worker as tcw  # noqa: E402
from distributed_crawler_tpu_torch.inference import asr as tasr  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.inference import worker as twork  # noqa: E402
from distributed_crawler_tpu_torch.media import worker as tmw  # noqa: E402
from distributed_crawler_tpu_torch.models import whisper as tw  # noqa: E402
from distributed_crawler_tpu_torch.utils import flight  # noqa: E402
from distributed_crawler_tpu_torch.utils import metrics as tmet  # noqa: E402
from distributed_crawler_tpu_torch.utils import trace  # noqa: E402

perfreport = pytest.importorskip("tools.perfreport")
postmortem = pytest.importorskip("tools.postmortem")

CFG = dict(model="tiny", n_labels=3, batch_size=4, buckets=(16, 32, 64))
BEAT = 0.05   # heartbeat and span-export interval, seconds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wait_for(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


class Side:
    """One package's worker kind: bus, worker class and config class."""

    def __init__(self, bus_cls, worker_cls, cfg_cls, registry_cls, msg):
        self.bus_cls, self.worker_cls = bus_cls, worker_cls
        self.cfg_cls, self.registry_cls, self.msg = cfg_cls, registry_cls, msg


TEXT = {"ref": Side(JaxBus, jwork.TPUWorker, jwork.TPUWorkerConfig,
                    JaxRegistry, jmsg),
        "port": Side(InMemoryBus, twork.TPUWorker, twork.TPUWorkerConfig,
                     tmet.MetricsRegistry, tmsg)}
ASR = {"ref": Side(JaxBus, jmw.ASRWorker, jmw.ASRWorkerConfig, JaxRegistry,
                   jmsg),
       "port": Side(InMemoryBus, tmw.ASRWorker, tmw.ASRWorkerConfig,
                    tmet.MetricsRegistry, tmsg)}
CLUSTER = {"ref": Side(JaxBus, jcw.ClusterWorker, jcw.ClusterWorkerConfig,
                       JaxRegistry, jmsg),
           "port": Side(InMemoryBus, tcw.ClusterWorker,
                        tcw.ClusterWorkerConfig, tmet.MetricsRegistry,
                        tmsg)}


def serve(side, engine, payloads, worker_id, after=None, **cfg):
    """Queue ``payloads``, start the worker with fast beats, wait for a
    heartbeat that counts them all, then stop.  Returns what came out."""
    bus = side.bus_cls(sync=True)
    beats, spans = [], []
    bus.subscribe(side.msg.TOPIC_WORKER_STATUS, beats.append)
    bus.subscribe(side.msg.TOPIC_SPANS, spans.append)
    kw = dict(worker_id=worker_id, heartbeat_s=BEAT,
              span_export_interval_s=BEAT, **cfg)
    worker = side.worker_cls(bus, engine, cfg=side.cfg_cls(**kw),
                             registry=side.registry_cls())
    for p in payloads:
        worker._handle_payload(p)
    worker.start()
    out = {}
    try:
        assert worker.drain(timeout_s=60.0)
        _beats_after(beats, len(payloads))
        out["status"] = worker.get_status()
        out["costs"] = worker.get_costs()
        if after is not None:
            after(worker)
    finally:
        worker.stop()
        bus.close()
    out.update(beats=beats, spans=spans, worker=worker)
    return out


def _beats_after(beats, n):
    """Wait for two heartbeats after the drain, the last counting all
    ``n`` tasks: both workers then have beaten with their full telemetry."""
    seen = len(beats)
    assert wait_for(lambda: len(beats) >= seen + 2
                    and beats[-1].get("tasks_processed") == n)


def _beat_keys(beats):
    top, usage = set(), set()
    for b in beats:
        if b["message_type"] != "heartbeat":
            continue
        top |= set(b)
        usage |= set(b["resource_usage"])
    return sorted(top), sorted(usage)


def check_parity(ref, port, n_tasks, worker_type, extra_usage=()):
    """``extra_usage``: telemetry keys the port adds (the port's cluster
    engine keeps a device timeline, the reference's has none)."""
    top, usage = _beat_keys(port["beats"])
    ref_top, ref_usage = _beat_keys(ref["beats"])
    assert top == ref_top
    assert usage == sorted(set(ref_usage) | set(extra_usage))
    last = {k: [b for b in got["beats"] if b["message_type"] == "heartbeat"]
            [-1] for k, got in (("ref", ref), ("port", port))}
    for key in ("tasks_processed", "tasks_success", "tasks_error",
                "worker_type", "status", "queue_length"):
        assert last["port"][key] == last["ref"][key], key
    assert last["port"]["tasks_processed"] == n_tasks
    assert last["port"]["worker_type"] == worker_type
    assert sorted(port["status"]) == sorted(ref["status"])
    assert sorted(port["costs"]) == sorted(ref["costs"])
    assert sorted(port["costs"]["efficiency"]) == \
        sorted(ref["costs"]["efficiency"])
    # The reference's fleet view reads every port beat, and the stop.
    fleet = FleetView(registry=JaxRegistry())
    for b in port["beats"]:
        msg = jmsg.StatusMessage.from_dict(json.loads(json.dumps(b)))
        msg.validate()
        assert fleet.observe(msg)
    (row,) = fleet.export()["workers"].values()
    assert row["status"] == "offline" and row["worker_type"] == worker_type
    assert row["telemetry"]["rss_bytes"] > 0
    assert port["beats"][-1]["message_type"] == "worker_stopping"


# -- the text worker -----------------------------------------------------------
@pytest.fixture(scope="module")
def text_engines():
    je = jeng.InferenceEngine(jeng.EngineConfig(**CFG),
                              registry=JaxRegistry())
    params = jax.tree.map(np.asarray, je.params)
    return je, params


def _port_engine(params):
    return teng.InferenceEngine(teng.EngineConfig(**CFG), params=params,
                                registry=tmet.MetricsRegistry(),
                                device="cpu")


def _text_payloads(sizes=(3, 5, 2)):
    out, start = [], 0
    for i, n in enumerate(sizes):
        posts = [Post(post_uid=f"p{start + j}", channel_name="chan",
                      description=" ".join(["word"] * (j % 7 + 1)))
                 for j in range(n)]
        start += n
        out.append(JaxRecordBatch.from_posts(posts,
                                             crawl_id=f"c{i}").to_dict())
    return out


def test_text_worker_matches_the_reference(text_engines, capsys):
    je, params = text_engines
    payloads = _text_payloads()
    report = {}

    def render(worker):
        server = tmet.serve_metrics(0, worker._registry, providers={
            "status": worker.get_status, "costs": worker.get_costs})
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            code, body = _get(url + "/status")
            report["status"] = (code, json.loads(body))
            report["rc"] = perfreport.main([url])
        finally:
            server.shutdown()
            server.server_close()

    ref = serve(TEXT["ref"], je, payloads, "tpu-w")
    port = serve(TEXT["port"], _port_engine(params), payloads, "tpu-w",
                 after=render)
    check_parity(ref, port, len(payloads), "tpu")
    assert report["status"][0] == 200
    assert report["status"][1]["processed_batches"] == len(payloads)
    assert report["rc"] == 0
    assert "tpu-w" in capsys.readouterr().out
    # /costs: one analytic row per (bucket, path) served.
    rows = port["costs"]["costs"]
    assert rows and all(r["source"] == "analytic" for r in rows)
    assert port["costs"]["profiler"]["captures"] >= 0
    eff = port["costs"]["efficiency"]
    assert eff["peak_source"] == "cpu_estimate" and 0 < eff["mfu"] <= 1
    # Span batches: one trace per batch in the reference's collector.
    collector = TraceCollector(tracer=trace.Tracer(),
                               registry=JaxRegistry())
    for s in port["spans"]:
        collector.observe(jmsg.SpanBatchMessage.from_dict(s))
    traces = {t["trace_id"] for t in collector.export()["traces"]}
    assert {p["trace_id"] for p in payloads} <= traces


def _idle_worker(kind, worker_id, bus, text_engines):
    """A port worker of ``kind`` with slow beats and no span export."""
    cfg = dict(worker_id=worker_id, heartbeat_s=3600,
               span_export_interval_s=0)
    if kind == "tpu":
        return twork.TPUWorker(bus, _port_engine(text_engines[1]),
                               cfg=twork.TPUWorkerConfig(**cfg),
                               registry=tmet.MetricsRegistry())
    if kind == "asr":
        return tmw.ASRWorker(bus, types.SimpleNamespace(),
                             cfg=tmw.ASRWorkerConfig(**cfg),
                             registry=tmet.MetricsRegistry())
    return tcw.ClusterWorker(bus, cfg=tcw.ClusterWorkerConfig(k=4, **cfg),
                             registry=tmet.MetricsRegistry(), device="cpu")


@pytest.mark.parametrize("kind", ["tpu", "asr", "cluster"])
@pytest.mark.parametrize("end", ["stop", "kill"])
def test_stop_announces_and_kill_is_silent(text_engines, kind, end):
    bus = InMemoryBus(sync=True)
    beats = []
    bus.subscribe(tmsg.TOPIC_WORKER_STATUS, beats.append)
    worker = _idle_worker(kind, f"w-{kind}-{end}", bus, text_engines)
    worker.start()
    assert wait_for(lambda: len(beats) == 1)
    getattr(worker, end)()
    worker.stop()   # after kill(): still silent
    bus.close()
    kinds = [b["message_type"] for b in beats]
    if end == "stop":
        assert kinds == ["heartbeat", "worker_stopping"]
        assert beats[-1]["status"] == "offline"
        assert beats[-1]["worker_type"] == kind
    else:
        assert kinds == ["heartbeat"]
    assert not worker.get_status()["is_running"]


class _BlockingEngine:
    """A stub engine whose step blocks until released."""

    def __init__(self):
        self.cfg = types.SimpleNamespace(model="stub")
        self.tokenizer = types.SimpleNamespace(
            encode_batch=lambda texts: [[1, 2]] * len(texts))
        self.release = threading.Event()

    def run_tokenized(self, toks, pack=False):
        self.release.wait(timeout=30)
        return [{"embedding": [0.0], "label": 0, "scores": [1.0]}
                for _ in toks]

    def run(self, texts, pack=False):
        return self.run_tokenized([[1]] * len(texts), pack=pack)


def test_stall_watchdog_counts_dumps_and_exits_17(tmp_path):
    flight.RECORDER.reset()
    flight.configure(dump_dir=str(tmp_path))
    engine = _BlockingEngine()
    bus = InMemoryBus(sync=True)
    worker = twork.TPUWorker(bus, engine, cfg=twork.TPUWorkerConfig(
        worker_id="stall", heartbeat_s=3600, span_export_interval_s=0,
        stall_warn_s=0.05, stall_exit_s=0.15),
        registry=tmet.MetricsRegistry())
    codes = []
    worker._exit_fn = codes.append
    try:
        for p in _text_payloads((2, 2)):
            worker._handle_payload(p)
        worker.start()
        assert wait_for(lambda: codes, timeout_s=20)
        assert wait_for(lambda: worker.get_status()["device_stalled"])
        engine.release.set()
        assert worker.drain(timeout_s=20)
    finally:
        engine.release.set()
        worker.stop()
        bus.close()
        flight.configure(dump_dir="")
    assert codes == [twork.STALL_EXIT_CODE] == [17]
    assert worker.m_stalls.value == 1
    assert worker._processed == 2
    (bundle,) = tmp_path.glob("postmortem_*_stall_exit.json")
    kinds = {e["kind"] for e in json.loads(bundle.read_text())["flight"]}
    assert "device_stall" in kinds
    assert postmortem.main([str(bundle)]) == 0
    flight.RECORDER.reset()


# -- the ASR worker -------------------------------------------------------------
def _wav(path, seconds, seed):
    n = int(seconds * 16_000)
    rng = np.random.default_rng(seed)
    pcm = (0.2 * rng.standard_normal(n) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.tobytes())
    return str(path)


def test_asr_worker_matches_the_reference(tmp_path):
    cfg = jw.WHISPER_TEST
    params = jax.tree.map(np.asarray, jw.Whisper(cfg).init(
        jax.random.PRNGKey(0),
        np.zeros((1, cfg.n_audio_ctx * 2, cfg.n_mels), np.float32),
        np.zeros((1, 4), np.int32)))
    pipes = {
        "ref": jasr.ASRPipeline(jw.Whisper(cfg), params, batch_size=2,
                                max_len=4, registry=JaxRegistry()),
        "port": tasr.ASRPipeline(tw.Whisper(tw.WHISPER_TEST), params,
                                 batch_size=2, max_len=4,
                                 registry=tmet.MetricsRegistry(),
                                 device="cpu")}
    payloads = [tmsg.AudioBatchMessage.new(
        [tmsg.AudioRef(media_id=f"m{i}",
                       path=_wav(tmp_path / f"a{i}.wav", 0.2 + 0.3 * i, i))],
        crawl_id="c").to_dict() for i in range(2)]
    got = {k: serve(ASR[k], pipes[k], payloads, "asr-w",
                    slo_asr_batch_p95_ms=0.001) for k in ("ref", "port")}
    check_parity(got["ref"], got["port"], 2, "asr")
    assert got["port"]["costs"]["slo"]["budgets"] == \
        got["ref"]["costs"]["slo"]["budgets"]
    assert got["port"]["status"]["processed_batches"] == 2


# -- the cluster worker ----------------------------------------------------------
def _result_payload(seed, n=6, dim=16):
    rng = np.random.RandomState(seed)
    return RecordBatch.from_dict({
        "batch_id": f"b{seed}", "crawl_id": "c1",
        "trace_id": f"trace_cluster_{seed}",
        "records": [{"post_uid": f"p{seed}-{i}", "channel_name": "chanA",
                     "description": "t"} for i in range(n)],
        "results": [{"embedding": rng.randn(dim).tolist(), "label": "x"}
                    for _ in range(n)]}).to_dict()


def test_cluster_worker_matches_the_reference():
    payloads = [_result_payload(s) for s in range(3)]
    got = {}
    for k in ("ref", "port"):
        side = CLUSTER[k]
        kw = dict(k=4, buckets=(8, 32), checkpoint_every_batches=2)
        engine = None
        if k == "port":
            from distributed_crawler_tpu_torch.cluster.engine import (
                ClusterEngine,
                ClusterEngineConfig,
            )

            engine = ClusterEngine(ClusterEngineConfig(k=4, buckets=(8, 32)),
                                   registry=tmet.MetricsRegistry(),
                                   device="cpu")
        bus = side.bus_cls(sync=True)
        beats = []
        bus.subscribe(side.msg.TOPIC_WORKER_STATUS, beats.append)
        worker = side.worker_cls(
            bus, engine, provider=InMemoryStorageProvider(),
            cfg=side.cfg_cls(worker_id="cl-w", heartbeat_s=BEAT,
                             span_export_interval_s=BEAT, **kw),
            registry=side.registry_cls())
        for p in payloads:
            worker._handle_payload(p)
        worker.start()
        try:
            assert worker.drain(timeout_s=60)
            _beats_after(beats, len(payloads))
            got[k] = {"status": worker.get_status(),
                      "costs": worker.get_costs(),
                      "clusters": worker.get_clusters()}
        finally:
            worker.stop()
            bus.close()
        got[k]["beats"] = beats
    check_parity(got["ref"], got["port"], 3, "cluster",
                 extra_usage=("occupancy",))
    assert sorted(got["port"]["clusters"]) == sorted(got["ref"]["clusters"])
    assert got["port"]["clusters"]["assign_vectors_per_s"] > 0
    cluster_usage = [b["resource_usage"]["cluster"]
                     for b in got["port"]["beats"]
                     if b["message_type"] == "heartbeat"][-1]
    assert cluster_usage["vectors"] == 18


def test_cluster_bundle_carries_the_centroid_state():
    """A postmortem bundle written while a cluster worker runs, or after
    it was killed, carries its /clusters body; after ``stop()`` it does
    not."""
    from distributed_crawler_tpu_torch.cluster.engine import (
        ClusterEngine,
        ClusterEngineConfig,
    )

    engine = ClusterEngine(ClusterEngineConfig(k=4, buckets=(8, 32)),
                           registry=tmet.MetricsRegistry(), device="cpu")
    bus = InMemoryBus(sync=True)
    worker = tcw.ClusterWorker(bus, engine, cfg=tcw.ClusterWorkerConfig(
        worker_id="cl-pm", k=4, buckets=(8, 32), heartbeat_s=3600,
        span_export_interval_s=0), registry=tmet.MetricsRegistry())
    worker._handle_payload(_result_payload(0))
    worker.start()
    try:
        assert worker.drain(timeout_s=60)
        live = flight.RECORDER.bundle("test")["clusters"]
        assert sorted(live) == sorted(worker.get_clusters())
        assert live["worker_id"] == "cl-pm" and live["vectors"] == 6
        worker.kill()
        assert flight.RECORDER.bundle("test")["clusters"]["vectors"] == 6
    finally:
        worker.stop()
        bus.close()
    assert "clusters" not in flight.RECORDER.bundle("test")
    flight.RECORDER.reset()


def test_text_worker_breach_slow_capture_and_routes(text_engines, tmp_path,
                                                    monkeypatch):
    """Every knob on, on the CPU: a forced SLO breach counted on /metrics,
    the slow-batch hook's torch.profiler capture written to the dump dir,
    /profile answering 200 (or 409 while the automatic capture runs), and
    the cost rows, MFU and per-(bucket, path) FLOPs exported."""
    from distributed_crawler_tpu_torch.utils import exposition, profiling

    _, params = text_engines
    monkeypatch.setattr(profiling, "PROFILER", profiling.ProfileCapture(
        dump_dir=str(tmp_path), max_seconds=0.05))
    flight.RECORDER.reset()
    reg = tmet.MetricsRegistry()   # the engine's metrics on the worker's
    engine = teng.InferenceEngine(teng.EngineConfig(**CFG), params=params,
                                  registry=reg, device="cpu")
    bus = InMemoryBus(sync=True)
    beats = []
    bus.subscribe(tmsg.TOPIC_WORKER_STATUS, beats.append)
    worker = twork.TPUWorker(bus, engine, cfg=twork.TPUWorkerConfig(
        worker_id="knobs", heartbeat_s=BEAT, span_export_interval_s=BEAT,
        slo_batch_p95_ms=0.001, profile_on_slow_ms=0.001, profiler_port=1),
        registry=reg)
    payloads = _text_payloads((3, 4))
    for p in payloads:
        worker._handle_payload(p)
    worker.start()
    server = tmet.serve_metrics(0, reg, providers={
        "status": worker.get_status, "costs": worker.get_costs})
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert worker.drain(timeout_s=60)
        _beats_after(beats, 2)
        assert wait_for(lambda: profiling.PROFILER.captures >= 1)
        for _ in range(2):
            code, body = (lambda r: (r[0], json.loads(r[1])))(
                _get_any(url + "/profile?seconds=0.02"))
            if code != 409:
                break
            assert wait_for(lambda: not profiling.PROFILER.active)
        assert code == 200 and body["ok"]
        _, text = _get(url + "/metrics")
        samples = exposition.parse_exposition(text.decode())
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
        bus.close()
    by_name = {}
    for s in samples:
        by_name.setdefault(s.name, []).append(s)
    assert [s.value for s in by_name["slo_breach_total"]
            if s.labels == {"slo": "batch_p95"}][0] >= 1
    served = {(r["bucket"], r["path"])
              for r in worker.get_costs()["costs"]}
    flops = {(int(s.labels["bucket"]), s.labels["path"]): s.value
             for s in by_name["tpu_engine_bucket_flops"] if s.labels}
    assert served and set(flops) == served
    assert "tpu_engine_mfu" in by_name
    dirs = sorted(tmp_path.glob("profile_*"))
    assert len(dirs) >= 2 and all((d / "trace.json").is_file()
                                  for d in dirs)
    kinds = {e["kind"] for e in flight.RECORDER.events()}
    assert {"slo_breach", "slow_batch", "profile_capture"} <= kinds
    flight.RECORDER.reset()


def _get_any(url):
    try:
        return _get(url)
    except urllib.error.HTTPError as e:
        return e.code, e.read()

"""The port's fleet view and trace collector
(`distributed_crawler_tpu_torch/orchestrator/fleet.py`,
`orchestrator/tracecollect.py`) against the reference's, on the CPU.

- `FleetView`: the cases of the reference's
  `tests/test_fleet_telemetry.py::TestFleetView` and `::TestClusterEndpoint`
  as scripted heartbeat sequences, and the heartbeats of a port
  `TPUWorker` (tiny encoder, CPU) folded at fixed receive times: the same
  ``/cluster`` body and the same ``fleet_*`` exposition.
- `TraceCollector`: the cases of `tests/test_distributed_trace.py::
  TestTraceCollector` and `::TestDtracesEndpoint`, and the port worker's
  span batches: the same assembled traces, offsets and drop counts.
- Both orchestrators fold the port worker's frames from their bus handlers
  into the same ``/cluster`` and ``/dtraces`` structure.
"""

import json
import time
import urllib.request
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from distributed_crawler_tpu.bus import messages as jmsg  # noqa: E402
from distributed_crawler_tpu.bus.codec import (  # noqa: E402
    RecordBatch as JaxRecordBatch,
)
from distributed_crawler_tpu.datamodel import Post  # noqa: E402
from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.orchestrator import fleet as jfleet  # noqa: E402
from distributed_crawler_tpu.orchestrator import (  # noqa: E402
    tracecollect as jtc,
)
from distributed_crawler_tpu.utils import metrics as jmet  # noqa: E402
from distributed_crawler_tpu.utils import trace as jtrace  # noqa: E402
from distributed_crawler_tpu_torch.bus import InMemoryBus  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.inference import worker as twork  # noqa: E402
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    fleet as tfleet,
)
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    tracecollect as ttc,
)
from distributed_crawler_tpu_torch.utils import metrics as tmet  # noqa: E402
from distributed_crawler_tpu_torch.utils import trace as ttrace  # noqa: E402

CFG = dict(model="tiny", n_labels=3, batch_size=4, buckets=(16, 32, 64))
BEAT = 0.05


# -- the port worker's frames ---------------------------------------------------------
@pytest.fixture(scope="module")
def worker_frames():
    """Heartbeats and span batches of a port `TPUWorker` serving three
    batches with fast beats and span export."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    je = jeng.InferenceEngine(jeng.EngineConfig(**CFG),
                              registry=jmet.MetricsRegistry())
    params = jax.tree.map(np.asarray, je.params)
    engine = teng.InferenceEngine(teng.EngineConfig(**CFG), params=params,
                                  registry=tmet.MetricsRegistry(),
                                  device="cpu")
    bus = InMemoryBus(sync=True)
    beats, spans = [], []
    bus.subscribe(tmsg.TOPIC_WORKER_STATUS, beats.append)
    bus.subscribe(tmsg.TOPIC_SPANS, spans.append)
    worker = twork.TPUWorker(bus, engine, cfg=twork.TPUWorkerConfig(
        worker_id="tpu-w", heartbeat_s=BEAT, span_export_interval_s=BEAT),
        registry=tmet.MetricsRegistry())
    payloads = []
    for i, size in enumerate((3, 5, 2)):
        posts = [Post(post_uid=f"p{i}-{j}", channel_name="chan",
                      description=" ".join(["word"] * (j + 1)))
                 for j in range(size)]
        payloads.append(JaxRecordBatch.from_posts(
            posts, crawl_id=f"c{i}").to_dict())
    try:
        for p in payloads:
            worker._handle_payload(p)
        worker.start()
        assert worker.drain(timeout_s=60.0)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                beats and beats[-1].get("tasks_processed") == 3
                and len(spans) >= 1):
            time.sleep(0.01)
        time.sleep(3 * BEAT)
    finally:
        worker.stop()
        bus.close()
        torch.set_num_threads(n)
    assert beats[-1]["message_type"] == "worker_stopping"
    return dict(beats=json.loads(json.dumps(beats)),
                spans=json.loads(json.dumps(spans)),
                trace_ids=[p["trace_id"] for p in payloads])


def _fleet_views():
    return {"ref": (jfleet.FleetView(registry=jmet.MetricsRegistry()), jmsg),
            "port": (tfleet.FleetView(registry=tmet.MetricsRegistry()), tmsg)}


def test_port_worker_heartbeats_fold_as_the_reference(worker_frames):
    out = {}
    for name, (fv, msgs) in _fleet_views().items():
        last = None
        accepted = []
        for b in worker_frames["beats"]:
            msg = msgs.StatusMessage.from_dict(b)
            last = msg.timestamp + timedelta(seconds=0.25)
            accepted.append(fv.observe(msg, now=last))
        out[name] = dict(accepted=accepted, body=fv.export(now=last),
                         offsets=fv.clock_offsets(),
                         metrics=sorted(
                             line for line in fv.m_queue.expose().split("\n")
                             + fv.m_devmem.expose().split("\n")
                             + fv.m_rss.expose().split("\n")
                             + fv.m_mfu.expose().split("\n")
                             if line and not line.startswith("#")))
    assert out["port"] == out["ref"]
    row = out["port"]["body"]["workers"]["tpu-w"]
    assert row["worker_type"] == "tpu" and row["status"] == "offline"
    assert row["tasks"]["processed"] == 3
    assert row["clock_offset_s"] == 0.25
    assert row["telemetry"]["rss_bytes"] > 0


def _hb(msgs, worker_id="w1", ts=None, status="idle", processed=0, error=0,
        queue_length=0, usage=None, worker_type="crawl",
        message_type="heartbeat"):
    msg = msgs.StatusMessage.new(worker_id, message_type, status,
                                 tasks_processed=processed,
                                 tasks_success=processed - error,
                                 tasks_error=error, worker_type=worker_type)
    msg.queue_length = queue_length
    msg.resource_usage = usage or {}
    if ts is not None:
        msg.timestamp = ts
    return msg


def _fleet_script(name, view, msgs, t0):
    """The reference's TestFleetView cases; returns what each observes."""
    s = timedelta(seconds=1)
    recv = t0 + timedelta(seconds=0.5)   # one receive wall for every beat

    class fv:  # noqa: N801 (the fleet view, observing at ``recv``)
        observe = staticmethod(lambda m: view.observe(m, now=recv))
        export = view.export
        stale_count = view.stale_count
        refresh_staleness = view.refresh_staleness

    if name == "fold_and_rates":
        got = [fv.observe(_hb(msgs, ts=t0)),
               fv.observe(_hb(msgs, ts=t0 + 10 * s, processed=5, error=1))]
        return got, fv.export(now=t0 + 10 * s)
    if name == "restart_counter_reset":
        fv.observe(_hb(msgs, ts=t0, processed=500, error=10))
        fv.observe(_hb(msgs, ts=t0 + 10 * s, processed=3))
        return fv.export(now=t0 + 10 * s)
    if name == "out_of_order_dropped":
        fv.observe(_hb(msgs, ts=t0, status="busy", processed=9))
        got = fv.observe(_hb(msgs, ts=t0 - 30 * s, processed=2))
        return got, fv.export(now=t0)
    if name == "staleness_rollup":
        fv.observe(_hb(msgs, worker_id="fresh", ts=t0))
        fv.observe(_hb(msgs, worker_id="dead", ts=t0 - 301 * s))
        return fv.export(now=t0), fv.stale_count(now=t0)
    if name == "stopping_marks_offline_and_history":
        fv.observe(_hb(msgs, ts=t0))
        fv.observe(_hb(msgs, ts=t0 + s))
        fv.observe(_hb(msgs, ts=t0 + 2 * s, status="busy", queue_length=3))
        fv.observe(_hb(msgs, ts=t0 + 3 * s, status="offline",
                       message_type="worker_stopping"))
        return fv.export(now=t0 + 3 * s)
    if name == "gauges_labeled_per_worker":
        fv.observe(_hb(msgs, worker_id="tpu-1", worker_type="tpu",
                       queue_length=7, ts=t0, usage={
                           "rss_bytes": 2048,
                           "efficiency": {"mfu": 0.4,
                                          "goodput_tokens_per_s": 12.0},
                           "device_memory": [
                               {"device": "cuda:0", "bytes_in_use": 100,
                                "bytes_limit": 1000,
                                "peak_bytes_in_use": 150},
                               {"device": "cuda:1", "bytes_in_use": 50,
                                "bytes_limit": 1000,
                                "peak_bytes_in_use": 60}]}))
        return fv.export(now=t0)
    if name == "refresh_staleness":
        fv.observe(_hb(msgs, worker_id="dead", ts=t0 - 400 * s))
        return fv.refresh_staleness(now=t0), fv.export(now=t0)
    if name == "long_gone_evicted":
        fv.observe(_hb(msgs, worker_id="gone", queue_length=5,
                       usage={"rss_bytes": 1}, ts=t0 - 3001 * s))
        fv.observe(_hb(msgs, worker_id="alive", ts=t0))
        return fv.refresh_staleness(now=t0), fv.export(now=t0)
    if name == "telemetry_kept_verbatim":
        usage = {"compile_cache": {"misses_delta": 0.0},
                 "latency_ms": {"engine.compute": {
                     "count": 2, "p50_ms": 1.0, "p95_ms": 2.0,
                     "max_ms": 2.0}}}
        fv.observe(_hb(msgs, ts=t0, usage=usage))
        return fv.export(now=t0)
    raise KeyError(name)


FLEET_CASES = ["fold_and_rates", "restart_counter_reset",
               "out_of_order_dropped", "staleness_rollup",
               "stopping_marks_offline_and_history",
               "gauges_labeled_per_worker", "refresh_staleness",
               "long_gone_evicted", "telemetry_kept_verbatim"]


def _gauge_lines(fv):
    out = []
    for g in (fv.m_queue, fv.m_devmem, fv.m_rss, fv.m_mfu, fv.m_goodput,
              fv.m_stale):
        out += [line for line in g.expose().split("\n")
                if line and not line.startswith("#")]
    return out


@pytest.mark.parametrize("case", FLEET_CASES)
def test_fleet_view_case_matches_the_reference(case):
    t0 = tmsg.codec.utcnow()
    out = {}
    for name, (fv, msgs) in _fleet_views().items():
        got = _fleet_script(case, fv, msgs, t0)
        out[name] = (json.loads(json.dumps(got, default=str)),
                     _gauge_lines(fv))
    assert out["port"] == out["ref"]


def test_fleet_view_pins_the_reference_assertions():
    t0 = tmsg.codec.utcnow()
    fv, msgs = tfleet.FleetView(registry=tmet.MetricsRegistry()), tmsg
    (got, body) = _fleet_script("fold_and_rates", fv, msgs, t0)
    assert body["workers"]["w1"]["rates"] == {"tasks_per_s": 0.5,
                                              "errors_per_s": 0.1}
    fv = tfleet.FleetView(registry=tmet.MetricsRegistry())
    body = _fleet_script("stopping_marks_offline_and_history", fv, msgs, t0)
    assert [h[1] for h in body["workers"]["w1"]["history"]] == [
        "idle", "busy", "offline"]
    fv = tfleet.FleetView(registry=tmet.MetricsRegistry())
    _fleet_script("gauges_labeled_per_worker", fv, msgs, t0)
    lines = _gauge_lines(fv)
    assert ('fleet_worker_device_mem_bytes'
            '{kind="in_use",worker_id="tpu-1"} 150.0') in lines
    assert 'fleet_worker_queue_length{worker_id="tpu-1"} 7.0' in lines
    fv = tfleet.FleetView(registry=tmet.MetricsRegistry())
    n, body = _fleet_script("long_gone_evicted", fv, msgs, t0)
    assert set(body["workers"]) == {"alive"}
    assert not any('"gone"' in line for line in _gauge_lines(fv))


# -- the trace collector ------------------------------------------------------------
def _row(trace_id="t1", span_id="s1", start_wall=100.0, duration_ms=2.0,
         name="tpu_worker.process"):
    return {"name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": "", "start_wall": start_wall,
            "duration_ms": duration_ms, "attrs": {}}


def _batch(msgs, worker_id, rows, sent_wall=0.0):
    """A span batch with a fixed send wall (0: no send-wall estimate)."""
    msg = msgs.SpanBatchMessage.new(worker_id, rows)
    msg.sent_wall = sent_wall
    return msg


def _collectors(offsets=None):
    jtracer = jtrace.Tracer(capacity=16)
    ttrace.TRACER.reset()
    return {"ref": (jtc.TraceCollector(offsets_fn=offsets,
                                       process="orchestrator",
                                       tracer=jtracer,
                                       registry=jmet.MetricsRegistry()),
                    jmsg, jtracer),
            "port": (ttc.TraceCollector(offsets_fn=offsets),
                     tmsg, ttrace.TRACER)}


def _trace_script(case, col, msgs, tracer):
    if case == "skewed_clock_corrected_via_fleet_offsets":
        col.observe(_batch(msgs, "w-skew", [_row(
            start_wall=10_000.0 - 120.0)]), now=10_000.0)
    elif case == "sent_wall_fallback":
        col.observe(_batch(msgs, "w2", [_row(start_wall=9_940.0)],
                           sent_wall=9_940.0), now=10_000.0)
    elif case == "local_spans_merge_and_dedup":
        with tracer.span("orchestrator.dispatch", trace_id="t1"):
            pass
        local = tracer.spans()[0].to_dict()
        col.observe(_batch(msgs, "tpu-1", [local, _row(span_id="w-span")]),
                    now=time.time())
        out = col.export()
        # The local span's wall is this run's; keep the structure.
        return [(t["span_count"], t["processes"]) for t in out["traces"]]
    elif case == "trace_lru_bound":
        for i in range(515):
            col.observe(_batch(msgs, "w", [_row(
                trace_id=f"t{i}", span_id=f"s{i}")]), now=float(i))
    elif case == "per_trace_span_bound":
        col.observe(_batch(
            msgs, "w", [_row(span_id=f"s{i}") for i in range(515)]), now=1.0)
    elif case == "export_sorted_by_corrected_wall":
        col.observe(_batch(msgs, "w", [
            _row(span_id="late", start_wall=50.0),
            _row(span_id="early", start_wall=10.0)]), now=60.0)
    else:
        raise KeyError(case)
    out = col.export()
    return dict(n=len(out["traces"]), first=out["traces"][0],
                limited=col.export(limit=2)["traces"][-1]["trace_id"],
                workers=out["workers"], max=out["max_traces"])


TRACE_CASES = ["skewed_clock_corrected_via_fleet_offsets",
               "sent_wall_fallback", "local_spans_merge_and_dedup",
               "trace_lru_bound", "per_trace_span_bound",
               "export_sorted_by_corrected_wall"]


@pytest.mark.parametrize("case", TRACE_CASES)
def test_trace_collector_case_matches_the_reference(case):
    offsets = (lambda: {"w-skew": 120.0}) if case.startswith("skewed") \
        else (lambda: {})
    out = {name: _trace_script(case, col, msgs, tracer)
           for name, (col, msgs, tracer) in _collectors(offsets).items()}
    assert out["port"] == out["ref"]
    if case.startswith("skewed"):
        span = out["port"]["first"]["spans"][0]
        assert span["start_wall"] == 10_000.0
        assert span["clock_offset_s"] == 120.0
    if case == "trace_lru_bound":
        assert out["port"]["n"] == 512
        assert out["port"]["first"]["trace_id"] == "t514"
    if case == "per_trace_span_bound":
        assert out["port"]["first"]["span_count"] == 512
        assert out["port"]["first"]["dropped_spans"] == 3


def test_port_worker_span_batches_assemble_as_the_reference(worker_frames):
    offsets = {"tpu-w": 0.5}
    out = {}
    for name, (col, msgs, _) in _collectors(lambda: offsets).items():
        for i, s in enumerate(worker_frames["spans"]):
            col.observe(msgs.SpanBatchMessage.from_dict(s),
                        now=s["sent_wall"] + 0.5)
        body = col.export()
        out[name] = body
    assert out["port"] == out["ref"]
    traces = {t["trace_id"]: t for t in out["port"]["traces"]}
    assert set(worker_frames["trace_ids"]) <= set(traces)
    assert all(s["clock_offset_s"] == 0.5
               for t in traces.values() for s in t["spans"])


# -- through the orchestrators' bus handlers --------------------------------------------
def test_orchestrators_serve_the_port_worker_frames_alike(worker_frames,
                                                           tmp_path):
    from distributed_crawler_tpu.config.crawler import (
        CrawlerConfig as JCfg,
    )
    from distributed_crawler_tpu.orchestrator import Orchestrator as JOrch
    from distributed_crawler_tpu_torch.config.crawler import (
        CrawlerConfig as TCfg,
    )
    from distributed_crawler_tpu_torch.orchestrator import (
        CrawlJournal,
    )
    from distributed_crawler_tpu_torch.orchestrator import (
        Orchestrator as TOrch,
    )
    from distributed_crawler_tpu_torch.utils import metrics as tm

    orchs = {"ref": JOrch("c1", JCfg(crawl_id="c1"), None, None,
                          registry=jmet.MetricsRegistry(), alert_rules=[]),
             "port": TOrch("c1", TCfg(crawl_id="c1"), None, None,
                           journal=CrawlJournal(str(tmp_path / "journal")),
                           alert_rules=[])}
    out = {}
    for name, orch in orchs.items():
        for b in worker_frames["beats"]:
            orch.handle_status_payload(b)
        for s in worker_frames["spans"]:
            orch.handle_spans_payload(s)
        cluster = orch.get_cluster()
        row = cluster["workers"]["tpu-w"]
        traces = orch.get_dtraces()["traces"]
        out[name] = dict(
            keys=sorted(cluster), fleet=sorted(cluster["fleet"]),
            orch=sorted(cluster["orchestrator"]), row=sorted(row),
            status=row["status"], tasks=row["tasks"],
            telemetry=sorted(row["telemetry"]),
            traces=sorted(t["trace_id"] for t in traces),
            spans=sorted(len(t["spans"]) for t in traces),
            workers=orch.get_status()["tpu_worker_count"])
    assert out["port"] == out["ref"]
    # /cluster and /dtraces over HTTP from the port's providers.
    orch = orchs["port"]
    server = tm.serve_metrics(0, tm.MetricsRegistry())
    url = f"http://127.0.0.1:{server.server_address[1]}"
    tm.set_cluster_provider(orch.get_cluster)
    tm.set_dtraces_provider(orch.get_dtraces)
    try:
        with urllib.request.urlopen(url + "/cluster", timeout=10) as r:
            assert "tpu-w" in json.loads(r.read())["workers"]
        with urllib.request.urlopen(url + "/dtraces?limit=1",
                                    timeout=10) as r:
            assert len(json.loads(r.read())["traces"]) == 1
    finally:
        tm.clear_cluster_provider(orch.get_cluster)
        tm.clear_dtraces_provider(orch.get_dtraces)
        server.shutdown()
        server.server_close()

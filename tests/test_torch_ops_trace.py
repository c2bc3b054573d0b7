"""The port's tracing, SLO, time-series, queue-depth and flight-recorder
modules against the JAX package's, on the CPU.

Each case feeds the same spans, budgets, metric operations, edges or
events (seeded with numpy, on explicit timestamps or a fake clock) to both
packages and requires equal results: latency digests, trace exports, the
spans a `SpanExporter` ships, SLO breaches and counter values, sampled
series and time-weighted means.  Across the packages, a port
`SpanBatchMessage` must assemble into one trace per batch in the
reference's `TraceCollector`, and a port flight bundle must render with
`tools/postmortem.py`.
"""

import faulthandler
import json
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.utils import flight as tflight  # noqa: E402
from distributed_crawler_tpu_torch.utils import metrics as tmet  # noqa: E402
from distributed_crawler_tpu_torch.utils import occupancy as tocc  # noqa: E402
from distributed_crawler_tpu_torch.utils import slo as tslo  # noqa: E402
from distributed_crawler_tpu_torch.utils import timeseries as tts  # noqa: E402
from distributed_crawler_tpu_torch.utils import trace as ttrace  # noqa: E402

jtrace = pytest.importorskip("distributed_crawler_tpu.utils.trace")
jmet = pytest.importorskip("distributed_crawler_tpu.utils.metrics")
jslo = pytest.importorskip("distributed_crawler_tpu.utils.slo")
jts = pytest.importorskip("distributed_crawler_tpu.utils.timeseries")
jocc = pytest.importorskip("distributed_crawler_tpu.utils.occupancy")
jmsg = pytest.importorskip("distributed_crawler_tpu.bus.messages")
jcollect = pytest.importorskip("distributed_crawler_tpu.orchestrator."
                               "tracecollect")
postmortem = pytest.importorskip("tools.postmortem")

NAMES = ["tpu_worker.process", "tpu_worker.coalesce", "tpu_worker.queue_wait",
         "tpu_worker.batch_age", "engine.compute", "engine.unpack",
         "asr_worker.process", "cluster_worker.process", "bus.deliver"]
T0 = 1_700_000_000.0


def _span_rows(seed, n=120, traces=9):
    """Seeded span dicts (the wire form) over a few traces and tenants."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append({
            "name": NAMES[int(rng.integers(len(NAMES)))],
            "trace_id": f"trace_{int(rng.integers(traces))}",
            "span_id": f"sp_{i:04d}",
            "parent_id": "",
            "start_wall": T0 + float(rng.uniform(0, 10)),
            "duration_ms": round(float(rng.exponential(40.0)), 3),
            "attrs": {"tenant": ["a", "b", ""][int(rng.integers(3))],
                      "i": i},
        })
    return rows


def _tracers(rows, capacity=2048):
    """A tracer per package holding ``rows`` in order."""
    out = []
    for mod in (jtrace, ttrace):
        tr = mod.Tracer(capacity=capacity)
        for r in rows:
            tr._finish(mod.span_from_dict(r))
        out.append(tr)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_digest_and_export_equal(seed):
    rows = _span_rows(seed)
    ref, port = _tracers(rows)
    for since in (0.0, T0 + 5.0):
        assert ttrace.latency_digest(port.spans(), since_wall=since) == \
            jtrace.latency_digest(ref.spans(), since_wall=since)
    for limit in (0, 3):
        assert port.export(limit=limit) == ref.export(limit=limit)
    # A ring smaller than the stream keeps the same newest spans.
    ref, port = _tracers(rows, capacity=16)
    assert port.export() == ref.export()


def test_span_dict_round_trip_and_context():
    row = _span_rows(3, n=1)[0]
    assert ttrace.span_from_dict(row).to_dict() == row
    assert ttrace.current_trace_id() == ""
    with ttrace.span("outer", trace_id="trace_x") as sp:
        sp.set(late=True)
        assert (ttrace.current_trace_id(), ttrace.current_span_name()) == \
            ("trace_x", "outer")
        assert ttrace.current_span_id() == sp.span_id
    got = [s for s in ttrace.TRACER.spans() if s.span_id == sp.span_id]
    assert got and got[0].attrs == {"late": True}


@pytest.mark.parametrize("rate,prefixes,max_spans", [
    (1.0, (), 512), (0.5, (), 512), (0.0, (), 512),
    (1.0, ("tpu_worker.", "engine."), 512), (0.7, ("tpu_worker.",), 10)])
def test_span_exporter_ships_the_same_spans(rate, prefixes, max_spans):
    rows = _span_rows(4, n=200, traces=40)
    ref, port = _tracers(rows[:50], capacity=120)
    exporters = [mod.SpanExporter(tracer=tr, max_spans=max_spans,
                                  sample_rate=rate, name_prefixes=prefixes)
                 for mod, tr in ((jtrace, ref), (ttrace, port))]
    for chunk in (rows[50:80], rows[80:200], []):
        for mod, tr in ((jtrace, ref), (ttrace, port)):
            for r in chunk:
                tr._finish(mod.span_from_dict(r))
        (rs, rd), (ps, pd) = (e.collect() for e in exporters)
        assert [s.to_dict() for s in ps] == [s.to_dict() for s in rs]
        assert pd == rd
    assert all(exporters[1].keeps(r["trace_id"]) ==
               exporters[0].keeps(r["trace_id"]) for r in rows)


def test_port_span_batch_assembles_in_the_reference_collector():
    """Spans of two batches, exported by the port, fold into one trace per
    batch in the reference's TraceCollector."""
    tracer = ttrace.Tracer()
    exporter = ttrace.SpanExporter(tracer=tracer,
                                   name_prefixes=("tpu_worker.", "engine."))
    for tid in ("trace_batch_a", "trace_batch_b"):
        with tracer.span("tpu_worker.process", trace_id=tid):
            with tracer.span("engine.compute", bucket=32):
                pass
        tracer.record("tpu_worker.queue_wait", 0.004, trace_id=tid)
    with tracer.span("bus.deliver", trace_id="trace_batch_a"):
        pass  # another component's span: not this exporter's
    spans, dropped = exporter.collect()
    msg = tmsg.SpanBatchMessage.new("tpu-w", [s.to_dict() for s in spans],
                                    dropped=dropped)
    msg.validate()
    wire = json.loads(json.dumps(msg.to_dict()))
    ref_msg = jmsg.SpanBatchMessage.from_dict(wire)
    ref_msg.validate()
    assert ref_msg.to_dict() == wire
    collector = jcollect.TraceCollector(tracer=jtrace.Tracer(),
                                        registry=jmet.MetricsRegistry())
    assert collector.observe(ref_msg) == 6
    traces = {t["trace_id"]: t for t in collector.export()["traces"]}
    assert set(traces) == {"trace_batch_a", "trace_batch_b"}
    for t in traces.values():
        assert t["processes"] == ["tpu-w"]
        assert sorted(r["name"] for r in t["spans"]) == [
            "engine.compute", "tpu_worker.process", "tpu_worker.queue_wait"]
        compute = [r for r in t["spans"] if r["name"] == "engine.compute"][0]
        parent = [r for r in t["spans"]
                  if r["name"] == "tpu_worker.process"][0]
        assert compute["parent_id"] == parent["span_id"]
    # And the reverse: a reference batch decodes in the port.
    back = tmsg.SpanBatchMessage.from_dict(ref_msg.to_dict())
    assert back.to_dict() == wire


@pytest.mark.parametrize("budgets", [
    dict(batch_p95_ms=30.0),
    dict(batch_p95_ms=1e6, queue_wait_ms=10.0, batch_age_ms=50.0,
         asr_batch_p95_ms=20.0),
    dict()])
def test_slo_watchdog_breaches_equal(budgets):
    rows = _span_rows(6, n=300)
    ref_tr, port_tr = _tracers(rows)
    dogs = []
    for mod, met, tr in ((jslo, jmet, ref_tr), (tslo, tmet, port_tr)):
        reg = met.MetricsRegistry()
        dog = mod.SLOWatchdog(mod.standard_slos(**budgets), tracer=tr,
                              registry=reg)
        dog._last_eval = T0 + 2.0
        dogs.append((dog, reg))
    for now in (T0 + 6.0, T0 + 9.0, T0 + 30.0):
        (rd, rreg), (pd, preg) = dogs
        assert pd.evaluate(now=now) == rd.evaluate(now=now)
        assert pd.snapshot() == rd.snapshot()
        assert preg.expose() == rreg.expose()
    assert tslo.standard_slos(**budgets) == [
        tslo.SLO(s.name, s.span_names, s.budget_ms)
        for s in jslo.standard_slos(**budgets)]


def test_slo_watchdog_with_recording_off_evaluates_nothing():
    tr = ttrace.Tracer(capacity=0)
    dog = tslo.SLOWatchdog(tslo.standard_slos(batch_p95_ms=1.0), tracer=tr,
                           registry=tmet.MetricsRegistry())
    assert dog.evaluate() == []


def _drive(reg, seed):
    rng = np.random.default_rng(seed)
    c = reg.counter("ops_total", "ops")
    g = reg.gauge("ops_gauge", "a gauge")
    h = reg.histogram("ops_seconds", "a histogram")
    for _ in range(20):
        label = ["32", "64", 'q"uote'][int(rng.integers(3))]
        value = float(rng.exponential(0.3))
        c.labels(bucket=label).inc(value)
        g.labels(path=label).set(value)
        h.observe(value)


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_sampler_series_equal(seed):
    bodies = []
    for mod, met in ((jts, jmet), (tts, tmet)):
        reg = met.MetricsRegistry()
        store = mod.TimeSeriesStore(clock=lambda: T0 + 100.0)
        sampler = mod.RegistrySampler(reg, store=store)
        for tick in range(4):
            _drive(reg, seed + tick)
            sampler.sample(now=T0 + 10.0 * tick)
        bodies.append([store.snapshot(),
                       store.snapshot(series="ops_total", window_s=20.0),
                       store.snapshot(since_s=75.0),
                       store.increase("ops_total", window_s=25.0),
                       store.keys()])
    assert bodies[1] == bodies[0]


def test_queue_depth_sampler_time_weighted_mean_equal():
    rng = np.random.default_rng(7)
    edges = np.cumsum(rng.exponential(0.8, size=400))
    depths = rng.integers(0, 64, size=400)
    out = []
    for mod, met in ((jocc, jmet), (tocc, tmet)):
        now = [0.0]
        gauge = met.MetricsRegistry().gauge("q")
        qs = mod.QueueDepthSampler(gauge, window_s=30.0,
                                   clock=lambda: now[0], max_events=128)
        seen = []
        for t, d in zip(edges, depths):
            now[0] = float(t)
            qs.update(int(d))
            seen.append(gauge.value)
            if d % 5 == 0:
                now[0] += 2.0
                seen.append(qs.sample())
        now[0] += 100.0  # a queue gone quiet decays to its last depth
        seen.append(qs.sample())
        seen.append(qs.current())
        out.append(seen)
    assert out[1] == out[0]


@pytest.fixture
def recorder(tmp_path):
    rec = tflight.FlightRecorder(capacity=8)
    rec.configure(dump_dir=str(tmp_path), fingerprint={"mode": "tpu-worker"})
    return rec


def test_flight_bundle_renders_with_postmortem(recorder, tmp_path, capsys):
    for i in range(12):
        recorder.record("batch", batch=f"b{i}", outcome="ok")
    recorder.record("slo_breach", slo="batch_p95", p95_ms=12.5,
                    budget_ms=1.0, spans=3, worst_span="tpu_worker.process",
                    worst_ms=13.0, trace_id="trace_x")
    assert len(recorder.events()) == 8  # the ring keeps the newest
    path = recorder.dump("sigterm", error="test")
    assert path and recorder.dump("sigterm") is None  # one per reason
    bundle = json.loads(open(path, encoding="utf-8").read())
    assert bundle["schema"] == "dct-postmortem-v1"
    assert bundle["config"] == {"mode": "tpu-worker"}
    assert {"flight", "traces", "metrics"} <= set(bundle)
    assert postmortem.main([path]) == 0
    assert "slo_breach" in capsys.readouterr().out


def test_flight_install_chains_and_dumps(tmp_path, monkeypatch):
    """Arming the hooks chains the previous excepthooks; the test restores
    them."""
    calls = []
    monkeypatch.setattr(sys, "excepthook",
                        lambda *a: calls.append("sys"))
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: calls.append("thread"))
    monkeypatch.setattr(tflight, "_installed", False)
    monkeypatch.setattr(tflight, "_fault_log", None)
    armed = []
    monkeypatch.setattr(faulthandler, "enable",
                        lambda file=None, **kw: armed.append(file))
    rec = tflight.FlightRecorder()
    try:
        tflight.install(str(tmp_path), recorder=rec)
        sys.excepthook(ValueError, ValueError("boom"), None)
        t = threading.Thread(target=lambda: 1 / 0)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        if tflight._fault_log is not None:
            tflight._fault_log.close()
    assert calls == ["sys", "thread"]
    assert len(armed) == 1
    dumps = sorted(p.name for p in tmp_path.iterdir())
    assert any(n.endswith("_unhandled_exception.json") for n in dumps)
    assert "fatal_signal.log" in dumps

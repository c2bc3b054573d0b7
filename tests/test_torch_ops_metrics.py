"""The port's metrics registry and HTTP routes against the JAX package's,
on the CPU.

The same sequence of counter, gauge and histogram operations, labelled and
unlabelled (label values and help text that need escaping included), must
expose equal samples under the reference's `parse_exposition`; the routes
`serve_metrics` answers (bound to port 0) must give the same status codes
and JSON keys, and the orchestrator's routes answer 404 in the port.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from distributed_crawler_tpu_torch.utils import exposition as texpo  # noqa: E402
from distributed_crawler_tpu_torch.utils import metrics as tmet  # noqa: E402

jmet = pytest.importorskip("distributed_crawler_tpu.utils.metrics")
jexpo = pytest.importorskip("distributed_crawler_tpu.utils.exposition")

LABELS = ["32", "64", 'a "quoted" value', "back\\slash", "new\nline"]


def _drive(reg, seed):
    """A seeded sequence of metric operations on ``reg``."""
    rng = np.random.default_rng(seed)
    c = reg.counter("ops_total", 'ops with a "help" text\nand a newline')
    g = reg.gauge("ops_gauge", "a gauge")
    h = reg.histogram("ops_seconds", "a histogram")
    hb = reg.histogram("ops_custom_seconds", "custom buckets",
                       buckets=(0.5, 0.1, 2.0))
    for _ in range(60):
        op = int(rng.integers(6))
        label = LABELS[int(rng.integers(len(LABELS)))]
        value = float(rng.exponential(0.3))
        if op == 0:
            c.inc(value)
        elif op == 1:
            c.labels(bucket=label, path="packed").inc()
        elif op == 2:
            g.labels(path=label).set(value)
        elif op == 3:
            g.set(-value)
        elif op == 4:
            h.labels(bucket=label).observe(value)
        else:
            (hb if rng.integers(2) else h).observe(value)


def _samples(text):
    return [(s.name, s.labels, s.value)
            for s in jexpo.parse_exposition(text)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_samples_equal(seed):
    ref, port = jmet.MetricsRegistry(), tmet.MetricsRegistry()
    _drive(ref, seed)
    _drive(port, seed)
    text = port.expose()
    assert _samples(text) == _samples(ref.expose())
    # The port's own parser reads its exposition as the reference's does.
    assert [(s.name, s.labels, s.value, s.labels_str)
            for s in texpo.parse_exposition(text)] == \
        [(s.name, s.labels, s.value, s.labels_str)
         for s in jexpo.parse_exposition(text)]
    assert text == ref.expose()


def test_registry_type_clash_and_child_labels_raise():
    reg = tmet.MetricsRegistry()
    reg.counter("x_total")
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    child = reg.counter("x_total").labels(a="1")
    with pytest.raises(ValueError):
        child.labels(b="2")


def test_timer_observes_elapsed_seconds():
    h = tmet.MetricsRegistry().histogram("t_seconds")
    with tmet.Timer(h):
        pass
    assert h.count == 1 and 0 <= h.window()[0] < 1.0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _keys(body):
    try:
        doc = json.loads(body)
    except ValueError:
        return None
    return sorted(doc) if isinstance(doc, dict) else type(doc).__name__


@pytest.fixture
def both_servers():
    """One server per package on port 0, with the same /status, /costs and
    /clusters providers registered the way the workers register them."""
    status = lambda: {"worker_id": "w", "processed_batches": 3}  # noqa: E731
    costs = lambda: {"worker_id": "w", "costs": [], "efficiency": {}}  # noqa: E731
    clusters = lambda: {"k": 4, "sizes": [1, 2, 3, 4]}  # noqa: E731
    servers, regs = {}, {}
    for name, mod in (("ref", jmet), ("port", tmet)):
        regs[name] = mod.MetricsRegistry()
        _drive(regs[name], 5)
        mod.set_status_provider(status)
        mod.set_costs_provider(costs)
        mod.set_clusters_provider(clusters)
        servers[name] = mod.serve_metrics(0, regs[name])
    try:
        yield {k: f"http://127.0.0.1:{s.server_address[1]}"
               for k, s in servers.items()}
    finally:
        for mod, s in ((jmet, servers["ref"]), (tmet, servers["port"])):
            mod.clear_status_provider(status)
            mod.clear_costs_provider(costs)
            mod.clear_clusters_provider(clusters)
            s.shutdown()
            s.server_close()


ROUTES = ["/healthz", "/health", "/", "/metrics", "/status", "/costs",
          "/traces", "/traces?limit=2", "/timeseries",
          "/timeseries?series=x&window=5", "/clusters", "/logs",
          "/logs?limit=2", "/no-such-route",
          "/profile?seconds=nan", "/profile?seconds=abc"]


@pytest.mark.parametrize("route", ROUTES)
def test_routes_answer_as_the_reference(both_servers, route):
    got = {k: _get(url + route) for k, url in both_servers.items()}
    (rc, rb), (pc, pb) = got["ref"], got["port"]
    assert pc == rc
    assert _keys(pb) == _keys(rb)
    if route == "/metrics":
        assert _samples(pb.decode()) == _samples(rb.decode())
    if route.startswith(("/status", "/costs", "/clusters", "/health")):
        assert pb == rb


@pytest.mark.parametrize("route", ["/dtraces", "/dlq", "/alerts", "/shards",
                                   "/autoscaler", "/tenants", "/cluster"])
def test_orchestrator_routes_wait(both_servers, route):
    assert _get(both_servers["port"] + route)[0] == 404


def test_provider_failure_is_a_500_and_clearing_is_owner_only():
    reg = tmet.MetricsRegistry()

    def broken():
        raise RuntimeError("provider broke")

    tmet.set_costs_provider(broken)
    server = tmet.serve_metrics(0, reg)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body = _get(url + "/costs")
        assert code == 500 and json.loads(body) == {"error": "provider broke"}
        tmet.clear_costs_provider(lambda: {})  # not the active one
        assert _get(url + "/costs")[0] == 500
        tmet.clear_costs_provider(broken)
        assert _get(url + "/costs")[0] == 404
    finally:
        tmet.clear_costs_provider(broken)
        server.shutdown()
        server.server_close()


def test_server_providers_win_over_the_globals():
    """Two workers in one process each serve their own maps."""
    tmet.set_status_provider(lambda: {"who": "global"})
    mine = tmet.serve_metrics(0, tmet.MetricsRegistry(),
                              providers={"status": lambda: {"who": "mine"}})
    other = tmet.serve_metrics(0, tmet.MetricsRegistry())
    try:
        for server, who in ((mine, "mine"), (other, "global")):
            code, body = _get(
                f"http://127.0.0.1:{server.server_address[1]}/status")
            assert code == 200 and json.loads(body) == {"who": who}
    finally:
        tmet.set_status_provider(None)
        for s in (mine, other):
            s.shutdown()
            s.server_close()

"""The port's structured logging (`utils/structlog.py`) and its ``/logs``
route against the JAX package's, on the CPU.

The same `logging.LogRecord` goes through both packages' formatters and
rings; the lines and the ring records must be equal, exactly (the JSON
line's whole-second ``ts`` is read from the clock, so it is compared
after both are taken from one record).  ``/logs`` on the port's metrics
server must answer with the reference's body for the same records, and
the port's postmortem bundle must carry the same ``logs`` section.

Both packages' `setup_logging` configure the one ``"dct"`` logger tree
(``propagate = False`` hides its records from ``caplog``), and each keeps
a process-wide ring.  `restored_logging` saves and restores all of it
around every test here and in `tests/test_torch_cli.py`, so these tests
leave no state behind for the tests that share their process.
"""

import contextlib
import json
import logging
import urllib.request

import pytest

from distributed_crawler_tpu.utils import flight as jflight
from distributed_crawler_tpu.utils import metrics as jmet
from distributed_crawler_tpu.utils import structlog as jstruct
from distributed_crawler_tpu.utils import trace as jtrace
from distributed_crawler_tpu_torch.utils import flight as tflight
from distributed_crawler_tpu_torch.utils import metrics as tmet
from distributed_crawler_tpu_torch.utils import structlog as tstruct
from distributed_crawler_tpu_torch.utils import trace as ttrace


def logging_state():
    """What either package's `setup_logging` changes: the "dct" logger's
    handlers, level and propagate, and each package's ring."""
    log = logging.getLogger("dct")
    return (list(log.handlers), log.level, log.propagate,
            tstruct._ring_handler, jstruct._ring_handler)


@contextlib.contextmanager
def restored_logging():
    """Run the block, then put the "dct" logger tree and both rings back
    as they were."""
    log = logging.getLogger("dct")
    rings = []
    for mod in (tstruct, jstruct):
        handler = mod.uninstall_ring_handler()
        mod.reinstall_ring_handler(handler)
        rings.append((mod, handler))
    handlers, level, propagate = list(log.handlers), log.level, log.propagate
    try:
        yield
    finally:
        for mod, handler in rings:
            mod.uninstall_ring_handler()
            mod.reinstall_ring_handler(handler)
        log.handlers[:] = handlers
        log.setLevel(level)
        log.propagate = propagate


@pytest.fixture(autouse=True)
def _logging_restored():
    with restored_logging():
        yield


@contextlib.contextmanager
def fresh_rings():
    """Both packages' rings, new and empty, on the "dct" tree."""
    for mod in (tstruct, jstruct):
        mod.uninstall_ring_handler()
    yield tstruct.install_ring_handler(), jstruct.install_ring_handler()


def _record(level=logging.WARNING, msg="batch %s slow", args=("b1",),
            exc=False, **extra):
    exc_info = None
    if exc:
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            import sys

            exc_info = sys.exc_info()
    rec = logging.LogRecord("dct.torch.worker", level, __file__, 10, msg,
                            args, exc_info)
    for k, v in extra.items():
        setattr(rec, k, v)
    return rec


RECORDS = {
    "plain": dict(),
    "extras": dict(worker="w0", queue_depth=3),
    "exception": dict(exc=True),
    "error_level": dict(level=logging.ERROR, msg="no args", args=()),
}


@pytest.mark.parametrize("name", sorted(RECORDS))
@pytest.mark.parametrize("in_span", [False, True])
def test_formatters_and_ring_equal(name, in_span):
    rec = _record(**RECORDS[name])
    with contextlib.ExitStack() as stack:
        if in_span:
            stack.enter_context(ttrace.span("stage", trace_id="t" * 32))
            stack.enter_context(jtrace.span("stage", trace_id="t" * 32))
        t_json = json.loads(tstruct.JsonFormatter().format(rec))
        j_json = json.loads(jstruct.JsonFormatter().format(rec))
        t_console = tstruct.ConsoleFormatter().format(rec)
        j_console = jstruct.ConsoleFormatter().format(rec)
        t_ring, j_ring = tstruct.RingHandler(4), jstruct.RingHandler(4)
        t_ring.emit(rec)
        j_ring.emit(rec)
    assert abs(t_json.pop("ts") - j_json.pop("ts")) <= 1
    assert t_json == j_json
    assert t_console == j_console
    assert t_ring.snapshot() == j_ring.snapshot()
    if in_span:
        assert t_json["trace_id"] == "t" * 32 and t_json["span"] == "stage"


def test_ring_keeps_the_newest_warnings():
    t_ring, j_ring = tstruct.RingHandler(3), jstruct.RingHandler(3)
    logger = logging.getLogger("dct.test.ring")
    for i in range(5):
        for ring in (t_ring, j_ring):
            logger.addHandler(ring)
        logger.warning("w%d", i)
        logger.info("quiet %d", i)  # below the ring's level
        for ring in (t_ring, j_ring):
            logger.removeHandler(ring)
    assert [r["message"] for r in t_ring.snapshot()] == ["w2", "w3", "w4"]
    for limit in (0, 1, 2, 7):
        assert t_ring.snapshot(limit) == j_ring.snapshot(limit)


def test_setup_logging_configures_the_tree_and_keeps_the_ring():
    import io

    stream = io.StringIO()
    log = tstruct.setup_logging("debug", json_output=True, stream=stream)
    assert log is logging.getLogger("dct")
    assert log.level == logging.DEBUG and log.propagate is False
    ring = tstruct.install_ring_handler()
    assert ring in log.handlers
    logging.getLogger("dct.test").warning("first", extra={"k": 1})
    tstruct.setup_logging("info")  # a second configuration
    assert tstruct.install_ring_handler() is ring
    assert [r["message"] for r in tstruct.ring_snapshot()][-1] == "first"
    line = json.loads(stream.getvalue().splitlines()[-1])
    assert line["message"] == "first" and line["k"] == 1
    assert line["logger"] == "dct.test" and line["level"] == "warning"


def test_uninstall_and_reinstall_keep_the_records():
    ring = tstruct.install_ring_handler()
    logging.getLogger("dct.test").warning("kept")
    handler = tstruct.uninstall_ring_handler()
    assert handler is ring
    assert handler not in logging.getLogger("dct").handlers
    assert tstruct.ring_snapshot() == []
    tstruct.reinstall_ring_handler(handler)
    assert tstruct.ring_snapshot()[-1]["message"] == "kept"
    tstruct.reinstall_ring_handler(None)  # no-op
    assert tstruct.install_ring_handler() is ring


def test_restored_logging_undoes_setup_logging(caplog):
    """The hazard the fixture exists for: after either package's
    `setup_logging`, caplog sees nothing from the "dct" tree."""
    # The tree as a fresh process has it (a test that ran earlier in this
    # process may have configured it; the autouse fixture puts that back).
    logging.getLogger("dct").propagate = True
    before = logging_state()
    with restored_logging():
        tstruct.setup_logging("info")
        jstruct.setup_logging("info")
        assert logging.getLogger("dct").propagate is False
    assert logging_state() == before
    with caplog.at_level(logging.WARNING, logger="dct.test.caplog"):
        logging.getLogger("dct.test.caplog").warning("seen")
    assert "seen" in caplog.text


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("query", ["", "?limit=1", "?limit=2", "?limit=x"])
def test_logs_route_serves_the_references_body(query):
    """/logs on the port's metrics server (the route the three workers
    serve) against the reference's, for the same records: equal bodies,
    zero records rather than a 404 before anything warned."""
    with fresh_rings():
        t_srv = tmet.serve_metrics(0, tmet.MetricsRegistry())
        j_srv = jmet.serve_metrics(0, jmet.MetricsRegistry())
        urls = [f"http://127.0.0.1:{s.server_address[1]}/logs{query}"
                for s in (t_srv, j_srv)]
        try:
            quiet = [_get(u) for u in urls]
            assert quiet[0] == quiet[1] == (200, b'{"records": []}')
            logger = logging.getLogger("dct.test.logs")
            logger.warning("first %s", "warning", extra={"batch": "b1"})
            logger.info("not kept")
            logger.error("second")
            got, want = (_get(u) for u in urls)
            assert got == want and got[0] == 200
            n = len(json.loads(got[1])["records"])
            assert n == (1 if query == "?limit=1" else 2)
        finally:
            for s in (t_srv, j_srv):
                s.shutdown()
                s.server_close()


def test_flight_bundle_carries_the_ring():
    with fresh_rings():
        t_rec, j_rec = tflight.FlightRecorder(), jflight.FlightRecorder()
        assert "logs" not in t_rec.bundle("x")
        assert tmet.logs_snapshot() is None
        logging.getLogger("dct.test.bundle").warning("before the crash")
        got, want = t_rec.bundle("x")["logs"], j_rec.bundle("x")["logs"]
    assert got == want
    assert got["records"][0]["message"] == "before the crash"

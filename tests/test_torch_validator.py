"""The port's tandem validator (`distributed_crawler_tpu_torch/crawl/
validator.py`) and its t.me client (`clients/http_validator.py`) against
the reference's, on the CPU.

- The counterparts of `tests/test_validator.py`'s four classes: one edge's
  outcome from the caches, the claim and each HTTP result; the blocked
  state's threshold, access event, probe and counter; the walkback batch
  (forward with skipped edges, a forced walkback, the batch's crawl id, a
  crash between the completion and the flush); the transport from the
  config.  Each scenario runs in both packages on a
  `CompositeStateManager` with an in-memory graph, and both must leave
  the same updates, outcomes, graph rows and calls.
- The counterparts of `tests/test_validator_fuzz.py` and of
  `tests/test_clients.py`'s `TestChannelHTMLParsing`,
  `TestValidateChannelHTTP` and the validator limiter's case: every
  fixture, mutation, truncation and spoof goes through both parsers, which
  must give the same class or raise the same exception kind.
- Randomness: both packages get the same ``rng`` (the walkback decision)
  and the same stdlib `random` seed (the discovered set's draws), so ids
  are compared by order of appearance and everything else exactly.

Host code: no tolerance.
"""

import os
import random
import types

import pytest

pytest.importorskip("jax")

from distributed_crawler_tpu import clients as jcl  # noqa: E402
from distributed_crawler_tpu.clients import http_validator as jhv  # noqa: E402
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.crawl import validator as jval  # noqa: E402
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import datamodels as jdms  # noqa: E402
from distributed_crawler_tpu.state import interface as jstate  # noqa: E402
from distributed_crawler_tpu_torch import clients as tcl  # noqa: E402
from distributed_crawler_tpu_torch.clients import http_validator as thv  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.crawl import validator as tval  # noqa: E402
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import datamodels as tdms  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tstate  # noqa: E402

from tests.test_torch_orchestrator import normalize  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(name="ref", cl=jcl, hv=jhv, conf=jconf,
                                 val=jval, comp=jcomp, dms=jdms,
                                 state=jstate),
    "port": types.SimpleNamespace(name="port", cl=tcl, hv=thv, conf=tconf,
                                  val=tval, comp=tcomp, dms=tdms,
                                  state=tstate),
}
REF, PORT = PKGS["ref"], PKGS["port"]

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "telegram-html")
FIXTURES = sorted(os.listdir(FIXDIR))
SEEDS = range(25)


def load(name):
    with open(os.path.join(FIXDIR, name), "r", encoding="utf-8",
              errors="replace") as f:
        return f.read()


def make_sm(P, root):
    return P.comp.CompositeStateManager(P.state.StateConfig(
        crawl_id="c1", crawl_execution_id="e1", storage_root=str(root),
        sampling_method="random-walk", sql=P.state.SqlConfig(url=":memory:")))


def limiter(P):
    return P.cl.ValidatorRateLimiter(requests_per_minute=0, jitter_ms=0,
                                     clock=P.cl.FakeClock())


def cfg(P, **kw):
    base = dict(crawl_id="c1", validator_claim_batch_size=10)
    base.update(kw)
    return P.conf.CrawlerConfig(**base)


def edge(P, dest="dst_chan", pending_id=1, **kw):
    base = dict(pending_id=pending_id, batch_id="b1", crawl_id="c1",
                destination_channel=dest, source_channel="src_chan",
                sequence_id="q1", source_type="mention")
    base.update(kw)
    return P.dms.PendingEdge(**base)


def returning(P, status, reason="", calls=None):
    def fn(username):
        if calls is not None:
            calls.append(username)
        return P.hv.ChannelValidationResult(status=status, reason=reason)
    return fn


def raising(P, kind, calls=None):
    def fn(username):
        if calls is not None:
            calls.append(username)
        raise P.hv.ValidationHTTPError(kind, "nope")
    return fn


def graph_rows(sm):
    q = sm.graph.binding.query
    return dict(
        edges=q("SELECT destination_channel, source_channel, walkback, "
                "skipped, crawl_id, sequence_id FROM edge_records "
                "ORDER BY edge_id"),
        buffer=q("SELECT parent_id, depth, url, crawl_id, sequence_id FROM "
                 "page_buffer ORDER BY rowid"),
        pending=q("SELECT destination_channel, validation_status, "
                  "validation_reason FROM pending_edges ORDER BY pending_id"),
        batches=q("SELECT batch_id, status, attempt_count FROM "
                  "pending_edge_batches ORDER BY batch_id"),
        stats=q("SELECT crawl_id, source_type, total, valid, not_channel, "
                "invalid, duplicate FROM source_type_stats ORDER BY "
                "source_type"),
        seeds=q("SELECT channel_username, chat_id FROM seed_channels "
                "ORDER BY channel_username"),
        invalid=q("SELECT channel_username, reason FROM invalid_channels "
                  "ORDER BY channel_username"),
        discovered=q("SELECT channel_username, crawl_id FROM "
                     "discovered_channels ORDER BY channel_username"),
        events=q("SELECT reason FROM access_events"))


def update_of(u):
    return (u.pending_id, u.validation_status, u.validation_reason)


def both(tmp_path, fn, *a, **kw):
    got = {}
    for pkg, P in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        got[pkg] = normalize(fn(P, root, *a, **kw))
    assert got["port"] == got["ref"]
    return got["port"]


# -- TestValidateSingleEdge's cases ---------------------------------------------
def single(P, root, case):
    sm = make_sm(P, root)
    calls = []
    fn = {
        "cached_invalid": returning(P, "valid", calls=calls),
        "discovered": returning(P, "valid", calls=calls),
        "valid": returning(P, "valid", calls=calls),
        "claim_lost": returning(P, "valid", calls=calls),
        "not_channel": returning(P, "not_channel", "not_supergroup", calls),
        "invalid": returning(P, "invalid", "not_found", calls),
        "unknown": returning(P, "weird", calls=calls),
        "blocked": raising(P, P.hv.BLOCKED, calls),
        "transient": raising(P, P.hv.TRANSIENT, calls),
        "crash": lambda u: calls.append(u) or 1 / 0,
    }[case]
    if case == "cached_invalid":
        sm.mark_channel_invalid("dst_chan", "not_found")
    elif case == "discovered":
        sm.claim_discovered_channel("dst_chan", "earlier_crawl")
    elif case == "claim_lost":
        # Another validator won the race: the store says discovered, the
        # in-memory set does not.
        sm.graph.claim_discovered_channel("dst_chan", "other")
    update, kind = P.val.validate_single_edge(sm, cfg(P), limiter(P),
                                              edge(P), fn)
    return dict(update=update_of(update), kind=kind, calls=calls,
                invalid=sm.is_invalid_channel("dst_chan"),
                discovered=sm.is_channel_discovered("dst_chan"),
                graph=graph_rows(sm))


SINGLE_WANT = {
    "cached_invalid": ("invalid", "cached_invalid", "definitive", 0),
    "discovered": ("duplicate", "", "definitive", 0),
    "valid": ("valid", "", "definitive", 1),
    "claim_lost": ("duplicate", "", "definitive", 0),
    "not_channel": ("not_channel", "not_supergroup", "definitive", 1),
    "invalid": ("invalid", "not_found", "definitive", 1),
    "unknown": ("invalid", "unknown_status", "definitive", 1),
    "blocked": ("pending", "", "blocked", 1),
    "transient": ("pending", "", "transient", 1),
    "crash": ("pending", "", "transient", 1),
}


@pytest.mark.parametrize("case", sorted(SINGLE_WANT))
def test_single_edge_outcome_is_the_references(tmp_path, case):
    got = both(tmp_path, single, case)
    status, reason, kind, n_calls = SINGLE_WANT[case]
    assert got["update"] == [1, status, reason]
    assert got["kind"] == kind and len(got["calls"]) == n_calls
    if case == "valid":
        # Claimed, and cached as a seed with no chat id yet.
        assert got["discovered"] is True
        assert got["graph"]["seeds"] == [["dst_chan", 0]]
        assert got["graph"]["discovered"] == [["dst_chan", "c1"]]
    if case in ("blocked", "transient"):
        assert got["invalid"] is False  # an access problem never invalidates
    if case in ("not_channel", "invalid"):
        assert got["graph"]["invalid"] == [["dst_chan", reason]]


# -- TestBlockedStateMachine's cases ---------------------------------------------
def seed_edges(P, sm, n):
    sm.create_pending_batch(P.dms.PendingEdgeBatch(
        batch_id="b1", crawl_id="c1", source_channel="src_chan",
        source_page_id="p1", source_depth=0, sequence_id="q1"))
    for i in range(n):
        sm.insert_pending_edge(edge(P, dest=f"chan_{i:02d}", pending_id=0))


def blocked_threshold(P, root):
    sm = make_sm(P, root)
    seed_edges(P, sm, 6)
    blocked = P.val.BlockedState()
    clock = P.cl.FakeClock(start=100.0)
    n = P.val.edge_validation_step(
        sm, cfg(P), P.val.ValidatorConfig(blocked_threshold=5), limiter(P),
        blocked, raising(P, P.hv.BLOCKED), clock.time)
    graph = graph_rows(sm)
    # Blocked edges go straight back to pending: claimable at once.
    reclaimed = [e.destination_channel for e in sm.claim_pending_edges(100)]
    return dict(n=n, blocked=vars(blocked), graph=graph, reclaimed=reclaimed)


def test_blocked_threshold_enters_the_blocked_state(tmp_path):
    got = both(tmp_path, blocked_threshold)
    assert got["blocked"]["active"] is True
    assert got["blocked"]["consecutive_count"] == 6
    assert got["graph"]["events"] == [["ip_blocked"]]
    assert len(got["reclaimed"]) == 6 and got["n"] == 6


def probes(P, root, ok):
    sm = make_sm(P, root)
    blocked = P.val.BlockedState(active=True, consecutive_count=5,
                                 last_probe_at=0.0)
    vcfg = P.val.ValidatorConfig(probe_interval_s=300)
    clock = P.cl.FakeClock(start=1000.0)
    seen = []

    def probe(username):
        seen.append((username, clock.time()))
        if ok:
            return P.hv.ChannelValidationResult(status="valid")
        raise P.hv.ValidationHTTPError(P.hv.BLOCKED, "still blocked")

    states = []
    for advance in (0, 100, 250):
        clock.advance(advance)
        P.val.edge_validation_step(sm, cfg(P), vcfg, limiter(P), blocked,
                                   probe, clock.time)
        states.append(dict(vars(blocked)))
    return dict(seen=seen, states=states)


@pytest.mark.parametrize("ok", [True, False])
def test_probe_schedule_is_the_references(tmp_path, ok):
    got = both(tmp_path, probes, ok)
    if ok:
        # The first call probes the canary at once and resumes.
        assert got["seen"][0] == ["telegram", 1000.0]
        assert got["states"][0]["active"] is False
    else:
        # No new probe within the interval; one after it.
        assert [s[1] for s in got["seen"]] == [1000.0, 1350.0]
        assert all(s["active"] for s in got["states"])


def counter(P, root):
    sm = make_sm(P, root)
    seed_edges(P, sm, 3)
    blocked = P.val.BlockedState(consecutive_count=3)
    fns = [raising(P, P.hv.TRANSIENT), returning(P, "valid"),
           raising(P, P.hv.BLOCKED)]
    it = iter(fns)
    P.val.edge_validation_step(
        sm, cfg(P), P.val.ValidatorConfig(blocked_threshold=99), limiter(P),
        blocked, lambda u: next(it)(u), P.cl.FakeClock().time)
    return dict(blocked=vars(blocked), graph=graph_rows(sm))


def test_transient_decrements_and_definitive_resets(tmp_path):
    got = both(tmp_path, counter)
    # transient: 3 -> 2; definitive: -> 0; blocked: -> 1.
    assert got["blocked"]["consecutive_count"] == 1
    assert [p[1] for p in got["graph"]["pending"]] == \
        ["pending", "valid", "pending"]


# -- TestWalkbackProcessing's cases -------------------------------------------------
def prepare_batch(P, sm, statuses, batch_id="b1", crawl_id="c1"):
    sm.create_pending_batch(P.dms.PendingEdgeBatch(
        batch_id=batch_id, crawl_id=crawl_id, source_channel="src_chan",
        source_page_id="pp", source_depth=2, sequence_id="q1"))
    for i, _ in enumerate(statuses):
        sm.insert_pending_edge(edge(P, dest=f"chan_{i:02d}", pending_id=0,
                                    batch_id=batch_id, crawl_id=crawl_id))
    for e, status in zip(sm.claim_pending_edges(100), statuses):
        sm.update_pending_edge(P.dms.PendingEdgeUpdate(
            pending_id=e.pending_id, validation_status=status))
    sm.close_pending_batch(batch_id)


def walkback(P, root, statuses, seed, walkback_rate=0, crawl_id="c1",
             crash_flush=False):
    random.seed(seed)
    sm = make_sm(P, root)
    for ch in ("older_chan", "other_chan"):
        sm.add_discovered_channel(ch)
    prepare_batch(P, sm, statuses, crawl_id=crawl_id)
    if crash_flush:
        def crashing(*a, **kw):
            raise RuntimeError("crash before flush")
        sm.flush_batch_stats = crashing
    took = P.val.walkback_step(sm, cfg(P, walkback_rate=walkback_rate),
                               rng=random.Random(seed))
    orphans = sm.recover_orphan_edges() if crash_flush else None
    return dict(took=took, graph=graph_rows(sm), orphans=orphans,
                incomplete=sm.count_incomplete_batches("c1"),
                again=P.val.walkback_step(sm, cfg(P)))


@pytest.mark.parametrize("seed", range(6))
def test_forward_choice_writes_primary_and_skipped_edges(tmp_path, seed):
    got = both(tmp_path, walkback, ["valid", "valid", "invalid"], seed)
    assert got["took"] is True and got["again"] is False
    (row,) = got["graph"]["buffer"]
    assert row[:2] == ["pp", 3] and row[2] in ("chan_00", "chan_01")
    assert row[4] == "q1"  # a forward step keeps the chain
    other = ({"chan_00", "chan_01"} - {row[2]}).pop()
    assert [e[:4] for e in got["graph"]["edges"]] == [
        [row[2], "src_chan", 0, 0], [other, "src_chan", 0, 1]]
    assert got["graph"]["stats"] == [["c1", "mention", 3, 2, 0, 1, 0]]
    assert got["graph"]["pending"] == [] and got["incomplete"] == 0


@pytest.mark.parametrize("rate", [0, 100])
def test_all_invalid_or_rate_100_walks_back(tmp_path, rate):
    statuses = ["invalid", "not_channel"] if rate == 0 else ["valid"]
    got = both(tmp_path, walkback, statuses, 0, walkback_rate=rate)
    (row,) = got["graph"]["buffer"]
    assert row[2] in ("older_chan", "other_chan")
    assert row[4] != "q1"  # a walkback starts a new chain
    (primary,) = [e for e in got["graph"]["edges"] if not e[3]]
    assert primary[0] == row[2] and primary[2] == 1 and primary[5] == "q1"
    assert len(got["graph"]["edges"]) == 1 + statuses.count("valid")


def test_page_carries_the_batchs_crawl_id(tmp_path):
    got = both(tmp_path, walkback, ["valid"], 0, crawl_id="other_crawl")
    assert [r[2:4] for r in got["graph"]["buffer"]] == \
        [["chan_00", "other_crawl"]]
    assert got["graph"]["edges"][0][4] == "other_crawl"


def test_crash_between_completion_and_flush_leaves_orphans_only(tmp_path):
    got = both(tmp_path, walkback, ["valid"], 0, crash_flush=True)
    assert got["took"] is True and got["incomplete"] == 0
    assert got["orphans"] == 1 and got["graph"]["stats"] == []


def test_no_ready_batch(tmp_path):
    def scenario(P, root):
        sm = make_sm(P, root)
        seed_edges(P, sm, 2)   # open, its edges pending
        sm.close_pending_batch("b1")
        return dict(took=P.val.walkback_step(sm, cfg(P)),
                    graph=graph_rows(sm))

    got = both(tmp_path, scenario)
    assert got["took"] is False and got["graph"]["buffer"] == []


# -- TestValidatorTransportConfig's cases --------------------------------------------
@pytest.mark.parametrize("transport", ["carrier-pigeon", "", "urllib"])
def test_transport_from_the_config(transport):
    out = {}
    for pkg, P in PKGS.items():
        c = P.conf.CrawlerConfig(validator_transport=transport)
        try:
            loop = P.val.RunValidationLoop(sm=None, cfg=c)
            out[pkg] = ("ok", callable(loop.validate_fn),
                        loop.rate_limiter.jitter_ms)
        except ValueError as e:
            out[pkg] = ("raised", str(e))
    assert out["port"] == out["ref"]
    if transport == "carrier-pigeon":
        assert "unknown validator transport" in out["port"][1]


def test_zero_rate_and_jitter_are_not_honoured():
    """A fault of the reference the port keeps: the loop's limiter reads
    a rate or jitter of 0 as unset (6 per minute, 200 ms)."""
    got = {}
    for pkg, P in PKGS.items():
        loop = P.val.RunValidationLoop(sm=None, cfg=P.conf.CrawlerConfig(
            validator_request_rate=0, validator_request_jitter_ms=0))
        got[pkg] = (loop.rate_limiter.jitter_ms,
                    loop.rate_limiter._bucket.interval_s)
    assert got["port"] == got["ref"] == (200, 10.0)


def test_chrome_transport_names_the_native_client():
    """The port's chrome transport waits for the native client: it raises
    when the loop is built, where the reference builds a transport."""
    c = PORT.conf.CrawlerConfig(validator_transport="chrome")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 part D"):
        PORT.val.RunValidationLoop(sm=None, cfg=c)
    with pytest.raises(NotImplementedError, match="clients/native.py"):
        PORT.hv.chrome_transport("https://t.me/x", {})
    assert REF.val.RunValidationLoop(sm=None, cfg=REF.conf.CrawlerConfig(
        validator_transport="chrome")).validate_fn is not None


# -- the parser: fixtures, mutations, garbage, spoofs ---------------------------------
def classify(P, html):
    try:
        r = P.hv.parse_channel_html(html)
    except Exception as e:
        return ("raised", type(e).__name__, str(e))
    return ("ok", r.status, r.reason)


def same_class(html):
    got = {pkg: classify(P, html) for pkg, P in PKGS.items()}
    assert got["port"] == got["ref"]
    # The parser classifies or raises ValueError (the soft block), never
    # anything else.
    assert got["port"][0] == "ok" or got["port"][1] == "ValueError"
    if got["port"][0] == "ok":
        assert got["port"][1] in ("valid", "invalid", "not_channel")
    return got["port"]


FIXTURE_WANT = {
    "valid-channel.html": ("ok", "valid", ""),
    "not-a-supergroup.html": ("ok", "not_channel", "not_supergroup"),
    "username-not-occupied.html": ("ok", "invalid", "not_found"),
    "invalid-channel.html": ("ok", "invalid", "not_found"),
}


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_class(name):
    assert same_class(load(name)) == FIXTURE_WANT[name]


def test_unrecognised_title_raises():
    got = same_class("<html><head><title>Weird</title></head></html>")
    assert got[:2] == ("raised", "ValueError")
    assert "unrecognised title" in got[2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", FIXTURES)
def test_mutated_fixture_same_class(name, seed):
    rng = random.Random(seed)
    html = list(load(name))
    for _ in range(rng.randrange(1, 30)):
        op = rng.randrange(3)
        pos = rng.randrange(len(html)) if html else 0
        if op == 0 and html:
            html[pos] = chr(rng.randrange(32, 0x300))
        elif op == 1 and html:
            del html[pos]
        else:
            html.insert(pos, rng.choice("<>/=\"' &;\x00abct"))
    same_class("".join(html))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_garbage_same_class(seed):
    rng = random.Random(500 + seed)
    same_class("".join(chr(rng.randrange(1, 0x500))
                       for _ in range(rng.randrange(0, 3000))))


@pytest.mark.parametrize("name", FIXTURES)
def test_truncations_same_class(name):
    html = load(name)
    for cut in range(0, len(html), max(1, len(html) // 40)):
        same_class(html[:cut])


SPOOFS = {
    "body_text": ("<html><head><title>Telegram Messenger</title></head>"
                  "<body><p>Telegram: View @evil_channel</p></body></html>",
                  "invalid"),
    "description_meta": ('<html><head><title>Telegram: Contact @someone'
                         '</title><meta property="og:description" '
                         'content="Telegram: View @fake"></head><body>'
                         '</body></html>', "not_channel"),
    "second_title": ("<html><head><title>Telegram Messenger</title>"
                     "<title>Telegram: View @injected</title></head></html>",
                     "invalid"),
    "noindex_in_body": ('<html><head><title>Telegram: Contact @user</title>'
                        '<meta name="robots" content="all"></head>'
                        "<body>noindex</body></html>", "not_channel"),
}


@pytest.mark.parametrize("case", sorted(SPOOFS))
def test_spoof_resistance(case):
    html, status = SPOOFS[case]
    assert same_class(html)[1] == status


# -- validate_channel_http and the limiter ----------------------------------------------
def fetch(P, status, body, raise_=None):
    headers = []

    def transport(url, hdrs):
        headers.append((url, hdrs))
        if raise_ is not None:
            raise raise_
        return status, body

    try:
        r = P.hv.validate_channel_http("examplechannel", transport=transport,
                                       rng=random.Random(3),
                                       base_url="http://mirror.test/")
        out = ("ok", r.status, r.reason)
    except P.hv.ValidationHTTPError as e:
        out = ("raised", e.kind, str(e))
    return out, headers


HTTP_CASES = {
    "ok": (200, "valid-channel.html", None, ("ok", "valid", "")),
    "5xx": (503, "", None, ("raised", "transient")),
    "403": (403, "", None, ("raised", "blocked")),
    "429": (429, "", None, ("raised", "blocked")),
    "404": (404, "", None, ("raised", "blocked")),
    "unparseable_200": (200, "<html></html>", None, ("raised", "blocked")),
    "connection_error": (200, "", OSError("connection reset"),
                         ("raised", "transient")),
}


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_validate_channel_http_is_the_references(case):
    status, body, exc, want = HTTP_CASES[case]
    body = load(body).encode() if body.endswith(".html") else body.encode()
    got = {pkg: fetch(P, status, body, exc) for pkg, P in PKGS.items()}
    assert got["port"] == got["ref"]
    out, headers = got["port"]
    assert out[:len(want)] == want
    (url, hdrs), = headers
    assert url == "http://mirror.test/examplechannel"
    assert "Chrome" in hdrs["User-Agent"]
    assert hdrs["User-Agent"] in PORT.hv.BROWSER_USER_AGENTS


@pytest.mark.parametrize("rate,jitter", [(6, 0), (60, 0), (6, 200), (0, 0)])
def test_validator_rate_limiter_spacing(rate, jitter):
    got = {}
    for pkg, P in PKGS.items():
        clock = P.cl.FakeClock()
        lim = P.cl.ValidatorRateLimiter(requests_per_minute=rate,
                                        jitter_ms=jitter, clock=clock,
                                        rng=random.Random(7))
        got[pkg] = [lim.wait() for _ in range(4)] + [clock.now]
    assert got["port"] == got["ref"]
    if rate == 6 and jitter == 0:
        assert got["port"][1] >= 10.0


def test_exports_cover_the_references():
    names = ("ChannelValidationResult", "ValidationHTTPError",
             "ValidatorRateLimiter", "parse_channel_html",
             "validate_channel_http", "TRANSIENT", "BLOCKED")
    for n in names:
        assert n in REF.cl.__all__ and n in PORT.cl.__all__, n
    assert (PORT.cl.TRANSIENT, PORT.cl.BLOCKED) == (REF.cl.TRANSIENT,
                                                    REF.cl.BLOCKED)

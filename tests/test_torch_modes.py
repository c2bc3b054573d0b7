"""The port's modes (`distributed_crawler_tpu_torch/modes/`: the layerless
random walk, the validator mode and `runner.launch`) against the
reference's, on the CPU.

- The counterparts of `tests/test_modes.py::TestLayerless`: the walk
  until the buffer is empty, the 400-replacement and the page's deletion,
  the abort when FLOOD_WAIT retires the last connection, the tandem
  circuit breaker, the parked page, the tandem completion, and the
  duration bound; each through both packages' seams (a stubbed
  `run_for_channel`), with the same calls and buffer left.
- `TestLaunchRouter::test_random_walk_seeding` and the helpers
  (`normalize_seed_urls`, `determine_crawl_id`); the port's refusal of the
  router's branches that wait for the crawl modes.
- A whole tandem walk: `launch` over a seeded `SimNetwork` on a SQLite
  graph file, with the validator pod's loop (`run_validate_only`, its
  HTTP seam answered from the network) on the same file.  Both packages
  satisfy the same invariants: the walk completes with no batch left;
  every forward edge goes to a valid channel; the two bad names and the
  400 name are marked invalid with their reasons; the 400 name's edge is
  replaced by a walkback; every page without edges walked back; no post
  is stored.
- Across packages: the reference's crawler with the port's validator on
  one graph file, and the other way round; the walk completes and holds
  the same invariants.

Host code: no tolerance.
"""

import json
import os
import random
import threading
import types

import pytest

pytest.importorskip("jax")

from distributed_crawler_tpu import clients as jcl  # noqa: E402
from distributed_crawler_tpu import modes as jmodes  # noqa: E402
from distributed_crawler_tpu.clients import http_validator as jhv  # noqa: E402
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.crawl import errors as jcerr  # noqa: E402
from distributed_crawler_tpu.crawl import runner as jrun  # noqa: E402
from distributed_crawler_tpu.crawl import validator as jval  # noqa: E402
from distributed_crawler_tpu.modes import layerless as jlayerless  # noqa: E402
from distributed_crawler_tpu.modes import runner as jrouter  # noqa: E402
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import datamodels as jdms  # noqa: E402
from distributed_crawler_tpu.state import interface as jstate  # noqa: E402
from distributed_crawler_tpu_torch import clients as tcl  # noqa: E402
from distributed_crawler_tpu_torch import modes as tmodes  # noqa: E402
from distributed_crawler_tpu_torch.clients import http_validator as thv  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.crawl import errors as tcerr  # noqa: E402
from distributed_crawler_tpu_torch.crawl import runner as trun  # noqa: E402
from distributed_crawler_tpu_torch.crawl import validator as tval  # noqa: E402
from distributed_crawler_tpu_torch.modes import layerless as tlayerless  # noqa: E402
from distributed_crawler_tpu_torch.modes import runner as trouter  # noqa: E402
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import datamodels as tdms  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tstate  # noqa: E402

from tests.test_torch_orchestrator import normalize  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(
        name="ref", cl=jcl, hv=jhv, conf=jconf, cerr=jcerr, run=jrun,
        val=jval, modes=jmodes, layerless=jlayerless, router=jrouter,
        comp=jcomp, dms=jdms, state=jstate),
    "port": types.SimpleNamespace(
        name="port", cl=tcl, hv=thv, conf=tconf, cerr=tcerr, run=trun,
        val=tval, modes=tmodes, layerless=tlayerless, router=trouter,
        comp=tcomp, dms=tdms, state=tstate),
}
REF, PORT = PKGS["ref"], PKGS["port"]
POLL_S = 0.01


def make_sm(P, root, crawl_id="c1", graph=":memory:"):
    return P.comp.CompositeStateManager(P.state.StateConfig(
        crawl_id=crawl_id, crawl_execution_id="e1", storage_root=str(root),
        sampling_method="random-walk", sql=P.state.SqlConfig(url=graph)))


def make_cfg(P, **kw):
    base = dict(crawl_id="c1", platform="telegram", skip_media_download=True,
                sampling_method="random-walk", concurrency=1)
    base.update(kw)
    return P.conf.CrawlerConfig(**base)


def no_limits(P):
    return P.conf.TelegramRateLimitConfig(
        get_chat_history_rate=0, search_public_chat_rate=0,
        get_supergroup_info_rate=0, get_message_server_hit_rate=0,
        get_chat_history_jitter_ms=0, search_public_chat_jitter_ms=0,
        get_supergroup_info_jitter_ms=0, get_message_server_hit_jitter_ms=0)


class Pool:
    """A pool of sim connections installed in ``P``'s facade, and the
    stubbed ``run_for_channel`` restored, on exit."""

    def __init__(self, P, net=None, n=3, fake=None):
        self.P, self.fake = P, fake
        net = net or P.cl.SimNetwork()
        self.pool = P.cl.ConnectionPool.for_testing(
            {f"conn{i}": P.cl.SimTelegramClient(net, conn_id=f"conn{i}")
             for i in range(n)}, rate_limit=no_limits(P))

    def __enter__(self):
        self.P.run.shutdown_connection_pool()
        self.P.run.init_connection_pool(self.pool)
        if self.fake is not None:
            self.P.run.set_run_for_channel_fn(self.fake)
        return self.pool

    def __exit__(self, *exc):
        self.P.run.shutdown_connection_pool()
        self.P.run.set_run_for_channel_fn(None)


def buffered(sm):
    return sorted(p.url for p in sm.get_pages_from_page_buffer(50))


def both(tmp_path, fn, *a, **kw):
    got = {}
    for pkg, P in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        got[pkg] = normalize(fn(P, root, *a, **kw))
    assert got["port"] == got["ref"]
    return got["port"]


def page(P, url, **kw):
    return P.dms.Page(id=P.dms.new_id(), url=url, depth=0,
                      sequence_id=P.dms.new_id(), **kw)


# -- TestLayerless's cases -------------------------------------------------------------
def chain_walk(P, root, concurrency):
    sm = make_sm(P, root)
    sm.initialize([])
    chain = {"a": "b", "b": "c", "c": "d"}
    seen = []

    def fake(client, pg, prefix, sm_, cfg, processor=None, rng=None):
        seen.append(pg.url)
        nxt = chain.get(pg.url)
        if nxt:
            sm_.add_page_to_page_buffer(P.dms.Page(
                id=P.dms.new_id(), url=nxt, depth=pg.depth + 1,
                sequence_id=P.dms.new_id()))
        return []

    sm.add_page_to_page_buffer(page(P, "a"))
    with Pool(P, fake=fake):
        P.layerless.run_random_walk_layerless(
            sm, make_cfg(P, concurrency=concurrency), poll_interval_s=POLL_S)
    return dict(seen=seen, left=buffered(sm))


@pytest.mark.parametrize("concurrency", [1, 2])
def test_walk_until_the_buffer_is_empty(tmp_path, concurrency):
    got = both(tmp_path, chain_walk, concurrency)
    assert got == {"seen": ["a", "b", "c", "d"], "left": []}


def replaced_400(P, root):
    random.seed(0)
    sm = make_sm(P, root)
    sm.initialize([])
    sm.initialize_discovered_channels()
    sm.add_discovered_channel("fallback")
    crawled = []

    def fake(client, pg, prefix, sm_, cfg, processor=None, rng=None):
        crawled.append(pg.url)
        if pg.url == "bad":
            raise P.cerr.TDLib400Error("USERNAME_NOT_OCCUPIED")
        return []

    sm.add_page_to_page_buffer(page(P, "bad"))
    with Pool(P, fake=fake):
        P.layerless.run_random_walk_layerless(sm, make_cfg(P),
                                              poll_interval_s=POLL_S)
    return dict(crawled=crawled, invalid=sm.is_invalid_channel("bad"),
                left=buffered(sm),
                edges=sm.graph.binding.query(
                    "SELECT destination_channel, source_channel, walkback "
                    "FROM edge_records"))


def test_400_replacement_then_delete(tmp_path):
    got = both(tmp_path, replaced_400)
    # The 400 page walked back to the discovered channel, which was then
    # crawled and drained.
    assert got["crawled"] == ["bad", "fallback"]
    assert got["invalid"] is True and got["left"] == []
    assert got["edges"] == [["fallback", "bad", 1]]


def flood_retire(P, root):
    sm = make_sm(P, root)
    sm.initialize([])

    def fake(client, pg, prefix, sm_, cfg, processor=None, rng=None):
        raise P.cerr.FloodWaitRetireError(400)

    sm.add_page_to_page_buffer(page(P, "x"))
    with Pool(P, n=1, fake=fake) as pool:
        P.layerless.run_random_walk_layerless(sm, make_cfg(P),
                                              poll_interval_s=POLL_S)
        empty = P.run.pool_is_empty()
        stats = pool.stats()
    return dict(left=buffered(sm), empty=empty, total=stats["total"])


def test_flood_wait_retire_of_the_last_connection_aborts(tmp_path):
    got = both(tmp_path, flood_retire)
    # The page stays in the buffer for a restart.
    assert got["left"] == ["x"] and got["empty"] is True


def circuit_breaker(P, root):
    sm = make_sm(P, root)
    sm.initialize([])

    class Stuck:
        """An empty buffer and batches that never complete."""

        def __getattr__(self, name):
            return getattr(sm, name)

        def get_pages_from_page_buffer(self, limit):
            return []

        def count_incomplete_batches(self, crawl_id):
            return 3

    with Pool(P):
        try:
            P.layerless.run_random_walk_layerless(
                Stuck(), make_cfg(P, tandem_crawl=True,
                                  validator_timeout_s=0.05),
                poll_interval_s=POLL_S)
        except P.layerless.ValidatorCircuitBreakerError as e:
            return ("raised", "(3 incomplete batches)" in str(e))
    return ("ok",)


def test_tandem_circuit_breaker(tmp_path):
    assert both(tmp_path, circuit_breaker) == ["raised", True]


def parked(P, root):
    sm = make_sm(P, root)
    sm.initialize([])
    attempts = []

    def fake(client, pg, prefix, sm_, cfg, processor=None, rng=None):
        attempts.append(pg.url)
        raise P.cerr.WalkbackExhaustedError("no discovered channels")

    sm.add_page_to_page_buffer(page(P, "deadend"))
    with Pool(P, fake=fake):
        P.layerless.run_random_walk_layerless(sm, make_cfg(P),
                                              poll_interval_s=POLL_S)
    return dict(attempts=attempts, left=buffered(sm))


def test_walkback_exhausted_page_is_parked(tmp_path):
    got = both(tmp_path, parked)
    assert got == {"attempts": ["deadend"], "left": ["deadend"]}


def tandem_done(P, root):
    sm = make_sm(P, root)
    sm.initialize([])
    with Pool(P):
        P.layerless.run_random_walk_layerless(
            sm, make_cfg(P, tandem_crawl=True), poll_interval_s=POLL_S)
    return dict(left=buffered(sm))


def test_tandem_completes_without_batches(tmp_path):
    assert both(tmp_path, tandem_done) == {"left": []}


def bounded(P, root):
    """A walk that never empties its buffer ends on its duration, with
    the page in flight at the bound finished."""
    sm = make_sm(P, root)
    sm.initialize([])
    now = [0.0]
    crawled = []

    def fake(client, pg, prefix, sm_, cfg, processor=None, rng=None):
        crawled.append(pg.url)
        now[0] += 1.0
        sm_.add_page_to_page_buffer(P.dms.Page(
            id=P.dms.new_id(), url=f"hop{len(crawled)}", depth=pg.depth + 1,
            sequence_id=P.dms.new_id()))
        return []

    sm.add_page_to_page_buffer(page(P, "hop0"))
    with Pool(P, fake=fake):
        P.layerless.run_random_walk_layerless(
            sm, make_cfg(P, tandem_crawl=True, max_crawl_duration_s=3.5),
            poll_interval_s=POLL_S, clock=lambda: now[0],
            sleep=lambda s: None)
    return dict(crawled=crawled, left=buffered(sm))


def test_max_crawl_duration_ends_a_tandem_walk(tmp_path):
    got = both(tmp_path, bounded)
    assert got["crawled"] == ["hop0", "hop1", "hop2", "hop3"]
    assert got["left"] == ["hop4"]


# -- TestLaunchRouter's and the helpers' cases ---------------------------------------------
def seeding(P, root):
    sm = make_sm(P, root)
    with Pool(P):
        P.modes.seed_random_walk(sm, ["Alpha", "https://t.me/beta"])
        first = buffered(sm)
        # A resume leaves the buffer as it is.
        P.modes.seed_random_walk(sm, ["gamma"])
        again = buffered(sm)
    rows = sm.graph.binding.query(
        "SELECT depth, crawl_id, length(sequence_id) FROM page_buffer")
    return dict(first=first, again=again, rows=sorted(rows))


def test_random_walk_seeding(tmp_path):
    got = both(tmp_path, seeding)
    assert got["first"] == got["again"] == ["alpha", "beta"]
    assert got["rows"] == [[0, "c1", 36], [0, "c1", 36]]


def test_normalize_seed_urls():
    urls = ["https://t.me/Alpha", "http://t.me/BETA", "t.me/gamma",
            "@Delta", "plain", "T.me/Upper"]
    assert PORT.modes.normalize_seed_urls(urls) == \
        REF.modes.normalize_seed_urls(urls) == [
            "alpha", "beta", "gamma", "delta", "plain", "t.me/upper"]


def resume(P, root):
    out = []
    cfg = make_cfg(P, storage_root=str(root), crawl_id="rc")
    for meta in (None, {"status": "running", "executionId": "20200101000000"},
                 {"status": "completed", "executionId": "20200101000000"}):
        if meta is not None:
            os.makedirs(root / "rc", exist_ok=True)
            (root / "rc" / "metadata.json").write_text(json.dumps(meta))
        exec_id, resuming = P.modes.determine_crawl_id(
            P.modes.create_state_manager(cfg), cfg)
        out.append((exec_id if resuming else len(exec_id), resuming))
    return out


def test_determine_crawl_id(tmp_path):
    assert both(tmp_path, resume) == [
        [14, False], ["20200101000000", True], [14, False]]


@pytest.mark.parametrize("platform,sampling", [
    ("telegram", "channel"), ("telegram", "snowball"),
    ("youtube", "random"), ("youtube", "channel")])
def test_launch_refuses_the_crawl_modes_branches(tmp_path, platform,
                                                 sampling):
    cfg = make_cfg(PORT, platform=platform, sampling_method=sampling,
                   storage_root=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 part C"):
        PORT.router.launch(["alpha"], cfg)
    assert not os.listdir(tmp_path)  # refused before any set-up


def test_launch_validate_only_runs_the_validator(tmp_path, monkeypatch):
    """The validate-only branch initializes the manager and hands it to
    the validator mode with the HTTP seam, in both packages."""
    got = {}
    for pkg, P in PKGS.items():
        ran = []
        monkeypatch.setattr(P.router, "run_validate_only",
                            lambda sm, cfg, validate_fn=None, **kw:
                            ran.append((type(sm).__name__, cfg.validate_only,
                                        validate_fn)))
        sm = make_sm(P, tmp_path / pkg)
        P.router.launch([], make_cfg(P, validate_only=True,
                                     sampling_method="channel"),
                        sm=sm, validate_fn=len)
        got[pkg] = ran
    assert got["port"] == got["ref"] == [
        ("CompositeStateManager", True, len)]


def validator_mode(P, root):
    """`run_validate_only` without blocking: caches warmed, stale claims
    and orphans recovered, the loop running until stopped."""
    graph = str(root / "graph.sqlite")
    sm = make_sm(P, root, graph=graph)
    sm.mark_channel_crawled("seedchan", 7)
    sm.mark_channel_invalid("badchan", "not_found")
    sm.claim_discovered_channel("oldchan", "earlier")
    sm.create_pending_batch(P.dms.PendingEdgeBatch(
        batch_id="b1", crawl_id="c1", source_channel="seedchan",
        source_page_id="p1", source_depth=0, sequence_id="q1"))
    sm.insert_pending_edge(P.dms.PendingEdge(
        batch_id="b1", crawl_id="c1", destination_channel="newchan",
        source_channel="seedchan", sequence_id="q1", source_type="mention"))
    sm.close_pending_batch("b1")
    v_sm = make_sm(P, root / "v", graph=graph)
    calls = []
    loop = P.val.RunValidationLoop(
        v_sm, make_cfg(P, walkback_rate=0),
        vcfg=P.val.ValidatorConfig(edge_poll_interval_s=POLL_S,
                                   walkback_poll_interval_s=POLL_S),
        validate_fn=lambda u: calls.append(u) or P.hv.ChannelValidationResult(
            status="valid"),
        rate_limiter=P.cl.ValidatorRateLimiter(0, 0))
    P.modes.run_validate_only(v_sm, loop.cfg, loop=loop, block=False)
    try:
        deadline = 30.0
        while sm.count_incomplete_batches("c1") and deadline > 0:
            loop.stop_event.wait(POLL_S)
            deadline -= POLL_S
    finally:
        loop.stop()
    return dict(calls=calls, buffer=[(p.url, p.sequence_id)
                                     for p in sm.get_pages_from_page_buffer(9)],
                caches=(v_sm.is_seed_channel("seedchan"),
                        v_sm.is_invalid_channel("badchan"),
                        v_sm.is_discovered_channel("oldchan")),
                alive=[t.is_alive() for t in loop._threads])


def test_validator_mode_warms_the_caches_and_completes_a_batch(tmp_path):
    got = both(tmp_path, validator_mode)
    assert got == {"calls": ["newchan"], "buffer": [["newchan", "q1"]],
                   "caches": [True, True, True], "alive": [False, False]}


# -- a whole tandem walk, and across packages ------------------------------------------------
WALK_SEEDS = ("seedalpha", "seedbravo", "seedcharlie")
FOUR_SEED = "seeddelta"     # names only the 400 name and the ghost
GHOST = "ghostname"         # no such username
PRIVATE = "privroom"        # a chat that is not a supergroup
FOUR = "fourhundred"        # valid on t.me, unknown to the network


def kids(seed):
    return [f"{seed}kid{i}" for i in range(2)]


def walk_network(P):
    net = P.cl.SimNetwork(cache_latency_s=0.0, server_latency_s=0.0)

    def msg(body, i):
        return P.cl.TLMessage(content={"@type": "messageText",
                                       "text": {"text": body,
                                                "entities": []}},
                              date=1700000000 + 60 * i, view_count=5)

    for s in WALK_SEEDS:
        names = kids(s) + [GHOST, PRIVATE]
        net.add_channel(s, messages=[msg(" ".join(
            (f"@{n}" if (i + j) % 2 else f"t.me/{n}")
            for j, n in enumerate(names)), i) for i in range(3)])
        for k in kids(s):
            net.add_channel(k, messages=[msg(f"plain post {i}", i)
                                         for i in range(3)])
    net.add_channel(FOUR_SEED, messages=[msg(f"see @{FOUR} and @{GHOST}",
                                             0)])
    net.add_channel(PRIVATE, messages=[msg("private", 0)],
                    is_supergroup=False)
    return net


def page_for(V, net):
    """The validator's HTTP seam answered as t.me would answer for the
    network, the 400 name shown as a valid channel."""
    def fn(name):
        ch = net.channels.get(name)
        if name == FOUR or (ch is not None and ch.is_supergroup):
            return V.hv.ChannelValidationResult(status="valid")
        if ch is not None:
            return V.hv.ChannelValidationResult(status="not_channel",
                                                reason="not_supergroup")
        return V.hv.ChannelValidationResult(status="invalid",
                                            reason="not_found")
    return fn


def tandem_walk(C, V, root):
    """``C``'s crawler (`launch`) and ``V``'s validator on one graph file;
    returns the walk's invariants."""
    random.seed(11)
    net = walk_network(C)
    graph = str(root / "graph.sqlite")
    crawl = make_sm(C, root / "crawler", crawl_id="tw", graph=graph)
    for s in WALK_SEEDS + (FOUR_SEED,):   # the deployment's seed pool
        crawl.upsert_seed_channel_chat_id(s, net.channels[s].chat_id)
    v_sm = make_sm(V, root / "validator", crawl_id="tw", graph=graph)
    asked = []
    answer = page_for(V, net)
    loop = V.val.RunValidationLoop(
        v_sm, make_cfg(V, crawl_id="tw", walkback_rate=0),
        vcfg=V.val.ValidatorConfig(edge_poll_interval_s=POLL_S,
                                   walkback_poll_interval_s=POLL_S),
        validate_fn=lambda n: asked.append(n) or answer(n),
        rate_limiter=V.cl.ValidatorRateLimiter(0, 0))
    V.modes.run_validate_only(v_sm, loop.cfg, loop=loop, block=False)
    cfg = make_cfg(C, crawl_id="tw", storage_root=str(root / "crawler"),
                   tandem_crawl=True, concurrency=2,
                   max_crawl_duration_s=60.0)
    try:
        with Pool(C, net, n=2):
            C.modes.launch(list(WALK_SEEDS + (FOUR_SEED,)), cfg, sm=crawl,
                           layerless_poll_s=POLL_S)
    finally:
        loop.stop()
        crawl.close()   # the caller's manager: its close saves metadata
    return walk_invariants(graph, root / "crawler" / "tw", asked)


def walk_invariants(graph, crawl_dir, asked):
    import sqlite3

    con = sqlite3.connect(graph)
    try:
        q = lambda sql: con.execute(sql).fetchall()  # noqa: E731
        edges = q("SELECT destination_channel, source_channel, walkback, "
                  "skipped, sequence_id FROM edge_records")
        batches = q("SELECT status FROM pending_edge_batches")
        pending = q("SELECT COUNT(*) FROM pending_edges")[0][0]
        buffer = q("SELECT url FROM page_buffer")
        invalid = dict(q("SELECT channel_username, reason FROM "
                         "invalid_channels"))
        claimed = {r[0] for r in q("SELECT channel_username FROM "
                                   "discovered_channels")}
        events = q("SELECT COUNT(*) FROM access_events")[0][0]
    finally:
        con.close()
    with open(crawl_dir / "metadata.json", encoding="utf-8") as f:
        status = json.load(f)["status"]
    all_kids = {k for s in WALK_SEEDS for k in kids(s)}
    forward = [e for e in edges if not e[2] and not e[3]]
    walkbacks = [e for e in edges if e[2]]
    return dict(
        status=status, buffer=buffer, pending=pending, events=events,
        batches_completed=all(b[0] == "completed" for b in batches),
        seed_batches=len(batches) >= len(WALK_SEEDS) + 1,
        invalid=invalid,
        forward_to_valid=all(e[0] in all_kids for e in forward),
        every_seed_forward={e[1] for e in forward} == set(WALK_SEEDS),
        four_edge_gone=not any(e[0] == FOUR for e in edges),
        four_replaced=[(e[1], e[2]) for e in walkbacks if e[1] == FOUR_SEED],
        forced=len({e[1] for e in walkbacks if e[1] in all_kids}) >= 1,
        kids_claimed=all_kids <= claimed and FOUR in claimed,
        asked_once=sorted(asked) == sorted(set(asked)),
        asked=sorted(set(asked)),
        posts=[p for p in (os.listdir(crawl_dir) if os.path.isdir(crawl_dir)
                           else []) if os.path.isdir(crawl_dir / p / "posts")])


WALK_WANT = dict(
    status="completed", buffer=[], pending=0, events=0,
    batches_completed=True, seed_batches=True,
    invalid={GHOST: "not_found", PRIVATE: "not_supergroup",
             FOUR: "tdlib_400"},
    forward_to_valid=True, every_seed_forward=True, four_edge_gone=True,
    four_replaced=[[FOUR_SEED, 1]], forced=True, kids_claimed=True,
    asked_once=True,
    asked=sorted({k for s in WALK_SEEDS for k in kids(s)}
                 | {GHOST, PRIVATE, FOUR}),
    posts=[])


@pytest.mark.parametrize("crawler,validator", [
    ("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")])
def test_tandem_walk_completes_with_the_references_invariants(
        tmp_path, crawler, validator):
    got = normalize(tandem_walk(PKGS[crawler], PKGS[validator], tmp_path))
    assert got == normalize(WALK_WANT)


def test_walk_threads_are_joined(tmp_path):
    """No crawler or validator thread outlives the walk."""
    before = {t.name for t in threading.enumerate()}
    tandem_walk(PORT, PORT, tmp_path)
    left = {t.name for t in threading.enumerate()} - before
    assert not {n for n in left if n.startswith(("dct-rw-", "dct-valid"))}

"""The port's Telegram client layer (`distributed_crawler_tpu_torch/
clients/`) against the reference's, on the CPU.

Each case is the counterpart of a case of the reference's
`tests/test_clients.py` (errors, the token bucket, the rate limiter under a
`FakeClock`, the connection pool, the simulated network and client, the
username filter), written once as a scenario that takes a package and
returns what it observed: return values (dataclasses as their fields),
raised errors (class name and message), the fake clock's sleeps and time,
the simulated client's call log and the pool's stats.  Both packages run
every scenario on the same inputs, made from a seed where they are drawn,
and must observe the same thing; nothing is masked.  Host code: no
tolerance.
"""

import dataclasses
import os
import random
import types

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu import clients as jcl  # noqa: E402
from distributed_crawler_tpu.clients import errors as jerr  # noqa: E402
from distributed_crawler_tpu.clients import pool as jpool  # noqa: E402
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu_torch import clients as tcl  # noqa: E402
from distributed_crawler_tpu_torch.clients import errors as terr  # noqa: E402
from distributed_crawler_tpu_torch.clients import pool as tpool  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(cl=jcl, err=jerr, pool=jpool, conf=jconf),
    "port": types.SimpleNamespace(cl=tcl, err=terr, pool=tpool, conf=tconf),
}


def observe(x):
    """Plain data for comparison across packages."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, observe(dataclasses.asdict(x)))
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    if isinstance(x, dict):
        return {k: observe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [observe(v) for v in x]
    return x


def attempt(fn, *a, **kw):
    """fn's result, or the error it raised, as plain data."""
    try:
        return ("ok", observe(fn(*a, **kw)))
    except Exception as e:
        return ("raised", observe(e))


def both(scenario, *args):
    """Run ``scenario`` on each package; they must observe the same."""
    ref = scenario(PKGS["ref"], *args)
    port = scenario(PKGS["port"], *args)
    assert port == ref
    return port


# -- errors ----------------------------------------------------------------------
ERROR_INPUTS = [
    ("exc", "[429] FLOOD_WAIT_72560"),
    ("exc", "429 Too Many Requests: retry after 120"),
    ("exc", "FLOOD_WAIT_"),
    ("exc", "retry after "),
    ("exc", "connection reset"),
    ("none", ""),
    ("flood", 400),
    ("flood", 1),
    ("tg", (400, "USERNAME_INVALID")),
    ("tg", (500, "internal")),
    ("exc", "[400] CHANNEL_INVALID"),
    ("exc", "400 USERNAME_NOT_OCCUPIED"),
    ("exc", "400 USERNAME_INVALID"),
    ("exc", "no messages found in the chat"),
    ("exc", "[500] internal"),
]


def _make_error(P, kind, arg):
    if kind == "none":
        return None
    if kind == "flood":
        return P.err.FloodWaitError(arg)
    if kind == "tg":
        return P.err.TelegramError(*arg)
    return Exception(arg)


@pytest.mark.parametrize("kind,arg", ERROR_INPUTS,
                         ids=[f"{k}-{a}" for k, a in ERROR_INPUTS])
def test_error_taxonomy(kind, arg):
    """`TestErrors`: FLOOD_WAIT parsing in both formats, the unparseable
    short ban, the typed error, the 400 detection."""
    def scenario(P):
        e = _make_error(P, kind, arg)
        out = {"flood": P.err.parse_flood_wait_seconds(e),
               "is_400": P.err.is_telegram_400(e)}
        if e is not None:
            out["str"] = str(e)
            out["code"] = getattr(e, "code", None)
            out["retry_after_s"] = getattr(e, "retry_after_s", None)
        return out

    both(scenario)


def test_retire_threshold():
    assert terr.FLOOD_WAIT_RETIRE_THRESHOLD_S \
        == jerr.FLOOD_WAIT_RETIRE_THRESHOLD_S == 300


# -- the token bucket and the rate limiter ---------------------------------------
@pytest.mark.parametrize("rate", [60.0, 30.0, 6.0, 0])
def test_token_bucket_spacing(rate):
    """`TestTokenBucket`: the first token is free, then one per interval;
    a rate of 0 never waits."""
    def scenario(P):
        clock = P.cl.FakeClock()
        bucket = P.cl.TokenBucket(rate, clock)
        waits = [bucket.wait() for _ in range(5)]
        clock.advance(3.0)
        waits += [bucket.wait() for _ in range(3)]
        return waits, clock.now, clock.sleeps

    waits, _, _ = both(scenario)
    assert waits[0] == 0.0


def make_network(P, n_msgs=5):
    net = P.cl.SimNetwork()
    msgs = [P.cl.TLMessage(content={"@type": "messageText",
                                    "text": f"msg {i}"},
                           date=1700000000 + i) for i in range(n_msgs)]
    net.add_channel("mychannel", messages=msgs, member_count=5000)
    return net


def limited(P, jitter=False, seed=0):
    clock = P.cl.FakeClock()
    net = make_network(P)
    raw = P.cl.SimTelegramClient(net, clock=clock)
    cfg = P.conf.TelegramRateLimitConfig() if jitter else \
        P.conf.TelegramRateLimitConfig(
            get_chat_history_jitter_ms=0, search_public_chat_jitter_ms=0,
            get_supergroup_info_jitter_ms=0,
            get_message_server_hit_jitter_ms=0)
    lim = P.cl.RateLimitedTelegramClient(raw, cfg, clock=clock,
                                         rng=random.Random(seed))
    return lim, raw, clock, net


def _limiter_calls(lim, net, which):
    chat_id = net.channels["mychannel"].chat_id
    sg = net.channels["mychannel"].supergroup_id
    ids = [m.id for m in net.channels["mychannel"].messages]
    out = []
    if which == "chat_history":
        for _ in range(3):
            out.append(attempt(lim.get_chat_history, chat_id))
    elif which == "search":
        for _ in range(3):
            out.append(attempt(lim.search_public_chat, "mychannel"))
    elif which == "get_message_cache":
        for _ in range(3):
            out.append(attempt(lim.get_message, chat_id, ids[0]))
    elif which == "get_message_server":
        for i in ids[:3]:
            out.append(attempt(lim.get_message, chat_id, i))
    elif which == "passthrough":
        for _ in range(10):
            out.append(attempt(lim.get_chat, chat_id))
        out.append(attempt(lim.get_supergroup, sg))
        out.append(attempt(lim.get_message_link, chat_id, ids[1]))
        out.append(attempt(lim.get_me))
        out.append(attempt(lim.get_user, 7))
    elif which == "supergroup_info":
        for _ in range(3):
            out.append(attempt(lim.get_supergroup_full_info, sg))
        out.append(attempt(lim.get_basic_group_full_info, 3))
    elif which == "error_server_hit":
        out.append(attempt(lim.get_message, chat_id, 999999999))
        out.append(attempt(lim.get_message, chat_id, ids[0]))
    return out


LIMITER_CASES = ["chat_history", "search", "get_message_cache",
                 "get_message_server", "passthrough", "supergroup_info",
                 "error_server_hit"]


@pytest.mark.parametrize("jitter", [False, True], ids=["no-jitter", "jitter"])
@pytest.mark.parametrize("which", LIMITER_CASES)
def test_rate_limited_client(which, jitter):
    """`TestRateLimitedClient`: the proactive spacing of history, search
    and supergroup calls, the reactive GetMessage limiter (cache hits
    free, server hits throttled, an error still a server hit), the
    pass-through methods unlimited; with the jitter on, the same seeded
    jitter sleeps."""
    def scenario(P):
        lim, raw, clock, net = limited(P, jitter=jitter, seed=11)
        results = _limiter_calls(lim, net, which)
        return results, clock.now, clock.sleeps, raw.calls

    _, now, sleeps, _ = both(scenario)
    if which == "search" and not jitter:
        assert now >= 19.9  # 6 per minute: 10 s apart
    if which == "get_message_cache" and not jitter:
        assert now < 0.1  # one server hit, then cache hits for free


# -- the connection pool ---------------------------------------------------------
def make_pool(P, n=2):
    net = make_network(P)
    pool = P.pool.ConnectionPool(
        factory=lambda cid: P.cl.SimTelegramClient(net, conn_id=cid),
        database_urls=[f"https://db/{i}.tar.gz" for i in range(n)],
        rate_limit=P.conf.TelegramRateLimitConfig())
    created = pool.initialize()
    return pool, net, created


def _conn(c):
    return (c.conn_id, c.uses, c.errors, c.retired, c.retire_reason,
            c.database_url, type(c.client).__name__)


def pool_acquire_release_reuse(P):
    pool, _, created = make_pool(P, 2)
    c1 = pool.acquire(timeout_s=1)
    c2 = pool.acquire(timeout_s=1)
    pool.release(c1)
    c3 = pool.acquire(timeout_s=1)
    return created, [_conn(c) for c in (c1, c2, c3)], pool.stats(), \
        c3 is c1


def pool_retire_until_empty(P):
    pool, _, _ = make_pool(P, 2)
    out = [pool.empty()]
    pool.retire("conn_0", "flood_wait_72560")
    out.append(pool.empty())
    pool.retire("conn_1", "flood_wait_90000")
    pool.retire("conn_1", "again")  # a second retire is a no-op
    out.append(pool.empty())
    out.append(attempt(pool.acquire, timeout_s=0.1))
    out.append(pool.stats())
    return out


def pool_retired_not_returned(P):
    pool, _, _ = make_pool(P, 2)
    c1 = pool.acquire(timeout_s=1)
    pool.release(c1)
    pool.retire(c1.conn_id)
    c = pool.acquire(timeout_s=1)
    return _conn(c1), _conn(c), pool.stats()


def pool_recreate_after_error(P):
    pool, net, _ = make_pool(P, 1)
    conn = pool.acquire(timeout_s=1)
    conn.client.close()
    fresh = pool.recreate(conn)
    chat = fresh.client.get_chat(net.channels["mychannel"].chat_id)
    pool.release(fresh)
    got = pool.acquire(timeout_s=1)
    return _conn(fresh), observe(chat), got is fresh, pool.stats()


def pool_recreate_caller_owns(P):
    pool, _, _ = make_pool(P, 1)
    conn = pool.acquire(timeout_s=1)
    fresh = pool.recreate(conn)
    out = [attempt(pool.acquire, timeout_s=0.1)]
    pool.release(conn)  # the stale handle: a no-op
    out.append(attempt(pool.acquire, timeout_s=0.1))
    pool.release(fresh)
    out.append(pool.acquire(timeout_s=1) is fresh)
    out.append(pool.stats())
    return out


def pool_recreate_failure_retires(P):
    net = make_network(P)
    made = []

    def factory(cid):
        made.append(cid)
        if len(made) > 1:
            raise RuntimeError("login failed")
        return P.cl.SimTelegramClient(net, conn_id=cid)

    pool = P.pool.ConnectionPool(factory, database_urls=["u"])
    pool.initialize()
    conn = pool.acquire(timeout_s=1)
    return attempt(pool.recreate, conn), pool.stats(), pool.empty(), made


def pool_for_testing(P):
    net = make_network(P)
    pool = P.pool.ConnectionPool.for_testing(
        {"a": P.cl.SimTelegramClient(net, "a"),
         "b": P.cl.SimTelegramClient(net, "b")})
    conns = [pool.acquire(timeout_s=1), pool.acquire(timeout_s=1)]
    out = [_conn(c) for c in conns], pool.stats()
    pool.close_all()
    return out, [c.client.inner.closed for c in conns]


def pool_factory_failure_skipped(P):
    net = make_network(P)

    def factory(cid):
        if cid == "conn_1":
            raise RuntimeError("bad db")
        return P.cl.SimTelegramClient(net, conn_id=cid)

    pool = P.pool.ConnectionPool(factory, database_urls=["a", "b", "c"])
    return pool.initialize(), pool.stats()


def pool_uninitialized(P):
    pool = P.pool.ConnectionPool(lambda cid: None)
    return pool.empty(), attempt(pool.acquire, timeout_s=0.1), pool.stats()


POOL_CASES = [pool_acquire_release_reuse, pool_retire_until_empty,
              pool_retired_not_returned, pool_recreate_after_error,
              pool_recreate_caller_owns, pool_recreate_failure_retires,
              pool_for_testing, pool_factory_failure_skipped,
              pool_uninitialized]


@pytest.mark.parametrize("scenario", POOL_CASES,
                         ids=[f.__name__ for f in POOL_CASES])
def test_connection_pool(scenario):
    """`TestConnectionPool`: acquire and release without a new login, the
    rate-limiter wrapper, retire until empty, recreate (the caller owns
    the fresh connection, a stale release is ignored, a failed recreate
    retires the slot), the testing constructor, a failed connection
    skipped at start."""
    both(scenario)


def test_pool_empty_error_is_the_facade_error():
    assert tcl.PoolEmptyError is tpool.PoolEmptyError


# -- the simulated network and client --------------------------------------------
def seeded_network(P, seed):
    """A few channels of seeded messages, comments and files."""
    rng = np.random.default_rng(seed)
    net = P.cl.SimNetwork()
    for c in range(3):
        n = int(rng.integers(1, 9))
        msgs = [P.cl.TLMessage(
            content={"@type": "messageText",
                     "text": {"text": f"c{c} m{i} {int(rng.integers(1e6))}",
                              "entities": []}},
            date=1700000000 + int(rng.integers(0, 10_000)),
            view_count=int(rng.integers(0, 1000)),
            reply_count=int(rng.integers(0, 3)))
            for i in range(n)]
        ch = net.add_channel(f"seedchan{c}", messages=msgs,
                             member_count=int(rng.integers(10, 10_000)),
                             description=f"about {c}")
        if msgs[0].reply_count:
            net.add_comments(ch.chat_id, msgs[0].id, [
                P.cl.TLMessage(content={"@type": "messageText",
                                        "text": {"text": "a comment"}},
                               sender_username="fan")])
        net.add_file(f"file{c}", bytes(rng.integers(0, 256, 64,
                                                    dtype=np.uint8)))
    return net


def sim_client_walk(P, seed):
    net = seeded_network(P, seed)
    client = P.cl.SimTelegramClient(net, conn_id="c0")
    out = []
    for name in sorted(net.channels):
        chat = client.search_public_chat(name)
        out.append(observe(chat))
        out.append(observe(client.get_chat(chat.id)))
        out.append(observe(client.get_supergroup(chat.supergroup_id)))
        out.append(observe(client.get_supergroup_full_info(
            chat.supergroup_id)))
        frm = 0
        while True:
            page = client.get_chat_history(chat.id, from_message_id=frm,
                                           limit=3)
            out.append(observe(page))
            if not page.messages:
                break
            frm = page.messages[-1].id
        first = net.channels[name].messages[0]
        out.append(attempt(client.get_message, chat.id, first.id))
        out.append(attempt(client.get_message_link, chat.id, first.id))
        out.append(attempt(client.get_message_thread, chat.id, first.id))
        out.append(attempt(client.get_message_thread_history, chat.id,
                           first.id))
    out.append(attempt(client.search_public_chat, "doesnotexist"))
    out.append(attempt(client.get_chat, 42))
    out.append(attempt(client.get_supergroup, 999))
    out.append(attempt(client.get_basic_group_full_info, 1))
    out.append(observe(client.get_me()))
    out.append(observe(client.get_user(5)))
    return out, observe(client.calls)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_client_over_a_seeded_network(seed):
    """`TestSimClient`: history pages newest first and strictly older than
    the cursor, chat and supergroup lookups, messages, links and comment
    threads, the 400s of unknown names and ids, over a seeded network;
    the call logs equal."""
    both(sim_client_walk, seed)


def sim_flood_injection(P):
    net = make_network(P)
    net.inject_flood_wait("SearchPublicChat", 400, count=2)
    net.inject_fault("GetChatHistory", P.err.TelegramError(500, "down"))
    client = P.cl.SimTelegramClient(net)
    chat_id = net.channels["mychannel"].chat_id
    out = [attempt(client.search_public_chat, "mychannel")
           for _ in range(3)]
    out += [attempt(client.get_chat_history, chat_id) for _ in range(2)]
    client.close()
    out.append(attempt(client.get_chat, chat_id))
    return out


def sim_file_download_and_delete(P):
    net = make_network(P)
    net.add_file("remote123", b"JPEGDATA")
    client = P.cl.SimTelegramClient(net)
    f = client.get_remote_file("remote123")
    f = client.download_file(f.id)
    with open(f.local_path, "rb") as fh:
        data = fh.read()
    existed = os.path.exists(f.local_path)
    client.delete_file(f.id)
    return (f.id, f.remote_id, f.size, f.downloaded, existed, data,
            os.path.exists(f.local_path),
            attempt(client.get_remote_file, "missing"),
            attempt(client.download_file, 77))


def sim_latency_clock(P):
    clock = P.cl.FakeClock()
    net = make_network(P)
    client = P.cl.SimTelegramClient(net, clock=clock)
    chat_id = net.channels["mychannel"].chat_id
    first = net.channels["mychannel"].messages[0].id
    client.get_message(chat_id, first)   # server
    client.get_message(chat_id, first)   # cache
    client.get_chat_history(chat_id)
    client.get_chat(chat_id)             # cache latency
    return clock.sleeps, clock.now


def sim_explicit_ids(P):
    net = P.cl.SimNetwork()
    a = net.add_channel("Alpha", chat_id=5, supergroup_id=9)
    b = net.add_channel("beta")
    c = net.add_channel("gamma", supergroup_id=1)
    d = net.add_channel("delta")
    return [(ch.username, ch.chat_id, ch.supergroup_id, ch.title)
            for ch in (a, b, c, d)]


SIM_CASES = [sim_flood_injection, sim_file_download_and_delete,
             sim_latency_clock, sim_explicit_ids]


@pytest.mark.parametrize("scenario", SIM_CASES,
                         ids=[f.__name__ for f in SIM_CASES])
def test_sim_network(scenario):
    """`TestSimClient`: injected FLOOD_WAITs and faults consumed one per
    call, a closed client refused, file download and delete, the modelled
    latency on a fake clock, explicit and assigned ids."""
    both(scenario)


# -- the username filter ---------------------------------------------------------
FILTER_CASES = ["abcd", "a" * 33, "1channel", "_underscore", "trailing_",
                "has space", "кириллица", "somebot", "some_bot", "SomeBot",
                "valid_channel", "NewsRoom24", "abcde", "x1234",
                "tech_news_daily", "dots.in.name", "a" * 32, "Ünicode_x"]


@pytest.mark.parametrize("username", FILTER_CASES)
def test_username_filter(username):
    """`TestUsernameFilter`: the rejection reasons and the accepted
    names."""
    both(lambda P: observe(P.cl.filter_username(username)))


def test_username_filter_fuzz():
    """Seeded random names over the filter's alphabet and its edges."""
    rng = np.random.default_rng(7)
    alphabet = list("abcxyzABZ019_ .-/é")
    names = ["".join(rng.choice(alphabet, int(rng.integers(0, 40))))
             for _ in range(500)]
    got = [observe(tcl.filter_username(n)) for n in names]
    want = [observe(jcl.filter_username(n)) for n in names]
    assert got == want
    assert {g[1]["reason"] for g in got} >= {"", "too_short", "too_long",
                                            "invalid_char"}

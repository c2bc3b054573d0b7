"""The port's channel crawl (`distributed_crawler_tpu_torch/crawl/`,
`telegram/`, `datamodel/validation.py`) against the reference's, on the
CPU.

The counterparts of the reference's `tests/test_crawl_engine.py` for what
the port has: message parsing and link extraction over every content type
the parser knows (text, photo, video, voice note, animation, document,
audio, poll, sticker, giveaway, paid media, and forwarded and replied-to
posts), media through the state manager's hooks, comments, the history
fetch's windows and sampling, the message bookkeeping, `run_for_channel`
and its gates (random-walk sampling accepted; the walk itself is held in
`tests/test_torch_crawl_random_walk.py`), the pool facade, and a pool
from database URLs or a gateway that gets no connection (the native
client's pools themselves: `tests/test_torch_native_client.py`).

Messages and networks are made from a seed with numpy and built the same
way in each package.  Posts are compared as `Post.to_json()` bytes with
one field masked, ``capture_time`` (the wall clock at parse time); page
and message ids are compared where both packages were given them, and
the ids a run draws itself (`new_id`) are masked.  Host code: no
tolerance.
"""

import json
import os
import random
import types
from datetime import datetime, timezone

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu import clients as jcl  # noqa: E402
from distributed_crawler_tpu import datamodel as jdm  # noqa: E402
from distributed_crawler_tpu import telegram as jtg  # noqa: E402
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.crawl import runner as jrun  # noqa: E402
from distributed_crawler_tpu.crawl import errors as jcerr  # noqa: E402
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import datamodels as jdms  # noqa: E402
from distributed_crawler_tpu.state import interface as jstate  # noqa: E402
from distributed_crawler_tpu_torch import clients as tcl  # noqa: E402
from distributed_crawler_tpu_torch import datamodel as tdm  # noqa: E402
from distributed_crawler_tpu_torch import telegram as ttg  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.crawl import runner as trun  # noqa: E402
from distributed_crawler_tpu_torch.crawl import errors as tcerr  # noqa: E402
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import datamodels as tdms  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tstate  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(
        cl=jcl, dm=jdm, tg=jtg, conf=jconf, run=jrun, cerr=jcerr,
        comp=jcomp, dms=jdms, state=jstate),
    "port": types.SimpleNamespace(
        cl=tcl, dm=tdm, tg=ttg, conf=tconf, run=trun, cerr=tcerr,
        comp=tcomp, dms=tdms, state=tstate),
}
REF, PORT = PKGS["ref"], PKGS["port"]


def make_sm(P, root, crawl_id="c1"):
    return P.comp.CompositeStateManager(P.state.StateConfig(
        crawl_id=crawl_id, crawl_execution_id="e1", storage_root=str(root),
        # Both packages' graph stores in memory: a run leaves no file.
        sql=P.state.SqlConfig(url=":memory:")))


def make_cfg(P, **kw):
    base = dict(crawl_id="c1", skip_media_download=True)
    base.update(kw)
    return P.conf.CrawlerConfig(**base)


def masked(line):
    """A `Post.to_json()` line with the wall-clock ``capture_time``
    masked; every other byte kept."""
    d = json.loads(line)
    assert d.pop("capture_time")
    return json.dumps(d)


def post_bytes(post):
    return masked(post.to_json())


def unlimited(P):
    """No proactive waits and no jitter (the limiter's own behaviour is
    held in `tests/test_torch_clients.py`)."""
    return P.conf.TelegramRateLimitConfig(
        get_chat_history_rate=0, search_public_chat_rate=0,
        get_supergroup_info_rate=0, get_message_server_hit_rate=0,
        get_chat_history_jitter_ms=0, search_public_chat_jitter_ms=0,
        get_supergroup_info_jitter_ms=0, get_message_server_hit_jitter_ms=0)


def text_node(text, entities=()):
    return {"text": text, "entities": list(entities)}


# -- seeded messages over every content type ----------------------------------
KINDS = ("text", "photo", "video", "voice", "animation", "document", "audio",
         "poll", "sticker", "giveaway", "paid", "emoji", "forwarded",
         "reply", "unknown")
NAMES = ("alpha_chan", "beta_news", "gamma_feed", "delta_room", "joinchat",
         "somebot", "Mixed_Case1")


def seeded_text(rng):
    """Text with mentions, t.me links, entities (UTF-16 offsets past an
    emoji) and reserved paths."""
    parts, entities = ["😀 start"], []
    units = 2 + len(" start")  # the emoji is two UTF-16 units
    for _ in range(int(rng.integers(1, 5))):
        name = NAMES[int(rng.integers(len(NAMES)))]
        form = int(rng.integers(4))
        token = (f"@{name}", f"t.me/{name}", f"https://t.me/{name}/12",
                 "here")[form]
        parts.append(token)
        offset = units + 1
        if form == 0:
            entities.append({"type": {"@type": "textEntityTypeMention"},
                             "offset": offset, "length": len(token)})
        elif form == 2:
            entities.append({"type": {"@type": "textEntityTypeUrl"},
                             "offset": offset, "length": len(token)})
        elif form == 3:
            entities.append({"type": {"@type": "textEntityTypeTextUrl",
                                      "url": f"https://t.me/{name}"},
                             "offset": offset, "length": len(token)})
        units += 1 + len(token)
    return " ".join(parts), entities


def seeded_content(rng, kind, i):
    text, entities = seeded_text(rng)
    cap = text_node(text, entities)
    media = {"remote_id": f"file_{kind}_{i}"}
    if kind in ("text", "forwarded", "reply"):
        return {"@type": "messageText", "text": cap}
    if kind == "photo":
        return {"@type": "messagePhoto", "caption": cap,
                "photo": {"sizes": [{"remote_id": f"small_{i}"},
                                    {"remote_id": f"big_{i}"}]}}
    if kind == "video":
        return {"@type": "messageVideo", "caption": cap, "video": media}
    if kind == "voice":
        return {"@type": "messageVoiceNote", "caption": cap,
                "voice_note": media}
    if kind == "animation":
        return {"@type": "messageAnimation", "caption": cap,
                "animation": media}
    if kind == "document":
        return {"@type": "messageDocument", "caption": cap,
                "document": media}
    if kind == "audio":
        return {"@type": "messageAudio", "caption": cap, "audio": media}
    if kind == "poll":
        return {"@type": "messagePoll", "poll": {
            "question": {"text": "which @alpha_chan?"},
            "options": [{"text": {"text": "one"}}, {"text": "two"}]}}
    if kind == "sticker":
        return {"@type": "messageSticker",
                "sticker": {"emoji": "🔥", "remote_id": f"st_{i}"}}
    if kind == "giveaway":
        return {"@type": "messageGiveaway", "description": text}
    if kind == "paid":
        return {"@type": "messagePaidMedia", "caption": cap}
    if kind == "emoji":
        return {"@type": "messageAnimatedEmoji", "emoji": "🎉"}
    return {"@type": "messageUnsupported"}


def seeded_messages(P, seed, n=30):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        m = P.cl.TLMessage(
            id=(i + 1) * 1048576,
            content=seeded_content(rng, kind, i),
            date=1700000000 + int(rng.integers(0, 86400)),
            view_count=int(rng.integers(0, 10_000)),
            forward_count=int(rng.integers(0, 50)) if kind == "forwarded"
            else int(rng.integers(0, 3)),
            reply_count=int(rng.integers(0, 4)),
            reactions={"👍": int(rng.integers(0, 9))},
            reply_to_message_id=1048576 if kind == "reply" else 0,
            sender_username=f"user{i}")
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_link_extraction_over_content_types(seed):
    """`TestParsing`'s link cases over seeded messages of every content
    type: names, their sources (mention > text_url > url > plaintext),
    reserved t.me paths dropped, UTF-16 offsets past an emoji."""
    def scenario(P):
        return [[(l.name, l.source_type) for l in
                 P.tg.extract_channel_links_with_source(m)]
                for m in seeded_messages(P, seed)]

    ref, port = scenario(REF), scenario(PORT)
    assert port == ref
    assert any(ref) and all("joinchat" not in [n for n, _ in r] for r in ref)


def test_utf16_slice_and_links():
    cases = [("😀 @chan_one rest", 3, 9), ("abc", 0, 10), ("a😀b", 1, 2),
             ("", 0, 1), ("x😀😀y", 5, 1)]
    for s, off, n in cases:
        assert ttg.utf16_slice(s, off, n) == jtg.utf16_slice(s, off, n)
    for uid in (0, 1048576, 5 * 1048576, 123456789):
        assert ttg.build_telegram_link("chan", uid) \
            == jtg.build_telegram_link("chan", uid)


class HookSM:
    """A state manager with the media hooks the parser calls: the
    processed-media set, `store_file` and `notify_media_stored`, logging
    every call (the same class in both runs)."""

    def __init__(self, root):
        self.root = root
        self.log = []
        self.processed = set()

    def has_processed_media(self, media_id):
        self.log.append(("has", media_id))
        return media_id in self.processed

    def mark_media_as_processed(self, media_id):
        self.log.append(("mark", media_id))
        self.processed.add(media_id)

    def store_file(self, channel, source, name):
        with open(source, "rb") as f:
            data = f.read()
        os.remove(source)
        self.log.append(("store", channel, len(data)))
        return os.path.join(self.root, channel, "media"), f"{channel}-file"

    def notify_media_stored(self, media_id, path, channel_name):
        self.log.append(("notify", media_id, channel_name))


def parse_all(P, seed, tmp, skip_media, max_comments=-1, with_files=True):
    msgs = seeded_messages(P, seed)
    net = P.cl.SimNetwork()
    ch = net.add_channel("mychan", messages=msgs, member_count=777,
                         description="a channel")
    if with_files:
        for m in msgs:
            rid = (m.content.get("video") or m.content.get("voice_note")
                   or m.content.get("document") or {}).get("remote_id")
            if rid:
                net.add_file(rid, b"x" * (len(rid) * 10))
        net.add_file("big_0", b"y" * 32)
    for m in msgs:
        if m.reply_count:
            net.add_comments(ch.chat_id, m.id, [
                P.cl.TLMessage(content={"@type": "messageText",
                                        "text": text_node(f"c{k}")},
                               sender_username=f"fan{k}", view_count=k,
                               reactions={"❤": k})
                for k in range(m.reply_count)])
    client = P.cl.SimTelegramClient(net)
    chat = client.search_public_chat("mychan")
    sg = client.get_supergroup(chat.supergroup_id)
    sgi = client.get_supergroup_full_info(chat.supergroup_id)
    sm = HookSM(str(tmp))
    cfg = make_cfg(P, skip_media_download=skip_media,
                   max_comments=max_comments, crawl_label="lbl")
    posts = []
    for i, m in enumerate(msgs):
        # Alternate the optional supergroup arguments.
        args = (sg, sgi) if i % 3 == 0 else (None, sgi) if i % 3 == 1 \
            else (None, None)
        post = P.tg.parse_message("c1", m, chat, *args, 50, 1000,
                                  "mychan", client, sm, cfg)
        posts.append(post_bytes(post))
    # A second parse of the same messages: the media is deduped.
    posts.append([P.tg.parse_message("c1", m, chat, None, None, 1, 0,
                                     "mychan", client, sm, cfg)
                  .media_data.document_name for m in msgs])
    return posts, sm.log, [c[0] for c in client.calls]


@pytest.mark.parametrize("skip_media", [True, False],
                         ids=["skip-media", "media"])
@pytest.mark.parametrize("seed", [0, 5])
def test_parse_message_over_content_types(seed, skip_media, tmp_path):
    """`test_parse_message_end_to_end`, `_media_and_cap` and `_comments`
    over seeded messages of every type: each `Post.to_json()` equal but
    for ``capture_time``; with media on, the state manager's hooks called
    in the same order (dedup, store, the stored-file announcement, the
    mark) and a second parse storing nothing; the clients' call logs
    equal."""
    ref = parse_all(REF, seed, tmp_path / "ref", skip_media)
    port = parse_all(PORT, seed, tmp_path / "port", skip_media)
    assert port == ref
    if not skip_media:
        assert ("notify", "file_video_2", "mychan") in ref[1]
        assert not any(ref[0][-1])


@pytest.mark.parametrize("max_comments", [0, 1, 100])
def test_parse_message_comments_limit(max_comments, tmp_path):
    ref = parse_all(REF, 9, tmp_path / "ref", True, max_comments)
    port = parse_all(PORT, 9, tmp_path / "port", True, max_comments)
    assert port == ref


def test_parse_message_media_failure_is_contained(tmp_path):
    """A media fetch that fails (no such remote file) leaves the post
    without a document name, in both packages."""
    ref = parse_all(REF, 1, tmp_path / "ref", False, with_files=False)
    port = parse_all(PORT, 1, tmp_path / "port", False, with_files=False)
    assert port == ref


# -- the history fetch ---------------------------------------------------------
def fetch_case(P, seed, window, max_posts, sample):
    rng = np.random.default_rng(seed)
    dates = sorted(int(d) for d in rng.integers(1000, 9000, 250))
    net = P.cl.SimNetwork()
    ch = net.add_channel("chan", messages=[
        P.cl.TLMessage(content={"@type": "messageText",
                                "text": text_node(f"m{i}")}, date=d)
        for i, d in enumerate(dates)])
    client = P.cl.SimTelegramClient(net)
    lo, hi = window
    ts = (lambda x: datetime.fromtimestamp(x, tz=timezone.utc)
          if x is not None else None)
    msgs = P.tg.fetch_channel_messages_with_sampling(
        client, ch.chat_id, P.dms.Page(url="chan"), min_post_date=ts(lo),
        max_post_date=ts(hi), max_posts=max_posts, sample_size=sample,
        rng=random.Random(seed))
    return [(m.id, m.date) for m in msgs], [c[1] for c in client.calls]


FETCH_CASES = [((None, None), -1, 0), ((2500, None), -1, 0),
               ((None, None), 7, 0), ((None, None), -1, 10),
               ((1500, 4500), -1, 0), ((1500, 4500), 20, 5),
               ((9500, None), -1, 0), ((None, None), 0, 0)]


@pytest.mark.parametrize("window,max_posts,sample", FETCH_CASES)
def test_fetch_windows_and_sampling(window, max_posts, sample):
    """`TestFetch`: the min-date cutoff, `max_posts`, seeded sampling and
    the date window, over 250 seeded dates: the same messages in the same
    order, from the same history calls."""
    assert fetch_case(PORT, 3, window, max_posts, sample) \
        == fetch_case(REF, 3, window, max_posts, sample)


# -- message bookkeeping ---------------------------------------------------------
def test_message_bookkeeping():
    """`TestMessageBookkeeping` over seeded statuses."""
    rng = np.random.default_rng(4)
    statuses = ["fetched", "unfetched", "failed", "resample", "deleted"]
    spec = [(int(rng.integers(1, 4)), int(rng.integers(1, 30)),
             statuses[int(rng.integers(len(statuses)))]) for _ in range(40)]
    disc = [(int(rng.integers(1, 4)), int(rng.integers(1, 30)))
            for _ in range(30)]

    def scenario(P):
        owner = P.dms.Page(id="p1", messages=[
            P.dms.Message(chat_id=c, message_id=m, status=s)
            for c, m, s in spec])
        found = [P.dms.Message(chat_id=c, message_id=m) for c, m in disc]
        merged = P.run.add_new_messages(found, owner)
        marked = P.run.resample_marker(merged, found)
        return [(m.chat_id, m.message_id, m.status) for m in marked]

    assert scenario(PORT) == scenario(REF)


# -- run_for_channel -----------------------------------------------------------
def seeded_crawl_network(P, seed):
    """A source channel whose seeded messages mention channels that exist
    and channels that do not, plus the targets."""
    rng = np.random.default_rng(seed)
    net = P.cl.SimNetwork()
    targets = ("target_one", "target_two", "target_three")
    msgs = []
    for i in range(12):
        named = [targets[int(rng.integers(3))] for _ in range(2)]
        text = f"post {i} @{named[0]} t.me/{named[1]} @ghost_{i % 3} " \
               f"t.me/source_chan"
        msgs.append(P.cl.TLMessage(
            content={"@type": "messageText", "text": text_node(text)},
            date=1700000000 + i * 60, view_count=int(rng.integers(1, 500)),
            reply_count=int(rng.integers(0, 2))))
    net.add_channel("source_chan", messages=msgs, member_count=1000)
    for t in targets:
        net.add_channel(t, messages=[P.cl.TLMessage(
            content={"@type": "messageText", "text": text_node("hi")},
            date=1700000005)], member_count=500)
    return net


def read_posts(root):
    path = os.path.join(str(root), "c1", "source_chan", "posts",
                        "posts.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [masked(ln) for ln in f.read().splitlines()]


def run_channel(P, root, seed=0, processor=None, **cfg_kw):
    net = seeded_crawl_network(P, seed)
    client = P.cl.SimTelegramClient(net)
    sm = make_sm(P, root)
    page = P.dms.Page(id="p1", url="source_chan", depth=2, parent_id="p0")
    sm.update_page(page)
    result = attempt(P.run.run_for_channel, client, page, "", sm,
                     make_cfg(P, max_comments=5, **cfg_kw),
                     processor=processor)
    if result[0] == "ok":
        result = ("ok", [(p["url"], p["depth"], p["parent_id"], p["status"])
                         for p in result[1]])
    return dict(result=result, page_status=page.status,
                messages=[(m.chat_id, m.message_id, m.status, m.page_id)
                          for m in sm.get_page("p1").messages]
                if "p1" in sm.page_map else None,
                posts=read_posts(root), calls=[c[0] for c in client.calls])


def attempt(fn, *a, **kw):
    try:
        out = fn(*a, **kw)
    except Exception as e:
        return ("raised", type(e).__name__, str(e))
    if isinstance(out, list):
        out = [vars(p) if hasattr(p, "__dict__") else p for p in out]
    return ("ok", out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_for_channel_discovers_and_stores(seed, tmp_path):
    """`test_happy_path_stores_posts_and_discovers` over a seeded network:
    the discovered pages (url, depth, parent, status) equal, every stored
    post byte-equal but for ``capture_time``, the page's message statuses
    equal, the same client calls."""
    ref = run_channel(REF, tmp_path / "ref", seed)
    port = run_channel(PORT, tmp_path / "port", seed)
    assert port == ref
    assert ref["result"][0] == "ok" and ref["page_status"] == "fetched"
    assert len(ref["posts"]) == 12
    assert {u for u, *_ in ref["result"][1]} >= {"target_one"}
    assert all(d == 3 and p == "p1" for _, d, p, _ in ref["result"][1])


GATES = {
    "min_users": dict(min_users=999999),
    "post_recency": dict(post_recency=datetime(2030, 1, 1,
                                               tzinfo=timezone.utc)),
    "recent_enough": dict(post_recency=datetime(2020, 1, 1,
                                                tzinfo=timezone.utc)),
    "max_posts": dict(max_posts=4),
    "date_window": dict(date_between_min=datetime.fromtimestamp(
        1700000100, tz=timezone.utc), date_between_max=datetime.fromtimestamp(
        1700000400, tz=timezone.utc)),
    "snowball": dict(sampling_method="snowball"),
    "null_config": dict(null_config=json.dumps({"rules": {
        "description": {"behavior": "critical"}}})),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_run_for_channel_gates(gate, tmp_path):
    """`test_min_users_gate_marks_deadend`, `test_post_recency_gate`, and
    the windows, snowball sampling and a user null-field rule: the same
    outcome, pages, statuses and posts."""
    ref = run_channel(REF, tmp_path / "ref", 1, **GATES[gate])
    port = run_channel(PORT, tmp_path / "port", 1, **GATES[gate])
    assert port == ref


def test_unknown_channel_raises_400(tmp_path):
    def scenario(P, root):
        net = P.cl.SimNetwork()
        client = P.cl.SimTelegramClient(net)
        return attempt(P.run.run_for_channel, client,
                       P.dms.Page(id="p1", url="ghost_chan"), "",
                       make_sm(P, root), make_cfg(P))

    ref = scenario(REF, tmp_path / "ref")
    assert scenario(PORT, tmp_path / "port") == ref
    assert ref[1] == "TDLib400Error"


def test_failed_message_marked_and_others_continue(tmp_path):
    """A processor that fails on the second and fifth messages: those are
    marked failed, the others fetched, in both packages."""
    def flaky(P):
        class Flaky(P.run.DefaultMessageProcessor):
            count = 0

            def process_message(self, *a, **kw):
                Flaky.count += 1
                if Flaky.count in (2, 5):
                    raise RuntimeError("boom")
                return super().process_message(*a, **kw)
        return Flaky()

    ref = run_channel(REF, tmp_path / "ref", 2, processor=flaky(REF))
    port = run_channel(PORT, tmp_path / "port", 2, processor=flaky(PORT))
    assert port == ref
    assert [m[2] for m in ref["messages"]].count("failed") == 2


def test_resumed_page_skips_fetched_messages(tmp_path):
    """A page crawled twice: the second run keeps the fetched messages and
    stores nothing again."""
    def scenario(P, root):
        net = seeded_crawl_network(P, 3)
        client = P.cl.SimTelegramClient(net)
        sm = make_sm(P, root)
        page = P.dms.Page(id="p1", url="source_chan")
        sm.update_page(page)
        first = P.run.run_for_channel(client, page, "", sm, make_cfg(P))
        second = P.run.run_for_channel(client, page, "", sm, make_cfg(P))
        return (len(first), len(second),
                [m.status for m in sm.get_page("p1").messages],
                len(read_posts(root)))

    assert scenario(PORT, tmp_path / "port") == scenario(REF,
                                                         tmp_path / "ref")


# -- the refusals ----------------------------------------------------------------
def test_random_walk_is_refused_by_name(tmp_path):
    """Random-walk sampling is no longer refused: `run_for_channel` and
    `process_all_messages` take it in both packages, make the same client
    calls and return no pages (the walk's next page goes to the page
    buffer, held in `tests/test_torch_crawl_random_walk.py`)."""
    def scenario(P, root):
        random.seed(5)
        net = seeded_crawl_network(P, 0)
        client = P.cl.SimTelegramClient(net)
        sm = make_sm(P, root)
        cfg = make_cfg(P, sampling_method="random-walk")
        page = P.dms.Page(id="p1", url="source_chan")
        sm.update_page(page)
        pages = P.run.run_for_channel(client, page, "", sm, cfg,
                                      rng=random.Random(1))
        again = P.run.process_all_messages(
            client, None, [], "c1", "source_chan", sm,
            P.dms.Page(id="p2", url="source_chan"), cfg,
            rng=random.Random(2))
        return (pages, again, [c[0] for c in client.calls],
                [p.url for p in sm.get_pages_from_page_buffer(10)])

    got = scenario(PORT, tmp_path / "port")
    assert got == scenario(REF, tmp_path / "ref")
    assert got[0] == [] and got[1] == [] and "SearchPublicChat" in got[2]


@pytest.mark.parametrize("field,value", [
    ("tdlib_database_urls", ["https://db/0.tar.gz", "https://db/1.tar.gz"]),
    ("tdlib_database_url", "https://db/one.tar.gz"),
    ("dc_address", "127.0.0.1:4430"),
])
def test_native_pool_is_refused_by_name(field, value, tmp_path):
    """A pool whose every connection is refused (an https seed URL, which
    the native client's `acquire_seed_db` refuses; a gateway address no
    one listens on) raises the reference's `PoolEmptyError` with its
    message, and no pool is installed, in both packages."""
    got = {}
    for name, P in PKGS.items():
        P.run.shutdown_connection_pool()
        with pytest.raises(Exception) as ei:
            P.run.setup_pool_from_config(make_cfg(
                P, storage_root=str(tmp_path / name), **{field: value}))
        got[name] = (type(ei.value).__name__, str(ei.value))
        assert P.run._pool is None
    assert got["port"] == got["ref"]
    assert got["port"][0] == "PoolEmptyError"


def test_setup_pool_noop_cases_match_the_reference():
    """`test_noop_without_urls_or_with_existing_pool`: no URL is False; an
    installed pool is left alone and is True (each package's own pool)."""
    out = {}
    for name, P in PKGS.items():
        P.run.shutdown_connection_pool()
        no_urls = P.run.setup_pool_from_config(make_cfg(P))
        net = seeded_crawl_network(P, 0)
        pool = P.cl.ConnectionPool(
            factory=lambda cid, net=net, P=P: P.cl.SimTelegramClient(net,
                                                                    cid))
        pool.initialize()
        P.run.init_connection_pool(pool)
        try:
            kept = P.run.setup_pool_from_config(make_cfg(
                P, tdlib_database_urls=["unused.tar.gz"]))
            out[name] = (no_urls, kept, P.run._pool is pool)
        finally:
            P.run.shutdown_connection_pool()
    assert out["port"] == out["ref"] == (False, True, True)


def pool_facade(P, root):
    net = seeded_crawl_network(P, 0)
    pool = P.cl.ConnectionPool(factory=lambda cid: P.cl.SimTelegramClient(
        net, cid), database_urls=["a", "b"], rate_limit=unlimited(P))
    pool.initialize()
    P.run.shutdown_connection_pool()
    P.run.init_connection_pool(pool)
    sm = make_sm(P, root)
    seen = []

    def flood(client, page, prefix, sm_, cfg, processor=None):
        seen.append(page.connection_id)
        raise P.cerr.FloodWaitRetireError(90000)

    def plain(client, page, prefix, sm_, cfg, processor=None):
        seen.append(page.connection_id)
        raise RuntimeError("plain error")

    out = []
    try:
        for fn in (flood, plain, None):
            P.run.set_run_for_channel_fn(fn)
            page = P.dms.Page(id=f"p{len(out)}", url="source_chan")
            sm.update_page(page)
            r = attempt(P.run.run_for_channel_with_pool, page, "", sm,
                        make_cfg(P))
            out.append((r if r[0] == "raised" else
                        ("ok", sorted(p["url"] for p in r[1])),
                        pool.stats()))
        conn = P.run.get_connection_from_pool(timeout_s=1)
        P.run.release_connection_to_pool(conn)
        P.run.retire_connection_from_pool(conn.conn_id, "manual")
        out.append(pool.stats())
        P.run.retire_connection_from_pool("conn_1", "manual")
        out.append(attempt(P.run.get_connection_from_pool, timeout_s=0.1))
    finally:
        P.run.set_run_for_channel_fn(None)
        P.run.shutdown_connection_pool()
    out.append(attempt(P.run.get_connection_from_pool, timeout_s=0.1))
    return out, seen


def test_pool_facade_retires_on_flood_wait(tmp_path):
    """`TestPoolFacade`: a FloodWaitRetireError retires the connection, a
    plain error releases it, a crawl through the pool succeeds; then the
    pool empties and the uninstalled facade refuses."""
    ref = pool_facade(REF, tmp_path / "ref")
    port = pool_facade(PORT, tmp_path / "port")
    assert port == ref
    assert ref[0][0][1]["retired"] == 1


def test_null_validator_matches_the_reference():
    """`NullValidator` on seeded posts and channel data, with the default
    rules and a user JSON rule: the same validity, errors, warnings and
    events."""
    user = json.dumps({"rules": {"handle": {"behavior": "critical",
                                            "message": "need it"}}})

    def scenario(dm):
        out = []
        for platform in ("telegram", "youtube"):
            for v in (dm.NullValidator(platform),
                      dm.NullValidator.from_json(user, platform)):
                r = np.random.default_rng(12)
                for i in range(6):
                    post = dm.Post(
                        post_uid=f"u{i}" if r.random() < 0.7 else "",
                        post_link="l" if r.random() < 0.7 else "",
                        channel_id="c", url="u", platform_name=platform,
                        handle="h" if r.random() < 0.5 else "",
                        view_count=int(r.integers(0, 3)))
                    res = v.validate_post(post)
                    out.append((res.valid, res.errors, res.warnings,
                                res.unavailable_used,
                                [e.to_dict() for e in res.null_log_events]))
                    cd = dm.ChannelData(channel_id=f"{i}" * (i % 2))
                    res = v.validate_channel_data(cd)
                    out.append((res.valid, res.errors, res.warnings))
        return out

    assert scenario(tdm) == scenario(jdm)
    with pytest.raises(ValueError):
        tdm.merge_configs("myspace", None)

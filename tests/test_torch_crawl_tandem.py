"""The port's tandem crawl step (`distributed_crawler_tpu_torch/crawl/
runner.py`: the tandem branch of `process_all_messages`, `_finish_tandem`)
and its 400-replacement (`crawl/replacement.py`) against the reference's,
on the CPU.

- The counterparts of `tests/test_crawl_engine.py::TestTandem`: one
  tandem step over the same seeded `SimNetwork` in both packages, each on
  a `CompositeStateManager` with an in-memory graph, must leave the same
  pending batches and edges, edge records, page-buffer rows, invalid
  marks and discovered set, and make the same client calls (no
  ``SearchPublicChat`` for an outlink); bot usernames are filtered out; a
  page without edges walks back at once.
- The counterparts of `::Test400Replacement`: a forward edge promotes a
  skipped sibling, or walks back when there is none; a walkback edge walks
  back again; a channel without an edge walks back, or is replaced from
  the seed pool when it is a seed.
- Randomness: both packages get the same ``rng`` and the same stdlib
  `random` seed, so ids are compared by order of appearance and
  everything else exactly.

Host code: no tolerance.
"""

import json
import random
import types

import pytest

pytest.importorskip("jax")

from distributed_crawler_tpu.crawl import replacement as jrepl  # noqa: E402
from distributed_crawler_tpu_torch.crawl import replacement as trepl  # noqa: E402

from tests.test_torch_crawl_random_walk import (  # noqa: E402
    PKGS,
    attempt,
    make_cfg,
    make_sm,
    rw_network,
    text,
)
from tests.test_torch_orchestrator import normalize  # noqa: E402

# The random-walk file's namespaces, with each package's replacement.
PKGS = {pkg: types.SimpleNamespace(**vars(P), repl=repl)
        for (pkg, P), repl in zip(PKGS.items(), (jrepl, trepl))}


def graph_rows(sm):
    q = sm.graph.binding.query
    return dict(
        batches=q("SELECT batch_id, crawl_id, source_channel, "
                  "source_page_id, source_depth, sequence_id, status FROM "
                  "pending_edge_batches ORDER BY created_at, batch_id"),
        pending=q("SELECT batch_id, crawl_id, destination_channel, "
                  "source_channel, sequence_id, source_type, "
                  "validation_status FROM pending_edges ORDER BY pending_id"),
        edges=q("SELECT destination_channel, source_channel, walkback, "
                "skipped, sequence_id FROM edge_records ORDER BY edge_id"),
        buffer=q("SELECT page_id, parent_id, depth, url, crawl_id, "
                 "sequence_id FROM page_buffer ORDER BY rowid"),
        seeds=q("SELECT channel_username, chat_id, invalidated_at IS NULL "
                "FROM seed_channels ORDER BY channel_username"),
        invalid=q("SELECT channel_username, reason FROM invalid_channels "
                  "ORDER BY channel_username"),
        discovered=q("SELECT channel_username FROM discovered_channels "
                     "ORDER BY channel_username"))


def both(tmp_path, fn, *a, **kw):
    got = {}
    for pkg, P in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        got[pkg] = normalize(fn(P, root, *a, **kw))
    assert got["port"] == got["ref"]
    return got["port"]


# -- TestTandem's cases -----------------------------------------------------------
def tandem_step(P, root, seed, extra=()):
    """One tandem step over ``rw_network(seed)`` with ``extra`` names
    added to the source's last post."""
    random.seed(seed)
    net, targets = rw_network(P, seed)
    if extra:
        net.channels["source_chan"].messages[-1].content["text"]["text"] += \
            " " + " ".join(f"@{n}" for n in extra)
    client = P.cl.SimTelegramClient(net)
    sm = make_sm(P, root)
    sm.mark_channel_invalid("target_9", "not_found")
    sm.initialize(["source_chan"])
    page = sm.get_layer_by_depth(0)[0]
    out = attempt(P.run.run_for_channel, client, page, "", sm,
                  make_cfg(P, tandem_crawl=True, walkback_rate=0),
                  rng=random.Random(seed))
    return dict(out=out, graph=graph_rows(sm), seq=page.sequence_id,
                page_id=page.id, calls=[c[0] for c in client.calls],
                searched=[c[1][0] for c in client.calls
                          if c[0] == "SearchPublicChat"],
                discovered=sorted(sm.discovered_channels._keys),
                incomplete=sm.count_incomplete_batches("c1"),
                status=page.status)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_edges_streamed_and_the_batch_closed(tmp_path, seed):
    got = both(tmp_path, tandem_step, seed)
    g = got["graph"]
    # No SearchPublicChat for an outlink: only the source's own.
    assert got["searched"] == ["source_chan"]
    (batch,) = g["batches"]
    assert batch[2:] == ["source_chan", got["page_id"], 0, got["seq"],
                         "closed"]
    named = {f"target_{i}" for i in range(1 + seed % 4)} | {
        "ghost_chan", "private_room", "seed_chan"}
    # Each name once, target_9 (invalid before) and the source left out.
    dests = [e[2] for e in g["pending"]]
    assert sorted(dests) == sorted(named) and len(set(dests)) == len(dests)
    assert all(e[0] == batch[0] and e[4] == got["seq"] and e[6] == "pending"
               for e in g["pending"])
    # The validator owns the next page: no edge record, no buffered page.
    assert g["edges"] == [] and g["buffer"] == []
    assert got["incomplete"] == 1 and got["status"] == "fetched"
    assert got["out"] == ["ok", []]


def test_bot_usernames_prefiltered(tmp_path):
    got = both(tmp_path, tandem_step, 0, extra=("spam_bot", "SomeBot",
                                                "abc", "1channel"))
    dests = {e[2] for e in got["graph"]["pending"]}
    assert not dests & {"spam_bot", "SomeBot", "abc", "1channel"}
    assert "target_0" in dests


def no_edges(P, root, seed):
    random.seed(seed)
    net = P.cl.SimNetwork()
    net.add_channel("source_chan", messages=[
        text(P, "no mentions here", date=1700000000)], member_count=100)
    net.add_channel("other_chan", messages=[text(P, "x", date=1)])
    net.add_channel("third_chan", messages=[text(P, "y", date=1)])
    client = P.cl.SimTelegramClient(net)
    sm = make_sm(P, root)
    sm.initialize(["source_chan", "other_chan", "third_chan"])
    for ch in ("other_chan", "third_chan", "source_chan"):
        sm.add_discovered_channel(ch)
    page = [p for p in sm.get_layer_by_depth(0) if p.url == "source_chan"][0]
    out = attempt(P.run.run_for_channel, client, page, "", sm,
                  make_cfg(P, tandem_crawl=True), rng=random.Random(seed))
    return dict(out=out, graph=graph_rows(sm), seq=page.sequence_id,
                page_id=page.id)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_no_edges_forces_a_walkback(tmp_path, seed):
    got = both(tmp_path, no_edges, seed)
    g = got["graph"]
    assert g["batches"] == [] and g["pending"] == []
    (row,) = g["buffer"]
    assert row[1:3] == [got["page_id"], 1]
    assert row[3] in ("other_chan", "third_chan")
    assert row[5] != got["seq"]  # the next page starts a new chain
    assert g["edges"] == [[row[3], "source_chan", 1, 0, got["seq"]]]


def test_no_edges_and_nothing_to_walk_back_to(tmp_path):
    def scenario(P, root):
        random.seed(0)
        net = P.cl.SimNetwork()
        net.add_channel("source_chan", messages=[
            text(P, "nothing", date=1700000000)], member_count=100)
        client = P.cl.SimTelegramClient(net)
        sm = make_sm(P, root)
        sm.initialize(["source_chan"])
        page = sm.get_layer_by_depth(0)[0]
        return dict(out=attempt(P.run.run_for_channel, client, page, "", sm,
                                make_cfg(P, tandem_crawl=True),
                                rng=random.Random(0)),
                    graph=graph_rows(sm))

    got = both(tmp_path, scenario)
    assert got["out"][:2] == ["raised", "WalkbackExhaustedError"]
    assert got["graph"]["buffer"] == [] and got["graph"]["edges"] == []


# -- Test400Replacement's cases ---------------------------------------------------------
def replacement(P, root, case, seed):
    random.seed(seed)
    sm = make_sm(P, root)
    for ch in ("src_chan", "dead_chan", "alt_chan", "walk_chan"):
        sm.add_discovered_channel(ch)
    E = P.dms.EdgeRecord
    if case.startswith("forward_promotes"):
        siblings = ["alt_chan", "walk_chan"][:2 if case.endswith("two")
                                              else 1]
        sm.save_edge_records([
            E(destination_channel="dead_chan", source_channel="src_chan",
              skipped=False, sequence_id="q1")] + [
            E(destination_channel=ch, source_channel="src_chan",
              skipped=True, sequence_id="q1") for ch in siblings])
    elif case == "forward_no_skipped":
        sm.save_edge_records([
            E(destination_channel="dead_chan", source_channel="src_chan",
              skipped=False, sequence_id="q1")])
    elif case == "walkback_edge":
        sm.save_edge_records([
            E(destination_channel="dead_chan", source_channel="src_chan",
              walkback=True, skipped=False, sequence_id="q1")])
    elif case == "seed_no_edge":
        sm.mark_channel_crawled("dead_chan", 1)
        sm.mark_channel_crawled("fresh_seed", 2)
        sm.load_seed_channels()
    page = P.dms.Page(id="pdead", url="dead_chan", sequence_id="q1",
                      depth=3, parent_id="pp")
    out = attempt(P.repl.handle_400_replacement, sm, page,
                  make_cfg(P), rng=random.Random(seed))
    got = dict(out=out, graph=graph_rows(sm),
               invalid=sm.is_invalid_channel("dead_chan"))
    if case == "forward_promotes_of_two":
        # The store draws the sibling with ORDER BY RANDOM(), which no
        # seed reaches: name the promoted one by its role.
        (row,) = got["graph"]["buffer"]
        other = {"alt_chan", "walk_chan"} - {row[3]}
        got = normalize(got)
        got = json.loads(json.dumps(got).replace(f'"{row[3]}"', '"<promoted>"')
                         .replace(f'"{other.pop()}"', '"<other>"'))
        got["graph"] = {k: sorted(v) for k, v in got["graph"].items()}
    return got


REPLACEMENT_CASES = ("forward_promotes", "forward_promotes_of_two",
                     "forward_no_skipped", "walkback_edge", "no_edge",
                     "seed_no_edge")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", REPLACEMENT_CASES)
def test_400_replacement_is_the_references(tmp_path, case, seed):
    got = both(tmp_path, replacement, case, seed)
    g = got["graph"]
    assert got["out"] == ["ok", None] and got["invalid"] is True
    assert ["dead_chan", "tdlib_400"] in g["invalid"]
    assert not any(e[0] == "dead_chan" for e in g["edges"])  # deleted
    (row,) = g["buffer"]
    assert row[1:3] == ["pp", 3]
    if case.startswith("forward_promotes"):
        assert row[3] in ("alt_chan", "<promoted>") and row[5] == "q1"
        promoted = [e for e in g["edges"] if e[0] == row[3]]
        assert promoted == [[row[3], "src_chan", 0, 0, "q1"]]
    elif case == "seed_no_edge":
        # dead_chan left the seed pool: only fresh_seed remains.
        assert row[3] == "fresh_seed" and row[5] != "q1"
        assert g["edges"] == []
        assert ["dead_chan", 1, 0] in g["seeds"]
    else:
        assert row[3] not in ("dead_chan",) and row[5] != "q1"
        source = "dead_chan" if case == "no_edge" else "src_chan"
        assert [row[3], source, 1, 0, "q1"] in g["edges"]

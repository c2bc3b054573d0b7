"""The port's page state (`distributed_crawler_tpu_torch/state/base.py`,
`state/local.py`, `state/composite.py`, `state/datamodels.py`,
`modes/common.py`) against the reference's, on the CPU.

- The page-state cases of the reference's `tests/test_state_base.py`
  (`TestBaseStateManager`, `TestLocalStateManager`) run on both packages
  and must observe the same pages, depths, metadata and incomplete-crawl
  answers (ids and walls by structure).
- ``state.json`` and ``metadata.json`` are byte-equal both ways: each
  package resumes the other's files and writes them back unchanged.
- The composite manager's cross-crawl URL cache skips the seeds a previous
  crawl processed, as the reference's does; a mode gets the class the
  reference's factory picks for it; and the port's state tree is the
  reference's without
  ``graph.sqlite`` (ROADMAP Queue 3: the SQL graph store is not ported).
"""

import json
import os
from datetime import datetime, timezone

import pytest

pytest.importorskip("jax")

from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.datamodel import Post as JPost  # noqa: E402
from distributed_crawler_tpu.modes import common as jcommon  # noqa: E402
from distributed_crawler_tpu.state import base as jbase  # noqa: E402
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import datamodels as jdm  # noqa: E402
from distributed_crawler_tpu.state import factory as jfactory  # noqa: E402
from distributed_crawler_tpu.state import interface as jiface  # noqa: E402
from distributed_crawler_tpu.state import local as jlocal  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.datamodel import Post as TPost  # noqa: E402
from distributed_crawler_tpu_torch.modes import common as tcommon  # noqa: E402
from distributed_crawler_tpu_torch.state import base as tbase  # noqa: E402
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import datamodels as tdm  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tiface  # noqa: E402
from distributed_crawler_tpu_torch.state import local as tlocal  # noqa: E402

from tests.test_torch_orchestrator import normalize  # noqa: E402

PKGS = {
    "ref": dict(base=jbase, local=jlocal, comp=jcomp, dm=jdm, iface=jiface,
                common=jcommon, conf=jconf, Post=JPost),
    "port": dict(base=tbase, local=tlocal, comp=tcomp, dm=tdm, iface=tiface,
                 common=tcommon, conf=tconf, Post=TPost),
}
FIXED = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)


def cfg(P, **kw):
    base = dict(crawl_id="c1", crawl_execution_id="e1", platform="telegram")
    base.update(kw)
    return P["iface"].StateConfig(**base)


def local_sm(P, root, **kw):
    return P["local"].LocalStateManager(cfg(
        P, local=P["iface"].LocalConfig(base_path=str(root)), **kw))


def layers(sm):
    out = []
    try:
        top = sm.get_max_depth()
    except LookupError:
        return out
    for d in range(top + 1):
        out.append([(p.url, p.depth, p.status, p.parent_id)
                    for p in sm.get_layer_by_depth(d)])
    return out


# -- TestBaseStateManager / TestLocalStateManager's cases ---------------------------
def sc_initialize_seeds_layer_zero(P, root):
    sm = P["base"].BaseStateManager(cfg(P))
    sm.initialize(["a", "b"])
    return dict(layers=layers(sm),
                seq=[p.sequence_id for p in sm.get_layer_by_depth(0)],
                platform=[p.platform for p in sm.get_layer_by_depth(0)])


def sc_add_layer_dedups_urls_across_layers(P, root):
    sm = P["base"].BaseStateManager(cfg(P))
    sm.initialize(["a"])
    Page = P["dm"].Page
    sm.add_layer([Page(url="a", depth=1), Page(url="b", depth=1),
                  Page(url="b", depth=1)])
    sm.add_layer([])
    return layers(sm)


def sc_add_layer_max_pages_deadend_replacement(P, root):
    sm = P["base"].BaseStateManager(cfg(P, max_pages=2))
    Page = P["dm"].Page
    sm.initialize(["a", "b"])
    sm.add_layer([Page(url="c", depth=1)])
    first = layers(sm)
    page = sm.get_layer_by_depth(0)[0]
    page.status = P["dm"].PAGE_DEADEND
    sm.update_page(page)
    sm.add_layer([Page(url="c", depth=1), Page(url="d", depth=1)])
    return dict(first=first, after=layers(sm))


def sc_get_max_depth(P, root):
    sm = P["base"].BaseStateManager(cfg(P))
    with pytest.raises(LookupError):
        sm.get_max_depth()
    sm.initialize(["a"])
    sm.add_layer([P["dm"].Page(url="b", depth=1)])
    return sm.get_max_depth()


def sc_metadata_update_guards_crawl_id(P, root):
    sm = P["base"].BaseStateManager(cfg(P))
    with pytest.raises(ValueError) as e:
        sm.update_crawl_metadata("other", {"status": "completed"})
    sm.update_crawl_metadata("c1", {
        "status": "completed", "previousCrawlID": "old1",
        "endTime": "2026-01-02T03:04:05Z", "messagesCount": 7,
        "errorsCount": 2, "ignored": 1})
    sm.update_crawl_metadata("c1", {"previousCrawlID": ["old2", "old3"]})
    return dict(error=str(e.value), meta=sm.metadata.to_dict())


def sc_find_incomplete_crawl(P, root):
    sm = P["base"].BaseStateManager(cfg(P))
    sm.initialize(["a"])
    first = sm.find_incomplete_crawl("c1")
    sm.update_crawl_metadata("c1", {"status": "completed"})
    mid = sm.find_incomplete_crawl("c1")
    for p in sm.get_layer_by_depth(0):
        p.status = P["dm"].PAGE_FETCHED
        sm.update_page(p)
    return [first, mid, sm.find_incomplete_crawl("c1"),
            sm.find_incomplete_crawl("other")]


def sc_state_persistence_roundtrip(P, root):
    sm = local_sm(P, root)
    sm.initialize(["a", "b"])
    page = sm.get_layer_by_depth(0)[0]
    page.status = P["dm"].PAGE_FETCHED
    sm.update_page(page)
    sm.save_state()
    sm2 = local_sm(P, root)
    sm2.initialize(["ignored"])
    return dict(layers=layers(sm2), files=sorted(os.listdir(root / "c1")))


def sc_store_post_appends_jsonl(P, root):
    sm = local_sm(P, root)
    sm.initialize(["a"])
    post = P["Post"](post_link="x", channel_id="chan", post_uid="1", url="x",
                     platform_name="telegram")
    sm.store_post("chan", post)
    sm.store_post("chan", post)
    sm.close()
    return (root / "c1" / "chan" / "posts" / "posts.jsonl").read_text()


def sc_find_incomplete_crawl_from_disk(P, root):
    sm = local_sm(P, root)
    sm.initialize(["a"])
    sm.save_state()
    got = [local_sm(P, root).find_incomplete_crawl("c1")]
    sm.update_crawl_metadata("c1", {"status": "completed",
                                    "previousCrawlID": "c0"})
    for p in sm.get_layer_by_depth(0):
        p.status = P["dm"].PAGE_FETCHED
        sm.update_page(p)
    sm.save_state()
    got.append(local_sm(P, root).find_incomplete_crawl("c1"))
    prev = local_sm(P, root, crawl_id="c0", crawl_execution_id="e0")
    prev.initialize(["z"])
    prev.save_state()
    got.append(local_sm(P, root).find_incomplete_crawl("c1"))
    return got


def sc_close_without_initialize_writes_nothing(P, root):
    sm = local_sm(P, root)
    sm.close()
    return sorted(os.listdir(root))


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_case_matches_the_reference(name, tmp_path):
    got = {}
    for pkg, P in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        got[pkg] = normalize(SCENARIOS[name](P, root))
    assert got["port"] == got["ref"]


# -- the files, byte for byte, both ways ---------------------------------------------
def _crawl_files(P, root):
    """A crawl with layers, statuses, errors and metadata, saved."""
    sm = local_sm(P, root)
    sm.initialize(["chana", "chanb"])
    Page = P["dm"].Page
    sm.add_layer([Page(url="chanc", depth=1, parent_id="x",
                       status=P["dm"].PAGE_UNFETCHED)])
    a = sm.get_layer_by_depth(0)[0]
    a.status, a.error = P["dm"].PAGE_ERROR, "boom"
    sm.update_page(a)
    sm.update_crawl_metadata("c1", {"status": "completed",
                                    "endTime": FIXED,
                                    "previousCrawlID": "c0"})
    sm.last_updated = FIXED
    sm.save_state()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_resumes_and_rewrites_the_others_files(
        tmp_path, writer, reader):
    src = tmp_path / "src"
    src.mkdir()
    _crawl_files(PKGS[writer], src)
    before = {f: (src / "c1" / f).read_bytes()
              for f in ("state.json", "metadata.json")}
    sm = local_sm(PKGS[reader], src)
    sm.initialize(["other"])     # resumes: the seeds are not added
    assert [p.url for p in sm.get_layer_by_depth(0)] == ["chana", "chanb"]
    assert sm.get_layer_by_depth(0)[0].error == "boom"
    sm.last_updated = FIXED
    sm.save_state()
    after = {f: (src / "c1" / f).read_bytes() for f in before}
    assert after == before
    assert json.loads(before["metadata.json"])["status"] == "completed"


# -- the composite manager, the factory, the mode's config -----------------------------
def test_composite_skips_seeds_a_previous_crawl_processed(tmp_path):
    got = {}
    for pkg, P in PKGS.items():
        root = tmp_path / pkg
        old = local_sm(P, root, crawl_id="c0", crawl_execution_id="e0")
        old.initialize(["chana", "chanb"])
        old.save_state()
        meta = local_sm(P, root)
        meta.update_crawl_metadata("c1", {"previousCrawlID": "c0"})
        meta.save_state()   # layers empty: not a resumable crawl
        # The port has no SQL graph store to configure (ROADMAP Queue 3).
        sql = {"sql": P["iface"].SqlConfig(url=":memory:")} \
            if pkg == "ref" else {}
        sm = P["comp"].CompositeStateManager(cfg(
            P, storage_root=str(root), **sql))
        sm.initialize(["chana", "chand"])
        sm.add_layer([P["dm"].Page(url="chane", depth=1)])
        got[pkg] = dict(layers=layers(sm),
                        seen=[sm.seen_url(u) for u in
                              ("chana", "chanb", "chand", "chane", "zz")])
    assert normalize(got["port"]) == normalize(got["ref"])
    assert got["port"]["layers"][0][0][0] == "chand"


def test_factory_and_mode_config_are_the_references(tmp_path):
    """A mode's manager is the class the reference's factory picks for the
    mode's config (the port builds it directly: every mode config names a
    SQL store), and the config is the reference's but ``sql``."""
    for exec_id in ("", "e9"):
        c = dict(storage_root=str(tmp_path / exec_id), crawl_id="c5")
        ref = jfactory.create_state_manager(
            jcommon.state_config_from_crawler_config(jconf.CrawlerConfig(**c),
                                                     exec_id))
        port = tcommon.create_state_manager(tconf.CrawlerConfig(**c),
                                            exec_id)
        assert type(port).__name__ == type(ref).__name__ \
            == "CompositeStateManager"
        ref.close()
        port.close()
        ref = jcommon.state_config_from_crawler_config(jconf.CrawlerConfig(
            storage_root="/x", crawl_id="c5", max_pages=9,
            sampling_method="snowball"), exec_id)
        port = tcommon.state_config_from_crawler_config(tconf.CrawlerConfig(
            storage_root="/x", crawl_id="c5", max_pages=9,
            sampling_method="snowball"), exec_id)
        for field in vars(port):
            want = getattr(ref, field)
            have = getattr(port, field)
            if field == "local":
                want, have = vars(want), vars(have)
                want = {k: want[k] for k in have}
            assert have == want, field


def test_state_tree_is_the_references_without_the_graph(tmp_path):
    """The orchestrator's state manager from the mode's config, through a
    crawl: the same files but ``graph.sqlite``."""
    trees = {}
    for pkg, P in PKGS.items():
        root = tmp_path / pkg
        c = P["conf"].CrawlerConfig(storage_root=str(root), crawl_id="c1")
        sm = P["common"].create_state_manager(c, "c1")
        sm.initialize(["chana"])
        sm.add_layer([P["dm"].Page(url="chanb", depth=1)])
        sm.store_post("chana", P["Post"](post_uid="1", channel_id="chana"))
        sm.close()
        trees[pkg] = sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs)
    assert "graph.sqlite" in trees["ref"]
    # (with its -wal/-shm companions while the store is open)
    assert trees["port"] == [f for f in trees["ref"]
                             if not f.startswith("graph.sqlite")]


def test_datamodels_round_trip_across_packages():
    page = tdm.Page(id="p1", url="u", depth=2, status=tdm.PAGE_ABANDONED,
                    error="e", timestamp=FIXED, platform="telegram",
                    parent_id="p0", messages=[tdm.Message(
                        chat_id=1, message_id=2, status="s", page_id="p1")],
                    connection_id="k", sequence_id="q", crawl_id="c")
    d = page.to_dict()
    assert jdm.Page.from_dict(d).to_dict() == d
    state = tdm.State(layers=[tdm.Layer(depth=2, pages=[page])],
                      metadata=tdm.CrawlMetadata(crawl_id="c", start_time=FIXED,
                                                 target_channels=["a"]),
                      last_updated=FIXED)
    sd = state.to_dict()
    assert jdm.State.from_dict(sd).to_dict() == sd
    assert tdm.State.from_dict(jdm.State.from_dict(sd).to_dict()).to_dict() \
        == sd
    for name in ("PAGE_UNFETCHED", "PAGE_PROCESSING", "PAGE_FETCHED",
                 "PAGE_ERROR", "PAGE_DEADEND", "PAGE_ABANDONED"):
        assert getattr(tdm, name) == getattr(jdm, name)

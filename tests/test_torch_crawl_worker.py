"""The port's crawl worker (`distributed_crawler_tpu_torch/worker/`)
against the reference's, on the CPU.

The counterparts of the reference's `tests/test_orchestrator_worker.py`
worker cases: a work item handled on each package's `InMemoryBus` gives
the same `ResultMessage` (on success, on a permanent error, on a
retryable error, and after the fetch policy rode out a FLOOD_WAIT); the
heartbeats and ``get_status()`` match; non-work and expired messages are
ignored; the error classification and the config conversion agree.  Then
each package's `Orchestrator` and `CrawlWorker` crawl one seeded
`SimNetwork` to completion, in process and over each package's gRPC
broker, and must visit the same pages.

Masked, and only these: message and trace ids, ``timestamp`` and
``completed_at`` (wall clock), ``processing_time``, ``uptime``,
``uptime_s`` and ``uptime_seconds`` (elapsed time), and the heartbeat's telemetry values
(the process's RSS and thread count; its keys are compared).  Each
package keeps its own connection pool (`crawl/runner`), so a test that
runs both installs one in each.  Host code: no tolerance.
"""

import json
import time
import types
from datetime import timedelta

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu import clients as jcl  # noqa: E402
from distributed_crawler_tpu import worker as jwk  # noqa: E402
from distributed_crawler_tpu.bus import inmemory as jbus  # noqa: E402
from distributed_crawler_tpu.bus import messages as jmsg  # noqa: E402
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.crawl import runner as jrun  # noqa: E402
from distributed_crawler_tpu.orchestrator import journal as jjour  # noqa: E402
from distributed_crawler_tpu.orchestrator import (  # noqa: E402
    orchestrator as jorch,
)
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import interface as jstate  # noqa: E402
from distributed_crawler_tpu.utils import flight as jflight  # noqa: E402
from distributed_crawler_tpu.utils import trace as jtrace  # noqa: E402
from distributed_crawler_tpu.worker import worker as jwmod  # noqa: E402
from distributed_crawler_tpu_torch import clients as tcl  # noqa: E402
from distributed_crawler_tpu_torch import worker as twk  # noqa: E402
from distributed_crawler_tpu_torch.bus import inmemory as tbus  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.crawl import runner as trun  # noqa: E402
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    journal as tjour,
)
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    orchestrator as torch_orch,
)
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tstate  # noqa: E402
from distributed_crawler_tpu_torch.utils import flight as tflight  # noqa: E402
from distributed_crawler_tpu_torch.utils import trace as ttrace  # noqa: E402
from distributed_crawler_tpu_torch.worker import worker as twmod  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(
        cl=jcl, wk=jwk, wmod=jwmod, bus=jbus, msg=jmsg, conf=jconf, run=jrun,
        jour=jjour, orch=jorch, comp=jcomp, state=jstate, flight=jflight),
    "port": types.SimpleNamespace(
        cl=tcl, wk=twk, wmod=twmod, bus=tbus, msg=tmsg, conf=tconf, run=trun,
        jour=tjour, orch=torch_orch, comp=tcomp, state=tstate,
        flight=tflight),
}
REF, PORT = PKGS["ref"], PKGS["port"]

MASKED = {"message_id", "trace_id", "timestamp", "completed_at",
          "processing_time", "uptime", "uptime_s", "uptime_seconds", "id",
          "work_item_id"}


def mask(x):
    """The payload with the masked fields replaced by their type."""
    if isinstance(x, dict):
        return {k: (type(v).__name__ if k in MASKED else mask(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [mask(v) for v in x]
    return x


def make_sm(P, root):
    return P.comp.CompositeStateManager(P.state.StateConfig(
        crawl_id="c1", crawl_execution_id="e1", storage_root=str(root),
        # The port has no SQL graph store to configure (ROADMAP Queue 3).
        **({"sql": P.state.SqlConfig(url=":memory:")} if P is REF else {})))


def make_cfg(P, **kw):
    base = dict(crawl_id="c1", platform="telegram", skip_media_download=True,
                sampling_method="channel")
    base.update(kw)
    return P.conf.CrawlerConfig(**base)


def unlimited(P):
    return P.conf.TelegramRateLimitConfig(
        get_chat_history_rate=0, search_public_chat_rate=0,
        get_supergroup_info_rate=0, get_message_server_hit_rate=0,
        get_chat_history_jitter_ms=0, search_public_chat_jitter_ms=0,
        get_supergroup_info_jitter_ms=0, get_message_server_hit_jitter_ms=0)


def seeded_network(P, seed, fanout=2, depth=3):
    """A seeded tree of channels: each channel's messages mention its
    children (and a channel that does not exist), to ``depth`` levels."""
    rng = np.random.default_rng(seed)
    net = P.cl.SimNetwork()
    level = ["root0"]
    for d in range(depth):
        nxt = []
        for name in level:
            kids = [f"{name}x{k}" for k in range(fanout)] \
                if d < depth - 1 else []
            nxt += kids
            msgs = []
            for i in range(int(rng.integers(1, 4))):
                links = " ".join(f"t.me/{k}" for k in kids)
                msgs.append(P.cl.TLMessage(
                    content={"@type": "messageText", "text": {
                        "text": f"{name} {i} {links} @ghost_{name}",
                        "entities": []}},
                    date=1700000000 + int(rng.integers(0, 1000)),
                    view_count=int(rng.integers(0, 500))))
            net.add_channel(name, messages=msgs,
                            member_count=int(rng.integers(100, 5000)))
        level = nxt
    return net


def install_pool(P, net, n=1):
    P.run.shutdown_connection_pool()
    P.run.init_connection_pool(P.cl.ConnectionPool.for_testing(
        {f"conn{i}": P.cl.SimTelegramClient(net, conn_id=f"conn{i}")
         for i in range(n)}, rate_limit=unlimited(P)))


@pytest.fixture(autouse=True)
def _pools():
    yield
    for P in PKGS.values():
        P.run.shutdown_connection_pool()


@pytest.fixture(autouse=True)
def _empty_trace_rings():
    """Each package's process-wide span ring starts empty: a worker's
    first telemetry snapshot digests every span in it, so spans left by
    an earlier test in the process would show in one package's
    ``latency_ms`` and not the other's."""
    for tr in (jtrace, ttrace):
        tr.TRACER.reset()


def item(P, url, depth=0, platform="telegram", root="", fixed_id="wi-1"):
    it = P.msg.WorkItem.new(url, depth, "p0", "c1", platform,
                            P.msg.WorkItemConfig(storage_root=str(root)))
    it.id = fixed_id
    return it


def handle_one(P, root, url, platform="telegram", faults=(), seed=0,
               max_redeliveries=None, depth=0):
    """One work item through P's worker on P's in-memory bus: the
    ResultMessage payloads and the status payloads, masked."""
    net = seeded_network(P, seed)
    for method, secs, count in faults:
        net.inject_flood_wait(method, secs, count=count)
    install_pool(P, net)
    kw = {} if max_redeliveries is None else {
        "max_redeliveries": max_redeliveries}
    bus = P.bus.InMemoryBus(**kw)
    results, statuses = [], []
    bus.subscribe(P.msg.TOPIC_RESULTS, results.append)
    bus.subscribe(P.msg.TOPIC_WORKER_STATUS, statuses.append)
    worker = P.wk.CrawlWorker("w1", make_cfg(P), bus, make_sm(P, root))
    worker.start(background=False)
    worker.handle_work_message(P.msg.WorkQueueMessage.new(
        item(P, url, depth=depth, platform=platform, root=root)))
    status = worker.get_status()
    worker.stop()
    return dict(results=mask(results),
                statuses=[mask({k: v for k, v in s.items()
                                if k != "resource_usage"}) for s in statuses],
                telemetry_keys=[sorted(s.get("resource_usage") or {})
                                for s in statuses],
                status=mask(status),
                counters=(worker.tasks_processed, worker.tasks_success,
                          worker.tasks_error))


CASES = {
    "success": dict(url="root0"),
    "success_deep": dict(url="root0x1", depth=1),
    "leaf": dict(url="root0x0x1", depth=2),
    "unknown_channel": dict(url="nochan", max_redeliveries=0),
    "flood_wait_ridden_out": dict(url="root0", faults=[
        ("SearchPublicChat", 0, 1)]),
    "flood_wait_exhausts_fetch_retries": dict(url="root0", faults=[
        ("GetChatHistory", 0, 2)], max_redeliveries=0),
    "youtube_without_crawler": dict(url="UC_chan", platform="youtube",
                                    max_redeliveries=0),
    "unsupported_platform": dict(url="x", platform="myspace",
                                 max_redeliveries=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_work_item_gives_the_references_result(case, tmp_path):
    """A work item through each package's worker: the same ResultMessage
    (status, discovered pages, message count, metadata, error text and
    ``retry_recommended``), the same busy and idle heartbeats with the
    same telemetry keys, the same ``get_status()`` and counters."""
    kw = CASES[case]
    ref = handle_one(REF, tmp_path / "ref", **kw)
    port = handle_one(PORT, tmp_path / "port", **kw)
    assert port == ref
    wr = ref["results"][0]["work_result"]
    if case.startswith("success") or case in ("leaf",
                                              "flood_wait_ridden_out"):
        assert wr["status"] == "success" and wr["message_count"] > 0
    else:
        assert wr["status"] == "error" and wr["error"]
    if case == "unknown_channel":
        # "USERNAME_NOT_OCCUPIED" carries no permanent marker.
        assert wr["retry_recommended"] is True
    if case == "flood_wait_exhausts_fetch_retries":
        assert wr["retry_recommended"] is True


def test_heartbeat_loop_and_kill(tmp_path):
    """The interval heartbeat (``worker_type="crawl"``, telemetry and the
    SLO breach counts attached), then ``kill()``: no stopping message, the
    ``worker_kill`` flight event."""
    def scenario(P, root):
        P.flight.configure(capacity=64)
        bus = P.bus.InMemoryBus()
        statuses = []
        bus.subscribe(P.msg.TOPIC_WORKER_STATUS, statuses.append)
        worker = P.wk.CrawlWorker(
            "w1", make_cfg(P), bus, make_sm(P, root),
            wcfg=P.wk.WorkerConfig(worker_id="w1", heartbeat_s=0.05,
                                   slo_batch_p95_ms=5.0))
        worker.start()
        deadline = time.monotonic() + 10
        while len(statuses) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        worker.kill()
        n = len(statuses)
        time.sleep(0.2)
        beats = [(s["message_type"], s["status"], s["worker_type"],
                  sorted(s.get("resource_usage") or {}))
                 for s in statuses[:3]]
        kinds = [e["kind"] for e in P.flight.RECORDER.events()]
        return beats, len(statuses) == n, worker.is_running, \
            "worker_kill" in kinds, worker.evaluate_slos() == []

    ref = scenario(REF, tmp_path / "ref")
    port = scenario(PORT, tmp_path / "port")
    assert port == ref
    assert ref[0][0][:3] == ("worker_started", "active", "crawl")
    assert ref[0][1][:3] == ("heartbeat", "idle", "crawl")
    assert "slo_breaches" in ref[0][1][3]


def test_ignores_non_work_and_expired_messages(tmp_path):
    def scenario(P, root):
        install_pool(P, seeded_network(P, 0))
        bus = P.bus.InMemoryBus()
        results = []
        bus.subscribe(P.msg.TOPIC_RESULTS, results.append)
        worker = P.wk.CrawlWorker("w1", make_cfg(P), bus, make_sm(P, root))
        worker.start(background=False)
        msg = P.msg.WorkQueueMessage.new(item(P, "root0"))
        msg.message_type = "poison_pill"
        worker.handle_work_message(msg)
        expired = P.msg.WorkQueueMessage.new(item(P, "root0"))
        expired.timestamp = P.orch.utcnow() - timedelta(hours=2)
        worker.handle_work_payload(expired.to_dict())
        return results, worker.tasks_processed

    assert scenario(PORT, tmp_path / "port") \
        == scenario(REF, tmp_path / "ref") == ([], 0)


def test_worker_guards_and_conversions(tmp_path):
    """`TestErrorClassification`, `TestConfigConversion`, the empty id."""
    errors = ["channel not found", "ACCESS DENIED", "Forbidden: x",
              "connection reset", "timeout", "", "[400] USERNAME_INVALID",
              "FLOOD_WAIT_30"]
    for text in errors:
        assert twk.should_retry_error(ValueError(text)) \
            == jwk.should_retry_error(ValueError(text)), text
    from datetime import datetime, timezone

    t = datetime(2024, 1, 2, tzinfo=timezone.utc)
    for kw in ({}, {"sampling_method": ""}, dict(
            storage_root="/s", concurrency=3, timeout=9, min_post_date=t,
            post_recency=t, date_between_min=t, date_between_max=t,
            sample_size=4, max_comments=2, max_posts=8, max_depth=5,
            max_pages=77, min_users=11, crawl_label="L",
            skip_media_download=True, youtube_api_key="k",
            sampling_method="snowball", min_channel_videos=3)):
        got = twmod.work_item_config_to_crawler_config(
            tmsg.WorkItemConfig(**kw), "telegram")
        want = jwmod.work_item_config_to_crawler_config(
            jmsg.WorkItemConfig(**kw), "telegram")
        names = [f for f in vars(got) if not f.startswith("_")]
        assert {n: getattr(got, n) for n in names if n != "rate_limit"
                and n != "inference" and n != "media"} \
            == {n: getattr(want, n) for n in names if n != "rate_limit"
                and n != "inference" and n != "media"}
    for P in PKGS.values():
        with pytest.raises(ValueError, match="worker ID cannot be empty"):
            P.wk.CrawlWorker("", make_cfg(P), P.bus.InMemoryBus(),
                             make_sm(P, tmp_path))


# -- the orchestrator and the crawl worker to completion --------------------------
def pages(orch):
    sm = orch.sm
    return {d: sorted((p.url, p.status) for p in sm.get_layer_by_depth(d))
            for d in range(sm.get_max_depth() + 1)}


def crawl_in_process(P, root, seed, max_depth):
    install_pool(P, seeded_network(P, seed))
    bus = P.bus.InMemoryBus()
    cfg = make_cfg(P, max_depth=max_depth)
    orch = P.orch.Orchestrator(
        "c1", cfg, bus, make_sm(P, root / "orch"),
        journal=P.jour.CrawlJournal(str(root / "journal")))
    worker = P.wk.CrawlWorker("w1", cfg, bus, make_sm(P, root / "wrk"))
    orch.start(["root0"], background=False)
    worker.start(background=False)
    for _ in range(20):
        orch.distribute_work()
        if orch.crawl_completed:
            break
    return dict(completed=orch.crawl_completed, pages=pages(orch),
                counts=(orch.completed_items, orch.error_items),
                workers=sorted(orch.workers),
                worker=(worker.tasks_processed, worker.tasks_success))


@pytest.mark.parametrize("seed,max_depth", [(0, 3), (1, 1), (2, 2)])
def test_orchestrator_and_worker_crawl_to_completion(seed, max_depth,
                                                     tmp_path):
    """`TestRoundTrip::test_bfs_crawl_completes` on a seeded network: the
    port's orchestrator and crawl worker visit the same pages, with the
    same statuses, as the reference's pair."""
    ref = crawl_in_process(REF, tmp_path / "ref", seed, max_depth)
    port = crawl_in_process(PORT, tmp_path / "port", seed, max_depth)
    assert port == ref
    # Every channel mentions a ghost channel, which ends in an error.
    assert ref["completed"] and ref["counts"][0] > 0 and ref["counts"][1] > 0


def crawl_over_grpc(P, root, grpc_mod, seed):
    install_pool(P, seeded_network(P, seed))
    server = grpc_mod.GrpcBusServer("127.0.0.1:0")
    server.enable_pull(P.msg.TOPIC_WORK_QUEUE)
    server.start()
    remote = grpc_mod.RemoteBus(f"127.0.0.1:{server.bound_port}")
    cfg = make_cfg(P, max_depth=2)
    orch = P.orch.Orchestrator(
        "c1", cfg, server, make_sm(P, root / "orch"),
        journal=P.jour.CrawlJournal(str(root / "journal")))
    worker = P.wk.CrawlWorker("w1", cfg, remote, make_sm(P, root / "wrk"))
    try:
        orch.start(["root0"], background=False)
        worker.start(background=False)
        deadline = time.monotonic() + 30
        while not orch.crawl_completed and time.monotonic() < deadline:
            orch.distribute_work()
            time.sleep(0.05)
        return dict(completed=orch.crawl_completed, pages=pages(orch),
                    counts=(orch.completed_items, orch.error_items),
                    workers=sorted(orch.workers))
    finally:
        worker.stop()
        remote.close()
        server.close()


def test_crawl_over_each_packages_grpc_broker(tmp_path):
    """`TestGrpcRoundTrip::test_bfs_crawl_over_grpc`: each package's
    orchestrator hosts its broker and its crawl worker dials it; the same
    pages."""
    pytest.importorskip("grpc")
    from distributed_crawler_tpu.bus import grpc_bus as jgrpc
    from distributed_crawler_tpu_torch.bus import grpc_bus as tgrpc

    ref = crawl_over_grpc(REF, tmp_path / "ref", jgrpc, 4)
    port = crawl_over_grpc(PORT, tmp_path / "port", tgrpc, 4)
    assert port == ref
    assert ref["completed"] and ref["counts"][0] == 7


def test_crawl_through_the_bridge_stores_and_ships_posts(tmp_path):
    """The gate's wiring on the CPU without the gate: the port's crawl
    worker stores through an `InferenceBridge` and every stored post is
    shipped once as a record, as the reference's worker through the
    reference's bridge does."""
    from distributed_crawler_tpu.inference import bridge as jbridge
    from distributed_crawler_tpu_torch.inference import bridge as tbridge

    def scenario(P, bridge_mod, root):
        install_pool(P, seeded_network(P, 6))
        bus = P.bus.InMemoryBus()
        batches = []
        bus.subscribe(P.msg.TOPIC_INFERENCE_BATCHES, batches.append)
        bridge = bridge_mod.InferenceBridge(
            make_sm(P, root), bus, crawl_id="c1", batch_size=4,
            deadline_s=0.05)
        worker = P.wk.CrawlWorker("w1", make_cfg(P), bus, bridge)
        worker.start(background=False)
        for i, url in enumerate(("root0", "root0x0", "root0x1", "root0")):
            worker.handle_work_message(P.msg.WorkQueueMessage.new(
                item(P, url, root=root, fixed_id=f"wi-{i}")))
        bridge.flush()
        worker.stop()
        uids = [r["post_uid"] for b in batches for r in b["records"]]
        texts = sorted(json.dumps(r.get("description")) for b in batches
                       for r in b["records"])
        return sorted(uids), texts, len(uids) == len(set(uids))

    ref = scenario(REF, jbridge, tmp_path / "ref")
    port = scenario(PORT, tbridge, tmp_path / "port")
    assert port == ref
    assert ref[2] and len(ref[0]) > 0

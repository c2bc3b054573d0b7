"""The port's orchestrator (`distributed_crawler_tpu_torch/orchestrator/`)
against the reference's, on the CPU.

Each scenario drives one package's `Orchestrator` with scripted
`StatusMessage`/`ResultMessage` sequences on that package's in-memory bus,
calling the tick methods directly, and returns what it observed: the
dispatched items (url, depth, priority, retry count), the page statuses,
``get_status()``, the journal's replay and ``state.json``.  Both packages
run every scenario and must observe the same thing; ids and wall times are
compared by structure (each distinct id maps to its order of appearance),
everything else exactly.

The scenarios are the cases of the reference's
`tests/test_orchestrator_worker.py::TestOrchestrator` and
`::TestCrashRecovery`, the outbox valve
(`tests/test_bus_durability.py::TestOutboxBackpressureValve`), the sharded
frontier (`tests/test_bus_partition.py::TestShardedFrontier`),
`test_orchestrator_applied_results_absorb_duplicate`, and the cluster guide
with its TTL (`tests/test_cluster_serve.py::TestClusterGuidedFrontier`).
The timing constants the port holds as module constants (``MAX_RETRIES``,
``WORK_TTL_S``, ``CLUSTER_GUIDE_TTL_S``) are the reference's defaults, so
both packages run at those.

Across packages: the reference's crawl `CrawlWorker` crawls the simulated
Telegram network through the port's orchestrator, in process and over the
port's gRPC broker, and each package resumes the other's journal and
``state.json``.
"""

import json
import os
import re
import time
import types
from datetime import datetime, timedelta

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu.bus import inmemory as jbus  # noqa: E402
from distributed_crawler_tpu.bus import messages as jmsg  # noqa: E402
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.orchestrator import journal as jjour  # noqa: E402
from distributed_crawler_tpu.orchestrator import (  # noqa: E402
    orchestrator as jorch,
)
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import interface as jstate  # noqa: E402
from distributed_crawler_tpu.utils import flight as jflight  # noqa: E402
from distributed_crawler_tpu_torch.bus import inmemory as tbus  # noqa: E402
from distributed_crawler_tpu_torch.bus import messages as tmsg  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    journal as tjour,
)
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    orchestrator as torch_orch,
)
from distributed_crawler_tpu_torch.orchestrator import (  # noqa: E402
    watchtower as twt,
)
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tstate  # noqa: E402
from distributed_crawler_tpu_torch.utils import flight as tflight  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(
        bus=jbus, msg=jmsg, conf=jconf, orch=jorch, jour=jjour, comp=jcomp,
        state=jstate, flight=jflight),
    "port": types.SimpleNamespace(
        bus=tbus, msg=tmsg, conf=tconf, orch=torch_orch, jour=tjour,
        comp=tcomp, state=tstate, flight=tflight),
}


# -- building blocks -------------------------------------------------------------
def make_sm(P, root, crawl_id="c1"):
    return P.comp.CompositeStateManager(P.state.StateConfig(
        crawl_id=crawl_id, crawl_execution_id="e1", storage_root=str(root),
        # The port has no SQL graph store to configure (ROADMAP Queue 3).
        **({"sql": P.state.SqlConfig(url=":memory:")}
           if P is PKGS["ref"] else {})))


def make_cfg(P, **kw):
    base = dict(crawl_id="c1", platform="telegram", skip_media_download=True,
                sampling_method="channel")
    base.update(kw)
    return P.conf.CrawlerConfig(**base)


def make_orch(P, root, bus=None, ocfg=None, sm=None, **cfg):
    bus = bus if bus is not None else P.bus.InMemoryBus()
    jdir = os.path.join(str(root), "journal")
    return P.orch.Orchestrator(
        "c1", make_cfg(P, **cfg), bus,
        sm if sm is not None else make_sm(P, os.path.join(str(root), "s")),
        ocfg=ocfg, journal=P.jour.CrawlJournal(jdir))


def capture(P, bus):
    out = []
    bus.subscribe(P.msg.TOPIC_WORK_QUEUE, out.append)
    return out


def result(P, orch, url, status="success", error="", retry=False,
           discovered=(), wid=None):
    item = next(i for i in orch.active_work.values() if i.url == url) \
        if wid is None else None
    wr = P.msg.WorkResult(
        work_item_id=wid or item.id, worker_id="w1", status=status,
        error=error, processed_url=url, completed_at=P.orch.utcnow(),
        retry_recommended=retry)
    pages = [P.msg.DiscoveredPage(url=u, parent_id=item.parent_id if item
                                  else "", depth=1, platform="telegram")
             for u in discovered]
    return P.msg.ResultMessage.new(wr, pages)


def heartbeat(P, worker_id, status, queue=0, worker_type="crawl",
              current_work=None, ts=None, message_type="heartbeat"):
    msg = P.msg.StatusMessage.new(worker_id, message_type, status,
                                  worker_type=worker_type)
    msg.queue_length = queue
    msg.current_work = current_work
    if ts is not None:
        msg.timestamp = ts
    return msg


def dispatched(frames):
    return [(f["work_item"]["url"], f["work_item"]["depth"], f["priority"],
             f["work_item"]["retry_count"]) for f in frames]


def pages(orch):
    out = {}
    for depth in range(orch.sm.get_max_depth() + 1):
        out[depth] = sorted((p.url, p.status, p.error)
                            for p in orch.sm.get_layer_by_depth(depth))
    return out


def status(orch):
    st = orch.get_status()
    st.pop("uptime_s")
    return st


# -- comparison by structure -----------------------------------------------------
_UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}$")
_WORK = re.compile(r"^work_\d{14}_[A-Za-z0-9]{6}(#\d+)?$")
_TRACE = re.compile(r"^trace_\d{14}_[A-Za-z0-9]{8}$")
_TIME = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d")
_WALL_KEYS = {"ts", "uptime_s", "duration_s", "end_time", "endTime",
              "startTime", "lastUpdated", "timestamp", "last_seen",
              "created_at", "assigned_at", "received_at"}


def normalize(obj, ids=None):
    """Ids -> their order of appearance, walls -> a placeholder."""
    ids = {} if ids is None else ids

    def norm_str(s):
        if _UUID.match(s):
            return "<id%d>" % ids.setdefault(s, len(ids))
        m = _WORK.match(s)
        if m:
            base = s.split("#")[0]
            return "<work%d>%s" % (ids.setdefault(base, len(ids)),
                                   m.group(1) or "")
        if _TRACE.match(s):
            return "<trace>"
        if _TIME.match(s):
            return "<time>"
        return s

    if isinstance(obj, dict):
        return {norm_str(k) if isinstance(k, str) else k:
                ("<wall>" if k in _WALL_KEYS and obj[k] is not None
                 else normalize(obj[k], ids))
                for k in obj}
    if isinstance(obj, (list, tuple)):
        return [normalize(v, ids) for v in obj]
    if isinstance(obj, set):
        return sorted(normalize(v, ids) for v in obj)
    if isinstance(obj, datetime):
        return "<time>"
    if isinstance(obj, str):
        return norm_str(obj)
    return obj


def both(scenario, tmp_path):
    """Run ``scenario`` on each package; return (ref, port) normalized."""
    got = {}
    for name, P in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        got[name] = normalize(scenario(P, root))
    return got["ref"], got["port"]


# -- TestOrchestrator's cases ------------------------------------------------------
def sc_distributes_unfetched_pages(P, root):
    orch = make_orch(P, root)
    out = capture(P, orch.bus)
    orch.start(["chana", "chanb"], background=False)
    first = orch.distribute_work()
    second = orch.distribute_work()
    return dict(counts=[first, second], sent=dispatched(out),
                status=status(orch))


def sc_result_updates_page_and_creates_layer(P, root):
    orch = make_orch(P, root)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana", discovered=["chanb"]))
    return dict(pages=pages(orch), status=status(orch))


def sc_error_result_marks_page_error(P, root):
    orch = make_orch(P, root)
    out = capture(P, orch.bus)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana", status="error",
                              error="boom", retry=True))
    mid = pages(orch)
    again = orch.distribute_work()
    return dict(mid=mid, again=again, sent=dispatched(out),
                status=status(orch))


def sc_permanent_error_not_retried(P, root):
    orch = make_orch(P, root)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana", status="error",
                              error="channel not found", retry=False))
    return dict(again=orch.distribute_work(), pages=pages(orch),
                retries=dict(orch._retry_counts))


def sc_retry_exhaustion(P, root):
    orch = make_orch(P, root)
    out = capture(P, orch.bus)
    orch.start(["chana"], background=False)
    rounds = []
    for _ in range(6):
        n = orch.distribute_work()
        rounds.append(n)
        if n == 0:
            break
        orch.handle_result(result(P, orch, "chana", status="error",
                                  error="boom", retry=True))
    return dict(rounds=rounds, sent=dispatched(out), pages=pages(orch),
                retries=dict(orch._retry_counts))


def sc_worker_registry_from_status(P, root):
    orch = make_orch(P, root)
    msg = P.msg.StatusMessage.new("w1", "worker_started", "idle",
                                  tasks_processed=5, tasks_success=4,
                                  tasks_error=1)
    orch.handle_status(msg)
    return dict(workers=status(orch)["workers"])


def sc_status_distinguishes_worker_types(P, root):
    orch = make_orch(P, root)
    orch.handle_status(heartbeat(P, "crawl-1", "idle"))
    orch.handle_status(heartbeat(P, "tpu-1", "busy", queue=17,
                                 worker_type="tpu"))
    return status(orch)


def sc_inference_backpressure(P, root):
    ocfg = P.orch.OrchestratorConfig(inference_backpressure_high=10,
                                     inference_backpressure_low=5)
    orch = make_orch(P, root, ocfg=ocfg)
    out = capture(P, orch.bus)
    orch.start(["chana", "chanb"], background=False)
    seen = []
    for queue in (12, 7, 2):
        orch.handle_status(heartbeat(P, "tpu-1", "busy", queue=queue,
                                     worker_type="tpu"))
        seen.append((orch.distribute_work(),
                     orch.get_status()["backpressure_active"]))
    return dict(seen=seen, sent=dispatched(out))


def sc_offline_tpu_worker_releases_backpressure(P, root):
    ocfg = P.orch.OrchestratorConfig(inference_backpressure_high=10,
                                     inference_backpressure_low=5)
    orch = make_orch(P, root, ocfg=ocfg)
    orch.start(["chana"], background=False)
    orch.handle_status(heartbeat(P, "tpu-1", "busy", queue=50,
                                 worker_type="tpu"))
    shut = orch.distribute_work()
    orch.workers["tpu-1"].last_seen = P.orch.utcnow() - \
        timedelta(minutes=10)
    backlog = orch.inference_backlog()
    failed = orch.check_worker_health()
    return dict(shut=shut, backlog=backlog, failed=failed,
                state=orch.workers["tpu-1"].status,
                after=orch.distribute_work())


def sc_backpressure_never_blocks_completion(P, root):
    ocfg = P.orch.OrchestratorConfig(inference_backpressure_high=10,
                                     inference_backpressure_low=5)
    orch = make_orch(P, root, ocfg=ocfg)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana"))
    orch.handle_status(heartbeat(P, "tpu-1", "busy", queue=99,
                                 worker_type="tpu"))
    ticks = [orch.distribute_work() for _ in range(3)]
    return dict(ticks=ticks, completed=orch.crawl_completed,
                status=status(orch))


def sc_backpressure_disabled_with_zero_watermark(P, root):
    ocfg = P.orch.OrchestratorConfig(inference_backpressure_high=0)
    orch = make_orch(P, root, ocfg=ocfg)
    orch.start(["chana"], background=False)
    orch.handle_status(heartbeat(P, "tpu-1", "busy", queue=10_000,
                                 worker_type="tpu"))
    return dict(n=orch.distribute_work())


def sc_health_monitor_reassigns_work(P, root):
    orch = make_orch(P, root)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    out = capture(P, orch.bus)
    item = next(iter(orch.active_work.values()))
    orch.handle_status(heartbeat(
        P, "w1", "busy", current_work=item.id,
        ts=P.orch.utcnow() - timedelta(minutes=10)))
    claimed = item.assigned_to
    first = orch.check_worker_health()
    second = orch.check_worker_health()
    return dict(claimed=claimed, first=first, second=second,
                sent=dispatched(out), ids=sorted(orch.active_work),
                status=status(orch))


def sc_stale_work_requeued_then_abandoned(P, root):
    orch = make_orch(P, root)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    out = capture(P, orch.bus)
    item = next(iter(orch.active_work.values()))
    now = P.orch.utcnow()
    steps = [orch.requeue_stale_work(now)]
    # Each generation lives 3600 s (the reference's default work TTL):
    # past it the item is requeued under a rotated id, until the retry
    # budget (3) is spent and the page is abandoned.
    for k in range(1, 5):
        steps.append(orch.requeue_stale_work(now + timedelta(
            seconds=3700 * k)))
        if k == 1:
            # A result addressed to the stale generation is unknown.
            orch.handle_result(result(P, orch, "chana", wid=item.id))
    return dict(steps=steps, sent=dispatched(out),
                ids=[f["work_item"]["id"] for f in out],
                pages=pages(orch), retries=dict(orch._retry_counts),
                status=status(orch),
                replay=orch.journal.replay().to_debug_dict())


def sc_max_depth_caps_distribution(P, root):
    orch = make_orch(P, root, max_depth=1)
    orch.start(["chana"], background=False)
    orch.current_depth = 2
    return dict(n=orch.distribute_work(), completed=orch.crawl_completed)


def sc_completion_when_layers_exhausted(P, root):
    orch = make_orch(P, root)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana"))
    ticks = []
    for _ in range(4):
        ticks.append((orch.distribute_work(), orch.current_depth,
                      orch.crawl_completed))
    orch.stop()
    with open(os.path.join(str(root), "s", "c1", "metadata.json")) as f:
        meta = json.load(f)
    return dict(ticks=ticks, meta=meta, status=status(orch))


# -- TestCrashRecovery's cases ------------------------------------------------------
def sc_journal_replay_is_deterministic(P, root):
    orch = make_orch(P, root)
    orch.start(["chana", "chanb"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana", discovered=["chanc"]))
    journal = P.jour.CrawlJournal(os.path.join(str(root), "journal"))
    rec1, rec2 = journal.replay(), journal.replay()
    return dict(same=rec1.to_debug_dict() == rec2.to_debug_dict(),
                rec=rec1.to_debug_dict(), completed=rec1.completed_items,
                layers=[(d, len(p)) for d, p in rec1.layers])


def sc_journal_tolerates_torn_tail_line(P, root):
    journal = P.jour.CrawlJournal(os.path.join(str(root), "journal"))
    journal.append("begin", crawl_id="c1")
    journal.append("depth", depth=3)
    with open(journal.journal_path, "a", encoding="utf-8") as f:
        f.write('{"kind": "result", "work_item_id": "wx", "stat')
    rec = journal.replay()
    return dict(depth=rec.current_depth, events=rec.events_replayed)


def sc_replay_idempotent_across_compaction(P, root):
    journal = P.jour.CrawlJournal(os.path.join(str(root), "journal"))
    journal.snapshot({"crawl_id": "c1", "completed_items": 1,
                      "total_work_items": 2, "applied_results": ["w1"],
                      "active_work": {"w2": {"id": "w2", "url": "u2"}}})
    journal.append("result", work_item_id="w1", status="success",
                   page_id="p1", page_status="fetched", retries=0)
    journal.append("dispatch", item={"id": "w2", "url": "u2"}, page_id="p2")
    rec = journal.replay()
    return dict(completed=rec.completed_items, total=rec.total_work_items,
                active=sorted(rec.active_work))


def sc_foreign_journal_is_discarded(P, root):
    journal = P.jour.CrawlJournal(os.path.join(str(root), "journal"))
    journal.append("begin", crawl_id="some-other-crawl")
    journal.append("dispatch", item={"id": "wx", "url": "ux"}, page_id="px")
    journal.close()
    orch = make_orch(P, root)
    orch.start(["chana"], background=False)
    return dict(resumed=orch.resumed, active=len(orch.active_work),
                pages=pages(orch),
                recorded=P.jour.CrawlJournal(
                    os.path.join(str(root), "journal")).recorded_crawl_id())


def sc_kill_then_resume_requeues_inflight(P, root):
    bus = P.bus.InMemoryBus()
    orch1 = make_orch(P, root, bus=bus)
    orch1.start(["chana", "chanb"], background=False)
    n = orch1.distribute_work()
    inflight = set(orch1.active_work)
    orch1.kill()
    out = capture(P, bus)
    orch2 = make_orch(P, root, bus=bus)
    orch2.start(["chana", "chanb"], background=False)
    same_ids = set(orch2.active_work) == inflight
    layer0 = pages(orch2)
    wid = sorted(inflight)[0]
    msg = result(P, orch2, orch2.active_work[wid].url, wid=wid)
    orch2.handle_result(msg)
    once = orch2.completed_items
    orch2.handle_result(msg)
    # Requeued in work-item id order, and ids end in random characters.
    return dict(n=n, resumed=orch2.resumed, same_ids=same_ids,
                sent=sorted(dispatched(out)), layer0=layer0,
                counts=[once, orch2.completed_items], status=status(orch2))


def sc_result_applied_before_crash(P, root):
    bus = P.bus.InMemoryBus()
    orch1 = make_orch(P, root, bus=bus)
    orch1.start(["chana"], background=False)
    orch1.distribute_work()
    msg = result(P, orch1, "chana")
    orch1.handle_result(msg)
    orch1.kill()
    orch2 = make_orch(P, root, bus=bus)
    orch2.start(["chana"], background=False)
    before = orch2.completed_items
    orch2.handle_result(msg)
    return dict(resumed=orch2.resumed, counts=[before, orch2.completed_items],
                active=len(orch2.active_work), pages=pages(orch2))


class WedgeableSM:
    """Pass-through state manager whose reads/writes can be wedged."""

    def __init__(self, inner):
        self._inner = inner
        self.wedged = False

    def _guard(self):
        if self.wedged:
            raise RuntimeError("backend wedged")

    def get_layer_by_depth(self, depth):
        self._guard()
        return self._inner.get_layer_by_depth(depth)

    def update_page(self, page):
        self._guard()
        return self._inner.update_page(page)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def sc_result_apply_deferred_until_store_recovers(P, root):
    sm = WedgeableSM(make_sm(P, os.path.join(str(root), "s")))
    ocfg = P.orch.OrchestratorConfig(state_retry_attempts=1,
                                     state_breaker_threshold=1,
                                     state_breaker_recovery_s=0.0)
    orch = make_orch(P, root, ocfg=ocfg, sm=sm)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    sm.wedged = True
    orch.handle_result(result(P, orch, "chana", discovered=["chanb"]))
    parked = (orch.completed_items, len(orch._deferred_results),
              sm._inner.get_layer_by_depth(0)[0].status)
    sm.wedged = False
    orch.distribute_work()
    return dict(parked=parked, deferred=len(orch._deferred_results),
                pages={d: sorted((p.url, p.status)
                                 for p in sm._inner.get_layer_by_depth(d))
                       for d in (0, 1)})


def sc_fresh_flag_discards_existing_crawl(P, root):
    bus = P.bus.InMemoryBus()
    orch1 = make_orch(P, root, bus=bus)
    orch1.start(["chana"], background=False)
    orch1.distribute_work()
    orch1.stop()
    orch2 = make_orch(P, root, bus=bus)
    orch2.start(["chana", "chanb"], background=False, fresh=True)
    return dict(resumed=orch2.resumed, completed=orch2.completed_items,
                active=len(orch2.active_work), pages=pages(orch2))


def sc_resume_without_journal_sweeps(P, root):
    bus = P.bus.InMemoryBus()
    orch1 = make_orch(P, root, bus=bus)
    orch1.start(["chana"], background=False)
    orch1.distribute_work()
    orch1.stop()
    orch1.journal.reset()   # only the state snapshot is left
    orch2 = make_orch(P, root, bus=bus)
    orch2.start(["chana"], background=False)
    swept = pages(orch2)
    return dict(resumed=orch2.resumed, swept=swept,
                n=orch2.distribute_work())


def sc_retry_counts_pruned_on_terminal_states(P, root):
    orch = make_orch(P, root)
    orch.start(["chana", "chanb"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana", status="error",
                              error="timeout", retry=True))
    mid = dict(orch._retry_counts)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana"))
    orch.handle_result(result(P, orch, "chanb", status="error",
                              error="channel not found", retry=False))
    return dict(mid=len(mid), retries=dict(orch._retry_counts),
                pages=pages(orch), again=orch.distribute_work(),
                replay=orch.journal.replay().to_debug_dict())


# -- the valves, the sharded frontier, the cluster guide ---------------------------
def sc_outbox_near_full_pauses_dispatch(P, root):
    class FakeOutbox:
        full = True

        def near_full(self):
            return self.full

        def depth(self):
            return 7

    class FakeBus(P.bus.InMemoryBus):
        outbox = FakeOutbox()

    bus = FakeBus()
    orch = make_orch(P, root, bus=bus)
    P.flight.RECORDER.reset()
    seen = [orch._backpressure_engaged()]
    kinds = [(e["kind"], e.get("reason"), e.get("depth"))
             for e in P.flight.RECORDER.events()]
    seen.append(orch._backpressure_engaged())
    bus.outbox.full = False
    seen.append(orch._backpressure_engaged())
    return dict(seen=seen, kinds=kinds)


def sc_applied_results_absorb_duplicate(P, root):
    orch = make_orch(P, root)
    orch.start(["chana"], background=False)
    orch.distribute_work()
    msg = result(P, orch, "chana")
    counts = []
    for _ in range(3):
        orch.handle_result(msg)
        counts.append(orch.completed_items)
    return dict(counts=counts, applied=len(orch._applied_results))


def _sharded(P):
    from distributed_crawler_tpu.bus.partition import (
        ShardMap as JShardMap,
        default_shard_ids as jids,
    )
    from distributed_crawler_tpu_torch.bus.partition import (
        ShardMap as TShardMap,
        default_shard_ids as tids,
    )
    inner = P.bus.InMemoryBus(sync=True)
    smap = (JShardMap(jids(3)) if P is PKGS["ref"] else TShardMap(tids(3)))

    class ShardedBus:
        shard_map = smap

        def __getattr__(self, name):
            return getattr(inner, name)

    return ShardedBus(), inner


def sc_sharded_frontier_lanes(P, root):
    bus, inner = _sharded(P)
    out = capture(P, inner)
    P.flight.RECORDER.reset()
    orch = make_orch(P, root, bus=bus)
    orch.start([f"https://t.me/chan{i}" for i in range(9)],
               background=False)
    n = orch.distribute_work()
    events = [e["lanes"] for e in P.flight.RECORDER.events()
              if e["kind"] == "frontier_shards"]
    return dict(n=n, order=[f["work_item"]["url"] for f in out],
                lanes=orch.get_status()["frontier_lanes"], events=events)


def sc_no_shard_map_is_identity(P, root):
    orch = make_orch(P, root)
    out = capture(P, orch.bus)
    urls = [f"https://t.me/chan{i}" for i in range(5)]
    orch.start(urls, background=False)
    orch.distribute_work()
    return dict(lanes=orch.get_status()["frontier_lanes"],
                order=[f["work_item"]["url"] for f in out])


def sc_cluster_guide_and_ttl(P, root):
    orch = make_orch(P, root)
    out = capture(P, orch.bus)
    orch.handle_cluster_payload({"message_type": "cluster_update"})
    undecodable = orch._cluster_guide is None
    orch.handle_cluster_payload(P.msg.ClusterUpdateMessage.new(
        "cluster-1", k=4, step=5, vectors=100, sizes=[50, 40, 8, 2],
        underpopulated=[3], channel_clusters={"sparseChan": 3,
                                              "denseChan": 0}).to_dict())
    orch.start(["https://t.me/sparseChan", "https://t.me/denseChan",
                "https://t.me/unknownChan"], background=False)
    orch.distribute_work()
    guided = dispatched(out)
    st = status(orch)["cluster_guide"]
    # Age the guide past its TTL (600 s): it stops steering.
    orch._cluster_guide["received_at"] -= 601.0
    item = next(iter(orch.active_work.values()))
    return dict(undecodable=undecodable, guided=sorted(guided), guide=st,
                expired=orch._frontier_priority(item))


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name, tmp_path):
    ref, port = both(SCENARIOS[name], tmp_path)
    assert port == ref


# -- spot checks of what the scenarios observe ---------------------------------------
def test_the_scenarios_see_what_the_reference_tests_assert(tmp_path):
    """The parity above is only as good as what the scenarios return; pin
    the reference tests' own assertions on the port's observations."""
    P = PKGS["port"]
    obs = {}
    for name in ("distributes_unfetched_pages", "inference_backpressure",
                 "health_monitor_reassigns_work", "retry_exhaustion",
                 "stale_work_requeued_then_abandoned",
                 "kill_then_resume_requeues_inflight", "cluster_guide_and_ttl",
                 "outbox_near_full_pauses_dispatch"):
        root = tmp_path / name
        root.mkdir()
        obs[name] = SCENARIOS[name](P, root)
    assert obs["distributes_unfetched_pages"]["counts"] == [2, 0]
    assert obs["inference_backpressure"]["seen"] == [
        (0, True), (0, True), (2, False)]
    hm = obs["health_monitor_reassigns_work"]
    assert hm["claimed"] == "w1" and hm["first"] == ["w1"]
    assert hm["second"] == [] and hm["sent"] == [("chana", 0, 1, 1)]
    assert obs["retry_exhaustion"]["rounds"] == [1, 1, 1, 0]
    assert obs["retry_exhaustion"]["pages"][0] == [
        ("chana", "abandoned", "boom")]
    stale = obs["stale_work_requeued_then_abandoned"]
    assert stale["steps"] == [0, 1, 1, 1, 0]
    assert stale["ids"][0].endswith("#1") and stale["retries"] == {}
    assert stale["pages"][0][0][1] == "abandoned"
    kill = obs["kill_then_resume_requeues_inflight"]
    assert kill["resumed"] and kill["same_ids"]
    assert kill["counts"] == [1, 1]
    assert {p for _, _, p, _ in kill["sent"]} == {1}
    guide = obs["cluster_guide_and_ttl"]
    assert guide["undecodable"]
    assert ("https://t.me/sparseChan", 0, 1, 0) in guide["guided"]
    assert guide["guide"]["prioritized_items"] == 1
    assert guide["expired"] == 3
    assert obs["outbox_near_full_pauses_dispatch"]["seen"] == [
        True, True, False]


def test_option_constants_are_the_references_defaults():
    ref = jorch.OrchestratorConfig()
    for name, value in (("distribute_interval_s",
                         torch_orch.DISTRIBUTE_INTERVAL_S),
                        ("health_interval_s", torch_orch.HEALTH_INTERVAL_S),
                        ("worker_timeout_s", torch_orch.WORKER_TIMEOUT_S),
                        ("max_retries", torch_orch.MAX_RETRIES),
                        ("work_ttl_s", torch_orch.WORK_TTL_S),
                        ("alert_eval_interval_s", twt.EVAL_INTERVAL_S),
                        ("cluster_guide_ttl_s",
                         torch_orch.CLUSTER_GUIDE_TTL_S)):
        assert getattr(ref, name) == value, name
    port = torch_orch.OrchestratorConfig()
    for name, value in vars(port).items():
        assert getattr(ref, name) == value, name
    assert torch_orch.APPLIED_RESULTS_WINDOW == jorch.APPLIED_RESULTS_WINDOW
    assert torch_orch.APPLIED_RESULTS_SNAPSHOT == \
        jorch.APPLIED_RESULTS_SNAPSHOT
    assert tjour.COMPACT_EVERY == jjour.DEFAULT_COMPACT_EVERY


# -- the wire and the files, across packages -------------------------------------------
def test_work_frames_decode_in_both_packages():
    cfg = tmsg.WorkItemConfig(storage_root="/x", concurrency=4, max_posts=9,
                              skip_media_download=True,
                              sampling_method="snowball")
    item = tmsg.WorkItem.new("chana", 2, "p0", "c1", "telegram", cfg)
    frame = tmsg.WorkQueueMessage.new(item, tmsg.PRIORITY_HIGH, 60).to_dict()
    assert jmsg.WorkQueueMessage.from_dict(frame).to_dict() == frame
    wr = jmsg.WorkResult(work_item_id=item.id, worker_id="w", status="error",
                         error="e", processed_url="chana",
                         completed_at=jmsg.utcnow(), retry_recommended=True)
    res = jmsg.ResultMessage.new(wr, [jmsg.DiscoveredPage(
        url="chanb", parent_id="p0", depth=3, platform="telegram")]).to_dict()
    assert tmsg.ResultMessage.from_dict(res).to_dict() == res
    alert = tmsg.AlertMessage.new("r", "threshold", "s", "firing",
                                  prev_state="pending", value=2.5,
                                  detail={"series": 1}).to_dict()
    assert jmsg.AlertMessage.from_dict(alert).to_dict() == alert


def _journal_crawl(P, root):
    """Dispatch two seeds, apply one result with a discovery, die."""
    bus = P.bus.InMemoryBus()
    orch = make_orch(P, root, bus=bus)
    orch.start(["chana", "chanb"], background=False)
    orch.distribute_work()
    orch.handle_result(result(P, orch, "chana", discovered=["chanc"]))
    orch.distribute_work()
    orch.kill()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_resumes_the_others_journal(tmp_path, writer, reader):
    """A crawl killed under one package resumes under the other: the same
    in-flight items requeue under their ids, and the recovery equals the
    writer's own resume of the same files."""
    src = tmp_path / "src"
    src.mkdir()
    _journal_crawl(PKGS[writer], src)
    got = {}
    for who in (writer, reader):
        root = tmp_path / who
        import shutil
        shutil.copytree(src, root / "x")
        P = PKGS[who]
        bus = P.bus.InMemoryBus()
        out = capture(P, bus)
        orch = make_orch(P, root / "x", bus=bus)
        orch.start(["chana", "chanb"], background=False)
        rec = P.jour.CrawlJournal(
            os.path.join(str(root / "x"), "journal")).replay()
        got[who] = normalize(dict(
            resumed=orch.resumed, sent=dispatched(out),
            active=sorted(orch.active_work), pages=pages(orch),
            rec=rec.to_debug_dict(), status=status(orch)))
        orch.stop()
    assert got[reader] == got[writer]
    assert got[reader]["resumed"] is True


def test_state_json_is_the_references_both_ways(tmp_path):
    """The same crawl in both packages writes the same ``state.json`` and
    ``metadata.json`` (modulo ids and walls), and no ``graph.sqlite``
    appears in the port's tree."""
    trees = {}
    for name, P in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        orch = make_orch(P, root)
        orch.start(["chana", "chanb"], background=False)
        orch.distribute_work()
        orch.handle_result(result(P, orch, "chana", discovered=["chanc"]))
        orch.handle_result(result(P, orch, "chanb", status="error",
                                  error="boom", retry=True))
        orch.stop()
        files = {}
        for d, _, fs in os.walk(root / "s"):
            for f in fs:
                with open(os.path.join(d, f), encoding="utf-8") as fh:
                    files[os.path.relpath(os.path.join(d, f), root / "s")] = \
                        json.load(fh)
        trees[name] = normalize(files)
    assert sorted(trees["port"]) == ["c1/metadata.json", "c1/state.json"]
    assert trees["port"] == trees["ref"]


# -- with the reference's crawl worker ---------------------------------------------------
@pytest.fixture
def telegram_net():
    from distributed_crawler_tpu.clients import SimNetwork
    from distributed_crawler_tpu.crawl import runner as crawl_runner
    from tests.test_crawl_engine import text_msg

    net = SimNetwork()
    net.add_channel("chana", messages=[
        text_msg("hello t.me/chanb", date=1700000000, view_count=5),
    ], member_count=100)
    net.add_channel("chanb", messages=[
        text_msg("plain message t.me/chanc", date=1700000100, view_count=3),
    ], member_count=200)
    net.add_channel("chanc", messages=[
        text_msg("leaf", date=1700000200, view_count=1),
    ], member_count=300)
    install_pool(net)
    yield net
    crawl_runner.shutdown_connection_pool()


def install_pool(net):
    """A fresh connection pool on ``net``: a crawl leaves its connections
    in use, so each crawl in one test gets its own."""
    from distributed_crawler_tpu.clients import SimTelegramClient
    from distributed_crawler_tpu.clients.pool import ConnectionPool
    from distributed_crawler_tpu.crawl import runner as crawl_runner

    crawl_runner.shutdown_connection_pool()
    crawl_runner.init_connection_pool(ConnectionPool.for_testing(
        {"conn0": SimTelegramClient(net, conn_id="conn0")}))


def _ref_worker(bus, root):
    from distributed_crawler_tpu.worker import CrawlWorker

    return CrawlWorker("w1", make_cfg(PKGS["ref"]), bus,
                       make_sm(PKGS["ref"], os.path.join(str(root), "wrk")))


def test_mid_crawl_kill_resume_completes_with_the_reference_worker(
        tmp_path, telegram_net):
    """The reference's `test_mid_crawl_kill_resume_completes_crawl` with
    the port's orchestrator: killed with an item in flight, resumed from
    the journal, and the reference's `CrawlWorker` finishes the crawl."""
    P = PKGS["port"]
    bus = P.bus.InMemoryBus()
    orch1 = make_orch(P, tmp_path, bus=bus)
    orch1.start(["chana"], background=False)
    assert orch1.distribute_work() == 1
    orch1.kill()
    out = capture(P, bus)
    orch2 = make_orch(P, tmp_path, bus=bus)
    orch2.start(["chana"], background=False)
    assert orch2.resumed and len(out) == 1
    worker = _ref_worker(bus, tmp_path)
    worker.start(background=False)
    worker.handle_work_payload(out[0])
    for _ in range(10):
        orch2.distribute_work()
        if orch2.crawl_completed:
            break
    assert orch2.crawl_completed
    assert orch2.completed_items == 3 and orch2.error_items == 0
    assert pages(orch2) == {0: [("chana", "fetched", "")],
                            1: [("chanb", "fetched", "")],
                            2: [("chanc", "fetched", "")]}


def _crawl_over_grpc(P, root, grpc_mod):
    """P's orchestrator on P's broker; the reference's worker dials it."""
    from distributed_crawler_tpu.bus.grpc_bus import RemoteBus

    server = grpc_mod.GrpcBusServer("127.0.0.1:0")
    server.enable_pull(P.msg.TOPIC_WORK_QUEUE)
    server.start()
    remote = RemoteBus(f"127.0.0.1:{server.bound_port}")
    orch = make_orch(P, root, bus=server)
    worker = _ref_worker(remote, root)
    try:
        orch.start(["chana"], background=False)
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


def test_bfs_crawl_over_grpc_with_the_reference_worker(tmp_path,
                                                      telegram_net):
    """`TestGrpcRoundTrip::test_bfs_crawl_over_grpc` across packages: the
    port's orchestrator hosts the port's broker and the reference's
    `CrawlWorker` crawls through it; the crawl ends with the reference
    orchestrator's pages."""
    pytest.importorskip("grpc")
    from distributed_crawler_tpu.bus import grpc_bus as jgrpc
    from distributed_crawler_tpu_torch.bus import grpc_bus as tgrpc

    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = _crawl_over_grpc(PKGS["ref"], tmp_path / "ref", jgrpc)
    install_pool(telegram_net)
    port = _crawl_over_grpc(PKGS["port"], tmp_path / "port", tgrpc)
    assert port["completed"] and port["counts"] == (3, 0)
    assert port == ref

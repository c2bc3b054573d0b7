"""Scenario-driven fault injection: declarative timelines of failure.

The port's copy of the reference's `distributed_crawler_tpu/loadgen/
chaos.py`, with the same timeline grammar and parse errors.

A chaos timeline is a list of one-line fault declarations, each anchored
to an offset from scenario start:

    at=2s kill tpu-1              # abrupt worker death (no drain, no ack)
    at=4s restart tpu-1           # supervisor-style restart
    from=1s..2s down tpu-1        # kill at window start, restart at end
    at=3s stall tpu-1 1.5s        # device call blocks 1.5s mid-step
    from=1s..2.5s wedge tpu-1     # backend wedged for the window
                                  # (a wedged-backend failure mode)
    from=5s..6s delay bus 200ms   # every inference publish +200ms
    from=5s..6s drop bus          # inference publishes dropped
    at=2s poison batch            # next batch's records undecodable
    at=1s flood network 1s        # crawl-side FLOOD_WAIT burst (1s
                                  # retry-after hints; the gate's sim-
                                  # network handle)

Kill/restart/down apply to ANY registered target with ``kill()`` /
``restart()`` — including the ``orchestrator`` handle the gate registers,
so a timeline can take the coordinator itself down mid-crawl and assert
the journal-based resume (`orchestrator/journal.py`):

    from=1.2s..2.2s down orchestrator

and, on gRPC runs, the ``bus`` handle — the broker itself dies (RAM
queues and in-flight ledgers dropped) and restarts as a new
`GrpcBusServer` generation over the same WAL spool dir + port
(`bus/spool.py`; the kill-broker scenario):

    from=1.5s..2.8s down bus

Note the distinction from ``delay bus`` / ``drop bus``, which degrade
the publish PATH through the `ChaosBus` wrapper while the broker stays
up — ``down bus`` kills the broker process-analog itself.

Point faults fire once; window faults apply at ``from`` and unwind at
the window end.  Every application and unwind is recorded as a
``chaos`` flight event (postmortems show cause next to effect) and
announced on ``TOPIC_CHAOS`` as a typed `ChaosMessage`, so distributed
targets can observe faults they cannot feel locally.

The controller acts on registered *targets* (duck-typed handles with
``kill()`` / ``restart()`` / ``stall(seconds)`` — the gate's worker
handles) and on a `ChaosBus`, the publish-side wrapper that delays,
drops, or poisons record-batch traffic while keeping a ledger of every
post_uid it let through — the gate's reconciliation source of truth.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..bus.messages import (
    TOPIC_CHAOS,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_MEDIA_BATCHES,
    ChaosMessage,
)
from ..utils import flight

logger = logging.getLogger("dct.loadgen.chaos")

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)?$")

# action -> (needs_window, takes_target, takes_duration_arg)
_ACTIONS = {
    "kill": (False, True, False),
    "restart": (False, True, False),
    "down": (True, True, False),     # kill at window start, restart at end
    "stall": (False, True, True),
    "wedge": (True, True, False),
    "delay": (True, True, True),     # target is the literal word "bus"
    "drop": (True, True, False),     # target is the literal word "bus"
    "poison": (False, True, False),  # target is the literal word "batch"
    # Crawl-side rate-limit storm: the target handle injects a burst of
    # FLOOD_WAIT errors (retry_after = the duration arg) into the sim
    # backend — the reference's defining failure mode, driven through
    # the resilience layer's server-directed-backoff hints.
    "flood": (False, True, True),
}

# Actions resolved against a registered target handle (vs the ChaosBus).
_TARGET_ACTIONS = ("kill", "restart", "down", "stall", "wedge", "flood")


def parse_duration_s(text: str) -> float:
    m = _DUR_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. 2s, 1.5s, "
                         f"200ms)")
    value = float(m.group(1))
    return value / 1000.0 if m.group(2) == "ms" else value


@dataclass(frozen=True)
class Fault:
    """One parsed timeline entry."""

    action: str
    target: str
    at_s: float
    until_s: Optional[float] = None    # None = point fault
    arg_s: Optional[float] = None      # stall/delay duration
    raw: str = ""

    @property
    def windowed(self) -> bool:
        return self.until_s is not None


def parse_fault(line: str) -> Fault:
    """Parse one declaration line (see module docstring for the forms)."""
    parts = line.split()
    if len(parts) < 2:
        raise ValueError(f"bad chaos line {line!r}")
    anchor, action, rest = parts[0], parts[1], parts[2:]
    if action not in _ACTIONS:
        raise ValueError(f"unknown chaos action {action!r} in {line!r}")
    needs_window, takes_target, takes_arg = _ACTIONS[action]
    if anchor.startswith("from="):
        window = anchor[len("from="):]
        start_s, sep, end_s = window.partition("..")
        if not sep:
            raise ValueError(f"bad window {anchor!r} (want from=1s..2s)")
        at_s, until_s = parse_duration_s(start_s), parse_duration_s(end_s)
        if until_s <= at_s:
            raise ValueError(f"empty window in {line!r}")
        if not needs_window:
            raise ValueError(f"{action!r} is a point fault; use at=<t> "
                             f"in {line!r}")
    elif anchor.startswith("at="):
        at_s, until_s = parse_duration_s(anchor[len("at="):]), None
        if needs_window:
            raise ValueError(f"{action!r} needs a window; use "
                             f"from=<t1>..<t2> in {line!r}")
    else:
        raise ValueError(f"bad anchor {anchor!r} in {line!r} "
                         f"(want at=<t> or from=<t1>..<t2>)")
    if not takes_target or not rest:
        raise ValueError(f"{action!r} needs a target in {line!r}")
    target = rest.pop(0)
    if action in ("delay", "drop") and target != "bus":
        raise ValueError(f"{action!r} targets 'bus', got {target!r}")
    if action == "poison" and target != "batch":
        raise ValueError(f"poison targets 'batch', got {target!r}")
    arg_s = None
    if takes_arg:
        if not rest:
            raise ValueError(f"{action!r} needs a duration in {line!r}")
        arg_s = parse_duration_s(rest.pop(0))
    if rest:
        raise ValueError(f"trailing tokens {rest} in {line!r}")
    return Fault(action=action, target=target, at_s=at_s, until_s=until_s,
                 arg_s=arg_s, raw=line.strip())


def parse_timeline(lines: List[str]) -> List[Fault]:
    """Parse a timeline, sorted by activation time."""
    faults = [parse_fault(ln) for ln in lines
              if ln.strip() and not ln.strip().startswith("#")]
    return sorted(faults, key=lambda f: f.at_s)


class ChaosBus:
    """Publish-side wrapper over any bus transport.

    Faults apply only to record/audio-batch traffic on ``chaos_topics``
    (default: the inference + media topics) — heartbeats, results, and
    control messages pass through untouched, the way a degraded DCN link
    hurts the fat record stream first.  Every batch that goes through
    (or is dropped/poisoned) lands in the ledger — post_uids for text
    record batches, media_ids for audio batches — which is what the gate
    reconciles against the writeback sink: published - dropped -
    poisoned must equal written, exactly.
    """

    def __init__(self, inner, chaos_topics=(TOPIC_INFERENCE_BATCHES,
                                            TOPIC_MEDIA_BATCHES)):
        self._inner = inner
        self._topics = set(chaos_topics)
        self._lock = threading.Lock()
        self._delay_s = 0.0
        self._dropping = False
        self._poison_next = False
        self.published: Dict[str, List[str]] = {}  # batch_id -> post_uids
        self.dropped: List[str] = []               # batch_ids
        self.poisoned: List[str] = []              # batch_ids

    # -- fault switches (controller-driven) --------------------------------
    def set_delay(self, seconds: float) -> None:
        with self._lock:
            self._delay_s = max(0.0, seconds)

    def set_drop(self, dropping: bool) -> None:
        with self._lock:
            self._dropping = dropping

    def poison_next(self) -> None:
        with self._lock:
            self._poison_next = True

    # -- ledger -------------------------------------------------------------
    def expected_uids(self) -> List[str]:
        """post_uids that reached the bus intact (ledger minus dropped
        minus poisoned) — what the writeback sink must contain."""
        with self._lock:
            skip = set(self.dropped) | set(self.poisoned)
            return [uid for bid, uids in self.published.items()
                    if bid not in skip for uid in uids]

    # -- transport ----------------------------------------------------------
    def publish(self, topic: str, payload: Any) -> None:
        is_text = isinstance(payload, dict) and "records" in payload
        is_audio = isinstance(payload, dict) and "refs" in payload
        if topic not in self._topics or not (is_text or is_audio):
            self._inner.publish(topic, payload)
            return
        batch_id = payload.get("batch_id", "")
        if is_text:
            uids = [r.get("post_uid", "")
                    for r in payload.get("records", [])
                    if isinstance(r, dict)]
        else:
            uids = [r.get("media_id", "")
                    for r in payload.get("refs", [])
                    if isinstance(r, dict)]
        with self._lock:
            self.published[batch_id] = uids
            delay_s = self._delay_s
            dropping = self._dropping
            # A drop window must not consume a scheduled poison: the
            # poison waits for the first batch that actually goes out.
            poison = self._poison_next and not dropping
            if poison:
                self._poison_next = False
            if dropping:
                self.dropped.append(batch_id)
            elif poison:
                self.poisoned.append(batch_id)
        if dropping:
            flight.record("chaos_effect", action="drop", batch=batch_id,
                          records=len(uids))
            return
        if poison:
            # Records/refs that decode as the right envelope but break
            # the per-batch front door (Post.from_dict on a non-dict;
            # an audio ref list whose entries are not dicts) — the
            # poisoned-batch isolation path must absorb it.
            key = "records" if is_text else "refs"
            payload = {**payload, key: [None] * len(uids)}
            flight.record("chaos_effect", action="poison", batch=batch_id,
                          records=len(uids))
        if delay_s > 0:
            time.sleep(delay_s)
        self._inner.publish(topic, payload)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ChaosEngine:
    """Engine proxy whose device calls can be blocked for a window — the
    in-process analog of a wedged backend (a device call that normally
    takes tens of ms suddenly doesn't return).  Blocking happens INSIDE
    run/run_tokenized, i.e. mid-step from the TPU worker's perspective,
    so the stall watchdog sees a step that does not return.  On the card
    the block is a host-side wait before the call, so no stream is left
    blocked; :meth:`release` ends any open block at teardown.

    ``device_lock``, shared by every proxy over one engine on the card
    (the gate's elastic fleet), lets one worker thread at a time launch:
    threads launching one model's kernels into one CUDA context contend
    on its locks and on the caching allocators, so that three workers
    launching at once served fewer posts than one and the fleet never
    drained a flash crowd."""

    def __init__(self, inner, clock: Callable[[], float] = time.monotonic,
                 device_lock: Optional[threading.Lock] = None):
        self._inner = inner
        self._clock = clock
        self._blocked_until = 0.0
        self._lock = threading.Lock()
        self._device_lock = device_lock or threading.Lock()

    def block_for(self, seconds: float) -> None:
        with self._lock:
            self._blocked_until = max(self._blocked_until,
                                      self._clock() + seconds)

    def _maybe_block(self) -> None:
        while True:
            with self._lock:
                remaining = self._blocked_until - self._clock()
            if remaining <= 0:
                return
            time.sleep(min(0.02, remaining))

    def release(self) -> None:
        """End any open block now (teardown: a thread parked in a wedge
        returns instead of calling the device after the run)."""
        with self._lock:
            self._blocked_until = 0.0

    # Explicit signatures: TPUWorker's capability probes inspect them
    # (`pack` must be a named parameter for the packed paths to engage).
    def run(self, texts, pack: bool = False):
        self._maybe_block()
        with self._device_lock:
            return self._inner.run(texts, pack=pack)

    def run_tokenized(self, token_lists, pack: bool = False):
        self._maybe_block()
        with self._device_lock:
            return self._inner.run_tokenized(token_lists, pack=pack)

    def warmup(self, buckets=None, pack: bool = False):
        with self._device_lock:
            return self._inner.warmup(buckets=buckets, pack=pack)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ChaosASRPipeline:
    """`ChaosEngine`'s ASR twin: an `inference.asr.ASRPipeline` proxy
    whose device calls can be blocked for a window, so `stall`/`wedge`
    timeline lines work against an ASR worker too.  The block happens
    inside ``transcribe_plan``/``transcribe_audio`` — mid-step from the
    `ASRWorker`'s perspective."""

    def __init__(self, inner, clock: Callable[[], float] = time.monotonic):
        self._inner = inner
        self._clock = clock
        self._blocked_until = 0.0
        self._lock = threading.Lock()

    def block_for(self, seconds: float) -> None:
        with self._lock:
            self._blocked_until = max(self._blocked_until,
                                      self._clock() + seconds)

    def _maybe_block(self) -> None:
        while True:
            with self._lock:
                remaining = self._blocked_until - self._clock()
            if remaining <= 0:
                return
            time.sleep(min(0.02, remaining))

    def release(self) -> None:
        """End any open block now (teardown: a thread parked in a wedge
        returns instead of calling the device after the run)."""
        with self._lock:
            self._blocked_until = 0.0

    def transcribe_plan(self, plan):
        self._maybe_block()
        return self._inner.transcribe_plan(plan)

    def transcribe_audio(self, audio_batch, real_windows=None,
                         record=True):
        self._maybe_block()
        return self._inner.transcribe_audio(audio_batch,
                                            real_windows=real_windows,
                                            record=record)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ChaosController:
    """Applies a parsed timeline to registered targets and a ChaosBus.

    ``targets`` maps the names used in timeline lines to handles; worker
    handles need ``kill()`` / ``restart()`` / ``stall(seconds)`` (the
    gate's `WorkerHandle`).  ``tick()`` is public and side-effect-
    complete so tests drive the timeline with a fake clock; ``start()``
    wires the same method to a 10 ms background thread."""

    def __init__(self, timeline: List[Fault],
                 targets: Optional[Dict[str, Any]] = None,
                 bus: Optional[ChaosBus] = None,
                 publish_bus=None,
                 clock: Callable[[], float] = time.monotonic,
                 dynamic_targets: bool = False):
        self.timeline = list(timeline)
        self.targets = dict(targets or {})
        self.bus = bus
        self.publish_bus = publish_bus
        self.clock = clock
        self.dynamic_targets = dynamic_targets
        self.events: List[Dict[str, Any]] = []
        self._applied: set = set()
        self._unwound: set = set()
        self._t0: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        for f in self.timeline:
            if f.action in _TARGET_ACTIONS and targets is not None \
                    and f.target not in self.targets \
                    and not dynamic_targets:
                # With an elastic fleet (``dynamic_targets``) a timeline
                # may name a worker the autoscaler has not spawned yet —
                # the fault errors at APPLY time if it still doesn't
                # exist; static fleets keep the loud config-time check.
                raise ValueError(f"chaos fault {f.raw!r} names unknown "
                                 f"target {f.target!r}")
            if f.action in ("delay", "drop", "poison") and bus is None:
                raise ValueError(f"chaos fault {f.raw!r} needs a ChaosBus")

    def register_target(self, name: str, handle: Any) -> None:
        """Register (or replace) a fault target mid-run — how autoscaler-
        spawned workers become valid chaos targets the moment they
        exist."""
        with self._lock:
            self.targets[name] = handle

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._t0 = self.clock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dct-chaos")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        # Unwind any still-open windows so a stopped controller never
        # leaves the bus delayed/dropping into the next phase.
        for i, f in enumerate(self.timeline):
            if f.windowed and i in self._applied and i not in self._unwound:
                self._unwind(i, f)

    def done(self) -> bool:
        return all(i in self._applied for i in range(len(self.timeline))) \
            and all(i in self._unwound
                    for i, f in enumerate(self.timeline) if f.windowed)

    def _loop(self) -> None:
        while not self._stop.is_set() and not self.done():
            self.tick()
            self._stop.wait(0.01)

    # -- the tick ------------------------------------------------------------
    def tick(self, now_s: Optional[float] = None) -> None:
        """Apply every fault due at ``now_s`` (offset from start) and
        unwind every expired window."""
        if now_s is None:
            if self._t0 is None:
                self._t0 = self.clock()
            now_s = self.clock() - self._t0
        for i, f in enumerate(self.timeline):
            with self._lock:
                due = i not in self._applied and now_s >= f.at_s
                if due:
                    self._applied.add(i)
            if due:
                self._apply(i, f)
            with self._lock:
                expired = (f.windowed and i in self._applied
                           and i not in self._unwound
                           and now_s >= (f.until_s or 0.0))
            if expired:
                self._unwind(i, f)

    # -- application ---------------------------------------------------------
    def _announce(self, f: Fault, phase: str) -> None:
        flight.record("chaos", action=f.action, target=f.target,
                      phase=phase, at_s=f.at_s, until_s=f.until_s,
                      raw=f.raw)
        self.events.append({"action": f.action, "target": f.target,
                            "phase": phase, "at_s": f.at_s,
                            "until_s": f.until_s})
        if self.publish_bus is not None and phase == "apply":
            try:
                msg = ChaosMessage.new(
                    f.action, f.target, f.at_s, f.until_s or 0.0,
                    parameters={"arg_s": f.arg_s} if f.arg_s else {})
                self.publish_bus.publish(TOPIC_CHAOS, msg.to_dict())
            except Exception as e:  # announcements must not kill the run
                logger.warning("chaos announce failed: %s", e)

    def _apply(self, i: int, f: Fault) -> None:
        logger.warning("chaos: applying %s", f.raw)
        try:
            if f.action in _TARGET_ACTIONS and f.target not in self.targets:
                raise KeyError(
                    f"target {f.target!r} does not exist (not spawned "
                    f"yet, or already retired)")
            if f.action in ("kill", "down"):
                self.targets[f.target].kill()
            elif f.action == "restart":
                self.targets[f.target].restart()
            elif f.action == "stall":
                self.targets[f.target].stall(f.arg_s or 0.0)
            elif f.action == "wedge":
                self.targets[f.target].stall((f.until_s or 0.0) - f.at_s)
            elif f.action == "flood":
                self.targets[f.target].flood(f.arg_s or 1.0)
            elif f.action == "delay":
                self.bus.set_delay(f.arg_s or 0.0)
            elif f.action == "drop":
                self.bus.set_drop(True)
            elif f.action == "poison":
                self.bus.poison_next()
            self._announce(f, "apply")
        except Exception as e:
            logger.error("chaos fault %r failed to apply: %s", f.raw, e)
            self.events.append({"action": f.action, "target": f.target,
                                "phase": "error", "error": str(e)})

    def _unwind(self, i: int, f: Fault) -> None:
        with self._lock:
            if i in self._unwound:
                return
            self._unwound.add(i)
        try:
            if f.action == "delay":
                self.bus.set_delay(0.0)
            elif f.action == "drop":
                self.bus.set_drop(False)
            elif f.action == "down":
                # The supervisor brings the target back at window end.
                self.targets[f.target].restart()
            # wedge unwinds by its own deadline inside ChaosEngine
            self._announce(f, "unwind")
        except Exception as e:
            logger.error("chaos fault %r failed to unwind: %s", f.raw, e)

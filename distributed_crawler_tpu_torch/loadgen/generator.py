"""Seeded synthetic workload source + flight-bundle replay.

The port's copy of the reference's `distributed_crawler_tpu/loadgen/
generator.py`: for one seed its plans, batch JSON and WAV bytes are the
reference's, byte for byte.

The generator is the "millions of users" stand-in: it emits
`RecordBatch` work through the real bus so the orchestrator, crawl
worker, and TPU worker run their production code paths against traffic
with production shape — Zipf-distributed post lengths (crawl streams are
short-message dominated with a long tail), a telegram/youtube platform
mix, and a configurable arrival process:

- ``poisson``: open-loop Poisson arrivals at ``rate_batches_per_s`` —
  offered load does NOT slow down when the service backs up, which is
  what makes queue growth visible;
- ``ramp``: closed-loop concurrency ramp — at most ``window`` batches
  outstanding (per a caller-supplied ``pending_fn``), the window ramping
  linearly from ``ramp_from`` to ``ramp_to`` over the run.

Everything derives from ``seed`` through one `random.Random`, so the
same seed reproduces identical batch shapes and arrival schedules
(asserted by tests/test_torch_loadgen.py against the reference).

Replay: :func:`workload_from_bundle` rebuilds a workload from a
flight-recorder/postmortem bundle — batch count, per-batch record
counts, total token (word) volume, and arrival gaps — turning every
postmortem under ``--dump-dir`` into a reproducible load test.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..bus.codec import RecordBatch
from ..bus.messages import (
    DEFAULT_TENANT,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_MEDIA_BATCHES,
    VALID_PLATFORMS,
    AudioBatchMessage,
    AudioRef,
)
from ..datamodel.post import Post
from ..utils import flight

logger = logging.getLogger("dct.loadgen")

# Same 997-word synthetic vocabulary as bench.py's `_zipf_text`: words
# repeat (compression and tokenizer memos see realistic reuse) but no two
# texts are identical.
_VOCAB = 997


def zipf_text(phase: int, n_words: int) -> str:
    """Deterministic Zipf-ish text: ``n_words`` words from a 997-word
    vocabulary with per-text phase."""
    return " ".join(f"w{(phase * 31 + j * 7) % _VOCAB}"
                    for j in range(max(1, n_words)))


@dataclass(frozen=True)
class PlannedRecord:
    """Shape of one synthetic post before it is materialized."""

    platform: str
    words: int


@dataclass(frozen=True)
class PlannedBatch:
    """Shape + arrival slot of one batch; ``offset_s`` is None for
    closed-loop arrivals (the completion feedback sets the time).
    ``tenant`` is empty for batches planned before the tenant mix is
    consulted (gate tail batches, replays) — `build_batch` then draws a
    deterministic tenant from the mix by batch index."""

    index: int
    offset_s: Optional[float]
    records: tuple  # of PlannedRecord
    tenant: str = ""


@dataclass
class LoadGenConfig:
    seed: int = 0
    duration_s: float = 5.0
    arrival: str = "poisson"            # poisson | ramp
    rate_batches_per_s: float = 10.0    # poisson
    # Piecewise-constant Poisson rate: [[t_s, rate], ...] breakpoints
    # (ascending t; rate_batches_per_s applies before the first one).
    # This is the hostile-traffic shape source — a flash crowd is a
    # single 10x step, a diurnal cycle is a staircase up and back down —
    # still fully seeded: the same seed reproduces the same arrivals.
    rate_profile: List[Any] = field(default_factory=list)
    ramp_from: int = 1                  # ramp: starting concurrency window
    ramp_to: int = 8                    # ramp: final concurrency window
    ramp_batches: int = 50              # ramp: total batches to offer
    records_per_batch: int = 8
    zipf_a: float = 1.6                 # post-length tail exponent
    max_words: int = 120
    platform_mix: Dict[str, float] = field(
        default_factory=lambda: {"telegram": 0.8, "youtube": 0.2})
    # Tenant traffic mix: {tenant_name: weight}.  Each planned
    # batch draws one tenant from this distribution (seeded, so the same
    # seed reproduces the same per-tenant volumes).  Empty = everything
    # stamps the documented DEFAULT_TENANT.
    tenants: Dict[str, float] = field(default_factory=dict)
    crawl_id: str = "loadgen"

    def validate(self) -> None:
        if self.arrival not in ("poisson", "ramp"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.duration_s <= 0:
            raise ValueError("duration_s must be positive")
        if self.arrival == "poisson" and self.rate_batches_per_s <= 0:
            raise ValueError("rate_batches_per_s must be positive")
        if self.rate_profile:
            if self.arrival != "poisson":
                raise ValueError("rate_profile applies to poisson "
                                 "arrivals only")
            prev_t = -1.0
            for bp in self.rate_profile:
                if (not isinstance(bp, (list, tuple)) or len(bp) != 2
                        or not all(isinstance(v, (int, float))
                                   for v in bp)):
                    raise ValueError(
                        f"rate_profile entries must be [t_s, rate] "
                        f"pairs, got {bp!r}")
                t, rate = float(bp[0]), float(bp[1])
                if t < 0 or t <= prev_t:
                    raise ValueError("rate_profile breakpoints must be "
                                     "ascending and non-negative")
                if rate <= 0:
                    raise ValueError("rate_profile rates must be positive")
                prev_t = t
        bad = set(self.platform_mix) - set(VALID_PLATFORMS)
        if bad:
            raise ValueError(f"platform_mix names unknown platforms: "
                             f"{sorted(bad)}")
        if not self.platform_mix or \
                sum(self.platform_mix.values()) <= 0:
            raise ValueError("platform_mix must have positive weight")
        for name, weight in self.tenants.items():
            if not isinstance(name, str) or not name.strip():
                raise ValueError(
                    f"tenants keys must be non-empty strings, got {name!r}")
            if not isinstance(weight, (int, float)) or weight <= 0:
                raise ValueError(
                    f"tenant {name!r} weight must be a positive number, "
                    f"got {weight!r}")

    def rate_at(self, t_s: float) -> float:
        """The offered Poisson rate at offset ``t_s`` (the last
        breakpoint at or before it; the base rate before the first)."""
        rate = self.rate_batches_per_s
        for bp_t, bp_rate in self.rate_profile:
            if t_s >= float(bp_t):
                rate = float(bp_rate)
            else:
                break
        return rate


@dataclass
class RunStats:
    """What actually went onto the bus (the reconciliation source of
    truth lives in the chaos bus ledger; these are the generator-side
    totals)."""

    batches: int = 0
    records: int = 0
    words: int = 0
    first_at: float = 0.0
    last_at: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"batches": self.batches, "records": self.records,
                "words": self.words,
                "span_s": round(max(0.0, self.last_at - self.first_at), 3)}


class _WorkloadBase:
    """Shared publish loop over a precomputed plan."""

    cfg: LoadGenConfig

    def plan(self) -> List[PlannedBatch]:
        raise NotImplementedError

    # -- materialization ----------------------------------------------------
    def tenant_for(self, index: int) -> str:
        """Deterministic tenant for batch ``index`` from the configured
        mix (seeded by (seed, index), so ad-hoc batches — e.g. the
        gate's tail batches — draw the same tenant for the same slot
        regardless of plan order).  No mix → DEFAULT_TENANT."""
        mix = getattr(self.cfg, "tenants", None)
        if not mix:
            return DEFAULT_TENANT
        names = sorted(mix)
        # String seed, NOT a tuple: tuple seeding hashes its elements,
        # and str hashes are randomized per process (PYTHONHASHSEED) —
        # the draw must be identical across processes, replays included.
        rng = random.Random(f"{self.cfg.seed}:{index}:tenant")
        return rng.choices(names, weights=[mix[n] for n in names])[0]

    def build_batch(self, pb: PlannedBatch) -> RecordBatch:
        posts = []
        for j, rec in enumerate(pb.records):
            uid = f"lg{self.cfg.seed}-{pb.index}-{j}"
            posts.append(Post(
                post_uid=uid,
                channel_id=f"lgchan{pb.index % 7}",
                channel_name=f"lgchan{pb.index % 7}",
                post_link=f"https://sim/{uid}",
                platform_name=rec.platform,
                description=zipf_text(pb.index * 131 + j, rec.words)))
        tenant = getattr(pb, "tenant", "") or self.tenant_for(pb.index)
        return RecordBatch.from_posts(posts, crawl_id=self.cfg.crawl_id,
                                      tenant=tenant)

    # -- publishing ---------------------------------------------------------
    def run(self, bus, topic: str = TOPIC_INFERENCE_BATCHES,
            stop: Optional[threading.Event] = None,
            pending_fn: Optional[Callable[[], int]] = None,
            record_flight: bool = True) -> RunStats:
        """Publish the planned workload through ``bus`` in real time.

        Open-loop plans honor each batch's ``offset_s`` against a
        monotonic clock (a slow consumer does NOT slow the offered
        load); closed-loop plans publish whenever ``pending_fn()`` is
        below the ramping window.  Each published batch is flight-
        recorded as a ``loadgen_batch`` event (records + words), which
        is what :func:`workload_from_bundle` replays from.
        """
        stats = RunStats()
        stop = stop or threading.Event()
        t0 = time.monotonic()
        deadline = t0 + self.cfg.duration_s

        def publish(pb: PlannedBatch) -> None:
            batch = self.build_batch(pb)
            words = sum(r.words for r in pb.records)
            bus.publish(topic, batch.to_dict())
            now = time.monotonic()
            if stats.batches == 0:
                stats.first_at = now
            stats.last_at = now
            stats.batches += 1
            stats.records += len(pb.records)
            stats.words += words
            if record_flight:
                flight.record("loadgen_batch", batch=batch.batch_id,
                              records=len(pb.records), words=words,
                              tenant=batch.tenant,
                              offset_s=round(now - t0, 4))

        plan = self.plan()
        closed = any(pb.offset_s is None for pb in plan)
        if closed and pending_fn is None:
            raise ValueError(
                "closed-loop (ramp) workloads need a pending_fn for "
                "completion feedback")
        for pb in plan:
            if stop.is_set():
                break
            if pb.offset_s is not None:
                target = t0 + pb.offset_s
                while not stop.is_set():
                    now = time.monotonic()
                    if now >= target:
                        break
                    stop.wait(min(0.02, target - now))
                if stop.is_set():
                    break
            else:
                window = self._ramp_window(time.monotonic() - t0)
                while not stop.is_set() and time.monotonic() < deadline \
                        and pending_fn() >= window:
                    stop.wait(0.005)
                    window = self._ramp_window(time.monotonic() - t0)
                if stop.is_set() or time.monotonic() >= deadline:
                    break
            publish(pb)
        return stats

    def _ramp_window(self, elapsed_s: float) -> int:
        frac = min(1.0, max(0.0, elapsed_s / self.cfg.duration_s))
        return max(1, round(self.cfg.ramp_from
                            + frac * (self.cfg.ramp_to
                                      - self.cfg.ramp_from)))


class SyntheticWorkload(_WorkloadBase):
    """The fully-seeded synthetic source (see module docstring)."""

    def __init__(self, cfg: LoadGenConfig):
        cfg.validate()
        self.cfg = cfg
        self._plan: Optional[List[PlannedBatch]] = None

    def plan(self) -> List[PlannedBatch]:
        """Deterministic batch shapes + arrival slots from the seed."""
        if self._plan is not None:
            return self._plan
        rng = random.Random(self.cfg.seed)
        out: List[PlannedBatch] = []
        if self.cfg.arrival == "poisson":
            t = 0.0
            i = 0
            while True:
                # Non-homogeneous Poisson via piecewise-constant rate:
                # the gap out of ``t`` is drawn at the rate in force AT
                # ``t`` — a coarse but fully-seeded thinning stand-in
                # (breakpoint windows are long against the mean gap).
                t += rng.expovariate(self.cfg.rate_at(t))
                if t >= self.cfg.duration_s:
                    break
                out.append(PlannedBatch(i, round(t, 6),
                                        self._records(rng),
                                        self.tenant_for(i)))
                i += 1
        else:  # ramp: shapes only; completion feedback paces them
            for i in range(self.cfg.ramp_batches):
                out.append(PlannedBatch(i, None, self._records(rng),
                                        self.tenant_for(i)))
        self._plan = out
        return out

    def _records(self, rng: random.Random) -> tuple:
        platforms = sorted(self.cfg.platform_mix)
        weights = [self.cfg.platform_mix[p] for p in platforms]
        recs = []
        for _ in range(self.cfg.records_per_batch):
            platform = rng.choices(platforms, weights=weights)[0]
            # Bounded Pareto: mostly-short posts with a heavy tail —
            # the inverse-CDF form keeps it a pure function of the rng.
            u = max(1e-9, 1.0 - rng.random())
            words = int(u ** (-1.0 / max(0.1, self.cfg.zipf_a - 1.0)))
            recs.append(PlannedRecord(platform,
                                      max(1, min(self.cfg.max_words,
                                                 words))))
        return tuple(recs)


class ReplayWorkload(_WorkloadBase):
    """A workload reconstructed from a recorded run (see
    :func:`workload_from_bundle`): same batch count, record counts,
    token volume, and arrival gaps as the original."""

    def __init__(self, batches: List[PlannedBatch],
                 cfg: Optional[LoadGenConfig] = None,
                 source: str = ""):
        self.cfg = cfg or LoadGenConfig(crawl_id="replay")
        if batches:
            last = max((pb.offset_s or 0.0) for pb in batches)
            self.cfg.duration_s = max(self.cfg.duration_s, last + 1.0)
        self._batches = batches
        self.source = source

    def plan(self) -> List[PlannedBatch]:
        return self._batches

    def totals(self) -> Dict[str, int]:
        return {
            "batches": len(self._batches),
            "records": sum(len(pb.records) for pb in self._batches),
            "words": sum(r.words for pb in self._batches
                         for r in pb.records),
        }


# --- synthetic audio (the ASR workload, `media/`) ---------------------------

@dataclass
class AudioLoadConfig:
    """Seeded synthetic media stream for the ASR serving leg: a duration
    distribution → generated WAV files → `AudioBatchMessage`s through
    the real bus (`TOPIC_MEDIA_BATCHES`)."""

    seed: int = 0
    duration_s: float = 5.0             # load-phase length
    rate_batches_per_s: float = 3.0     # open-loop Poisson arrivals
    refs_per_batch: int = 3
    # Bounded-Pareto audio durations: mostly-short voice notes with a
    # tail of longer clips (multiple 30 s windows on real configs).
    min_audio_s: float = 0.1
    max_audio_s: float = 1.0
    zipf_a: float = 1.6
    sample_rate: int = 16_000
    crawl_id: str = "loadgen-asr"
    tenant: str = DEFAULT_TENANT        # stamped onto every audio batch

    def validate(self) -> None:
        if self.duration_s <= 0:
            raise ValueError("duration_s must be positive")
        if self.rate_batches_per_s <= 0:
            raise ValueError("rate_batches_per_s must be positive")
        if self.refs_per_batch <= 0:
            raise ValueError("refs_per_batch must be positive")
        if not 0 < self.min_audio_s <= self.max_audio_s:
            raise ValueError(
                f"bad audio duration bounds [{self.min_audio_s}, "
                f"{self.max_audio_s}]")


@dataclass(frozen=True)
class PlannedAudioBatch:
    """Arrival slot + per-ref durations of one synthetic audio batch."""

    index: int
    offset_s: float
    durations_s: tuple  # seconds per ref


class AudioWorkload:
    """The fully-seeded audio source: same seed → identical WAV bytes,
    media ids, batch shapes, and arrival schedule."""

    def __init__(self, cfg: AudioLoadConfig, media_dir: str):
        cfg.validate()
        self.cfg = cfg
        self.media_dir = media_dir
        self._plan: Optional[List[PlannedAudioBatch]] = None

    def plan(self) -> List[PlannedAudioBatch]:
        if self._plan is not None:
            return self._plan
        rng = random.Random(self.cfg.seed)
        out: List[PlannedAudioBatch] = []
        t = 0.0
        i = 0
        while True:
            t += rng.expovariate(self.cfg.rate_batches_per_s)
            if t >= self.cfg.duration_s:
                break
            durations = []
            for _ in range(self.cfg.refs_per_batch):
                u = max(1e-9, 1.0 - rng.random())
                span = u ** (-1.0 / max(0.1, self.cfg.zipf_a - 1.0))
                durations.append(round(min(
                    self.cfg.max_audio_s,
                    self.cfg.min_audio_s * span), 4))
            out.append(PlannedAudioBatch(i, round(t, 6), tuple(durations)))
            i += 1
        self._plan = out
        return out

    def media_id(self, batch_index: int, ref_index: int) -> str:
        return f"am{self.cfg.seed}-{batch_index}-{ref_index}"

    def materialize(self) -> int:
        """Write every planned WAV under ``media_dir`` (deterministic
        sine tones: seeded frequency per ref); returns the file count.
        Done up front so file I/O never skews the arrival schedule."""
        import os
        import wave

        import numpy as np

        os.makedirs(self.media_dir, exist_ok=True)
        n = 0
        rate = self.cfg.sample_rate
        for pb in self.plan():
            for j, seconds in enumerate(pb.durations_s):
                freq = 220.0 + ((pb.index * 31 + j * 7) % 24) * 55.0
                t = np.arange(int(seconds * rate)) / rate
                pcm = (np.sin(2 * np.pi * freq * t)
                       * 0.3 * 32767).astype(np.int16)
                path = os.path.join(self.media_dir,
                                    f"{self.media_id(pb.index, j)}.wav")
                with wave.open(path, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(rate)
                    w.writeframes(pcm.tobytes())
                n += 1
        return n

    def run(self, bus, topic: str = TOPIC_MEDIA_BATCHES,
            stop: Optional[threading.Event] = None,
            record_flight: bool = True) -> RunStats:
        """Publish the planned audio batches in real time (open-loop:
        a slow ASR worker does NOT slow the offered load)."""
        import os

        stats = RunStats()
        stop = stop or threading.Event()
        t0 = time.monotonic()
        for pb in self.plan():
            target = t0 + pb.offset_s
            while not stop.is_set():
                now = time.monotonic()
                if now >= target:
                    break
                stop.wait(min(0.02, target - now))
            if stop.is_set():
                break
            refs = [AudioRef(
                media_id=self.media_id(pb.index, j),
                path=os.path.join(self.media_dir,
                                  f"{self.media_id(pb.index, j)}.wav"),
                channel_name=f"lgchan{pb.index % 5}")
                for j in range(len(pb.durations_s))]
            msg = AudioBatchMessage.new(refs, crawl_id=self.cfg.crawl_id,
                                        tenant=self.cfg.tenant)
            bus.publish(topic, msg.to_dict())
            now = time.monotonic()
            if stats.batches == 0:
                stats.first_at = now
            stats.last_at = now
            stats.batches += 1
            stats.records += len(refs)
            stats.words += int(sum(pb.durations_s) * 1000)  # audio ms
            if record_flight:
                flight.record("loadgen_audio_batch", batch=msg.batch_id,
                              refs=len(refs),
                              audio_s=round(sum(pb.durations_s), 3),
                              offset_s=round(now - t0, 4))
        return stats


def _spread_words(total: int, n: int) -> List[int]:
    """Split ``total`` words over ``n`` records exactly (no drift: the
    replay's token volume must match the recording within rounding)."""
    if n <= 0:
        return []
    base = max(1, total // n)
    words = [base] * n
    words[-1] = max(1, total - base * (n - 1))
    return words


def workload_from_bundle(path: str,
                         mean_words: int = 12) -> ReplayWorkload:
    """Rebuild a workload from a postmortem/flight bundle JSON file.

    Two sources, best first:

    - ``loadgen_batch`` flight events (runs driven by this module):
      exact record counts, word totals, and arrival offsets;
    - ``orchestrator.dispatch`` spans in the bundle's trace export
      (organic runs): record counts + arrival times, with
      ``mean_words`` standing in for the unrecorded text volume.

    Raises ``ValueError`` when the bundle carries neither — an empty
    replay would silently "pass" any gate.
    """
    with open(path, "r", encoding="utf-8") as f:
        bundle = json.load(f)
    events = [e for e in bundle.get("flight", [])
              if e.get("kind") == "loadgen_batch"]
    batches: List[PlannedBatch] = []
    if events:
        events.sort(key=lambda e: e.get("ts", 0.0))
        t0 = events[0].get("ts", 0.0)
        for i, e in enumerate(events):
            n = int(e.get("records") or 0)
            words = _spread_words(int(e.get("words") or n * mean_words), n)
            offset = e.get("offset_s")
            if offset is None:
                offset = max(0.0, e.get("ts", t0) - t0)
            batches.append(PlannedBatch(
                i, round(float(offset), 6),
                tuple(PlannedRecord("telegram", w) for w in words)))
        return ReplayWorkload(batches, source=f"{path}:flight")
    # Organic runs: the dispatch spans that rooted each batch's trace.
    spans = []
    for tr in bundle.get("traces", {}).get("traces", []):
        for s in tr.get("spans", []):
            if s.get("name") == "orchestrator.dispatch" \
                    and s.get("attrs", {}).get("records"):
                spans.append(s)
    if not spans:
        raise ValueError(
            f"bundle {path} carries no loadgen_batch flight events and "
            f"no orchestrator.dispatch batch spans; nothing to replay")
    spans.sort(key=lambda s: s.get("start_wall", 0.0))
    t0 = spans[0].get("start_wall", 0.0)
    for i, s in enumerate(spans):
        n = int(s["attrs"]["records"])
        words = _spread_words(n * mean_words, n)
        batches.append(PlannedBatch(
            i, round(max(0.0, s.get("start_wall", t0) - t0), 6),
            tuple(PlannedRecord("telegram", w) for w in words)))
    return ReplayWorkload(batches, source=f"{path}:traces")

"""Broker WAL spool: the durable memory of the gRPC bus.

The port's copy of the reference's `distributed_crawler_tpu/bus/
spool.py`, with the same on-disk formats, so a port broker resumes a
reference broker's spool and the other way round:

- :class:`TopicSpool` — one append-only JSONL WAL per pull topic
  recording ``enq`` (frame enters the queue), ``rq`` (requeue, attempt
  count bumped), ``ack`` (frame done) and ``dead`` (frame dead-lettered)
  events.  Appends are flushed per event and fsynced in batches
  (:data:`FSYNC_EVERY`); replay folds the surviving events into the exact
  queued + unacked-in-flight frame set, attempt counts included, with a
  torn tail line (crash mid-append) skipped, not fatal.  Compaction
  rewrites the WAL as pure ``enq`` events of the live frames — atomic
  (tmp + fsync + rename) and triggered once the acked/dead prefix
  dominates the live set.
- :class:`DeadLetterSpool` — the dead-letter queue: frames that exhausted
  ``max_attempts`` (or a local handler's retry budget) land in a per-topic
  JSONL spool with their payload, attempt count and reason.
  ``python -m distributed_crawler_tpu_torch.bus.dlq`` lists, inspects and
  replays them; a replay is marked with an ``rpl`` event, so an entry is
  re-driven at most deliberately.
- :class:`BusSpool` — the facade `GrpcBusServer(spool_dir=...)` holds:
  per-topic spools created on demand, plus the DLQ.

Frame ids (``fid``) are minted at enqueue and stay stable across broker
generations: a restarted broker redelivers the same frame under the same
id.  Topic names are encoded with ``urllib.parse.quote`` for directory
names, so replay recovers the exact topic string from the filesystem.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional
from urllib.parse import quote, unquote

logger = logging.getLogger("dct.torch.bus.spool")

WAL_FILE = "wal.jsonl"
TOPICS_DIR = "topics"
DLQ_DIR = "dlq"

FSYNC_EVERY = 16     # WAL lines between fsyncs (the OS-crash window)
COMPACT_EVERY = 256  # WAL events before a rewrite is considered


def _encode_topic(topic: str) -> str:
    return quote(topic, safe="-_.")


def _decode_topic(name: str) -> str:
    return unquote(name)


def new_frame_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class SpooledFrame:
    """One live (queued or in-flight-at-crash) frame recovered by replay."""

    fid: str
    payload: bytes
    attempts: int = 0


@dataclass
class DeadLetter:
    """One dead-lettered frame, folded from the DLQ spool."""

    fid: str
    topic: str
    payload: bytes
    attempts: int = 0
    reason: str = ""
    ts: float = 0.0
    replayed: bool = False

    def meta(self) -> Dict[str, Any]:
        """Payload-free summary (the /dlq listing row)."""
        return {"id": self.fid, "topic": self.topic,
                "attempts": self.attempts, "reason": self.reason,
                "ts": self.ts, "replayed": self.replayed,
                "bytes": len(self.payload)}


def _read_lines(path: str) -> List[str]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read().splitlines()
    except OSError:
        return []


def _fold_lines(path: str) -> List[Dict[str, Any]]:
    """Parse surviving JSONL events; a torn TAIL line is dropped (crash
    mid-append), a torn interior line is skipped with a warning."""
    lines = _read_lines(path)
    out: List[Dict[str, Any]] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                logger.warning("spool %s: dropping torn tail line", path)
            else:
                logger.warning("spool %s: skipping corrupt line %d",
                               path, i + 1)
    return out


class TopicSpool:
    """Append-only WAL + live-frame mirror for one pull topic."""

    def __init__(self, root: str, topic: str):
        self.topic = topic
        self.dir = os.path.join(root, TOPICS_DIR, _encode_topic(topic))
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False
        self._since_fsync = 0
        self._since_compact = 0
        # fid -> SpooledFrame; insertion order IS queue order (a requeue
        # moves the frame to the tail, matching the live queue).
        self._live: "OrderedDict[str, SpooledFrame]" = OrderedDict()
        os.makedirs(self.dir, exist_ok=True)
        self._load()

    @property
    def wal_path(self) -> str:
        return os.path.join(self.dir, WAL_FILE)

    # -- recovery -----------------------------------------------------------
    def _load(self) -> None:
        for ev in _fold_lines(self.wal_path):
            self._fold(ev)

    def _fold(self, ev: Dict[str, Any]) -> None:
        kind = ev.get("k")
        fid = str(ev.get("id", ""))
        if not fid:
            return
        if kind == "enq":
            try:
                payload = base64.b64decode(ev.get("d", ""))
            except (ValueError, TypeError):
                logger.warning("spool %s: undecodable enq payload (id=%s)",
                               self.topic, fid)
                return
            self._live[fid] = SpooledFrame(fid, payload,
                                           int(ev.get("a", 0) or 0))
        elif kind == "rq":
            frame = self._live.get(fid)
            if frame is not None:
                frame.attempts = int(ev.get("a", frame.attempts) or 0)
                self._live.move_to_end(fid)
        elif kind in ("ack", "dead"):
            self._live.pop(fid, None)
        # Unknown kinds ignored: spools must be forward-readable.

    def replay(self) -> List[SpooledFrame]:
        """The live frame set in queue order: a pure function of the
        on-disk bytes at construction plus the appends since."""
        with self._lock:
            return [SpooledFrame(f.fid, f.payload, f.attempts)
                    for f in self._live.values()]

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    # -- writing ------------------------------------------------------------
    def _append_locked(self, ev: Dict[str, Any]) -> None:
        if self._closed:
            raise RuntimeError(f"spool for {self.topic!r} is closed")
        if self._fh is None:
            # File I/O under the writer lock is the serialization point
            # (the caller holds _lock: the `_locked` suffix).
            self._fh = open(self.wal_path, "a",
                            encoding="utf-8")
        self._fh.write(json.dumps(ev) + "\n")
        self._fh.flush()
        self._since_fsync += 1
        if self._since_fsync >= FSYNC_EVERY:
            os.fsync(self._fh.fileno())
            self._since_fsync = 0
        self._since_compact += 1

    def enqueue(self, payload: bytes, attempts: int = 0,
                fid: Optional[str] = None) -> str:
        fid = fid or new_frame_id()
        ev = {"k": "enq", "id": fid,
              "d": base64.b64encode(payload).decode("ascii")}
        if attempts:
            ev["a"] = attempts
        with self._lock:
            self._append_locked(ev)
            self._live[fid] = SpooledFrame(fid, payload, attempts)
        return fid

    def requeue(self, fid: str, attempts: int) -> None:
        with self._lock:
            self._append_locked({"k": "rq", "id": fid, "a": attempts})
            frame = self._live.get(fid)
            if frame is not None:
                frame.attempts = attempts
                self._live.move_to_end(fid)

    def ack(self, fid: str) -> None:
        with self._lock:
            self._append_locked({"k": "ack", "id": fid})
            self._live.pop(fid, None)
            self._maybe_compact_locked()

    def remove_dead(self, fid: str) -> None:
        """Drop a frame that moved to the dead-letter spool (the DLQ
        append happens FIRST, so a crash between the two redelivers
        instead of losing the frame)."""
        with self._lock:
            self._append_locked({"k": "dead", "id": fid})
            self._live.pop(fid, None)
            self._maybe_compact_locked()

    # -- compaction ---------------------------------------------------------
    def _maybe_compact_locked(self) -> None:
        # Compact once the acked/dead prefix dominates: enough events
        # since the last rewrite AND at least half of them are now dead
        # weight (live*2 <= events means >= half the lines fold to
        # nothing on replay).
        if self._since_compact >= COMPACT_EVERY \
                and len(self._live) * 2 <= self._since_compact:
            self._compact_locked()

    def compact(self) -> None:
        """Force a WAL rewrite down to the live frames (shutdown)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self.wal_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for frame in self._live.values():
                ev = {"k": "enq", "id": frame.fid,
                      "d": base64.b64encode(frame.payload).decode("ascii")}
                if frame.attempts:
                    ev["a"] = frame.attempts
                f.write(json.dumps(ev) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        # The rename IS the commit point: a crash before it replays the
        # old WAL, a crash after it replays the rewritten one — both fold
        # to the same live set.
        os.replace(tmp, self.wal_path)
        self._since_compact = 0
        self._since_fsync = 0

    def close(self, compact: bool = False) -> None:
        with self._lock:
            if compact and not self._closed:
                self._compact_locked()
            if self._fh is not None:
                try:
                    if self._since_fsync:
                        os.fsync(self._fh.fileno())
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            self._closed = True


class DeadLetterSpool:
    """Per-topic persisted dead letters + replay markers.

    Replayed entries are audit history, not queue content: once their
    count passes ``replayed_retention`` the file is compacted — pending
    entries all survive, only the newest ``replayed_retention`` replayed
    ones are kept — so a broker that lives through many poison bursts
    and replays doesn't grow (or re-parse) an unbounded file forever.

    ``replayed_retention=None`` disables compaction entirely: the
    rewrite-and-rename is only safe for the instance that OWNS the spool
    (the broker) — a second process compacting concurrently (e.g.
    the DLQ tool against a live broker's directory) could erase a
    dead letter appended between its fold and its rename, so the tool
    runs with compaction off (``bus/dlq.py``)."""

    def __init__(self, root: str,
                 replayed_retention: Optional[int] = 256):
        self.dir = os.path.join(root, DLQ_DIR)
        self.replayed_retention = replayed_retention if \
            replayed_retention is None else max(0, replayed_retention)
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, topic: str) -> str:
        return os.path.join(self.dir, _encode_topic(topic) + ".jsonl")

    def topics(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(_decode_topic(n[:-6]) for n in names
                      if n.endswith(".jsonl"))

    def append(self, topic: str, fid: str, payload: bytes,
               attempts: int, reason: str) -> None:
        ev = {"k": "dead", "id": fid, "ts": time.time(),
              "a": attempts, "r": reason,
              "d": base64.b64encode(payload).decode("ascii")}
        with self._lock:
            with open(self._path(topic), "a",
                      encoding="utf-8") as f:
                f.write(json.dumps(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def mark_replayed(self, topic: str, fid: str) -> None:
        ev = {"k": "rpl", "id": fid, "ts": time.time()}
        with self._lock:
            with open(self._path(topic), "a",
                      encoding="utf-8") as f:
                f.write(json.dumps(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())
        self._maybe_compact(topic)

    def _maybe_compact(self, topic: str) -> None:
        if self.replayed_retention is None:
            return  # not the owning instance; never rewrite (see class doc)
        # Fold AND rewrite under one lock hold: an append landing between
        # the read and the rename would otherwise be silently dropped.
        with self._lock:
            entries = self.entries(topic)
            replayed = [e for e in entries if e.replayed]
            if len(replayed) <= self.replayed_retention:
                return
            drop = {e.fid for e in replayed[:len(replayed)
                                            - self.replayed_retention]}
            path = self._path(topic)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for e in entries:
                    if e.fid in drop:
                        continue
                    f.write(json.dumps({
                        "k": "dead", "id": e.fid, "ts": e.ts,
                        "a": e.attempts, "r": e.reason,
                        "d": base64.b64encode(e.payload).decode("ascii")})
                        + "\n")
                    if e.replayed:
                        f.write(json.dumps({"k": "rpl", "id": e.fid,
                                            "ts": e.ts}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)

    def entries(self, topic: str) -> List[DeadLetter]:
        """Folded dead letters for one topic, oldest first."""
        out: "OrderedDict[str, DeadLetter]" = OrderedDict()
        for ev in _fold_lines(self._path(topic)):
            fid = str(ev.get("id", ""))
            if not fid:
                continue
            if ev.get("k") == "dead":
                try:
                    payload = base64.b64decode(ev.get("d", ""))
                except (ValueError, TypeError):
                    logger.warning("dlq %s: undecodable payload (id=%s)",
                                   topic, fid)
                    continue
                out[fid] = DeadLetter(
                    fid=fid, topic=topic, payload=payload,
                    attempts=int(ev.get("a", 0) or 0),
                    reason=str(ev.get("r", "") or ""),
                    ts=float(ev.get("ts", 0.0) or 0.0))
            elif ev.get("k") == "rpl" and fid in out:
                out[fid].replayed = True
        return list(out.values())

    def get(self, topic: str, fid: str) -> Optional[DeadLetter]:
        for entry in self.entries(topic):
            if entry.fid == fid:
                return entry
        return None

    def snapshot(self, topic: Optional[str] = None,
                 fid: Optional[str] = None,
                 max_entries: int = 50) -> Dict[str, Any]:
        """The /dlq body: per-topic counts + newest entry metadata; with
        ``fid`` set, that entry's full payload (base64) rides along."""
        topics = [topic] if topic else self.topics()
        body: Dict[str, Any] = {"topics": {}}
        for t in topics:
            entries = self.entries(t)
            body["topics"][t] = {
                "count": len(entries),
                "pending": sum(1 for e in entries if not e.replayed),
                "entries": [e.meta() for e in entries[-max_entries:]],
            }
            if fid:
                hit = next((e for e in entries if e.fid == fid), None)
                if hit is not None:
                    body["entry"] = {
                        **hit.meta(),
                        "payload_b64":
                            base64.b64encode(hit.payload).decode("ascii"),
                    }
        return body


class BusSpool:
    """Everything durable about one broker: per-topic WALs + the DLQ."""

    def __init__(self, root: str):
        if not root:
            raise ValueError("spool root cannot be empty")
        self.root = root
        self._lock = threading.Lock()
        self._topics: Dict[str, TopicSpool] = {}
        self._closed = False
        os.makedirs(os.path.join(root, TOPICS_DIR), exist_ok=True)
        self.dlq = DeadLetterSpool(root)

    def existing_topics(self) -> List[str]:
        """Topics with an on-disk WAL — what a restarted broker rebuilds."""
        try:
            names = os.listdir(os.path.join(self.root, TOPICS_DIR))
        except OSError:
            return []
        return sorted(_decode_topic(n) for n in names
                      if os.path.exists(os.path.join(
                          self.root, TOPICS_DIR, n, WAL_FILE)))

    def topic(self, topic: str) -> TopicSpool:
        with self._lock:
            if self._closed:
                # A closed BusSpool must refuse even first-enqueue topics:
                # minting a fresh open TopicSpool here would let a publish
                # racing a broker kill() journal a frame into a WAL the
                # next generation has already read — acked but delivered
                # by no live generation.
                raise RuntimeError("bus spool is closed")
            ts = self._topics.get(topic)
            if ts is None:
                ts = TopicSpool(self.root, topic)
                self._topics[topic] = ts
            return ts

    # -- the broker-facing protocol -----------------------------------------
    def enqueue(self, topic: str, payload: bytes,
                attempts: int = 0) -> str:
        return self.topic(topic).enqueue(payload, attempts=attempts)

    def requeue(self, topic: str, fid: str, attempts: int) -> None:
        if fid:
            self.topic(topic).requeue(fid, attempts)

    def ack(self, topic: str, fid: str) -> None:
        if fid:
            self.topic(topic).ack(fid)

    def dead(self, topic: str, fid: str, payload: bytes,
             attempts: int, reason: str) -> str:
        """Move a frame to the DLQ (durably FIRST, then drop it from the
        topic WAL — a crash between the two duplicates a dead letter,
        never loses one).  An empty ``fid`` means the frame was never in
        a topic WAL (a local-handler dead letter on a fan-out topic): it
        gets a minted id for the DLQ entry, and the topic WAL is left
        untouched — writing there would conjure a phantom pull topic
        that a restarted broker rebuilds and nobody ever drains."""
        journaled = fid
        fid = fid or new_frame_id()
        self.dlq.append(topic, fid, payload, attempts, reason)
        if journaled:
            self.topic(topic).remove_dead(journaled)
        return fid

    def replay(self, topic: str) -> List[SpooledFrame]:
        return self.topic(topic).replay()

    def close(self, compact: bool = True) -> None:
        with self._lock:
            self._closed = True
            topics = list(self._topics.values())
        for ts in topics:
            ts.close(compact=compact)

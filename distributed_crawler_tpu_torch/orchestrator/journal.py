"""Crash-consistent crawl journal: the orchestrator's durable memory.

The port's copy of the reference's `distributed_crawler_tpu/orchestrator/
journal.py`, byte-compatible with it: either package resumes the other's
journal.  The orchestrator keeps its coordination state (`active_work`,
retry counts, current depth, applied-result ids) in memory and the page
state in ``state.json``; this write-ahead record makes
`Orchestrator.start()` resumable after the process dies:

- **append** — one JSON line per coordination event (``dispatch``,
  ``result``, ``requeue``, ``reassign``, ``abandon``, ``depth``,
  ``layer``, ``completed``), flushed per event.
- **snapshot/compact** — an atomic (tmp + rename) full-state snapshot;
  the event log is truncated after a successful snapshot, bounding
  replay work.  The orchestrator saves the state manager *before*
  snapshotting so truncation never orphans page-status fixups.
- **replay** — snapshot + surviving events folded into a
  :class:`RecoveredCrawl`.  A torn final line (the crash happened
  mid-append) is skipped, not fatal.

Files live under ``journal_dir`` (``--journal-dir``, by default
``<dump-dir>/orch-journal/<crawl-id>`` or
``<storage_root>/<crawl_id>/orch-journal``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

logger = logging.getLogger("dct.orchestrator.journal")

JOURNAL_FILE = "journal.jsonl"
SNAPSHOT_FILE = "snapshot.json"

COMPACT_EVERY = 256  # events between snapshots


@dataclass
class RecoveredCrawl:
    """Everything `Orchestrator._resume` needs, folded from snapshot +
    events."""

    crawl_id: str = ""
    current_depth: int = 0
    total_work_items: int = 0
    completed_items: int = 0
    error_items: int = 0
    discovered_pages: int = 0
    crawl_completed: bool = False
    # work-item id -> serialized WorkItem (dispatched, no result yet)
    active_work: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # page id -> retry count (non-terminal pages only)
    retry_counts: Dict[str, int] = field(default_factory=dict)
    # work-item ids whose results were already applied (idempotence set)
    applied_results: set = field(default_factory=set)
    # page id -> (status, error): the page's journaled terminal/interim
    # state, replayed over the (possibly stale) persisted state manager
    page_fixups: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # [(depth, [page dicts])] discovered layers, in journal order
    layers: List[Tuple[int, List[Dict[str, Any]]]] = \
        field(default_factory=list)
    events_replayed: int = 0

    def to_debug_dict(self) -> Dict[str, Any]:
        return {
            "crawl_id": self.crawl_id,
            "current_depth": self.current_depth,
            "active_work": sorted(self.active_work),
            "applied_results": len(self.applied_results),
            "retry_counts": dict(self.retry_counts),
            "layers": [(d, len(p)) for d, p in self.layers],
            "crawl_completed": self.crawl_completed,
            "events_replayed": self.events_replayed,
        }


class CrawlJournal:
    """Append-only event log + atomic snapshot under one directory."""

    def __init__(self, journal_dir: str):
        if not journal_dir:
            raise ValueError("journal_dir cannot be empty")
        self.journal_dir = journal_dir
        self._lock = threading.Lock()
        self._fh = None
        self._since_snapshot = 0
        os.makedirs(journal_dir, exist_ok=True)

    # -- paths --------------------------------------------------------------
    @property
    def journal_path(self) -> str:
        return os.path.join(self.journal_dir, JOURNAL_FILE)

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.journal_dir, SNAPSHOT_FILE)

    # -- lifecycle ----------------------------------------------------------
    def exists(self) -> bool:
        """True if there is anything to resume from."""
        if os.path.exists(self.snapshot_path):
            return True
        try:
            return os.path.getsize(self.journal_path) > 0
        except OSError:
            return False

    def reset(self) -> None:
        """Discard snapshot + events (``--fresh``)."""
        with self._lock:
            self._close_locked()
            for path in (self.journal_path, self.snapshot_path):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._since_snapshot = 0

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        # Caller holds _lock (the `_locked` suffix contract).
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    # -- writing ------------------------------------------------------------
    def append(self, kind: str, **fields: Any) -> None:
        """Write one event; flushed before returning so the record
        survives a process kill (not an OS crash: appends are not
        fsynced, as the reference's default)."""
        event = {"ts": time.time(), "kind": kind, **fields}
        line = json.dumps(event, default=str)
        with self._lock:
            if self._fh is None:
                # WAL semantics: file I/O under the writer lock IS the
                # serialization point.
                self._fh = open(self.journal_path, "a",
                                encoding="utf-8")
            self._fh.write(line + "\n")
            self._fh.flush()
            self._since_snapshot += 1

    def should_compact(self) -> bool:
        with self._lock:
            return self._since_snapshot >= COMPACT_EVERY

    def snapshot(self, state: Dict[str, Any]) -> None:
        """Atomically replace the snapshot and truncate the event log.
        Callers must have made any co-durable state (the state manager's
        ``save_state``) durable FIRST — after truncation the events that
        described it are gone."""
        tmp = self.snapshot_path + ".tmp"
        payload = {"ts": time.time(), "state": state}
        with self._lock:
            # Snapshot + truncation must be atomic w.r.t. appends: the
            # lock-held I/O is the crash-consistency mechanism.
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            self._close_locked()
            # Truncate AFTER the snapshot is durable.
            open(self.journal_path, "w",
                 encoding="utf-8").close()
            self._since_snapshot = 0

    # -- reading ------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Surviving events in append order; a torn tail line is dropped
        (crash mid-append), a torn *interior* line is skipped with a
        warning (should not happen with line-buffered appends)."""
        try:
            with open(self.journal_path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            return []
        out: List[Dict[str, Any]] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                if i == len(lines) - 1:
                    logger.warning("journal: dropping torn tail line")
                else:
                    logger.warning("journal: skipping corrupt line %d", i + 1)
        return out

    def load_snapshot(self) -> Dict[str, Any]:
        try:
            with open(self.snapshot_path, "r", encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return {}
        state = payload.get("state")
        return state if isinstance(state, dict) else {}

    def recorded_crawl_id(self) -> str:
        """The crawl this journal belongs to (snapshot, else the ``begin``
        event) — the identity check that keeps a shared journal dir from
        silently resuming an unrelated crawl."""
        snap = self.load_snapshot()
        if snap.get("crawl_id"):
            return str(snap["crawl_id"])
        for event in self.events():
            if event.get("kind") == "begin" and event.get("crawl_id"):
                return str(event["crawl_id"])
        return ""

    def replay(self) -> RecoveredCrawl:
        """Fold snapshot + events into a :class:`RecoveredCrawl`.

        Pure function of the on-disk bytes: calling it twice returns the
        same recovery (asserted by tests — determinism is what makes the
        resume path debuggable)."""
        rec = RecoveredCrawl()
        snap = self.load_snapshot()
        if snap:
            rec.crawl_id = snap.get("crawl_id", "")
            rec.current_depth = int(snap.get("current_depth", 0))
            rec.total_work_items = int(snap.get("total_work_items", 0))
            rec.completed_items = int(snap.get("completed_items", 0))
            rec.error_items = int(snap.get("error_items", 0))
            rec.discovered_pages = int(snap.get("discovered_pages", 0))
            rec.crawl_completed = bool(snap.get("crawl_completed", False))
            rec.active_work = {str(k): dict(v) for k, v in
                               (snap.get("active_work") or {}).items()}
            rec.retry_counts = {str(k): int(v) for k, v in
                                (snap.get("retry_counts") or {}).items()}
            rec.applied_results = set(snap.get("applied_results") or [])
            # NOTE: snapshots deliberately carry no page fixups — the
            # compaction protocol saves the state manager FIRST, so page
            # statuses as of the snapshot live in the persisted sm state;
            # fixups come only from post-snapshot events.
        for event in self.events():
            self._fold(rec, event)
            rec.events_replayed += 1
        return rec

    @staticmethod
    def _fold(rec: RecoveredCrawl, event: Dict[str, Any]) -> None:
        # Folding is IDEMPOTENT per work-item id: a journal event may
        # describe state a concurrent compaction already baked into the
        # snapshot (the append can land just after truncation), so an
        # event whose item is already accounted for must be a no-op —
        # otherwise counters double-fold on replay.
        kind = event.get("kind")
        if kind == "begin":
            rec.crawl_id = event.get("crawl_id", rec.crawl_id)
        elif kind == "dispatch":
            item = event.get("item") or {}
            wid = str(item.get("id", ""))
            if wid and wid not in rec.active_work \
                    and wid not in rec.applied_results:
                rec.active_work[wid] = item
                rec.total_work_items += 1
        elif kind in ("requeue", "reassign"):
            rec.active_work.pop(str(event.get("old_id", "")), None)
            item = event.get("item") or {}
            wid = str(item.get("id", ""))
            if wid and wid not in rec.applied_results:
                rec.active_work[wid] = item
            page_id = event.get("page_id", "")
            if page_id and event.get("retries") is not None:
                rec.retry_counts[page_id] = int(event["retries"])
        elif kind == "result":
            wid = str(event.get("work_item_id", ""))
            if not wid:
                return
            already = wid in rec.applied_results
            rec.active_work.pop(wid, None)
            rec.applied_results.add(wid)
            if not already:
                # Counters fold once per id; the PAGE fixup below folds
                # unconditionally — it is idempotent (absolute status),
                # and a snapshot racing the result apply may have
                # persisted the page pre-transition while already
                # counting the id as applied.
                if event.get("status") == "success":
                    rec.completed_items += 1
                else:
                    rec.error_items += 1
                rec.discovered_pages += int(event.get("discovered", 0) or 0)
            page_id = event.get("page_id", "")
            if page_id:
                page_status = event.get("page_status", "")
                if page_status:
                    rec.page_fixups[page_id] = (page_status,
                                                event.get("error", "") or "")
                retries = event.get("retries")
                if retries:
                    rec.retry_counts[page_id] = int(retries)
                else:
                    rec.retry_counts.pop(page_id, None)
        elif kind == "abandon":
            wid = str(event.get("work_item_id", ""))
            if not wid:
                return
            already = wid in rec.applied_results
            rec.active_work.pop(wid, None)
            rec.applied_results.add(wid)
            if not already:
                rec.error_items += 1
            page_id = event.get("page_id", "")
            if page_id:
                rec.page_fixups[page_id] = (
                    event.get("page_status", "abandoned"),
                    event.get("error", "") or "")
                rec.retry_counts.pop(page_id, None)
        elif kind == "depth":
            rec.current_depth = int(event.get("depth", rec.current_depth))
        elif kind == "layer":
            pages = event.get("pages") or []
            rec.layers.append((int(event.get("depth", 0)), list(pages)))
        elif kind == "completed":
            rec.crawl_completed = True
        # Unknown kinds are ignored: journals must be forward-readable.

"""`RecordBatch`: the unit of work between the crawl side and the worker,
and `BatchAccumulator`, which groups stored posts into batches.

The dict form is the reference's (`distributed_crawler_tpu/bus/codec.py:
174-238`), so a batch published by either package decodes in the other.
Records are plain post dicts (`Post.to_dict`); `texts()` reads each
record's inference text by `Post.text_for_inference`'s rule, without
building a `Post`.  The
reference's length-prefixed compressed frame codec is not ported: no port
caller frames a batch (the buses carry dicts).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from ..datamodel.post import (
    Post,
    format_time,
    parse_time,
    text_for_inference,
)
from .messages import DEFAULT_TENANT, new_trace_id, normalize_tenant


def new_id() -> str:
    return str(uuid.uuid4())


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


@dataclass
class RecordBatch:
    """A batch of post records bound for (or back from) the worker;
    ``results`` carries one output dict per record on the return path."""

    batch_id: str = ""
    crawl_id: str = ""
    source_topic: str = ""
    created_at: Optional[datetime] = None
    trace_id: str = ""
    tenant: str = DEFAULT_TENANT
    records: List[Dict[str, Any]] = field(default_factory=list)
    results: List[Dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_records(cls, records: List[Dict[str, Any]], crawl_id: str = "",
                     trace_id: str = "",
                     tenant: str = DEFAULT_TENANT) -> "RecordBatch":
        """A new batch with an id, a birth time and a trace id."""
        return cls(batch_id=new_id(), crawl_id=crawl_id, created_at=utcnow(),
                   trace_id=trace_id or new_trace_id(),
                   tenant=normalize_tenant(tenant), records=list(records))

    @classmethod
    def from_posts(cls, posts: List[Post], crawl_id: str = "",
                   trace_id: str = "",
                   tenant: str = DEFAULT_TENANT) -> "RecordBatch":
        """A new batch of ``posts``' dicts."""
        return cls.from_records([p.to_dict() for p in posts],
                                crawl_id=crawl_id, trace_id=trace_id,
                                tenant=tenant)

    def texts(self) -> List[str]:
        return [text_for_inference(r) for r in self.records]

    def __len__(self) -> int:
        return len(self.records)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "batch_id": self.batch_id,
            "crawl_id": self.crawl_id,
            "source_topic": self.source_topic,
            "created_at": format_time(self.created_at),
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "records": self.records,
            "results": self.results,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RecordBatch":
        return cls(
            batch_id=d.get("batch_id", "") or "",
            crawl_id=d.get("crawl_id", "") or "",
            source_topic=d.get("source_topic", "") or "",
            created_at=parse_time(d.get("created_at")),
            trace_id=d.get("trace_id", "") or "",
            tenant=normalize_tenant(d.get("tenant")),
            records=list(d.get("records") or []),
            results=list(d.get("results") or []),
        )


class BatchAccumulator:
    """Posts into RecordBatches of ``batch_size``, or fewer once
    ``deadline_s`` has passed since the first queued post (reference
    `bus/codec.py:296-340`).  ``now`` is the caller's monotonic clock."""

    def __init__(self, batch_size: int, deadline_s: float,
                 crawl_id: str = ""):
        self.batch_size = batch_size
        self.deadline_s = deadline_s
        self.crawl_id = crawl_id
        self._pending: List[Post] = []
        self._first_at: Optional[float] = None

    def add(self, post: Post, now: float) -> Optional[RecordBatch]:
        """Queue a post; returns a full batch if one is ready."""
        if self._first_at is None:
            self._first_at = now
        self._pending.append(post)
        if len(self._pending) >= self.batch_size:
            return self._emit()
        return None

    def poll(self, now: float) -> Optional[RecordBatch]:
        """A partial batch once the deadline has passed, else None."""
        if self._pending and self._first_at is not None \
                and now - self._first_at >= self.deadline_s:
            return self._emit()
        return None

    def flush(self) -> Optional[RecordBatch]:
        return self._emit() if self._pending else None

    def _emit(self) -> RecordBatch:
        batch = RecordBatch.from_posts(self._pending, crawl_id=self.crawl_id)
        self._pending = []
        self._first_at = None
        return batch

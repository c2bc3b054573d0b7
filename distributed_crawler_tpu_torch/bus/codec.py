"""`RecordBatch`: the unit of work between the crawl side and the worker.

The dict form is the reference's (`distributed_crawler_tpu/bus/codec.py:
174-238`), so a batch published by either package decodes in the other.
Records are plain post dicts; `texts()` reads each record's inference text
the way `Post.text_for_inference` does, without a `Post` class.  The
length-prefixed compressed frame codec waits for a later slice.
"""

from __future__ import annotations

import re
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from .messages import DEFAULT_TENANT, new_trace_id, normalize_tenant

# Go's time.Time zero value, used on the wire for "unset".
ZERO_TIME_STR = "0001-01-01T00:00:00Z"


def new_id() -> str:
    return str(uuid.uuid4())


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


def format_time(dt: Optional[datetime]) -> str:
    """RFC3339/UTC; None -> Go zero time."""
    if dt is None:
        return ZERO_TIME_STR
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


def parse_time(value: Any) -> Optional[datetime]:
    """Parse an RFC3339 string (or pass a datetime through); zero -> None."""
    if value is None or isinstance(value, datetime):
        return value
    s = str(value)
    if not s or s == ZERO_TIME_STR:
        return None
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        dt = datetime.fromisoformat(s)
    except ValueError:
        # More than 6 fractional digits: truncate to microseconds.
        m = re.match(r"^(.*?\.)(\d+)([+-]\d{2}:\d{2})$", s)
        if not m:
            return None
        dt = datetime.fromisoformat(m.group(1) + m.group(2)[:6] + m.group(3))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


def text_for_inference(record: Dict[str, Any]) -> str:
    """The text a post record contributes to embed+classify,
    best-field-first (`Post.text_for_inference` on the record dict)."""
    for key in ("all_text", "searchable_text", "description"):
        t = record.get(key) or ""
        if t:
            return t
    return record.get("transcript_text") or record.get("image_text") or ""


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

"""The crawl's page state: pages, layers, crawl metadata.

The part of the reference's `distributed_crawler_tpu/state/datamodels.py`
that the orchestrator's page state serializes.  ``to_dict``/``from_dict``
give the reference's JSON keys, so ``state.json`` and ``metadata.json``
are byte-equal between the packages and each resumes the other's.  The
random-walk graph's records (edges, pending edges, discovered channels)
and the media-cache records belong to the SQL graph store, which is not
ported.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from ..datamodel.post import format_time, parse_time

# Page status machine (state/datamodels.go:46, §5.4 of SURVEY.md):
# unfetched -> processing -> fetched | error | deadend | abandoned.
# "error" is non-terminal (the orchestrator retries it up to its budget);
# "abandoned" is the terminal form — permanent failure or an exhausted
# retry budget — and carries no live retry-counter entry, which is what
# keeps the orchestrator's per-page retry map bounded.
PAGE_UNFETCHED = "unfetched"
PAGE_PROCESSING = "processing"
PAGE_FETCHED = "fetched"
PAGE_ERROR = "error"
PAGE_DEADEND = "deadend"
PAGE_ABANDONED = "abandoned"

def new_id() -> str:
    return str(uuid.uuid4())


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


@dataclass
class Message:
    """A message associated with a page (`state/datamodels.go:65-71`)."""

    chat_id: int = 0
    message_id: int = 0
    status: str = ""
    page_id: str = ""
    platform: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "chatId": self.chat_id,
            "messageId": self.message_id,
            "status": self.status,
            "pageId": self.page_id,
            "platform": self.platform,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Message":
        return cls(
            chat_id=int(d.get("chatId") or 0),
            message_id=int(d.get("messageId") or 0),
            status=d.get("status", "") or "",
            page_id=d.get("pageId", "") or "",
            platform=d.get("platform", "") or "",
        )


@dataclass
class Page:
    """A URL/page being crawled (`state/datamodels.go:41-62`)."""

    id: str = ""
    url: str = ""
    depth: int = 0
    status: str = PAGE_UNFETCHED
    error: str = ""
    timestamp: Optional[datetime] = None
    platform: str = ""
    parent_id: str = ""
    messages: List[Message] = field(default_factory=list)
    connection_id: str = ""
    # UUID propagated through a forward chain; new UUID on walkback.
    sequence_id: str = ""
    # Overrides the state manager's own crawl_id when writing to page_buffer
    # (set by the validator when processing a batch from another crawl).
    crawl_id: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "url": self.url,
            "depth": self.depth,
            "status": self.status,
            "error": self.error,
            "timestamp": format_time(self.timestamp),
            "platform": self.platform,
            "parentId": self.parent_id,
            "messages": [m.to_dict() for m in self.messages],
            "LastConnectionID": self.connection_id,
            "sequenceId": self.sequence_id,
            "crawlId": self.crawl_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Page":
        return cls(
            id=d.get("id", "") or "",
            url=d.get("url", "") or "",
            depth=int(d.get("depth") or 0),
            status=d.get("status", PAGE_UNFETCHED) or PAGE_UNFETCHED,
            error=d.get("error", "") or "",
            timestamp=parse_time(d.get("timestamp")),
            platform=d.get("platform", "") or "",
            parent_id=d.get("parentId", "") or "",
            messages=[Message.from_dict(m) for m in (d.get("messages") or [])],
            connection_id=d.get("LastConnectionID", "") or "",
            sequence_id=d.get("sequenceId", "") or "",
            crawl_id=d.get("crawlId", "") or "",
        )


@dataclass
class Layer:
    """Pages at the same depth (`state/datamodels.go:165-169`)."""

    depth: int = 0
    pages: List[Page] = field(default_factory=list)


@dataclass
class CrawlMetadata:
    """Metadata about a crawl operation (`state/datamodels.go:172-183`)."""

    crawl_id: str = ""
    execution_id: str = ""
    start_time: Optional[datetime] = None
    end_time: Optional[datetime] = None
    status: str = "running"  # running | completed | failed
    previous_crawl_id: List[str] = field(default_factory=list)
    platform: str = ""
    target_channels: List[str] = field(default_factory=list)
    messages_count: int = 0
    errors_count: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "crawlId": self.crawl_id,
            "executionId": self.execution_id,
            "startTime": format_time(self.start_time),
            "endTime": format_time(self.end_time),
            "status": self.status,
            "previousCrawlId": self.previous_crawl_id,
            "platform": self.platform,
            "targetChannels": self.target_channels,
            "messagesCount": self.messages_count,
            "errorsCount": self.errors_count,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CrawlMetadata":
        return cls(
            crawl_id=d.get("crawlId", "") or "",
            execution_id=d.get("executionId", "") or "",
            start_time=parse_time(d.get("startTime")),
            end_time=parse_time(d.get("endTime")),
            status=d.get("status", "running") or "running",
            previous_crawl_id=list(d.get("previousCrawlId") or []),
            platform=d.get("platform", "") or "",
            target_channels=list(d.get("targetChannels") or []),
            messages_count=int(d.get("messagesCount") or 0),
            errors_count=int(d.get("errorsCount") or 0),
        )


@dataclass
class State:
    """Complete crawl state snapshot (`state/datamodels.go:210-214`)."""

    layers: List[Layer] = field(default_factory=list)
    metadata: CrawlMetadata = field(default_factory=CrawlMetadata)
    last_updated: Optional[datetime] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "layers": [
                {"depth": l.depth, "pages": [p.to_dict() for p in l.pages]}
                for l in self.layers
            ],
            "metadata": self.metadata.to_dict(),
            "lastUpdated": format_time(self.last_updated),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "State":
        return cls(
            layers=[
                Layer(depth=int(l.get("depth") or 0),
                      pages=[Page.from_dict(p) for p in (l.get("pages") or [])])
                for l in (d.get("layers") or [])
            ],
            metadata=CrawlMetadata.from_dict(d.get("metadata") or {}),
            last_updated=parse_time(d.get("lastUpdated")),
        )

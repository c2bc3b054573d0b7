"""Bus constants and the envelopes of the port's services — media,
cluster, worker status, span export, the crawl's work items and results,
and watchtower alerts — copied from the reference's
`distributed_crawler_tpu/bus/messages.py`.  The message types, topic
strings and dict field names are a wire contract and must stay identical:
a frame published by either package decodes in the other, so a port
worker's heartbeat reaches the reference's fleet view and its span batches
the reference's trace collector."""

from __future__ import annotations

import secrets
import string
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from ..datamodel.post import format_time, parse_time

# `utcnow` lives in `codec`, which imports this module: bind the module here
# and read the function at call time.
from . import codec

MSG_HEARTBEAT = "heartbeat"
MSG_WORKER_STARTED = "worker_started"
MSG_WORKER_STOPPING = "worker_stopping"
MSG_AUDIO_BATCH = "audio_batch"
MSG_TRANSCRIPT = "transcript"
# A bounded batch of finished spans one worker ships for cross-process
# trace assembly.
MSG_SPAN_BATCH = "span_batch"
# The cluster worker's periodic centroid-state announcement.
MSG_CLUSTER_UPDATE = "cluster_update"

WORKER_ACTIVE = "active"
WORKER_IDLE = "idle"
WORKER_BUSY = "busy"
WORKER_ERROR = "error"
WORKER_OFFLINE = "offline"

TOPIC_WORKER_STATUS = "worker-status"
# The crawler's work queue and scheduled-job commands: the orchestrator
# publishes work items, and a broker the port hosts queues them for the
# crawl workers, as the reference's broker does.
TOPIC_WORK_QUEUE = "crawl-work-queue"
TOPIC_JOBS = "job-commands"
TOPIC_INFERENCE_BATCHES = "tpu-inference-batches"
TOPIC_INFERENCE_RESULTS = "tpu-inference-results"
# Audio refs bound for the ASR worker, and the transcripts it sends back.
TOPIC_MEDIA_BATCHES = "tpu-media-batches"
TOPIC_TRANSCRIPTS = "tpu-transcripts"
# Cluster summaries after each checkpoint (fan-out; a missed update costs
# the frontier's prioritisation freshness only).
TOPIC_CLUSTERS = "tpu-clusters"
# Span batches (fan-out like worker-status; a missed batch costs one
# trace's completeness, never correctness).
TOPIC_SPANS = "tpu-spans"
# The crawler's and the orchestrator's fan-out topics: the partitioned
# bus broadcasts them as the reference's does (`bus/partition.py`).
TOPIC_RESULTS = "crawl-results"
TOPIC_ORCHESTRATOR = "orchestrator-commands"
TOPIC_CHAOS = "chaos-commands"
TOPIC_ALERTS = "tpu-alerts"

# Frames without a tenant label decode to this documented default.
DEFAULT_TENANT = "default"


def normalize_tenant(value: Any) -> str:
    """Fold falsy / non-string tenant values to ``DEFAULT_TENANT``."""
    if not isinstance(value, str) or not value.strip():
        return DEFAULT_TENANT
    return value.strip()


_ALPHANUM = string.ascii_letters + string.digits


def new_trace_id() -> str:
    """``trace_<UTC yyyymmddHHMMSS>_<8 alphanumerics>``."""
    stamp = datetime.now(timezone.utc).strftime("%Y%m%d%H%M%S")
    return "trace_" + stamp + "_" + "".join(
        secrets.choice(_ALPHANUM) for _ in range(8))


def _opt_time(value: Optional[datetime]) -> Optional[str]:
    return format_time(value) if value is not None else None


# -- media / ASR serving -----------------------------------------------------
@dataclass
class AudioRef:
    """One crawled media file bound for transcription: ``media_id`` is the
    platform's stable media id, ``path`` the decoded audio (a PCM wav)."""

    media_id: str = ""
    path: str = ""
    channel_name: str = ""
    post_uid: str = ""          # originating post, when known
    duration_s: float = 0.0     # 0 = unknown (the chunker measures)

    def validate(self) -> None:
        if not self.media_id:
            raise ValueError("audio ref media_id cannot be empty")
        if not self.path:
            raise ValueError("audio ref path cannot be empty")

    def to_dict(self) -> Dict[str, Any]:
        return {"media_id": self.media_id, "path": self.path,
                "channel_name": self.channel_name,
                "post_uid": self.post_uid,
                "duration_s": self.duration_s}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AudioRef":
        return cls(
            media_id=d.get("media_id", "") or "",
            path=d.get("path", "") or "",
            channel_name=d.get("channel_name", "") or "",
            post_uid=d.get("post_uid", "") or "",
            duration_s=float(d.get("duration_s") or 0.0),
        )


@dataclass
class AudioBatchMessage:
    """A batch of audio refs on ``TOPIC_MEDIA_BATCHES``, minted with a
    trace id at birth."""

    message_type: str = MSG_AUDIO_BATCH
    batch_id: str = ""
    crawl_id: str = ""
    refs: List[AudioRef] = field(default_factory=list)
    created_at: Optional[datetime] = None
    trace_id: str = ""
    tenant: str = DEFAULT_TENANT

    @classmethod
    def new(cls, refs: List[AudioRef], crawl_id: str = "",
            trace_id: str = "",
            tenant: str = DEFAULT_TENANT) -> "AudioBatchMessage":
        return cls(batch_id=codec.new_id(), crawl_id=crawl_id,
                   refs=list(refs), created_at=codec.utcnow(),
                   trace_id=trace_id or new_trace_id(),
                   tenant=normalize_tenant(tenant))

    def validate(self) -> None:
        if self.message_type != MSG_AUDIO_BATCH:
            raise ValueError(
                f"invalid audio batch message type: {self.message_type}")
        if not self.batch_id:
            raise ValueError("audio batch ID cannot be empty")
        if not self.refs:
            raise ValueError("audio batch carries no refs")
        for ref in self.refs:
            ref.validate()

    def __len__(self) -> int:
        return len(self.refs)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "batch_id": self.batch_id,
            "crawl_id": self.crawl_id,
            "refs": [r.to_dict() for r in self.refs],
            "created_at": _opt_time(self.created_at),
            "trace_id": self.trace_id,
            "tenant": self.tenant,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AudioBatchMessage":
        return cls(
            message_type=d.get("message_type", MSG_AUDIO_BATCH),
            batch_id=d.get("batch_id", "") or "",
            crawl_id=d.get("crawl_id", "") or "",
            refs=[AudioRef.from_dict(r) for r in (d.get("refs") or [])
                  if isinstance(r, dict)],
            created_at=parse_time(d.get("created_at")),
            trace_id=d.get("trace_id", "") or "",
            tenant=normalize_tenant(d.get("tenant")),
        )


@dataclass
class TranscriptMessage:
    """One media file's transcript on ``TOPIC_TRANSCRIPTS``.  ``post_uid``
    is ``media:<media_id>``, so a redelivery dedupes downstream; ``error``
    is non-empty for a file that failed to decode."""

    message_type: str = MSG_TRANSCRIPT
    media_id: str = ""
    post_uid: str = ""
    path: str = ""
    channel_name: str = ""
    crawl_id: str = ""
    batch_id: str = ""          # the AudioBatchMessage that carried it
    worker_id: str = ""
    text: str = ""
    tokens: List[int] = field(default_factory=list)
    windows: int = 0            # 30 s windows transcribed
    duration_s: float = 0.0
    error: str = ""
    timestamp: Optional[datetime] = None
    trace_id: str = ""
    tenant: str = DEFAULT_TENANT

    @classmethod
    def new(cls, media_id: str, crawl_id: str = "", batch_id: str = "",
            worker_id: str = "", trace_id: str = "",
            tenant: str = DEFAULT_TENANT, **kw: Any) -> "TranscriptMessage":
        return cls(media_id=media_id, post_uid=f"media:{media_id}",
                   crawl_id=crawl_id, batch_id=batch_id,
                   worker_id=worker_id, timestamp=codec.utcnow(),
                   trace_id=trace_id or new_trace_id(),
                   tenant=normalize_tenant(tenant), **kw)

    def validate(self) -> None:
        if self.message_type != MSG_TRANSCRIPT:
            raise ValueError(
                f"invalid transcript message type: {self.message_type}")
        if not self.media_id:
            raise ValueError("transcript media_id cannot be empty")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "media_id": self.media_id,
            "post_uid": self.post_uid,
            "path": self.path,
            "channel_name": self.channel_name,
            "crawl_id": self.crawl_id,
            "batch_id": self.batch_id,
            "worker_id": self.worker_id,
            "text": self.text,
            "tokens": list(self.tokens),
            "windows": self.windows,
            "duration_s": self.duration_s,
            "error": self.error,
            "timestamp": _opt_time(self.timestamp),
            "trace_id": self.trace_id,
            "tenant": self.tenant,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TranscriptMessage":
        return cls(
            message_type=d.get("message_type", MSG_TRANSCRIPT),
            media_id=d.get("media_id", "") or "",
            post_uid=d.get("post_uid", "") or "",
            path=d.get("path", "") or "",
            channel_name=d.get("channel_name", "") or "",
            crawl_id=d.get("crawl_id", "") or "",
            batch_id=d.get("batch_id", "") or "",
            worker_id=d.get("worker_id", "") or "",
            text=d.get("text", "") or "",
            tokens=[int(t) for t in (d.get("tokens") or [])],
            windows=int(d.get("windows") or 0),
            duration_s=float(d.get("duration_s") or 0.0),
            error=d.get("error", "") or "",
            timestamp=parse_time(d.get("timestamp")),
            trace_id=d.get("trace_id", "") or "",
            tenant=normalize_tenant(d.get("tenant")),
        )


# -- streaming clustering ----------------------------------------------------
@dataclass
class ClusterUpdateMessage:
    """The cluster worker's periodic centroid-state summary on
    ``TOPIC_CLUSTERS``: ``sizes`` is the cumulative assignment count per
    cluster (length ``k``), ``inertia`` the newest per-vector inertia,
    ``underpopulated`` the ids whose share of assignments is under the
    worker's ``min_cluster_fraction`` of the uniform share, and
    ``channel_clusters`` a bounded map of recently seen channels to the
    cluster their posts last landed in."""

    message_type: str = MSG_CLUSTER_UPDATE
    worker_id: str = ""
    k: int = 0
    step: int = 0                    # mini-batch steps applied so far
    vectors: int = 0                 # embeddings assigned so far
    sizes: List[int] = field(default_factory=list)
    inertia: Optional[float] = None
    underpopulated: List[int] = field(default_factory=list)
    channel_clusters: Dict[str, int] = field(default_factory=dict)
    timestamp: Optional[datetime] = None
    trace_id: str = ""

    @classmethod
    def new(cls, worker_id: str, k: int, step: int = 0, vectors: int = 0,
            sizes: Optional[List[int]] = None,
            inertia: Optional[float] = None,
            underpopulated: Optional[List[int]] = None,
            channel_clusters: Optional[Dict[str, int]] = None
            ) -> "ClusterUpdateMessage":
        return cls(worker_id=worker_id, k=int(k), step=int(step),
                   vectors=int(vectors), sizes=list(sizes or []),
                   inertia=inertia,
                   underpopulated=list(underpopulated or []),
                   channel_clusters=dict(channel_clusters or {}),
                   timestamp=codec.utcnow(), trace_id=new_trace_id())

    def validate(self) -> None:
        if self.message_type != MSG_CLUSTER_UPDATE:
            raise ValueError(
                f"invalid cluster update message type: {self.message_type}")
        if not self.worker_id:
            raise ValueError("cluster update worker_id cannot be empty")
        if self.k <= 0:
            raise ValueError("cluster update k must be positive")
        if self.sizes and len(self.sizes) != self.k:
            raise ValueError(
                f"cluster update carries {len(self.sizes)} sizes for k="
                f"{self.k}")
        for c in self.underpopulated:
            if not 0 <= int(c) < self.k:
                raise ValueError(f"underpopulated cluster id {c} out of "
                                 f"range for k={self.k}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "worker_id": self.worker_id,
            "k": self.k,
            "step": self.step,
            "vectors": self.vectors,
            "sizes": self.sizes,
            "inertia": self.inertia,
            "underpopulated": self.underpopulated,
            "channel_clusters": self.channel_clusters,
            "timestamp": _opt_time(self.timestamp),
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClusterUpdateMessage":
        inertia = d.get("inertia")
        return cls(
            message_type=d.get("message_type", MSG_CLUSTER_UPDATE),
            worker_id=d.get("worker_id", "") or "",
            k=int(d.get("k") or 0),
            step=int(d.get("step") or 0),
            vectors=int(d.get("vectors") or 0),
            sizes=[int(s) for s in (d.get("sizes") or [])],
            inertia=float(inertia) if inertia is not None else None,
            underpopulated=[int(c) for c in (d.get("underpopulated") or [])],
            channel_clusters={str(ch): int(c) for ch, c in
                              (d.get("channel_clusters") or {}).items()},
            timestamp=parse_time(d.get("timestamp")),
            trace_id=d.get("trace_id", "") or "",
        )


# -- worker status -----------------------------------------------------------
@dataclass
class StatusMessage:
    """Worker heartbeat/status.  ``worker_type`` is ``"tpu"``, ``"asr"``
    or ``"cluster"`` for the serving workers; ``resource_usage`` carries
    the telemetry snapshot (`utils/telemetry.py`)."""

    message_type: str = MSG_HEARTBEAT
    worker_id: str = ""
    status: str = WORKER_IDLE
    worker_type: str = "crawl"
    current_work: Optional[str] = None
    queue_length: int = 0
    resource_usage: Dict[str, Any] = field(default_factory=dict)
    tasks_processed: int = 0
    tasks_success: int = 0
    tasks_error: int = 0
    timestamp: Optional[datetime] = None
    uptime_s: float = 0.0
    trace_id: str = ""

    @classmethod
    def new(cls, worker_id: str, message_type: str, status: str,
            tasks_processed: int = 0, tasks_success: int = 0,
            tasks_error: int = 0, uptime_s: float = 0.0,
            worker_type: str = "crawl") -> "StatusMessage":
        return cls(message_type=message_type, worker_id=worker_id,
                   status=status, worker_type=worker_type,
                   tasks_processed=tasks_processed,
                   tasks_success=tasks_success, tasks_error=tasks_error,
                   timestamp=codec.utcnow(), uptime_s=uptime_s,
                   trace_id=new_trace_id())

    def validate(self) -> None:
        if not self.worker_id:
            raise ValueError("status message WorkerID cannot be empty")
        if self.message_type not in (MSG_HEARTBEAT, MSG_WORKER_STARTED,
                                     MSG_WORKER_STOPPING):
            raise ValueError(f"invalid message type: {self.message_type}")
        if self.status not in (WORKER_ACTIVE, WORKER_IDLE, WORKER_BUSY,
                               WORKER_ERROR, WORKER_OFFLINE):
            raise ValueError(f"invalid status: {self.status}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "worker_id": self.worker_id,
            "status": self.status,
            "worker_type": self.worker_type,
            "current_work": self.current_work,
            "queue_length": self.queue_length,
            "resource_usage": self.resource_usage,
            "tasks_processed": self.tasks_processed,
            "tasks_success": self.tasks_success,
            "tasks_error": self.tasks_error,
            "timestamp": _opt_time(self.timestamp),
            # "uptime" is the reference's compatibility alias.
            "uptime_s": self.uptime_s,
            "uptime": self.uptime_s,
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StatusMessage":
        return cls(
            message_type=d.get("message_type", MSG_HEARTBEAT),
            worker_id=d.get("worker_id", "") or "",
            status=d.get("status", WORKER_IDLE) or WORKER_IDLE,
            worker_type=d.get("worker_type", "crawl") or "crawl",
            current_work=d.get("current_work"),
            queue_length=int(d.get("queue_length") or 0),
            resource_usage=dict(d.get("resource_usage") or {}),
            tasks_processed=int(d.get("tasks_processed") or 0),
            tasks_success=int(d.get("tasks_success") or 0),
            tasks_error=int(d.get("tasks_error") or 0),
            timestamp=parse_time(d.get("timestamp")),
            uptime_s=float(d.get("uptime_s", d.get("uptime")) or 0.0),
            trace_id=d.get("trace_id", "") or "",
        )


# -- span export (`utils/trace.SpanExporter`) --------------------------------
@dataclass
class SpanBatchMessage:
    """A bounded batch of finished spans on ``TOPIC_SPANS``.

    ``spans`` holds `utils.trace.Span.to_dict()` rows, their
    ``start_wall`` on the sender's clock (``sent_wall`` lets a collector
    estimate the offset); ``dropped`` counts spans not shipped since the
    previous batch."""

    message_type: str = MSG_SPAN_BATCH
    worker_id: str = ""
    sent_wall: float = 0.0              # sender epoch at publish
    spans: List[Dict[str, Any]] = field(default_factory=list)
    dropped: int = 0
    timestamp: Optional[datetime] = None
    trace_id: str = ""

    @classmethod
    def new(cls, worker_id: str, spans: List[Dict[str, Any]],
            dropped: int = 0) -> "SpanBatchMessage":
        return cls(worker_id=worker_id, sent_wall=time.time(),
                   spans=list(spans), dropped=int(dropped),
                   timestamp=codec.utcnow(), trace_id=new_trace_id())

    def validate(self) -> None:
        if self.message_type != MSG_SPAN_BATCH:
            raise ValueError(
                f"invalid span batch message type: {self.message_type}")
        if not self.worker_id:
            raise ValueError("span batch worker_id cannot be empty")
        for s in self.spans:
            if not isinstance(s, dict) or not s.get("name") \
                    or not s.get("trace_id"):
                raise ValueError(
                    "span batch rows need at least name + trace_id")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "worker_id": self.worker_id,
            "sent_wall": self.sent_wall,
            "spans": self.spans,
            "dropped": self.dropped,
            "timestamp": _opt_time(self.timestamp),
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpanBatchMessage":
        return cls(
            message_type=d.get("message_type", MSG_SPAN_BATCH),
            worker_id=d.get("worker_id", "") or "",
            sent_wall=float(d.get("sent_wall") or 0.0),
            spans=[s for s in (d.get("spans") or [])
                   if isinstance(s, dict)],
            dropped=int(d.get("dropped") or 0),
            timestamp=parse_time(d.get("timestamp")),
            trace_id=d.get("trace_id", "") or "",
        )


# -- the crawl's work and results ---------------------------------------------
# The orchestrator's side of the crawl protocol: work items out on
# ``crawl-work-queue``, results (with the pages they discovered) back on
# ``crawl-results``.  The reference's crawl workers read these frames, so
# every dict key and default is the reference's.
MSG_WORK_ITEM = "work_item"
MSG_WORK_RESULT = "work_result"
MSG_ALERT = "alert"

STATUS_SUCCESS = "success"
STATUS_ERROR = "error"
STATUS_PARTIAL = "partial"
STATUS_RETRY = "retry"

PRIORITY_HIGH = 1
PRIORITY_MEDIUM = 3
PRIORITY_LOW = 5

VALID_PLATFORMS = ("telegram", "youtube")


def new_work_item_id() -> str:
    """``work_<UTC yyyymmddHHMMSS>_<6 alphanumerics>``."""
    stamp = codec.utcnow().strftime("%Y%m%d%H%M%S")
    return "work_" + stamp + "_" + "".join(
        secrets.choice(_ALPHANUM) for _ in range(6))


@dataclass
class WorkItemConfig:
    """Crawl config carried inside a work item (`messages.go:89-108`)."""

    storage_root: str = ""
    concurrency: int = 1
    timeout: int = 30
    min_post_date: Optional[datetime] = None
    post_recency: Optional[datetime] = None
    date_between_min: Optional[datetime] = None
    date_between_max: Optional[datetime] = None
    sample_size: int = 0
    max_comments: int = -1
    max_posts: int = -1
    max_depth: int = 0
    max_pages: int = 0
    min_users: int = 0
    crawl_label: str = ""
    skip_media_download: bool = False
    youtube_api_key: str = ""
    sampling_method: str = ""
    min_channel_videos: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "storage_root": self.storage_root,
            "concurrency": self.concurrency,
            "timeout": self.timeout,
            "min_post_date": _opt_time(self.min_post_date),
            "post_recency": _opt_time(self.post_recency),
            "date_between_min": _opt_time(self.date_between_min),
            "date_between_max": _opt_time(self.date_between_max),
            "sample_size": self.sample_size,
            "max_comments": self.max_comments,
            "max_posts": self.max_posts,
            "max_depth": self.max_depth,
            "max_pages": self.max_pages,
            "min_users": self.min_users,
            "crawl_label": self.crawl_label,
            "skip_media_download": self.skip_media_download,
            "youtube_api_key": self.youtube_api_key,
            "sampling_method": self.sampling_method,
            "min_channel_videos": self.min_channel_videos,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkItemConfig":
        return cls(
            storage_root=d.get("storage_root", "") or "",
            concurrency=int(d.get("concurrency") or 1),
            timeout=int(d.get("timeout") or 30),
            min_post_date=parse_time(d.get("min_post_date")),
            post_recency=parse_time(d.get("post_recency")),
            date_between_min=parse_time(d.get("date_between_min")),
            date_between_max=parse_time(d.get("date_between_max")),
            sample_size=int(d.get("sample_size") or 0),
            max_comments=int(d.get("max_comments") if d.get("max_comments") is not None else -1),
            max_posts=int(d.get("max_posts") if d.get("max_posts") is not None else -1),
            max_depth=int(d.get("max_depth") or 0),
            max_pages=int(d.get("max_pages") or 0),
            min_users=int(d.get("min_users") or 0),
            crawl_label=d.get("crawl_label", "") or "",
            skip_media_download=bool(d.get("skip_media_download") or False),
            youtube_api_key=d.get("youtube_api_key", "") or "",
            sampling_method=d.get("sampling_method", "") or "",
            min_channel_videos=int(d.get("min_channel_videos") or 0),
        )


@dataclass
class WorkItem:
    """A single crawl task (`messages.go:71-86`)."""

    id: str = ""
    url: str = ""
    depth: int = 0
    crawl_id: str = ""
    platform: str = ""
    config: WorkItemConfig = field(default_factory=WorkItemConfig)
    parent_id: str = ""
    retry_count: int = 0
    assigned_to: str = ""
    created_at: Optional[datetime] = None
    assigned_at: Optional[datetime] = None
    deadline: Optional[datetime] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    trace_id: str = ""

    @classmethod
    def new(cls, url: str, depth: int, parent_id: str, crawl_id: str,
            platform: str, config: WorkItemConfig) -> "WorkItem":
        """`messages.go:179-192`."""
        return cls(id=new_work_item_id(), url=url, depth=depth,
                   parent_id=parent_id, crawl_id=crawl_id, platform=platform,
                   config=config, created_at=codec.utcnow(), trace_id=new_trace_id())

    def validate(self) -> None:
        """`messages.go:255-269`."""
        if not self.id:
            raise ValueError("work item ID cannot be empty")
        if not self.url:
            raise ValueError("work item URL cannot be empty")
        if not self.platform:
            raise ValueError("work item platform cannot be empty")
        if self.platform not in VALID_PLATFORMS:
            raise ValueError(f"unsupported platform: {self.platform}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "url": self.url,
            "depth": self.depth,
            "crawl_id": self.crawl_id,
            "platform": self.platform,
            "config": self.config.to_dict(),
            "parent_id": self.parent_id,
            "retry_count": self.retry_count,
            "assigned_to": self.assigned_to,
            "created_at": _opt_time(self.created_at),
            "assigned_at": _opt_time(self.assigned_at),
            "deadline": _opt_time(self.deadline),
            "metadata": self.metadata,
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkItem":
        return cls(
            id=d.get("id", "") or "",
            url=d.get("url", "") or "",
            depth=int(d.get("depth") or 0),
            crawl_id=d.get("crawl_id", "") or "",
            platform=d.get("platform", "") or "",
            config=WorkItemConfig.from_dict(d.get("config") or {}),
            parent_id=d.get("parent_id", "") or "",
            retry_count=int(d.get("retry_count") or 0),
            assigned_to=d.get("assigned_to", "") or "",
            created_at=parse_time(d.get("created_at")),
            assigned_at=parse_time(d.get("assigned_at")),
            deadline=parse_time(d.get("deadline")),
            metadata=dict(d.get("metadata") or {}),
            trace_id=d.get("trace_id", "") or "",
        )


@dataclass
class WorkQueueMessage:
    """Work-queue envelope (`messages.go:61-68`)."""

    message_type: str = MSG_WORK_ITEM
    work_item: WorkItem = field(default_factory=WorkItem)
    priority: int = PRIORITY_MEDIUM
    timestamp: Optional[datetime] = None
    ttl_seconds: int = 3600
    trace_id: str = ""

    @classmethod
    def new(cls, item: WorkItem, priority: int = PRIORITY_MEDIUM,
            ttl_seconds: int = 3600) -> "WorkQueueMessage":
        """`messages.go:195-204` — except the envelope INHERITS the work
        item's trace id instead of minting a fresh one, so the dispatch
        span, the delivery span, and the worker's processing spans all
        correlate to one trace (the reference generated an id per envelope
        that nothing ever joined)."""
        return cls(message_type=MSG_WORK_ITEM, work_item=item,
                   priority=priority, timestamp=codec.utcnow(),
                   ttl_seconds=ttl_seconds,
                   trace_id=item.trace_id or new_trace_id())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "work_item": self.work_item.to_dict(),
            "priority": self.priority,
            "timestamp": _opt_time(self.timestamp),
            "ttl_seconds": self.ttl_seconds,
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkQueueMessage":
        return cls(
            message_type=d.get("message_type", MSG_WORK_ITEM),
            work_item=WorkItem.from_dict(d.get("work_item") or {}),
            priority=int(d.get("priority") or PRIORITY_MEDIUM),
            timestamp=parse_time(d.get("timestamp")),
            ttl_seconds=int(d.get("ttl_seconds") or 3600),
            trace_id=d.get("trace_id", "") or "",
        )

    def expired(self, now: Optional[datetime] = None) -> bool:
        if self.timestamp is None or self.ttl_seconds <= 0:
            return False
        now = now or codec.utcnow()
        return (now - self.timestamp).total_seconds() > self.ttl_seconds


@dataclass
class DiscoveredPage:
    """A newly discovered page (`messages.go:135-140`)."""

    url: str = ""
    parent_id: str = ""
    depth: int = 0
    platform: str = ""

    def validate(self) -> None:
        """`messages.go:289-300`."""
        if not self.url:
            raise ValueError("discovered page URL cannot be empty")
        if not self.platform:
            raise ValueError("discovered page platform cannot be empty")
        if self.depth < 0:
            raise ValueError("discovered page depth cannot be negative")

    def to_dict(self) -> Dict[str, Any]:
        return {"url": self.url, "parent_id": self.parent_id,
                "depth": self.depth, "platform": self.platform}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DiscoveredPage":
        return cls(url=d.get("url", "") or "", parent_id=d.get("parent_id", "") or "",
                   depth=int(d.get("depth") or 0), platform=d.get("platform", "") or "")


@dataclass
class WorkResult:
    """Result of a completed work item (`messages.go:120-132`)."""

    work_item_id: str = ""
    worker_id: str = ""
    status: str = STATUS_SUCCESS
    processed_url: str = ""
    message_count: int = 0
    discovered_pages: List[DiscoveredPage] = field(default_factory=list)
    error: str = ""
    processing_time_s: float = 0.0
    metadata: Dict[str, Any] = field(default_factory=dict)
    completed_at: Optional[datetime] = None
    retry_recommended: bool = False

    def validate(self) -> None:
        """`messages.go:272-286`."""
        if not self.work_item_id:
            raise ValueError("work result WorkItemID cannot be empty")
        if not self.worker_id:
            raise ValueError("work result WorkerID cannot be empty")
        if self.status not in (STATUS_SUCCESS, STATUS_ERROR, STATUS_PARTIAL,
                               STATUS_RETRY):
            raise ValueError(f"invalid status: {self.status}")
        if self.status == STATUS_ERROR and not self.error:
            raise ValueError("error status requires error message")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "work_item_id": self.work_item_id,
            "worker_id": self.worker_id,
            "status": self.status,
            "processed_url": self.processed_url,
            "message_count": self.message_count,
            "discovered_pages": [p.to_dict() for p in self.discovered_pages],
            "error": self.error,
            "processing_time": self.processing_time_s,
            "metadata": self.metadata,
            "completed_at": _opt_time(self.completed_at),
            "retry_recommended": self.retry_recommended,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkResult":
        return cls(
            work_item_id=d.get("work_item_id", "") or "",
            worker_id=d.get("worker_id", "") or "",
            status=d.get("status", STATUS_SUCCESS) or STATUS_SUCCESS,
            processed_url=d.get("processed_url", "") or "",
            message_count=int(d.get("message_count") or 0),
            discovered_pages=[DiscoveredPage.from_dict(p)
                              for p in (d.get("discovered_pages") or [])],
            error=d.get("error", "") or "",
            processing_time_s=float(d.get("processing_time") or 0.0),
            metadata=dict(d.get("metadata") or {}),
            completed_at=parse_time(d.get("completed_at")),
            retry_recommended=bool(d.get("retry_recommended") or False),
        )


@dataclass
class ResultMessage:
    """Results envelope (`messages.go:111-117`)."""

    message_type: str = MSG_WORK_RESULT
    work_result: WorkResult = field(default_factory=WorkResult)
    discovered_pages: List[DiscoveredPage] = field(default_factory=list)
    timestamp: Optional[datetime] = None
    trace_id: str = ""

    @classmethod
    def new(cls, result: WorkResult,
            discovered_pages: Optional[List[DiscoveredPage]] = None,
            trace_id: str = "") -> "ResultMessage":
        """`messages.go:222-230`; pass the originating work item's
        ``trace_id`` so the result leg joins the dispatch leg's trace
        (a fresh id is minted only for untraced callers)."""
        return cls(message_type=MSG_WORK_RESULT, work_result=result,
                   discovered_pages=list(discovered_pages or []),
                   timestamp=codec.utcnow(), trace_id=trace_id or new_trace_id())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "work_result": self.work_result.to_dict(),
            "discovered_pages": [p.to_dict() for p in self.discovered_pages],
            "timestamp": _opt_time(self.timestamp),
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResultMessage":
        return cls(
            message_type=d.get("message_type", MSG_WORK_RESULT),
            work_result=WorkResult.from_dict(d.get("work_result") or {}),
            discovered_pages=[DiscoveredPage.from_dict(p)
                              for p in (d.get("discovered_pages") or [])],
            timestamp=parse_time(d.get("timestamp")),
            trace_id=d.get("trace_id", "") or "",
        )


# -- watchtower alerts (`utils/alerts.py`) -------------------------------------
ALERT_STATES = ("pending", "firing", "resolved", "inactive")


@dataclass
class AlertMessage:
    """One alert lifecycle transition on ``TOPIC_ALERTS``.

    Published by the orchestrator's watchtower for ``firing`` and
    ``resolved`` transitions (pending/inactive churn stays local to
    ``/alerts``).  ``value`` is the rule's evaluated value at transition
    time (a burn rate, a slope, an aggregate) and ``detail`` carries the
    kind-specific context (fast/slow burn, threshold, matched-series
    count).  The envelope's ``trace_id`` exists for registry uniformity
    (the crawlint BUS contract); alerts are telemetry about the fleet,
    they do not participate in a work item's trace."""

    message_type: str = MSG_ALERT
    rule: str = ""
    kind: str = ""                   # threshold | trend | burn_rate
    series: str = ""
    state: str = ""                  # the state ENTERED (ALERT_STATES)
    prev_state: str = ""
    severity: str = "page"
    value: Optional[float] = None
    detail: Dict[str, Any] = field(default_factory=dict)
    at_wall: float = 0.0             # sender epoch of the transition
    timestamp: Optional[datetime] = None
    trace_id: str = ""

    @classmethod
    def new(cls, rule: str, kind: str, series: str, state: str,
            prev_state: str = "", severity: str = "page",
            value: Optional[float] = None,
            detail: Optional[Dict[str, Any]] = None,
            at_wall: float = 0.0) -> "AlertMessage":
        import time as _time

        return cls(rule=rule, kind=kind, series=series, state=state,
                   prev_state=prev_state, severity=severity, value=value,
                   detail=dict(detail or {}),
                   at_wall=at_wall or _time.time(),
                   timestamp=codec.utcnow(), trace_id=new_trace_id())

    def validate(self) -> None:
        if self.message_type != MSG_ALERT:
            raise ValueError(
                f"invalid alert message type: {self.message_type}")
        if not self.rule:
            raise ValueError("alert message rule cannot be empty")
        if self.state not in ALERT_STATES:
            raise ValueError(f"invalid alert state: {self.state}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "rule": self.rule,
            "kind": self.kind,
            "series": self.series,
            "state": self.state,
            "prev_state": self.prev_state,
            "severity": self.severity,
            "value": self.value,
            "detail": self.detail,
            "at_wall": self.at_wall,
            "timestamp": _opt_time(self.timestamp),
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AlertMessage":
        value = d.get("value")
        return cls(
            message_type=d.get("message_type", MSG_ALERT),
            rule=d.get("rule", "") or "",
            kind=d.get("kind", "") or "",
            series=d.get("series", "") or "",
            state=d.get("state", "") or "",
            prev_state=d.get("prev_state", "") or "",
            severity=d.get("severity", "page") or "page",
            value=float(value) if value is not None else None,
            detail=dict(d.get("detail") or {}),
            at_wall=float(d.get("at_wall") or 0.0),
            timestamp=parse_time(d.get("timestamp")),
            trace_id=d.get("trace_id", "") or "",
        )


# --- chaos injection (`loadgen/chaos.py`) ------------------------------------

MSG_CHAOS_FAULT = "chaos_fault"
# Fault actions the chaos controller knows how to apply; `validate()`
# rejects anything else at decode time.
CHAOS_ACTIONS = ("kill", "restart", "down", "stall", "wedge", "delay",
                 "drop", "poison", "flood")


@dataclass
class ChaosMessage:
    """One injected fault, announced on ``TOPIC_CHAOS`` the moment the
    chaos controller applies it (`loadgen/chaos.py`): the reference's
    frame.  ``at_s``/``until_s`` are offsets from scenario start; point
    faults carry ``until_s=0``."""

    message_type: str = MSG_CHAOS_FAULT
    action: str = ""                 # one of CHAOS_ACTIONS
    target_id: str = ""              # worker id or "bus"/"batch"
    at_s: float = 0.0
    until_s: float = 0.0             # 0 = point fault (no window)
    parameters: Dict[str, Any] = field(default_factory=dict)
    timestamp: Optional[datetime] = None
    trace_id: str = ""

    @classmethod
    def new(cls, action: str, target_id: str, at_s: float,
            until_s: float = 0.0,
            parameters: Optional[Dict[str, Any]] = None) -> "ChaosMessage":
        return cls(action=action, target_id=target_id, at_s=at_s,
                   until_s=until_s, parameters=dict(parameters or {}),
                   timestamp=codec.utcnow(), trace_id=new_trace_id())

    def validate(self) -> None:
        if self.message_type != MSG_CHAOS_FAULT:
            raise ValueError(
                f"invalid chaos message type: {self.message_type}")
        if self.action not in CHAOS_ACTIONS:
            raise ValueError(f"unknown chaos action: {self.action}")
        if not self.target_id:
            raise ValueError("chaos message target cannot be empty")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message_type": self.message_type,
            "action": self.action,
            "target_id": self.target_id,
            "at_s": self.at_s,
            "until_s": self.until_s,
            "parameters": self.parameters,
            "timestamp": _opt_time(self.timestamp),
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChaosMessage":
        return cls(
            message_type=d.get("message_type", MSG_CHAOS_FAULT),
            action=d.get("action", "") or "",
            target_id=d.get("target_id", "") or "",
            at_s=float(d.get("at_s") or 0.0),
            until_s=float(d.get("until_s") or 0.0),
            parameters=dict(d.get("parameters") or {}),
            timestamp=parse_time(d.get("timestamp")),
            trace_id=d.get("trace_id", "") or "",
        )

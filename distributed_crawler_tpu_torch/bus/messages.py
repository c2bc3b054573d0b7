"""Bus constants and the envelopes the serving slices need — media,
cluster, worker status and span export — copied from the reference's
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
# The crawler's work queue and scheduled-job commands: no port worker
# consumes them, but a broker the port hosts (``--mode bus``) queues them
# for the reference's crawl workers, as the reference's broker does.
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
# The crawler's and the orchestrator's fan-out topics, which no port
# worker publishes: the partitioned bus broadcasts them as the
# reference's does (`bus/partition.py`).
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

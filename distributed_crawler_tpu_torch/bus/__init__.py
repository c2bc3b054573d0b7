"""Bus layer of the port: `RecordBatch`, the media, cluster, status and
span envelopes, topics, the in-memory bus.  The gRPC bus between
processes is `bus.grpc_bus` (it imports ``grpc`` only when used)."""

from .codec import RecordBatch
from .inmemory import InMemoryBus
from .messages import (
    DEFAULT_TENANT,
    TOPIC_CLUSTERS,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_INFERENCE_RESULTS,
    TOPIC_MEDIA_BATCHES,
    TOPIC_SPANS,
    TOPIC_TRANSCRIPTS,
    TOPIC_WORKER_STATUS,
    AudioBatchMessage,
    AudioRef,
    ClusterUpdateMessage,
    SpanBatchMessage,
    StatusMessage,
    TranscriptMessage,
    new_trace_id,
    normalize_tenant,
)

__all__ = [
    "AudioBatchMessage", "AudioRef", "ClusterUpdateMessage",
    "DEFAULT_TENANT", "InMemoryBus", "RecordBatch", "SpanBatchMessage",
    "StatusMessage", "TOPIC_CLUSTERS", "TOPIC_INFERENCE_BATCHES",
    "TOPIC_INFERENCE_RESULTS", "TOPIC_MEDIA_BATCHES", "TOPIC_SPANS",
    "TOPIC_TRANSCRIPTS", "TOPIC_WORKER_STATUS", "TranscriptMessage",
    "new_trace_id", "normalize_tenant",
]

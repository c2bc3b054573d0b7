"""Bus layer of the port: `RecordBatch`, the media and cluster envelopes,
topics, the in-memory bus."""

from .codec import RecordBatch
from .inmemory import InMemoryBus
from .messages import (
    DEFAULT_TENANT,
    TOPIC_CLUSTERS,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_INFERENCE_RESULTS,
    TOPIC_MEDIA_BATCHES,
    TOPIC_TRANSCRIPTS,
    AudioBatchMessage,
    AudioRef,
    ClusterUpdateMessage,
    TranscriptMessage,
    new_trace_id,
    normalize_tenant,
)

__all__ = [
    "AudioBatchMessage", "AudioRef", "ClusterUpdateMessage",
    "DEFAULT_TENANT", "InMemoryBus", "RecordBatch", "TOPIC_CLUSTERS",
    "TOPIC_INFERENCE_BATCHES", "TOPIC_INFERENCE_RESULTS",
    "TOPIC_MEDIA_BATCHES", "TOPIC_TRANSCRIPTS", "TranscriptMessage",
    "new_trace_id", "normalize_tenant",
]

"""Bus layer of the port: `RecordBatch`, the media envelopes, topics, the
in-memory bus."""

from .codec import RecordBatch
from .inmemory import InMemoryBus
from .messages import (
    DEFAULT_TENANT,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_INFERENCE_RESULTS,
    TOPIC_MEDIA_BATCHES,
    TOPIC_TRANSCRIPTS,
    AudioBatchMessage,
    AudioRef,
    TranscriptMessage,
    new_trace_id,
    normalize_tenant,
)

__all__ = [
    "AudioBatchMessage", "AudioRef", "DEFAULT_TENANT", "InMemoryBus",
    "RecordBatch", "TOPIC_INFERENCE_BATCHES", "TOPIC_INFERENCE_RESULTS",
    "TOPIC_MEDIA_BATCHES", "TOPIC_TRANSCRIPTS", "TranscriptMessage",
    "new_trace_id", "normalize_tenant",
]

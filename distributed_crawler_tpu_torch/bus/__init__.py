"""Bus layer of the port: `RecordBatch`, topics, the in-memory bus."""

from .codec import RecordBatch
from .inmemory import InMemoryBus
from .messages import (
    DEFAULT_TENANT,
    TOPIC_INFERENCE_BATCHES,
    TOPIC_INFERENCE_RESULTS,
    new_trace_id,
    normalize_tenant,
)

__all__ = [
    "DEFAULT_TENANT", "InMemoryBus", "RecordBatch",
    "TOPIC_INFERENCE_BATCHES", "TOPIC_INFERENCE_RESULTS", "new_trace_id",
    "normalize_tenant",
]

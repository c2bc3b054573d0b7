"""Device ops of the port: bucketing/packing and attention."""

from .attention import attend, flash_attention, mha
from .padding import (
    DEFAULT_BUCKETS,
    DEFAULT_MAX_SEGMENTS_PER_ROW,
    BucketSpec,
    PackedRows,
    bucket_for,
    group_by_bucket,
    pack_batch,
    pack_rows,
    pad_to_bucket,
)

__all__ = [
    "DEFAULT_BUCKETS", "DEFAULT_MAX_SEGMENTS_PER_ROW", "BucketSpec",
    "PackedRows", "attend", "bucket_for", "flash_attention",
    "group_by_bucket", "mha", "pack_batch", "pack_rows", "pad_to_bucket",
]

"""Bucketed padding: turn ragged crawl text into fixed-shape device batches.

A copy of the reference's `distributed_crawler_tpu/ops/padding.py` (pure
numpy), kept here so the port imports nothing of the JAX package.  The
results must stay identical to the reference's, down to `pack_rows`'
(row, slot) assignments: the parity tests compare them element for element.

Sequence lengths are quantized into a small set of buckets so the device
sees a few static shapes; buckets default to powers of two from 32 to 512.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)

# Per-row segment bound for the packer: unpacking indexes a static
# [rows, MAX_SEGMENTS_PER_ROW] result block, so the bound is a shape, not a
# heuristic.
DEFAULT_MAX_SEGMENTS_PER_ROW = 8


@dataclass(frozen=True)
class BucketSpec:
    lengths: Tuple[int, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        if not self.lengths:
            raise ValueError("at least one bucket length required")
        if list(self.lengths) != sorted(set(self.lengths)):
            raise ValueError(
                f"bucket lengths must be strictly increasing: {self.lengths}")

    @property
    def max_len(self) -> int:
        return self.lengths[-1]


def bucket_for(length: int, spec: BucketSpec = BucketSpec()) -> int:
    """Smallest bucket that fits ``length``; over-long inputs truncate to max."""
    for b in spec.lengths:
        if length <= b:
            return b
    return spec.max_len


def pad_to_bucket(ids: Sequence[int], bucket: int,
                  pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """One sequence -> (ids[bucket] int32, mask[bucket] bool)."""
    arr = np.full(bucket, pad_id, dtype=np.int32)
    mask = np.zeros(bucket, dtype=bool)
    n = min(len(ids), bucket)
    arr[:n] = np.asarray(ids[:n], dtype=np.int32)
    mask[:n] = True
    return arr, mask


def pack_batch(sequences: Sequence[Sequence[int]],
               spec: BucketSpec = BucketSpec(),
               pad_id: int = 0,
               batch_pad_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Many sequences -> one (ids [B, L], mask [B, L]) pair.

    The bucket is chosen by the longest sequence in the batch; if
    ``batch_pad_to`` > 0 the batch dim is padded up with all-padding rows so
    the batch shape is static too.
    """
    if not sequences:
        raise ValueError("pack_batch requires at least one sequence")
    bucket = bucket_for(max(len(s) for s in sequences), spec)
    rows = [pad_to_bucket(s, bucket, pad_id) for s in sequences]
    ids = np.stack([r[0] for r in rows])
    mask = np.stack([r[1] for r in rows])
    if batch_pad_to and len(sequences) < batch_pad_to:
        pad_rows = batch_pad_to - len(sequences)
        ids = np.concatenate(
            [ids, np.full((pad_rows, bucket), pad_id, dtype=np.int32)])
        mask = np.concatenate([mask, np.zeros((pad_rows, bucket), dtype=bool)])
    return ids, mask


@dataclass
class PackedRows:
    """Several short sequences packed into each fixed-length bucket row.

    ``segment_ids`` is 0 at padding and 1..S at packed tokens; segment s of
    row r is the caller's sequence ``assignments[r][s - 1]``.  ``positions``
    restarts at 0 for every segment so absolute position embeddings see each
    packed sequence exactly as its unpacked twin would.
    """

    bucket: int
    ids: np.ndarray          # [R, L] int32
    mask: np.ndarray         # [R, L] bool (True = real token)
    segment_ids: np.ndarray  # [R, L] int32 (0 = padding)
    positions: np.ndarray    # [R, L] int32 (within-segment offsets)
    assignments: List[List[int]] = field(default_factory=list)

    @property
    def n_rows(self) -> int:
        return int(self.ids.shape[0])


def pack_rows(sequences: Sequence[Sequence[int]], bucket: int,
              max_segments: int = DEFAULT_MAX_SEGMENTS_PER_ROW,
              pad_id: int = 0,
              indices: Optional[Sequence[int]] = None) -> PackedRows:
    """Greedy first-fit-decreasing packer: many sequences -> few [L] rows.

    Every sequence lands in exactly one (row, segment) slot; a row takes a
    sequence only while it has both token room and a free segment slot.
    Over-long sequences truncate to the bucket (same rule as
    ``pad_to_bucket``).  ``indices`` relabels the assignment entries with
    the caller's own sequence numbering.
    """
    if bucket <= 0:
        raise ValueError(f"bucket must be positive, got {bucket}")
    if max_segments <= 0:
        raise ValueError(f"max_segments must be positive, got {max_segments}")
    idx = list(indices) if indices is not None else list(range(len(sequences)))
    if len(idx) != len(sequences):
        raise ValueError("indices must match sequences 1:1")
    # First-fit-decreasing; the sort is stable, so equal lengths keep input
    # order and the assignments are deterministic.
    order = sorted(range(len(sequences)),
                   key=lambda j: -min(len(sequences[j]), bucket))
    rows: List[Tuple[int, List[int]]] = []  # (tokens used, [seq position])
    for j in order:
        n = min(len(sequences[j]), bucket)
        for r, (used, members) in enumerate(rows):
            if used + n <= bucket and len(members) < max_segments:
                rows[r] = (used + n, members + [j])
                break
        else:
            rows.append((n, [j]))
    R = len(rows)
    ids = np.full((R, bucket), pad_id, dtype=np.int32)
    mask = np.zeros((R, bucket), dtype=bool)
    segment_ids = np.zeros((R, bucket), dtype=np.int32)
    positions = np.zeros((R, bucket), dtype=np.int32)
    assignments: List[List[int]] = []
    for r, (_, members) in enumerate(rows):
        off = 0
        slots: List[int] = []
        for s, j in enumerate(members, start=1):
            n = min(len(sequences[j]), bucket)
            ids[r, off:off + n] = np.asarray(sequences[j][:n], dtype=np.int32)
            mask[r, off:off + n] = True
            segment_ids[r, off:off + n] = s
            positions[r, off:off + n] = np.arange(n, dtype=np.int32)
            off += n
            slots.append(idx[j])
        assignments.append(slots)
    return PackedRows(bucket=bucket, ids=ids, mask=mask,
                      segment_ids=segment_ids, positions=positions,
                      assignments=assignments)


def group_by_bucket(sequences: Sequence[Sequence[int]],
                    spec: BucketSpec = BucketSpec()) -> Dict[int, List[int]]:
    """Indices of ``sequences`` grouped by their bucket."""
    groups: Dict[int, List[int]] = {}
    for i, s in enumerate(sequences):
        groups.setdefault(bucket_for(len(s), spec), []).append(i)
    return groups

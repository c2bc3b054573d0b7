"""media/: ASR serving — crawled audio to transcripts.

`AudioChunker` turns ragged waveforms into bucketed fixed-shape window
batches; `ASRWorker` serves `AudioBatchMessage`s from the bus through an
`inference.asr.ASRPipeline` and publishes `TranscriptMessage`s.  The
reference's `MediaBridge` and `TranscriptReentry` wait for the state
layer.
"""

from .chunker import (
    DEFAULT_WINDOW_BUCKETS,
    AudioChunker,
    ChunkPlan,
    bucket_for_windows,
)
from .worker import ASRWorker, ASRWorkerConfig, iter_transcripts

__all__ = [
    "ASRWorker",
    "ASRWorkerConfig",
    "AudioChunker",
    "ChunkPlan",
    "DEFAULT_WINDOW_BUCKETS",
    "bucket_for_windows",
    "iter_transcripts",
]

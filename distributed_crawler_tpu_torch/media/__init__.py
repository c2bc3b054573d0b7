"""media/: ASR serving — crawled audio to transcripts.

`AudioChunker` turns ragged waveforms into bucketed fixed-shape window
batches; `ASRWorker` serves `AudioBatchMessage`s from the bus through an
`inference.asr.ASRPipeline` and publishes `TranscriptMessage`s;
`TranscriptReentry` (`media/bridge.py`) stores each transcript as a post
that re-enters the text path.  The reference's `MediaBridge` is not
ported (only the reference's crawl modes build it).
"""

from .bridge import TranscriptReentry
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
    "TranscriptReentry",
    "bucket_for_windows",
    "iter_transcripts",
]

"""Ragged-audio scheduler: waveforms -> fixed 30 s windows -> bucketed
batches -> per-file reassembly.

A copy of `distributed_crawler_tpu/media/chunker.py` (numpy host code).
Every utterance is a fixed ``window_samples`` waveform (30 s for the
published configs), and the batch dimension is one of a few window-count
buckets.  Crawled media is ragged on both axes, so:

- :meth:`AudioChunker.chunk` slices each decoded waveform into fixed
  windows (zero-padded tail) and keeps a segment map from every window
  back to its (file, window-index) origin; reassembly walks that map;
- :meth:`AudioChunker.batches` fills the largest window-count bucket
  first, then the smallest bucket that covers the remainder;
- :meth:`AudioChunker.padding_stats` counts real against slot windows
  and samples.

Decode failures are explicit: a file that cannot be read contributes zero
windows and an entry in ``ChunkPlan.errors``, and downstream emits an
error transcript for it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("dct.torch.media.chunker")

# Window-count buckets for the batch axis: 8 is the ASR batch size's
# default, and powers of two below it cover stragglers with at most 2x
# slot waste on the final partial batch.
DEFAULT_WINDOW_BUCKETS = (1, 2, 4, 8)


def bucket_for_windows(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket when none covers (callers
    split to the largest bucket first, so this only sees n <= max)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class ChunkPlan:
    """The chunker's output: windows + the map back to source files.

    ``segment_map[w] == (file_index, window_index)`` — window ``w`` of
    the plan is window ``window_index`` of input file ``file_index``.
    Windows of one file are always contiguous and in order, so
    :meth:`AudioChunker.reassemble` is a single ordered walk.
    """

    window_samples: int
    windows: np.ndarray                  # [n_windows, window_samples] f32
    segment_map: List[Tuple[int, int]] = field(default_factory=list)
    n_files: int = 0
    errors: Dict[int, str] = field(default_factory=dict)
    real_samples: List[int] = field(default_factory=list)  # per window

    @property
    def n_windows(self) -> int:
        return len(self.segment_map)

    def windows_per_file(self) -> List[int]:
        counts = [0] * self.n_files
        for file_idx, _ in self.segment_map:
            counts[file_idx] += 1
        return counts


@dataclass
class WindowBatch:
    """One device dispatch: ``audio`` is padded to ``bucket`` rows (the
    compiled batch size); ``window_indices`` name the plan windows that
    occupy the real rows, in row order."""

    bucket: int
    audio: np.ndarray                    # [bucket, window_samples] f32
    window_indices: List[int]

    @property
    def real_windows(self) -> int:
        return len(self.window_indices)

    @property
    def pad_windows(self) -> int:
        return self.bucket - len(self.window_indices)


class AudioChunker:
    """Decode + window + bucket ragged audio into static shapes."""

    def __init__(self, window_samples: int,
                 buckets: Sequence[int] = DEFAULT_WINDOW_BUCKETS,
                 max_windows_per_file: int = 0,
                 reader: Optional[Callable[[str], np.ndarray]] = None):
        if window_samples <= 0:
            raise ValueError(f"window_samples must be positive, "
                             f"got {window_samples}")
        cleaned = sorted({int(b) for b in buckets if int(b) > 0})
        if not cleaned:
            raise ValueError(f"no positive window buckets in {buckets!r}")
        self.window_samples = int(window_samples)
        self.buckets = tuple(cleaned)
        # 0 = unbounded; >0 keeps the first N windows of a file (an
        # hour-long video is 120 windows).
        self.max_windows_per_file = max(0, int(max_windows_per_file))
        if reader is None:
            from ..inference.asr import read_wav_mono_16k

            reader = read_wav_mono_16k
        self._reader = reader

    # -- decode --------------------------------------------------------------
    def read(self, path: str) -> np.ndarray:
        """Decode one file to a float32 mono 16 kHz waveform (raises on
        failure; `chunk_files` catches per file)."""
        return np.asarray(self._reader(path), np.float32)

    # -- windowing -----------------------------------------------------------
    def split(self, audio: np.ndarray) -> List[np.ndarray]:
        """One waveform -> fixed windows (zero-padded tail).  An empty
        waveform still yields one silent window: the file was readable,
        so it must produce a transcript row, not vanish."""
        w = self.window_samples
        audio = np.asarray(audio, np.float32).reshape(-1)
        n = max(1, -(-len(audio) // w))  # ceil; >=1 window always
        if self.max_windows_per_file:
            n = min(n, self.max_windows_per_file)
        out = []
        for i in range(n):
            chunk = audio[i * w:(i + 1) * w]
            if len(chunk) < w:
                chunk = np.pad(chunk, (0, w - len(chunk)))
            out.append(chunk)
        return out

    def chunk(self, audios: Sequence[Optional[np.ndarray]],
              errors: Optional[Dict[int, str]] = None) -> ChunkPlan:
        """Waveforms (None = decode failure) -> a deterministic ChunkPlan:
        the same inputs give the same window order, segment map and
        batches, so a redelivered batch writes back identical rows."""
        plan = ChunkPlan(window_samples=self.window_samples,
                         windows=np.zeros((0, self.window_samples),
                                          np.float32),
                         n_files=len(audios), errors=dict(errors or {}))
        rows: List[np.ndarray] = []
        for file_idx, audio in enumerate(audios):
            if audio is None:
                plan.errors.setdefault(file_idx, "decode failed")
                continue
            real_len = int(np.asarray(audio).reshape(-1).shape[0])
            for win_idx, row in enumerate(self.split(audio)):
                rows.append(row)
                plan.segment_map.append((file_idx, win_idx))
                consumed = win_idx * self.window_samples
                plan.real_samples.append(
                    max(1, min(self.window_samples, real_len - consumed)))
        if rows:
            plan.windows = np.stack(rows)
        return plan

    def chunk_files(self, paths: Sequence[str]) -> ChunkPlan:
        """Decode + chunk a path list; per-file failures land in
        ``plan.errors`` (input order preserved by construction)."""
        audios: List[Optional[np.ndarray]] = []
        errors: Dict[int, str] = {}
        for i, path in enumerate(paths):
            try:
                audios.append(self.read(path))
            except Exception as e:
                logger.error("failed to read %s: %s", path, e)
                errors[i] = f"{type(e).__name__}: {e}"
                audios.append(None)
        return self.chunk(audios, errors=errors)

    # -- bucketed batches ----------------------------------------------------
    def batches(self, plan: ChunkPlan) -> List[WindowBatch]:
        """Split the plan's windows into bucket-sized device batches:
        full batches at the top bucket, then the smallest bucket covering
        the remainder."""
        out: List[WindowBatch] = []
        top = self.buckets[-1]
        idx = list(range(plan.n_windows))
        pos = 0
        while pos < len(idx):
            remaining = len(idx) - pos
            bucket = top if remaining >= top \
                else bucket_for_windows(remaining, self.buckets)
            take = idx[pos:pos + min(bucket, remaining)]
            pos += len(take)
            audio = np.zeros((bucket, self.window_samples), np.float32)
            audio[:len(take)] = plan.windows[take]
            out.append(WindowBatch(bucket=bucket, audio=audio,
                                   window_indices=take))
        return out

    def padding_stats(self, plan: ChunkPlan,
                      batches: Sequence[WindowBatch]) -> Dict[str, float]:
        """Real against slot windows and samples."""
        slot_windows = sum(b.bucket for b in batches)
        real_windows = sum(b.real_windows for b in batches)
        slot_samples = slot_windows * self.window_samples
        real_samples = sum(plan.real_samples)
        return {
            "real_windows": real_windows,
            "slot_windows": slot_windows,
            "real_samples": real_samples,
            "slot_samples": slot_samples,
            "window_density": real_windows / slot_windows
            if slot_windows else 0.0,
            "sample_density": real_samples / slot_samples
            if slot_samples else 0.0,
        }

    # -- reassembly ----------------------------------------------------------
    @staticmethod
    def reassemble(plan: ChunkPlan,
                   per_window: Sequence[Sequence[int]]
                   ) -> List[List[int]]:
        """Fan per-window token lists back to per-file lists, input order.

        ``per_window[w]`` is the (special-stripped) token output of plan
        window ``w``.  Files with decode errors get an empty list, which
        the caller pairs with ``plan.errors``.
        """
        if len(per_window) != plan.n_windows:
            raise ValueError(
                f"{len(per_window)} window outputs for {plan.n_windows} "
                f"plan windows")
        out: List[List[int]] = [[] for _ in range(plan.n_files)]
        for w, (file_idx, _win_idx) in enumerate(plan.segment_map):
            out[file_idx].extend(int(t) for t in per_window[w])
        return out

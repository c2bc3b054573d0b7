"""ASR pipeline: media files -> Whisper transcripts, in PyTorch.

The counterpart of `distributed_crawler_tpu/inference/asr.py`.  Host side:
WAV decode (PCM16 through the stdlib `wave`; other rates box-filtered and
linearly resampled, `read_wav_mono_16k`), then `media/chunker.py` cuts
every file into fixed 30 s windows and batches them by window-count
bucket.  Device side: one `models/whisper.transcribe_features` call per
bucketed batch (log-mel, the audio encoder on the attention kernel, the
KV-cached greedy decode).  Long files are windowed, transcribed window by
window and reassembled in order, never cut to their first 30 s.

The offline path (`transcribe_files`) and the serving `ASRWorker`
(`media/worker.py`) both run through :meth:`ASRPipeline.transcribe_plan`.
Transcripts are token ids; ``detokenize`` turns them into text when the
checkpoint directory has tokenizer files.

The pipeline runs on ``cuda`` unless the caller passes ``device="cpu"``.
Each window bucket is priced at its first dispatch
(`utils/costmodel.whisper_forward_flops`, ``path="asr"``) and every
recorded dispatch feeds the `EfficiencyMeter` (encoder positions are its
tokens: real windows against dispatched slots) and the `DeviceTimeline`;
`cost_snapshot()` is the ``/costs`` body.
"""

from __future__ import annotations

import logging
import threading
import time
import wave
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..media.chunker import AudioChunker
from ..models.whisper import (
    SAMPLE_RATE,
    Whisper,
    audio_window_samples,
    transcribe_features_with_steps,
)
from ..utils import trace
from ..utils.costmodel import CostModel, EfficiencyMeter, \
    whisper_forward_flops
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.occupancy import DeviceTimeline

logger = logging.getLogger("dct.torch.inference.asr")

# Decode steps of a warmup dispatch.  The first dispatch of a bucket pays
# the allocator's growth and the libraries' per-shape setup; every decode
# step has the same shapes (the KV cache is allocated whole), so a few
# steps cover the loop.
WARMUP_DECODE_LEN = 4


def read_wav_mono_16k(path: str) -> np.ndarray:
    """PCM16 WAV -> float32 mono waveform in [-1, 1] at 16 kHz.

    Other sample rates are resampled: above 16 kHz a box low-pass sized to
    the decimation ratio first, then linear interpolation.  Codec handling
    (OGG/Opus voice notes, video audio) belongs to an upstream ffmpeg
    step."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        audio = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
        channels = w.getnchannels()
    if channels > 1:
        audio = audio.reshape(-1, channels).mean(axis=1)
    audio = audio / 32768.0
    if rate != 16_000 and len(audio):
        if rate <= 0:
            raise ValueError(f"{path}: invalid sample rate {rate}")
        if rate > 16_000:
            k = int(round(rate / 16_000))
            if k > 1:  # anti-alias before downsampling
                audio = np.convolve(audio, np.ones(k, np.float32) / k,
                                    mode="same")
        n_out = max(1, int(round(len(audio) * 16_000 / rate)))
        audio = np.interp(
            np.linspace(0.0, len(audio) - 1.0, n_out),
            np.arange(len(audio), dtype=np.float64),
            audio).astype(np.float32)
        logger.debug("resampled %s: %d Hz -> 16 kHz (%d samples)",
                     path, rate, n_out)
    return audio


@dataclass
class ASRResult:
    path: str
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    windows: int = 0     # 30 s windows transcribed (0 on failure)
    error: str = ""      # non-empty = the file failed to decode


def default_window_buckets(batch_size: int) -> tuple:
    """Powers of two up to ``batch_size``, and ``batch_size`` itself."""
    out = []
    b = 1
    while b < batch_size:
        out.append(b)
        b *= 2
    out.append(max(1, int(batch_size)))
    return tuple(sorted(set(out)))


class ASRPipeline:
    """Bucketed batch transcriber over a `Whisper` model.  ``params`` is
    the reference's flax param tree as numpy arrays
    (`models/from_jax.load_whisper_params`); None keeps the model's own
    weights."""

    @classmethod
    def from_pretrained(cls, path: str, batch_size: int = 8,
                        max_len: Optional[int] = None,
                        dtype: str = "bfloat16",
                        window_buckets: Optional[Sequence[int]] = None,
                        registry: MetricsRegistry = REGISTRY,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> "ASRPipeline":
        """Build from a local HF Whisper checkpoint dir
        (`models/hf_convert.load_hf_whisper`), with its tokenizer as the
        detokenizer when the directory has one."""
        from ..models.hf_convert import load_hf_whisper
        from .tokenizer import from_pretrained_dir

        resolve_device(device)  # no card: raise before reading weights
        cfg, params = load_hf_whisper(path)
        cfg = replace(cfg, dtype=dtype)
        detok = None
        try:
            tok = from_pretrained_dir(path)
            if getattr(tok, "decode", None) is not None:
                detok = lambda ids: tok.decode(list(ids))  # noqa: E731
        except Exception:
            logger.info("no tokenizer assets in %s; token-id output only",
                        path)
        return cls(Whisper(cfg), params, batch_size=batch_size,
                   max_len=max_len, detokenize=detok,
                   window_buckets=window_buckets, registry=registry,
                   device=device)

    def __init__(self, model: Whisper, params: Optional[Any] = None,
                 batch_size: int = 8, max_len: Optional[int] = None,
                 detokenize: Optional[Callable[[Sequence[int]], str]] = None,
                 window_buckets: Optional[Sequence[int]] = None,
                 registry: MetricsRegistry = REGISTRY,
                 device: Optional[Union[str, torch.device]] = None):
        from ..models.from_jax import load_whisper_params

        self.device = resolve_device(device)
        if params is not None:
            load_whisper_params(model, params)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.max_len = max_len or model.cfg.n_text_ctx
        self.detokenize = detokenize
        self.sample_rate = SAMPLE_RATE
        self.window_samples = audio_window_samples(model.cfg)
        self.window_buckets = tuple(window_buckets) if window_buckets \
            else default_window_buckets(batch_size)
        self.chunker = AudioChunker(self.window_samples,
                                    buckets=self.window_buckets)
        # Cost rows share the text engine's metric families, told apart
        # by path="asr".
        self.costs = CostModel(registry=registry)
        self.meter = EfficiencyMeter(registry=registry, device=self.device)
        # The ASR dispatch is synchronous (tokens are read back in the same
        # call), so the timeline's busy fraction and bubbles say whether
        # the decode kept the card fed between bucketed batches.
        self.timeline = DeviceTimeline(registry=registry, path="asr")
        self.m_windows = registry.counter(
            "asr_windows_total", "30 s audio windows through Whisper")
        self.m_pad_windows = registry.counter(
            "asr_pad_window_slots_total",
            "wasted window slots (bucket padding)")
        self.m_compile_miss = registry.counter(
            "tpu_engine_compile_cache_misses_total",
            "first dispatches by bucket and path")
        self._lock = threading.Lock()
        self._seen_buckets: set = set()

    def strip_special(self, tokens: Sequence[int]) -> List[int]:
        cfg = self.model.cfg
        special = {cfg.sot_token, cfg.eot_token, cfg.no_timestamps_token,
                   cfg.transcribe_token}
        return [int(t) for t in tokens if int(t) not in special]

    # -- device dispatch ---------------------------------------------------
    def transcribe_audio(self, audio_batch: np.ndarray,
                         real_windows: Optional[int] = None,
                         record: bool = True,
                         max_len: Optional[int] = None) -> np.ndarray:
        """waveforms [B, T] -> token ids [B, L] int32 (one dispatch; L is
        ``max_len``, default the pipeline's).

        ``B`` should be one of ``window_buckets``.  ``real_windows``
        (default B) counts the real windows among them; ``record=False``
        (warmup) keeps the dispatch out of the timeline and the window
        counters."""
        bucket = int(audio_batch.shape[0])
        real = bucket if real_windows is None else int(real_windows)
        with self._lock:
            first = bucket not in self._seen_buckets
            self._seen_buckets.add(bucket)
        if first:
            self.m_compile_miss.labels(bucket=str(bucket),
                                       path="asr").inc()
            self.costs.capture(
                bucket, "asr",
                whisper_forward_flops(self.model.cfg, bucket, self.max_len),
                batch=bucket, seq=self.model.cfg.n_audio_ctx)
        t0 = time.perf_counter()
        with trace.span("asr.transcribe", bucket=bucket, windows=real):
            placed = torch.from_numpy(
                np.ascontiguousarray(audio_batch, np.float32)).to(self.device)
            with torch.inference_mode():
                tokens, steps = transcribe_features_with_steps(
                    self.model, placed, max_len=max_len or self.max_len)
            tokens = tokens.cpu().numpy()
        dt = time.perf_counter() - t0
        if record:  # warmup must not score as busy time
            self.timeline.record(t0, t0 + dt)
            # The cost row prices the full ``max_len`` decode, as the
            # reference's does; the meter is charged the steps that ran,
            # since the decode stops once every row has emitted EOT.
            # Goodput unit: encoder positions, real windows against the
            # dispatched slots.
            ctx = self.model.cfg.n_audio_ctx
            self.meter.record(
                dt, whisper_forward_flops(self.model.cfg, bucket, steps + 1),
                real * ctx, bucket * ctx)
            self.m_windows.inc(real)
            self.m_pad_windows.inc(bucket - real)
        return tokens

    def transcribe_plan(self, plan) -> List[List[int]]:
        """A `media.chunker.ChunkPlan` -> special-stripped token lists,
        one per plan window; one dispatch per `WindowBatch`."""
        per_window: List[List[int]] = [[] for _ in range(plan.n_windows)]
        for wb in self.chunker.batches(plan):
            tokens = self.transcribe_audio(wb.audio,
                                           real_windows=wb.real_windows)
            for row, w in enumerate(wb.window_indices):
                per_window[w] = self.strip_special(tokens[row])
        return per_window

    # -- file front door ---------------------------------------------------
    def transcribe_files(self, paths: Sequence[str]) -> List[ASRResult]:
        """Decode, window, transcribe, reassemble: results in input order,
        a file that fails to decode has ``error`` set and no tokens."""
        plan = self.chunker.chunk_files(paths)
        per_window = self.transcribe_plan(plan)
        per_file = self.chunker.reassemble(plan, per_window)
        counts = plan.windows_per_file()
        results: List[ASRResult] = []
        for i, p in enumerate(paths):
            if i in plan.errors:
                results.append(ASRResult(path=p, error=plan.errors[i]))
                continue
            toks = per_file[i]
            text = self.detokenize(toks) if self.detokenize else ""
            results.append(ASRResult(path=p, tokens=toks, text=text,
                                     windows=counts[i]))
        return results

    # -- serving support (`media/worker.py`) -------------------------------
    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Dispatch every window-count bucket once before serving, with a
        short decode (`WARMUP_DECODE_LEN`): the first call pays the kernel
        build and the allocator's growth."""
        for b in buckets or self.window_buckets:
            audio = np.zeros((int(b), self.window_samples), np.float32)
            self.transcribe_audio(audio, real_windows=0, record=False,
                                  max_len=WARMUP_DECODE_LEN)

    def compile_cache_stats(self) -> Dict[str, Any]:
        """Which buckets were dispatched, and the cumulative
        first-dispatch count."""
        misses: Dict[str, float] = {}
        total = 0.0
        for labels, value in self.m_compile_miss.series():
            if not labels or labels.get("path") != "asr":
                continue
            misses[f"asr:{labels.get('bucket', '?')}"] = value
            total += value
        with self._lock:
            programs = sorted(self._seen_buckets)
        return {"programs_asr": programs, "misses_total": total,
                "misses": misses}

    def efficiency_snapshot(self) -> Dict[str, Any]:
        return self.meter.snapshot()

    def occupancy_snapshot(self) -> Dict[str, Any]:
        """The heartbeat's occupancy map; it also refreshes the
        path="asr" busy/overlap gauges."""
        return self.timeline.snapshot()

    def cost_snapshot(self) -> Dict[str, Any]:
        """The /costs body: the Whisper program rows, the rolling
        efficiency window and the device occupancy."""
        return {
            "model": "whisper",
            "batch_size": self.batch_size,
            "window_buckets": list(self.window_buckets),
            "window_samples": self.window_samples,
            "decode_len": self.max_len,
            "costs": self.costs.snapshot(),
            "efficiency": self.meter.snapshot(),
            "occupancy": self.timeline.snapshot(),
        }

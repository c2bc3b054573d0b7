"""Inference engine: the device half of the worker, in PyTorch.

The counterpart of `distributed_crawler_tpu/inference/engine.py`: tokenize
-> bucket (or pack) -> fused embed+classify on the card -> host results, with
the same `EngineConfig`, the same result dicts, the same metric names and
the one-deep pipeline (batch i+1 is dispatched before batch i is read back).

On CUDA every input goes host -> pinned buffer -> device without blocking,
the outputs come back into fresh pinned buffers without blocking, and a
recorded `torch.cuda.Event` marks when they have landed; the readback waits
on that event only.  The engine runs on ``cuda`` unless the caller passes
``device="cpu"``.

The weights start as the reference's flax-layout tree of f32 numpy arrays —
from a fine-tuned port checkpoint (``checkpoint_dir``, whose head width and
``labels.json`` vocabulary the engine takes, ``label_name`` joining the
results), a local HF checkpoint (``pretrained_dir``), the caller
(``params``), or drawn from a seeded ``torch.Generator`` — then go through
``param_dtype`` and ``quantize`` as the reference's do, and are loaded
last.  Two draws cannot follow JAX's PRNG; each is a module-level function
a test can replace: `init_head` (the head of an encoder-only checkpoint)
and `calibration_probe` (the ids ``int8_static`` calibrates on).

Each (bucket, path) program is priced at its first dispatch
(`utils/costmodel.forward_flops`: the reference's analytic count for a
dense encoder, `moe_forward_flops` for one with experts), and every batch
read back feeds the `EfficiencyMeter` and the `DeviceTimeline` with the
same dispatch-to-host interval; `cost_snapshot()` is the ``/costs`` body.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Set, Union

import numpy as np
import torch

from ..device import DTYPES, resolve_device
from ..models.encoder import (
    E5_BASE,
    E5_LARGE,
    E5_SMALL,
    ClassificationHead,
    EmbedderClassifier,
    EncoderConfig,
    TINY_TEST,
    XLMR_BASE,
    init_weights_,
)
from ..models.from_jax import flax_tree, load_flax_params
from ..models.hf_convert import load_hf_encoder
from ..models.quant import (
    calibrate_activation_scales,
    quantize_encoder_params,
)
from ..ops.padding import (
    DEFAULT_MAX_SEGMENTS_PER_ROW,
    BucketSpec,
    bucket_for,
    pack_batch,
    pack_rows,
)
from ..utils import trace
from ..utils.costmodel import CostModel, EfficiencyMeter, forward_flops
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.occupancy import DeviceTimeline
from .tokenizer import HashingTokenizer, Tokenizer, from_pretrained_dir

MODEL_REGISTRY: Dict[str, EncoderConfig] = {
    "e5_small": E5_SMALL,
    "e5_base": E5_BASE,
    "e5_large": E5_LARGE,
    "xlmr_base": XLMR_BASE,
    "tiny": TINY_TEST,
}

@dataclass(frozen=True)
class EngineConfig:
    model: str = "e5_small"
    n_labels: int = 8
    batch_size: int = 256
    buckets: tuple = (32, 64, 128, 256, 512)
    seed: int = 0
    pretrained_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    param_dtype: Optional[str] = None
    quantize: Optional[str] = None
    # "auto" | "flash" | "xla".  On the card attention is always the CUDA
    # kernel, so "xla" (the plain version) is refused there; only the
    # trainer builds such a model.
    attention: Optional[str] = None
    moe_dispatch: Optional[str] = None
    # Per-row segment bound for packed runs: packed results come back as a
    # static [batch, pack_max_segments] block.
    pack_max_segments: int = DEFAULT_MAX_SEGMENTS_PER_ROW

    def encoder_config(self) -> EncoderConfig:
        try:
            base = MODEL_REGISTRY[self.model]
        except KeyError:
            raise ValueError(
                f"unknown model {self.model!r}; "
                f"one of {sorted(MODEL_REGISTRY)}") from None
        return replace(base, n_labels=self.n_labels)


class InferenceEngine:
    """Tokenize -> bucket -> fused embed+classify on the device -> host
    results.  ``params`` is the reference's flax param tree as numpy arrays
    (`models/from_jax.py`); without it the weights come from
    ``cfg.checkpoint_dir`` (a port checkpoint, `inference/checkpoint.py`),
    ``cfg.pretrained_dir``, or are drawn from a ``torch.Generator`` seeded
    with ``cfg.seed``.  The trainer starts from `training_weights`, the
    same weights in f32 without the model."""

    def __init__(self, cfg: EngineConfig,
                 mesh=None,
                 params: Optional[Any] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 registry: MetricsRegistry = REGISTRY,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError("multi-device serving is not ported yet")
        # Validated before any checkpoint I/O, as the reference does.
        if cfg.attention and cfg.attention not in ("auto", "xla", "flash"):
            raise ValueError(f"unknown attention mode {cfg.attention!r}")
        if cfg.moe_dispatch and cfg.moe_dispatch not in ("dense",
                                                         "capacity"):
            raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
        if cfg.moe_dispatch == "capacity" and cfg.quantize:
            raise ValueError(
                "moe_dispatch='capacity' requires quantize unset — the "
                "int8 expert GEMMs ride dense dispatch")
        if cfg.attention == "xla" and self.device.type == "cuda":
            raise ValueError("attention='xla' selects the plain version, "
                             "which never runs on the card")
        self.ecfg, params, tokenizer = _resolve_weights(cfg, params,
                                                        tokenizer)
        self.label_names: Optional[List[str]] = None
        if cfg.checkpoint_dir:
            # The checkpoint's own head width wins; its hidden size must be
            # the model's.
            params = self._restore_checkpoint(cfg.checkpoint_dir)
            head = params["params"]["cls_head"]
            pooler_in = int(head["pooler"]["kernel"].shape[0])
            if pooler_in != self.ecfg.hidden:
                raise ValueError(
                    f"checkpoint at {cfg.checkpoint_dir} was trained on a "
                    f"hidden={pooler_in} encoder but the engine model "
                    f"{cfg.model!r} has hidden={self.ecfg.hidden}")
            self.ecfg = replace(
                self.ecfg, n_labels=int(head["head"]["bias"].shape[0]))
        self._rows = cfg.batch_size
        self.n_devices = 1
        self.tokenizer = tokenizer or HashingTokenizer(self.ecfg.vocab_size)
        self.bucket_spec = BucketSpec(
            tuple(b for b in cfg.buckets if b <= self.ecfg.max_len))
        # Buckets dispatched so far per path: the first dispatch of each
        # counts as a miss, as the reference counts its jit compiles.
        self._steps: Set[int] = set()
        self._packed_steps: Set[int] = set()
        self.m_latency = registry.histogram(
            "tpu_inference_batch_seconds",
            "batch dispatch->results-on-host latency (pipelined: the "
            "window also spans the NEXT batch's host-side pack/dispatch, "
            "which overlaps this batch's device time)")
        self.m_posts = registry.counter(
            "tpu_inference_posts_total", "posts through embed+classify")
        self.m_padding = registry.counter(
            "tpu_inference_pad_slots_total", "wasted pad slots")
        self.m_packed = registry.counter(
            "tpu_inference_packed_segments_total",
            "sequences served through packed bucket rows")
        self.m_bucket_posts = registry.counter(
            "tpu_inference_bucket_posts_total",
            "posts through embed+classify per padding bucket")
        self.m_compile_miss = registry.counter(
            "tpu_engine_compile_cache_misses_total",
            "first dispatches by bucket and path")
        # Cost rows per (bucket, path), captured at the first dispatch, and
        # the rolling goodput/MFU window fed per device batch with the
        # timeline's interval: the /costs body and the heartbeats'
        # efficiency map.
        self.costs = CostModel(registry=registry)
        self.meter = EfficiencyMeter(registry=registry, device=self.device)
        self.timeline = DeviceTimeline(registry=registry, path="text")
        self.model = self._build_model(params)

    # -- weights -----------------------------------------------------------
    def _build_model(self, params: Optional[Any]) -> EmbedderClassifier:
        """f32 tree -> ``param_dtype`` -> ``quantize`` -> the loaded model,
        in the reference's order (`distributed_crawler_tpu/inference/
        engine.py` ``InferenceEngine.__init__``)."""
        cfg = self.cfg
        tree = params if params is not None else random_tree(self.ecfg,
                                                             cfg.seed)
        embed_dtype = torch.float32
        if cfg.param_dtype:
            # TypeError for a name outside DTYPES, as the reference's
            # ``jnp.dtype(name)`` raises for a name it does not know.
            try:
                embed_dtype = DTYPES[cfg.param_dtype]
            except KeyError:
                raise TypeError(
                    f"param_dtype {cfg.param_dtype!r} not understood; one "
                    f"of {sorted(DTYPES)}") from None
            # The reference casts every f32 leaf; the port rounds each
            # through the dtype and keeps the embedding tables in it (the
            # projections already hold the activation dtype).
            tree = _round_floats(tree, embed_dtype)
        if cfg.quantize:
            if cfg.quantize not in ("int8", "int8_static"):
                raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
            act_scales = None
            if cfg.quantize == "int8_static":
                act_scales = self._calibrate(tree, embed_dtype)
            tree = quantize_encoder_params(tree, act_scales=act_scales)
            self.ecfg = replace(self.ecfg, quant=cfg.quantize)
            self.ecfg.validate()
        return self._load(self.ecfg, tree, embed_dtype)

    def _restore_checkpoint(self, root: str) -> Any:
        """The fine-tuned tree of the newest ``step_N`` under ``root`` (or
        of ``root`` itself), legacy split q/k/v fused, and the label
        vocabulary (``labels.json`` at the root or in the step) when the
        trainer saved one."""
        import json
        import os

        from .checkpoint import latest_step_dir, load_params

        path = latest_step_dir(root) or root
        params = _migrate_split_qkv(load_params(path))
        for cand in (os.path.join(root, "labels.json"),
                     os.path.join(path, "labels.json")):
            if os.path.exists(cand):
                with open(cand, "r", encoding="utf-8") as f:
                    self.label_names = json.load(f)["labels"]
                break
        return params

    @property
    def params(self) -> Dict[str, Any]:
        """The served weights as a flax tree of numpy arrays (exactly the
        loaded f32 values when the model is f32)."""
        return flax_tree(self.model)

    @params.setter
    def params(self, tree: Any) -> None:
        load_flax_params(self.model, tree)

    def _load(self, ecfg: EncoderConfig, tree: Any,
              embed_dtype: torch.dtype) -> EmbedderClassifier:
        # Built on the engine's device: the default initialization that
        # the loaded weights replace runs there, and each weight crosses
        # to the card once.
        with torch.device(self.device):
            model = EmbedderClassifier(ecfg, embed_dtype)
        load_flax_params(model, tree)
        return model.to(self.device).eval()

    def _calibrate(self, tree: Any, embed_dtype: torch.dtype):
        """Per-projection activation abs-max from one float forward, on
        this engine's device, over `calibration_probe`'s ids at the longest
        bucket with every token real."""
        model = self._load(replace(self.ecfg, calibrate=True), tree,
                           embed_dtype)
        ids = calibration_probe(self.ecfg.vocab_size,
                                min(self.cfg.batch_size, 64),
                                self.bucket_spec.lengths[-1],
                                self.cfg.seed + 1)
        ids_t = torch.from_numpy(np.array(ids)).to(self.device)
        with torch.inference_mode():
            return calibrate_activation_scales(
                model, ids_t, torch.ones_like(ids_t, dtype=torch.bool))

    # -- device step -------------------------------------------------------
    def _program(self, bucket: int, path: str) -> None:
        steps = self._packed_steps if path == "packed" else self._steps
        if bucket not in steps:
            self.m_compile_miss.labels(bucket=str(bucket), path=path).inc()
            steps.add(bucket)
            self.costs.capture(bucket, path,
                               forward_flops(self.ecfg, self._rows, bucket),
                               batch=self._rows, seq=bucket)

    def _account(self, t0: float, bucket: int, path: str,
                 real_tokens: int) -> None:
        """One device batch read back: its dispatch-to-host interval into
        the timeline, the latency histogram and the efficiency meter."""
        dt = time.perf_counter() - t0
        self.timeline.record(t0, t0 + dt)
        self.m_latency.observe(dt)
        self.meter.record(dt, self.costs.flops_for(bucket, path),
                          real_tokens, self._rows * bucket)

    def compile_cache_stats(self) -> Dict[str, Any]:
        """Which (bucket, path) programs were dispatched, and the
        cumulative first-dispatch count."""
        misses: Dict[str, float] = {}
        total = 0.0
        for labels, value in self.m_compile_miss.series():
            if not labels:
                continue
            misses[f"{labels['path']}:{labels['bucket']}"] = value
            total += value
        return {
            "programs_unpacked": sorted(self._steps),
            "programs_packed": sorted(self._packed_steps),
            "misses_total": total,
            "misses": misses,
        }

    def cost_snapshot(self) -> Dict[str, Any]:
        """The /costs body: per-(bucket, path) cost rows, the rolling
        efficiency window and the device occupancy."""
        return {
            "model": self.cfg.model,
            "batch_size": self.cfg.batch_size,
            "rows_per_dispatch": self._rows,
            "n_devices": self.n_devices,
            "mesh": None,
            "buckets": list(self.bucket_spec.lengths),
            "costs": self.costs.snapshot(),
            "efficiency": self.meter.snapshot(),
            "occupancy": self.timeline.snapshot(),
        }

    def efficiency_snapshot(self) -> Dict[str, Any]:
        """Rolling MFU/goodput map for heartbeats; {} before the first
        batch."""
        return self.meter.snapshot()

    def occupancy_snapshot(self) -> Dict[str, Any]:
        """Device-occupancy map for heartbeats; it also refreshes the
        busy/overlap gauges between scrapes."""
        return self.timeline.snapshot()

    def _place(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Host arrays -> device tensors; on CUDA through pinned buffers
        without blocking (the caching host allocator keeps each buffer
        until its copy has completed)."""
        placed = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            placed.append(t)
        return placed

    def _dispatch(self, placed: Sequence[torch.Tensor], **kw):
        """Run the model on one placed batch without waiting for it:
        returns (emb, logits, event), host tensors that are valid once
        ``event`` (None on the CPU) has completed."""
        extra = dict(zip(("segment_ids", "positions"), placed[2:]))
        with torch.inference_mode():
            emb, logits = self.model(placed[0], placed[1], **extra, **kw)
            if self.device.type != "cuda":
                return emb, logits, None
            out = []
            for t in (emb, logits):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                out.append(host)
            event = torch.cuda.Event()
            event.record()
        return out[0], out[1], event

    @staticmethod
    def _readback(emb: torch.Tensor, logits: torch.Tensor, event):
        if event is not None:
            event.synchronize()
        return emb.numpy(), logits.numpy()

    # -- public API --------------------------------------------------------
    def run_tokenized(self, token_lists: Sequence[List[int]],
                      pack: bool = False) -> List[Dict[str, Any]]:
        """Embed+classify pre-tokenized sequences; results in input order.

        One-deep pipeline: batch i+1 is packed and dispatched before batch
        i's results are read back, so the host's packing overlaps the
        device's compute.  ``pack=True`` shares bucket rows between short
        sequences behind segment masks."""
        with trace.span("engine.run_tokenized",
                        sequences=len(token_lists), pack=bool(pack)):
            if any(not t for t in token_lists):
                return self._run_with_empties(token_lists, pack)
            if pack:
                return self._run_packed(token_lists)
            return self._run_unpacked(token_lists)

    def _groups(self, token_lists: Sequence[List[int]]
                ) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for i, toks in enumerate(token_lists):
            groups.setdefault(
                bucket_for(len(toks), self.bucket_spec), []).append(i)
        return groups

    def _result(self, emb_row: np.ndarray, logits_row: np.ndarray,
                scores_row: np.ndarray) -> Dict[str, Any]:
        label = int(np.argmax(logits_row))
        out = {
            "embedding": emb_row.tolist(),
            "label": label,
            "scores": scores_row.tolist(),
        }
        if self.label_names and label < len(self.label_names):
            out["label_name"] = self.label_names[label]
        return out

    def _run_unpacked(self, token_lists: Sequence[List[int]]
                      ) -> List[Dict[str, Any]]:
        results: List[Optional[Dict[str, Any]]] = [None] * len(token_lists)
        rows = self._rows
        pending: Optional[tuple] = None  # (chunk, emb, logits, event, t0,
        #                                  bucket, real_tokens)

        def materialize(chunk, emb, logits, event, t0, bucket, real_tokens):
            with trace.span("engine.unpack", rows=len(chunk)):
                emb_np, logits_np = self._readback(emb, logits, event)
                self._account(t0, bucket, "unpacked", real_tokens)
                self.m_posts.inc(len(chunk))
                self.m_padding.inc(rows - len(chunk))
                scores = _softmax_np(logits_np)
                for row, i in enumerate(chunk):
                    results[i] = self._result(emb_np[row], logits_np[row],
                                              scores[row])

        for bucket, indices in sorted(self._groups(token_lists).items()):
            for start in range(0, len(indices), rows):
                chunk = indices[start:start + rows]
                self.m_bucket_posts.labels(bucket=str(bucket)).inc(len(chunk))
                with trace.span("engine.pack", bucket=bucket,
                                rows=len(chunk)):
                    ids, mask = pack_batch(
                        [token_lists[i] for i in chunk],
                        BucketSpec((bucket,)), batch_pad_to=rows)
                real_tokens = int(mask.sum())
                with trace.span("engine.device_put", bucket=bucket):
                    placed = self._place((ids, mask))
                self._program(bucket, "unpacked")
                t0 = time.perf_counter()
                with trace.span("engine.compute", bucket=bucket, batch=rows,
                                sequences=len(chunk)):
                    emb, logits, event = self._dispatch(placed)
                if pending is not None:
                    materialize(*pending)
                pending = (chunk, emb, logits, event, t0, bucket,
                           real_tokens)
        if pending is not None:
            materialize(*pending)
        return results  # type: ignore[return-value]

    def _run_with_empties(self, token_lists: Sequence[List[int]],
                          pack: bool) -> List[Dict[str, Any]]:
        """Canonical host-side result for EMPTY token lists, identical in
        both paths: zero embedding, uniform scores, label 0."""
        sub = [t for t in token_lists if t]
        it = iter(self.run_tokenized(sub, pack=pack) if sub else [])
        uniform = [1.0 / self.ecfg.n_labels] * self.ecfg.n_labels
        out: List[Dict[str, Any]] = []
        for t in token_lists:
            if t:
                out.append(next(it))
                continue
            r: Dict[str, Any] = {"embedding": [0.0] * self.ecfg.hidden,
                                 "label": 0, "scores": list(uniform)}
            if self.label_names:
                r["label_name"] = self.label_names[0]
            out.append(r)
        return out

    def _run_packed(self, token_lists: Sequence[List[int]]
                    ) -> List[Dict[str, Any]]:
        """Packed twin of the dispatch loop: per bucket, first-fit-pack the
        sequences into shared rows, run the static [batch, bucket] shapes
        (plus segment ids and positions) through the one-deep pipeline, and
        fan per-segment results back to input order."""
        results: List[Optional[Dict[str, Any]]] = [None] * len(token_lists)
        rows = self._rows
        n_seg = self.cfg.pack_max_segments
        pending: Optional[tuple] = None  # (slots, used, emb, logits, event,
        #                                  t0, bucket, real_tokens)

        def materialize(slots, used_rows, emb, logits, event, t0, bucket,
                        real_tokens):
            with trace.span("engine.unpack", segments=len(slots),
                            rows=used_rows):
                emb_np, logits_np = self._readback(emb, logits, event)
                self._account(t0, bucket, "packed", real_tokens)
                self.m_posts.inc(len(slots))
                self.m_packed.inc(len(slots))
                self.m_padding.inc(rows - used_rows)
                flat = logits_np.reshape(-1, logits_np.shape[-1])
                scores = _softmax_np(flat).reshape(logits_np.shape)
                for row, slot, i in slots:
                    results[i] = self._result(emb_np[row, slot],
                                              logits_np[row, slot],
                                              scores[row, slot])

        for bucket, indices in sorted(self._groups(token_lists).items()):
            self.m_bucket_posts.labels(bucket=str(bucket)).inc(len(indices))
            with trace.span("engine.pack", bucket=bucket,
                            sequences=len(indices), packed=True):
                packed = pack_rows([token_lists[i] for i in indices], bucket,
                                   max_segments=n_seg, indices=indices)
            for start in range(0, packed.n_rows, rows):
                end = min(start + rows, packed.n_rows)
                used = end - start
                arrays = [packed.ids[start:end], packed.mask[start:end],
                          packed.segment_ids[start:end],
                          packed.positions[start:end]]
                if used < rows:
                    # All-pad filler rows (segment id 0) keep the batch
                    # shape static; no slot maps to them.
                    arrays = [np.pad(a, ((0, rows - used), (0, 0)))
                              for a in arrays]
                slots = [(r - start, s, orig)
                         for r in range(start, end)
                         for s, orig in enumerate(packed.assignments[r])]
                real_tokens = int(arrays[1].sum())
                with trace.span("engine.device_put", bucket=bucket,
                                packed=True):
                    placed = self._place(arrays)
                self._program(bucket, "packed")
                t0 = time.perf_counter()
                with trace.span("engine.compute", bucket=bucket, batch=rows,
                                segments=len(slots), packed=True):
                    emb, logits, event = self._dispatch(
                        placed, n_segments=n_seg)
                if pending is not None:
                    materialize(*pending)
                pending = (slots, used, emb, logits, event, t0, bucket,
                           real_tokens)
        if pending is not None:
            materialize(*pending)
        return results  # type: ignore[return-value]

    def run(self, texts: Sequence[str],
            pack: bool = False) -> List[Dict[str, Any]]:
        with trace.span("engine.run", texts=len(texts), pack=bool(pack)):
            with trace.span("engine.tokenize", texts=len(texts)):
                toks = self.tokenizer.encode_batch(texts)
            return self.run_tokenized(toks, pack=pack)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = self.run(texts)
        return np.asarray([r["embedding"] for r in out], dtype=np.float32)

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               pack: Optional[bool] = None) -> None:
        """Dispatch every (bucket, path) once before serving: the first
        call of each pays the kernel build and the allocator's growth.
        ``pack``: True = packed path, False = unpacked, None = both."""
        modes = (False, True) if pack is None else (bool(pack),)
        for b in buckets or self.bucket_spec.lengths:
            toks = ([[1, 2, 3]] * min(2, self.cfg.batch_size)
                    if b == self.bucket_spec.lengths[0]
                    else [[1] * (b - 1)])
            for m in modes:
                self.run_tokenized(toks, pack=m)
        # The cost rows stay; the warmup's intervals leave the occupancy
        # and efficiency windows, which start clean for live serving.
        self.timeline.reset()
        self.meter.reset()


def random_tree(ecfg: EncoderConfig, seed: int) -> Dict[str, Any]:
    """Seeded random weights as an f32 flax-layout tree: the reference's
    distributions (`EmbedderClassifier.init_weights`), drawn from
    ``torch.Generator(seed)``, not from JAX's PRNG."""
    model = EmbedderClassifier(replace(ecfg, dtype="float32", quant="none",
                                       calibrate=False))
    model.init_weights(torch.Generator().manual_seed(seed))
    return flax_tree(model)


def init_head(ecfg: EncoderConfig, seed: int) -> Dict[str, Any]:
    """A fresh ``cls_head`` subtree for an encoder-only checkpoint (E5).
    The reference draws it from ``jax.random.PRNGKey(seed)``; the port
    from ``torch.Generator(seed)``, with the same distributions."""
    head = ClassificationHead(ecfg)
    init_weights_(head, torch.Generator().manual_seed(seed))
    return {name: {"kernel": np.ascontiguousarray(d.weight.detach().T.numpy()),
                   "bias": d.bias.detach().numpy().copy()}
            for name, d in (("pooler", head.pooler), ("head", head.head))}


def calibration_probe(vocab_size: int, rows: int, length: int,
                      seed: int) -> np.ndarray:
    """The token ids ``int8_static`` calibrates on: uniform in
    [0, vocab_size).  The reference draws them with
    ``jax.random.randint(PRNGKey(seed), ...)``; the port from
    ``torch.Generator(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab_size, (rows, length), generator=gen,
                         dtype=torch.int32).numpy()


def _round_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Every f32 leaf rounded through ``dtype`` (kept as f32 numpy)."""
    if isinstance(tree, dict):
        return {k: _round_floats(v, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype != np.float32:
        return tree
    return torch.from_numpy(np.array(a)).to(dtype).float().numpy()


def _resolve_weights(cfg: EngineConfig, params: Optional[Any],
                     tokenizer: Optional[Tokenizer],
                     dtype: Optional[str] = None):
    """(encoder config, params or None for `random_tree`'s, tokenizer or
    None) of an engine built from ``cfg``, before any checkpoint restore,
    cast or quantize; ``dtype`` replaces the activation dtype."""
    if cfg.pretrained_dir:
        ecfg, params, tokenizer = _load_pretrained(cfg, params, tokenizer)
    else:
        ecfg = cfg.encoder_config()
    if cfg.attention:
        ecfg = replace(ecfg, attention=cfg.attention)
    if cfg.moe_dispatch:
        ecfg = replace(ecfg, moe_dispatch=cfg.moe_dispatch)
    if dtype:
        ecfg = replace(ecfg, dtype=dtype)
    return ecfg, params, tokenizer


def training_weights(cfg: EngineConfig,
                     device: Optional[Union[str, torch.device]] = None):
    """train-head's starting point, ``(encoder config, params, tokenizer,
    device)``: the f32 weights an engine built from ``cfg`` would load
    (the checkpoint's as read, or `random_tree`'s) with the activation
    dtype f32, without building the engine's model (the trainer builds
    its own).  ``cfg`` sets no cast, quantize or checkpoint restore."""
    if cfg.param_dtype or cfg.quantize or cfg.checkpoint_dir:
        raise ValueError("training_weights: the config casts, quantizes "
                         "or restores a checkpoint")
    dev = resolve_device(device)
    ecfg, params, tokenizer = _resolve_weights(cfg, None, None, "float32")
    if params is None:
        params = random_tree(ecfg, cfg.seed)
    return ecfg, params, tokenizer or HashingTokenizer(ecfg.vocab_size), dev


def _load_pretrained(cfg: EngineConfig, params: Optional[Any],
                     tokenizer: Optional[Tokenizer]):
    """(ecfg, params, tokenizer) from a local HF checkpoint dir.

    A classification checkpoint loads whole, its head's width setting
    ``n_labels``; an encoder-only one (E5) gets a fresh head from
    `init_head`.  Caller-given params and tokenizer win.  Without a usable
    tokenizer in the dir the engine falls back to `HashingTokenizer` and
    says so."""
    path = cfg.pretrained_dir
    try:
        ecfg, loaded = load_hf_encoder(path, arch="embedder_classifier",
                                       n_labels=None)
    except ValueError:
        ecfg, loaded = load_hf_encoder(path, arch="embedder",
                                       n_labels=cfg.n_labels)
        loaded = {"params": {**loaded["params"],
                             "cls_head": init_head(ecfg, cfg.seed)}}
    if params is None:
        params = loaded
    if tokenizer is None:
        try:
            tokenizer = from_pretrained_dir(path)
        except Exception as e:
            # Serving real weights over hashed ids silently would be
            # garbage: make the downgrade visible.
            logging.getLogger(__name__).warning(
                "no usable tokenizer in %s (%s); falling back to "
                "HashingTokenizer", path, e)
            tokenizer = None
    return ecfg, params, tokenizer


def _migrate_split_qkv(params: Any) -> Any:
    """Fuse legacy per-projection attention params on checkpoint load:
    ``attn/{q,k,v}`` trees become ``qkv/kernel`` [h, 3, h] and
    ``qkv/bias`` [3, h], as the reference's engine does."""
    enc = params.get("params", {}).get("encoder")
    if not isinstance(enc, dict):
        return params
    for name, layer in enc.items():
        if not name.startswith("layers_") or "attn" not in layer:
            continue
        attn = layer["attn"]
        if "qkv/kernel" in attn or "q" not in attn:
            continue
        q, k, v = attn.pop("q"), attn.pop("k"), attn.pop("v")
        attn["qkv/kernel"] = np.stack(
            [np.asarray(q["kernel"]), np.asarray(k["kernel"]),
             np.asarray(v["kernel"])], axis=1)
        attn["qkv/bias"] = np.stack(
            [np.asarray(q["bias"]), np.asarray(k["bias"]),
             np.asarray(v["bias"])], axis=0)
    return params


def _softmax_np(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)

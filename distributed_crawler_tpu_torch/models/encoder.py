"""Transformer text encoder: the E5/XLM-R family, dense path, in PyTorch.

The counterpart of `distributed_crawler_tpu/models/encoder.py`, with the
same config fields, published presets, module names and numerics:

- dense projections (``qkv``, ``attn_out``, ``mlp_up``, ``mlp_down``) hold
  their weights in the activation dtype (bf16 for the E5/XLM-R presets) and
  add their bias in that dtype — the reference keeps f32 params and casts
  them to bf16 on every call, which gives the same numbers;
- with ``quant="int8"`` / ``"int8_static"`` they are `QuantDense` (and the
  int8 fused QKV): int8 ``[out, in]`` weights, per-channel f32 scales, an
  f32 bias added before the cast (`ops/quant.py`);
- embeddings, LayerNorms and the classifier head stay f32 (the embedding
  tables may be held in a narrower ``embed_dtype``, as the reference's
  ``param_dtype`` casts them);
- post-LN like BERT, with residual adds in f32;
- attention through `ops.mha`: the hand-written CUDA kernel for a CUDA
  tensor, the plain version for a CPU tensor;
- no dynamic shapes: padding masks, and for packed rows ``segment_ids`` and
  within-segment ``positions``.

With ``calibrate=True`` each projection records its input's abs-max (f32)
in its module's ``absmax`` dict, which `models/quant.
calibrate_activation_scales` reads.  Switch-MoE (``n_experts > 0``) waits
for a later slice and raises ``NotImplementedError``.  ``remat`` is a
training flag; inference accepts and ignores it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import torch_dtype
from ..ops.attention import mha
from ..ops.quant import int8_dense, int8_qkv


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250002          # XLM-R sentencepiece vocab
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    n_labels: int = 2                 # classifier head width
    n_experts: int = 0                # 0 = dense MLP; >0 = switch MoE
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"           # activation dtype
    attention: str = "auto"           # auto | xla | flash
    remat: bool = False               # training only; ignored here
    quant: str = "none"
    calibrate: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def validate(self) -> None:
        if self.hidden % self.n_heads != 0:
            raise ValueError(
                f"hidden {self.hidden} not divisible by heads {self.n_heads}")
        if self.quant not in ("none", "int8", "int8_static"):
            raise ValueError(f"unknown quant mode {self.quant!r}")
        if self.moe_dispatch not in ("dense", "capacity"):
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}")
        if self.moe_dispatch == "capacity" and self.quant != "none":
            raise ValueError(
                "moe_dispatch='capacity' requires quant='none' — the "
                "int8 expert GEMMs' per-expert quantized layout can't "
                "host the pack/unpack matmuls; use dense dispatch")
        if self.calibrate and self.quant != "none":
            raise ValueError("calibrate requires the float path "
                             "(quant='none')")
        if self.attention not in ("auto", "xla", "flash"):
            raise ValueError(f"unknown attention mode {self.attention!r}")
        if self.n_experts:
            raise NotImplementedError("Switch-MoE is not ported yet")

    @property
    def quantized(self) -> bool:
        return self.quant in ("int8", "int8_static")


# Published configs (sizes match the HF checkpoints these mirror).
E5_SMALL = EncoderConfig(vocab_size=250037, hidden=384, n_layers=12,
                         n_heads=12, mlp_dim=1536)
E5_BASE = EncoderConfig(vocab_size=250037, hidden=768, n_layers=12,
                        n_heads=12, mlp_dim=3072)
E5_LARGE = EncoderConfig(vocab_size=250037, hidden=1024, n_layers=24,
                         n_heads=16, mlp_dim=4096)
XLMR_BASE = EncoderConfig(vocab_size=250002, hidden=768, n_layers=12,
                          n_heads=12, mlp_dim=3072)
# Tiny config for tests.
TINY_TEST = EncoderConfig(vocab_size=1024, hidden=64, n_layers=2, n_heads=4,
                          mlp_dim=128, max_len=128, dtype="float32")


class Dense(nn.Linear):
    """flax ``nn.Dense`` twin: ``x @ W.T`` in the weight's dtype, then the
    bias (if any) added in that dtype (not fused into the product)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias


class QuantDense(nn.Module):
    """Int8 twin of `Dense` (serving only): buffers ``kernel_q`` int8
    ``[out, in]``, ``scale`` f32 ``[out]``, ``bias`` f32 ``[out]`` and, under
    ``int8_static``, the calibrated scalar ``a_scale``.  Filled from a
    quantized tree (`models/quant.quantize_encoder_params`), never
    trained; the zeros and ones here only give the shapes."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: EncoderConfig, out_shape: Optional[tuple] = None):
        super().__init__()
        self.cfg = cfg
        out_shape = out_shape or (out_features,)
        self.register_buffer("kernel_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_shape))
        self.register_buffer("bias", torch.zeros(out_shape))
        self.register_buffer("a_scale", torch.ones(())
                             if cfg.quant == "int8_static" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.kernel_q, self.scale, self.bias,
                          out_dtype=self.cfg.adtype, a_scale=self.a_scale)


class QuantQKV(QuantDense):
    """The int8 fused QKV: ``kernel_q`` ``[3h, h]`` (q/k/v major), ``scale``
    and ``bias`` ``[3, h]``; the output is a fresh contiguous
    ``[b, l, 3, h]`` whose q/k/v views the attention kernel takes as the
    float path's."""

    def __init__(self, cfg: EncoderConfig):
        h = cfg.hidden
        super().__init__(h, 3 * h, cfg, out_shape=(3, h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_qkv(x, self.kernel_q, self.scale, self.bias,
                        out_dtype=self.cfg.adtype, a_scale=self.a_scale)


def _proj(cfg: EncoderConfig, in_features: int,
          out_features: int) -> nn.Module:
    """A projection: `Dense` in the activation dtype, or its int8 twin."""
    if cfg.quantized:
        return QuantDense(in_features, out_features, cfg)
    return Dense(in_features, out_features, dtype=cfg.adtype)


class _Calibrated(nn.Module):
    """Holder of the calibration hook: with ``cfg.calibrate`` each
    projection's input abs-max (f32, max over calls) lands in
    ``self.absmax["<projection>_in"]``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.absmax: Dict[str, torch.Tensor] = {}

    def _record(self, name: str, x: torch.Tensor) -> None:
        if not self.cfg.calibrate:
            return
        key = f"{name}_in"
        cur = torch.amax(torch.abs(x)).to(torch.float32)
        prev = self.absmax.get(key)
        self.absmax[key] = cur if prev is None else torch.maximum(prev, cur)


class SelfAttention(_Calibrated):
    def __init__(self, cfg: EncoderConfig):
        super().__init__(cfg)
        h = cfg.hidden
        # Fused QKV: one [h, 3h] product.  Output columns are q/k/v major
        # (the reference's [h, 3, h] kernel reshaped), so the result views
        # as [b, l, 3, heads, head_dim] and q/k/v are strided views of it.
        self.qkv = (QuantQKV(cfg) if cfg.quantized
                    else Dense(h, 3 * h, dtype=cfg.adtype))
        self.attn_out = _proj(cfg, h, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        self._record("qkv", x)
        proj = self.qkv(x).view(b, l, 3, cfg.n_heads, cfg.head_dim)
        o = mha(proj[:, :, 0], proj[:, :, 1], proj[:, :, 2], kv_mask=mask,
                segment_ids=segment_ids)
        o = o.reshape(b, l, cfg.hidden)
        self._record("attn_out", o)
        return self.attn_out(o)


class DenseMLP(_Calibrated):
    def __init__(self, cfg: EncoderConfig):
        super().__init__(cfg)
        self.mlp_up = _proj(cfg, cfg.hidden, cfg.mlp_dim)
        self.mlp_down = _proj(cfg, cfg.mlp_dim, cfg.hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._record("mlp_up", x)
        # Exact (erf) GELU, as the reference's dense MLP.
        h = F.gelu(self.mlp_up(x), approximate="none")
        self._record("mlp_down", h)
        return self.mlp_down(h)


def _layer_norm(cfg: EncoderConfig) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps,
                        dtype=torch.float32)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = SelfAttention(cfg)
        self.ln_attn = _layer_norm(cfg)
        self.mlp = DenseMLP(cfg)
        self.ln_mlp = _layer_norm(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        adtype = self.cfg.adtype
        a = self.attn(x, mask, segment_ids)
        x = self.ln_attn(x.float() + a.float()).to(adtype)
        m = self.mlp(x)
        return self.ln_mlp(x.float() + m.float()).to(adtype)


class Encoder(nn.Module):
    """ids [B, L] int, mask [B, L] bool/int -> hidden [B, L, H] (cfg dtype).

    Packed rows also pass ``segment_ids`` [B, L] int32 (attention confined
    per segment) and ``positions`` [B, L] int32 (within-segment offsets).
    ``embed_dtype`` is the dtype of the two embedding tables, whose sum is
    taken in it (the reference adds bf16 tables in bf16 under
    ``param_dtype="bfloat16"``); LayerNorm then runs in f32."""

    def __init__(self, cfg: EncoderConfig,
                 embed_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden, dtype=embed_dtype))
        self.embed_positions = nn.Parameter(
            torch.empty(cfg.max_len, cfg.hidden, dtype=embed_dtype))
        self.ln_embed = _layer_norm(cfg)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.n_layers))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        l = ids.shape[1]
        if positions is not None:
            pos = F.embedding(positions, self.embed_positions)
        else:
            pos = self.embed_positions[:l][None, :, :]
        x = F.embedding(ids, self.embed_tokens) + pos
        x = self.ln_embed(x.float()).to(self.cfg.adtype)
        # The kernel takes per-token int32 vectors: convert once, not per
        # layer.
        mask = mask.to(torch.int32)
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32)
        for layer in self.layers:
            x = layer(x, mask, segment_ids)
        return x


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over seq (E5 pooling), f32 accumulation."""
    m = mask[..., None].float()
    summed = torch.sum(hidden.float() * m, dim=1)
    count = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return summed / count


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def _segment_onehot(mask: torch.Tensor, segment_ids: torch.Tensor,
                    n_segments: int) -> torch.Tensor:
    """[B, L, S] f32 membership: token l of row b belongs to segment s+1."""
    seg_range = torch.arange(1, n_segments + 1, dtype=segment_ids.dtype,
                             device=segment_ids.device)
    sel = segment_ids[:, :, None] == seg_range[None, None]
    return (sel & mask.bool()[:, :, None]).float()


def segment_mean_pool(hidden: torch.Tensor, mask: torch.Tensor,
                      segment_ids: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    """Per-segment masked mean over packed rows: [B, L, H] -> [B, S, H];
    empty slots pool to zero (count clamped to 1)."""
    sel = _segment_onehot(mask, segment_ids, n_segments)
    summed = torch.einsum("blh,bls->bsh", hidden.float(), sel)
    count = torch.clamp(torch.sum(sel, dim=1), min=1.0)
    return summed / count[..., None]


def segment_first_token(hidden: torch.Tensor, mask: torch.Tensor,
                        segment_ids: torch.Tensor,
                        n_segments: int) -> torch.Tensor:
    """Each segment's first-token state: [B, L, H] -> [B, S, H]; empty
    slots come out zero."""
    sel = _segment_onehot(mask, segment_ids, n_segments)
    first = sel * (torch.cumsum(sel, dim=1) == 1.0)
    return torch.einsum("blh,bls->bsh", hidden.float(), first)


class ClassificationHead(nn.Module):
    """XLM-R-style head: first-token state -> tanh dense -> logits (f32)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.pooler = Dense(cfg.hidden, cfg.hidden, dtype=torch.float32)
        self.head = Dense(cfg.hidden, cfg.n_labels, dtype=torch.float32)

    def forward(self, cls_state: torch.Tensor) -> torch.Tensor:
        return self.head(torch.tanh(self.pooler(cls_state.float())))


class EmbedderClassifier(nn.Module):
    """Fused single-pass embed+classify.

    Unpacked: emb [B, H] (L2-normalized masked mean), logits [B, n_labels]
    from the first token.  Packed (``segment_ids``/``positions``,
    ``n_segments`` > 0): per-segment emb [B, S, H] and logits
    [B, S, n_labels], each segment pooled over its own tokens and
    classified from its own first token.  One set of weights serves both."""

    def __init__(self, cfg: EncoderConfig,
                 embed_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, embed_dtype)
        self.cls_head = ClassificationHead(cfg)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                n_segments: int = 0):
        hidden = self.encoder(ids, mask, segment_ids, positions)
        if segment_ids is None:
            emb = l2_normalize(mean_pool(hidden, mask))
            return emb, self.cls_head(hidden[:, 0, :])
        if n_segments <= 0:
            raise ValueError("packed mode requires n_segments > 0")
        emb = l2_normalize(
            segment_mean_pool(hidden, mask, segment_ids, n_segments))
        cls_states = segment_first_token(hidden, mask, segment_ids,
                                         n_segments)
        return emb, self.cls_head(cls_states)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator`` with the reference's
        distributions: normal(0.02) embeddings, fan-in truncated normal for
        every dense kernel (flax's ``lecun_normal`` and the qkv
        ``variance_scaling``), zero biases, unit LayerNorm scales.  Draws
        are f32 on the generator's device, then cast."""
        enc = self.encoder
        for p in (enc.embed_tokens, enc.embed_positions):
            _fill(p, generator,
                  lambda t: t.normal_(0.0, 0.02, generator=generator))
        init_weights_(self, generator)


def _fill(param: torch.Tensor, generator: torch.Generator, draw) -> None:
    tmp = torch.empty(param.shape, dtype=torch.float32,
                      device=generator.device)
    draw(tmp)
    param.copy_(tmp)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """The LayerNorms and `Dense` layers under ``module``, in module order:
    unit scales and zero biases; fan-in truncated normal kernels on
    [-2σ, 2σ], σ corrected for the truncation (jax's variance_scaling
    constant), zero biases."""
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Dense):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            _fill(m.weight, generator, lambda t: nn.init.trunc_normal_(
                t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))
            m.bias.zero_()

"""Transformer text encoder: the E5/XLM-R family, dense path, in PyTorch.

The counterpart of `distributed_crawler_tpu/models/encoder.py`, with the
same config fields, published presets, module names and numerics:

- dense projections (``qkv``, ``attn_out``, ``mlp_up``, ``mlp_down``) hold
  their weights in the activation dtype (bf16 for the E5/XLM-R presets) and
  add their bias in that dtype — the reference keeps f32 params and casts
  them to bf16 on every call, which gives the same numbers;
- embeddings, LayerNorms and the classifier head stay f32;
- post-LN like BERT, with residual adds in f32;
- attention through `ops.mha`: the hand-written CUDA kernel for a CUDA
  tensor, the plain version for a CPU tensor;
- no dynamic shapes: padding masks, and for packed rows ``segment_ids`` and
  within-segment ``positions``.

Switch-MoE (``n_experts > 0``), int8 (``quant != "none"``) and calibration
wait for later slices and raise ``NotImplementedError``.  ``remat`` is a
training flag; inference accepts and ignores it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import torch_dtype
from ..ops.attention import mha


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
        if self.attention not in ("auto", "xla", "flash"):
            raise ValueError(f"unknown attention mode {self.attention!r}")
        if self.n_experts:
            raise NotImplementedError("Switch-MoE is not ported yet")
        if self.quant != "none":
            raise NotImplementedError("int8 serving is not ported yet")
        if self.calibrate:
            raise NotImplementedError("calibration is not ported yet")


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
    bias added in that dtype (not fused into the product)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight) + self.bias


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        # Fused QKV: one [h, 3h] product.  Output columns are q/k/v major
        # (the reference's [h, 3, h] kernel reshaped), so the result views
        # as [b, l, 3, heads, head_dim] and q/k/v are strided views of it.
        self.qkv = Dense(h, 3 * h, dtype=cfg.adtype)
        self.attn_out = Dense(h, h, dtype=cfg.adtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        proj = self.qkv(x).view(b, l, 3, cfg.n_heads, cfg.head_dim)
        o = mha(proj[:, :, 0], proj[:, :, 1], proj[:, :, 2], kv_mask=mask,
                segment_ids=segment_ids)
        return self.attn_out(o.reshape(b, l, cfg.hidden))


class DenseMLP(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.mlp_up = Dense(cfg.hidden, cfg.mlp_dim, dtype=cfg.adtype)
        self.mlp_down = Dense(cfg.mlp_dim, cfg.hidden, dtype=cfg.adtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Exact (erf) GELU, as the reference's dense MLP.
        return self.mlp_down(F.gelu(self.mlp_up(x), approximate="none"))


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
    per segment) and ``positions`` [B, L] int32 (within-segment offsets)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden, dtype=torch.float32))
        self.embed_positions = nn.Parameter(
            torch.empty(cfg.max_len, cfg.hidden, dtype=torch.float32))
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
        x = self.ln_embed(x).to(self.cfg.adtype)
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

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
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
        def fill(param: torch.Tensor, draw) -> None:
            tmp = torch.empty(param.shape, dtype=torch.float32,
                              device=generator.device)
            draw(tmp)
            param.copy_(tmp)

        enc = self.encoder
        for p in (enc.embed_tokens, enc.embed_positions):
            fill(p, lambda t: t.normal_(0.0, 0.02, generator=generator))
        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, Dense):
                # fan_in truncated normal on [-2σ, 2σ], σ corrected for
                # the truncation (jax's variance_scaling constant).
                std = math.sqrt(1.0 / module.in_features) \
                    / 0.87962566103423978
                fill(module.weight, lambda t: nn.init.trunc_normal_(
                    t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))
                module.bias.zero_()

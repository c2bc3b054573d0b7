"""Transformer text encoder: the E5/XLM-R family, in PyTorch.

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
- with ``n_experts > 0`` each layer's MLP is a top-1 Switch-MoE
  (`SwitchMoE`): an f32 router, tanh-GELU experts, dense or capacity
  dispatch, and int8 experts on the dense dispatch;
- attention through `ops.mha`: the hand-written CUDA kernel for a CUDA
  tensor, the plain version for a CPU tensor;
- no dynamic shapes: padding masks, and for packed rows ``segment_ids`` and
  within-segment ``positions``.

With ``calibrate=True`` each projection records its input's abs-max (f32)
in its module's ``absmax`` dict, which `models/quant.
calibrate_activation_scales` reads (a MoE layer's experts record nothing,
as in the reference: they stay dynamic under ``int8_static``).

Training (`models/train.py`, `models/lora.py`) adds three things, none of
which inference pays for: ``Encoder.forward(..., with_aux=True)`` also
returns the Switch-MoE load-balancing loss summed over layers (the
reference sows it into its ``losses`` collection), computed per call and
kept in no module state; ``remat=True`` recomputes each layer in the
backward pass (`torch.utils.checkpoint`, non-reentrant) when gradients are
being recorded, as the reference's ``nn.remat`` does; and `Classifier`,
the reference's encoder -> head model the train step differentiates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..device import torch_dtype
from ..ops.attention import mha
from ..ops.quant import (
    int8_dense,
    int8_experts_down,
    int8_experts_up,
    int8_qkv,
)


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
    remat: bool = False               # recompute each layer in backward
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
                segment_ids=segment_ids, attention=cfg.attention)
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


class SwitchMoE(nn.Module):
    """Top-1 switch MLP (the reference's ``SwitchMoE``), dispatch by
    ``cfg.moe_dispatch``:

    - ``router``: an f32 `Dense` ``[E, h]`` with bias on the f32 input;
      softmax, then ``argmax`` (the first index wins ties, as in
      ``jnp.argmax``);
    - experts: tanh GELU; ``experts_up`` ``[E, m, h]`` and ``experts_down``
      ``[E, h, m]`` in the activation dtype, each expert ``[out, in]`` as
      `Dense` holds its weight (the reference's kernels are ``[E, in,
      out]``).  Under int8 they are ``*_q`` int8 buffers of the same
      layout with per-(expert, output channel) f32 scales ``[E, m]`` and
      ``[E, h]``;
    - the output is scaled by the chosen expert's router probability, cast
      to the activation dtype before the product.

    ``"dense"`` runs every expert on every token, then takes the chosen
    one's output: one ``[N, h] x [h, E*m]`` product up, one product per
    expert down (batched), an exact gather.  ``"capacity"`` packs each
    group of ``_GROUP`` tokens into ``cap = ceil(g / E * cf)`` slots per
    expert in arrival order; tokens past capacity, and tokens with mask 0,
    contribute zero.  The reference packs and unpacks with one-hot
    products; here a scatter packs and a gather unpacks, which selects the
    same values exactly."""

    _GROUP = 4096

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        e, h, m = cfg.n_experts, cfg.hidden, cfg.mlp_dim
        self.router = Dense(h, e, dtype=torch.float32)
        if cfg.quantized:
            self.register_buffer("experts_up_q", torch.zeros(
                e, m, h, dtype=torch.int8))
            self.register_buffer("experts_up_scale", torch.ones(e, m))
            self.register_buffer("experts_down_q", torch.zeros(
                e, h, m, dtype=torch.int8))
            self.register_buffer("experts_down_scale", torch.ones(e, h))
        else:
            self.experts_up = nn.Parameter(
                torch.empty(e, m, h, dtype=cfg.adtype))
            self.experts_down = nn.Parameter(
                torch.empty(e, h, m, dtype=cfg.adtype))

    def route(self, x: torch.Tensor):
        """(probs [..., E] f32, top [...] int64) of the f32 router."""
        probs = torch.softmax(self.router(x.float()), dim=-1)
        return probs, torch.argmax(probs, dim=-1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                with_aux: bool = False):
        """The layer's output; with ``with_aux`` also the Switch
        load-balancing loss ``E * sum_e f_e * P_e`` (f32 scalar) over real
        tokens: ``f_e`` the share of tokens dispatched to expert e, ``P_e``
        its mean router probability (the reference's ``moe_aux``)."""
        probs, top = self.route(x)
        if self.cfg.moe_dispatch == "capacity":
            out = self._capacity_experts(x, top, mask)
        else:
            out = self._dense_experts(x, top)
        chosen = probs.gather(-1, top[..., None])
        out = out * chosen.to(self.cfg.adtype)
        if not with_aux:
            return out
        e = self.cfg.n_experts
        w = (torch.ones(top.shape, dtype=torch.float32, device=x.device)
             if mask is None else mask.float())
        denom = torch.clamp(w.sum(), min=1.0)
        p_e = (probs * w[..., None]).sum(dim=(0, 1)) / denom
        f_e = (F.one_hot(top, e).float() * w[..., None]).sum(dim=(0, 1)) \
            / denom
        return out, e * torch.sum(f_e * p_e)

    def _dense_experts(self, x: torch.Tensor,
                       top: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        e, h, m = cfg.n_experts, cfg.hidden, cfg.mlp_dim
        xf = x.reshape(-1, h)
        if cfg.quantized:
            hid = int8_experts_up(xf, self.experts_up_q,
                                  self.experts_up_scale, out_dtype=cfg.adtype)
            hid = F.gelu(hid, approximate="tanh")
            out = int8_experts_down(hid, self.experts_down_q,
                                    self.experts_down_scale,
                                    out_dtype=cfg.adtype)      # [N, E, h]
            out = out.transpose(0, 1)                          # [E, N, h]
        else:
            hid = F.linear(xf, self.experts_up.reshape(e * m, h))
            hid = F.gelu(hid, approximate="tanh").view(-1, e, m)
            out = torch.bmm(hid.transpose(0, 1),
                            self.experts_down.transpose(1, 2))  # [E, N, h]
        idx = top.reshape(1, -1, 1).expand(1, xf.shape[0], h)
        return out.gather(0, idx).view(x.shape)

    def _capacity_experts(self, x: torch.Tensor, top: torch.Tensor,
                          mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        e, h = cfg.n_experts, cfg.hidden
        n = top.numel()
        g = min(n, self._GROUP)
        k = int(math.ceil(n / g))
        n_pad = k * g
        # The reference's expression, in Python floats.
        cap = max(1, int(math.ceil(g / e * cfg.moe_capacity_factor)))
        topf = top.reshape(n)
        valid = (torch.ones(n, dtype=torch.bool, device=x.device)
                 if mask is None else mask.reshape(n).bool())
        if n_pad != n:
            topf = F.pad(topf, (0, n_pad - n))
            valid = F.pad(valid, (0, n_pad - n))
        # 0-based arrival rank of each token in its expert's queue within
        # its group; padding tokens never route, so they take no slot.
        onehot = F.one_hot(topf, e) * valid[:, None]
        arrivals = torch.cumsum(onehot.view(k, g, e), dim=1).view(n_pad, e)
        rank = arrivals.gather(1, topf[:, None]).squeeze(1) - 1
        keep = valid & (rank < cap)
        group = torch.arange(n_pad, device=x.device) // g
        # Slot of each kept token in [E, K*cap]; the rest write one spare
        # row past the end, which nothing reads.
        slots = e * k * cap
        slot = torch.where(keep, (topf * k + group) * cap + rank,
                           torch.full_like(rank, slots))[:n]
        packed = torch.zeros(slots + 1, h, dtype=x.dtype, device=x.device)
        packed.index_copy_(0, slot, x.reshape(n, h))
        x_e = packed[:slots].view(e, k * cap, h)
        hid = F.gelu(torch.bmm(x_e, self.experts_up.transpose(1, 2)),
                     approximate="tanh")
        out_e = torch.bmm(hid, self.experts_down.transpose(1, 2))
        rows = out_e.view(slots, h).index_select(0, slot.clamp(max=slots - 1))
        y = torch.where(keep[:n, None], rows, torch.zeros_like(rows))
        return y.view(x.shape)


def _layer_norm(cfg: EncoderConfig) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps,
                        dtype=torch.float32)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = SelfAttention(cfg)
        self.ln_attn = _layer_norm(cfg)
        if cfg.n_experts:
            self.moe = SwitchMoE(cfg)
        else:
            self.mlp = DenseMLP(cfg)
        self.ln_mlp = _layer_norm(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                with_aux: bool = False):
        """The layer's output; with ``with_aux`` also its MoE aux loss (an
        f32 zero for a dense layer)."""
        adtype = self.cfg.adtype
        a = self.attn(x, mask, segment_ids)
        x = self.ln_attn(x.float() + a.float()).to(adtype)
        aux = None
        if not self.cfg.n_experts:
            m = self.mlp(x)
            if with_aux:
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
        elif with_aux:
            m, aux = self.moe(x, mask, with_aux=True)
        else:
            m = self.moe(x, mask)
        out = self.ln_mlp(x.float() + m.float()).to(adtype)
        return (out, aux) if with_aux else out


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
                positions: Optional[torch.Tensor] = None,
                with_aux: bool = False):
        """hidden; with ``with_aux`` (hidden, the MoE aux loss summed over
        layers)."""
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
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = None
        for layer in self.layers:
            args = (x, mask, segment_ids, with_aux)
            out = (torch.utils.checkpoint.checkpoint(
                layer, *args, use_reentrant=False) if remat
                else layer(*args))
            if with_aux:
                x, layer_aux = out
                aux = layer_aux if aux is None else aux + layer_aux
            else:
                x = out
        return (x, aux) if with_aux else x


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


class Classifier(nn.Module):
    """XLM-R-style classifier (the reference's ``Classifier``): encoder ->
    head on the first token -> logits f32 [B, n_labels].  Its weights are
    `EmbedderClassifier`'s (``encoder``, ``cls_head``), so one flax tree
    loads into either.  ``with_aux`` also returns the MoE aux loss."""

    def __init__(self, cfg: EncoderConfig,
                 embed_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, embed_dtype)
        self.cls_head = ClassificationHead(cfg)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                with_aux: bool = False):
        if with_aux:
            hidden, aux = self.encoder(ids, mask, with_aux=True)
            return self.cls_head(hidden[:, 0, :]), aux
        return self.cls_head(self.encoder(ids, mask)[:, 0, :])


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
    """The LayerNorms, `Dense` layers and float Switch-MoE experts under
    ``module``, in module order: unit scales and zero biases; fan-in
    truncated normal kernels on [-2σ, 2σ], σ corrected for the truncation
    (jax's variance_scaling constant), zero biases.  Each expert's fan-in
    is its input width, as flax's ``lecun_normal`` counts it for an
    ``[E, in, out]`` kernel."""
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Dense):
            _fill(m.weight, generator,
                  _trunc_normal(m.in_features, generator))
            m.bias.zero_()
        elif isinstance(m, SwitchMoE) and not m.cfg.quantized:
            for w in (m.experts_up, m.experts_down):
                _fill(w, generator, _trunc_normal(w.shape[-1], generator))


def _trunc_normal(fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return lambda t: nn.init.trunc_normal_(t, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=generator)

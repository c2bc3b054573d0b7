"""Attention: the plain PyTorch version and the hand-written CUDA kernel.

Layout convention, as in the reference: [batch, seq, heads, head_dim]
("BLHD") for q/k/v, [batch, seq] padding masks (True/nonzero = real token),
optional [batch, seq] int32 ``segment_ids`` for packed rows (0 = padding).
Scores and softmax are f32 whatever the input dtype; outputs are in the
input dtype.  A fully masked row gives zeros, never a uniform average.

- :func:`attend` — the plain version (`distributed_crawler_tpu/ops/
  attention.py:44-68` in torch).  The serving path sends it CPU tensors
  only; on the card it is called only to check the kernel against it.
- :func:`flash_attention` — the wrapper of the CUDA kernels.  For a CUDA
  tensor it launches one or raises; a CPU tensor takes :func:`attend`.
  :func:`check_operands` validates the operands and :func:`choose_path`
  picks the kernel from the layout, before launch: ``"sm90"``
  (`csrc/flash_attention_sm90.cu`: TMA, wgmma, a producer warp) for bf16
  at head dims 32/64 with TMA-legal operands; ``"mma_sync"``
  (`csrc/flash_attention.cu`: wgmma fed by cp.async from a producer
  warpgroup, the name kept from the mma.sync kernel it replaced) for every
  other bf16 input; ``"simt"`` (the same source: 3xTF32 on mma.sync, the
  name kept too) for f32.  Both take any head dim from 1 to 256, rounded up in
  shared memory to 16, 32, 64, 128 or 256 with zero columns.
  ``flash_attention.launches`` counts launches, and
  ``flash_attention.launches_by_path`` counts them per path; the same
  per-path count is the ``attention_kernel_launches_total{path}`` series
  of the process's ``/metrics`` (registered at the first launch), so a
  worker process's launches can be read from outside it.
- :func:`key_tile_plan` — the tile-skip rule of all three kernels in
  plain PyTorch: which key tiles each query block computes
  (:func:`block_n` gives a route's tile width).
- :func:`attend_3xtf32` — the f32 kernel's arithmetic in plain PyTorch:
  both products as three TF32 products (:func:`tf32_round`,
  :func:`split_tf32`).
- :func:`mha` — dispatch by the tensor's device, or to :func:`attend`
  for a model built with ``attention="xla"`` (the trainer's).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from .. import kernels
from ..utils.metrics import REGISTRY

_NEG_INF = -1e30

# Head dims the kernels take; `csrc/flash_attention.cu` rounds each up to
# 16, 32, 64, 128 or 256 in shared memory (zero columns).
MAX_HEAD_DIM = 256
HEAD_DIMS = range(1, MAX_HEAD_DIM + 1)
SM90_HEAD_DIMS = (32, 64)
PATHS = ("sm90", "mma_sync", "simt")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1

# The kernels' tiling (csrc/flash_attention_sm90.cu and, the same,
# csrc/flash_attention.cu): a work item is SM90_BLOCK_M consecutive query
# tokens of the flat [B*L] axis, split over consumer warpgroups of
# SM90_WG_ROWS rows; keys come in tiles of SM90_BLOCK_N tokens (16 for the
# f32 kernel above head dim 128, whose wider rows fill shared memory).
SM90_BLOCK_M, SM90_WG_ROWS, SM90_BLOCK_N = 128, 64, 64
F32_WIDE_BLOCK_N = 16

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "flash_attention_fwd": (
        [_c_void_p] * 6            # q, k, v, kv_mask, segment_ids, out
        + [_c_int] * 4             # batch, seq_len, n_heads, head_dim
        + [_c_int] * 9             # (b, l, h) strides of q, k, v
        + [ctypes.c_float, _c_int, _c_void_p],  # scale, dtype, stream
        _c_int),
    "flash_attention_error_string": ([_c_int], ctypes.c_char_p),
}
SM90_SIGNATURES = {
    "flash_attention_sm90_fwd": (
        [_c_void_p] * 6            # q, k, v, kv_mask, segment_ids, out
        + [_c_int] * 4             # batch, seq_len, n_heads, head_dim
        + [_c_int] * 6             # (l, h) strides of q, k, v
        + [ctypes.c_float, _c_void_p],  # scale, stream
        _c_int),
    "flash_attention_sm90_error_string": ([_c_int], ctypes.c_char_p),
}


def _allowed_mask(kv_mask: Optional[torch.Tensor],
                  segment_ids: Optional[torch.Tensor]
                  ) -> Optional[torch.Tensor]:
    """[B, 1, Q?, K] boolean allow-mask from padding + segment identity."""
    allowed = None
    if kv_mask is not None:
        allowed = kv_mask.bool()[:, None, None, :]
    if segment_ids is not None:
        same = (segment_ids[:, None, :, None] ==
                segment_ids[:, None, None, :])
        allowed = same if allowed is None else (allowed & same)
    return allowed


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_mask: Optional[torch.Tensor] = None,
           scale: Optional[float] = None,
           segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain bidirectional attention, BLHD in/out.

    An explicit masked softmax, not ``F.softmax``: a fully masked row must
    give zeros, as the kernel and the reference do, where ``F.softmax``
    would give a uniform row (or NaN with -inf scores)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    # Products of bf16 values are exact in f32, so casting first equals the
    # reference's bf16 einsum with f32 accumulation.
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    allowed = _allowed_mask(kv_mask, segment_ids)
    if allowed is not None:
        s = torch.where(allowed, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def block_n(path: str, d: int) -> int:
    """Keys per tile of a route's kernel at head dim ``d``: 64, and 16 for
    the f32 kernel above head dim 128 (padded width 256)."""
    return F32_WIDE_BLOCK_N if path == "simt" and d > 128 else SM90_BLOCK_N


def _tma_legal(x: torch.Tensor) -> bool:
    """A bf16 [B, L, H, D] operand the sm90 kernel's TMA maps can address:
    16-byte-aligned base, head dim contiguous, token and head strides whole
    16-byte units, and the batch stride L token strides, so that the
    tokens form one flat [B*L] axis."""
    b, l, _, _ = x.shape
    sb, sl, sh, sd = x.stride()
    return (sd == 1 and x.data_ptr() % 16 == 0 and sl % 8 == 0
            and sh % 8 == 0 and (b == 1 or sb == l * sl))


def choose_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes these operands, from dtype and layout alone:
    ``"simt"`` for f32, ``"sm90"`` for bf16 at head dims 32/64 whose q, k
    and v are all TMA-legal, ``"mma_sync"`` for any other bf16 input."""
    if q.dtype == torch.float32:
        return "simt"
    b, l, _, d = q.shape
    if (d in SM90_HEAD_DIMS and b * l <= _INT_MAX
            and all(_tma_legal(x) for x in (q, k, v))):
        return "sm90"
    return "mma_sync"


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   path: Optional[str] = None) -> str:
    """What :func:`flash_attention` checks before a launch, on any device:
    shapes, dtypes, the head dim (1 to :data:`MAX_HEAD_DIM`), a contiguous
    head dim, int32-sized strides and token count, masks of [B, L] on q's
    device.  Returns the kernel that takes the operands (``path`` when
    given and able to, else :func:`choose_path`'s); raises ``ValueError``
    or ``TypeError`` naming what it cannot take, and ``RuntimeError`` for
    operands that require grad while autograd records: the kernels have no
    backward (nor has the reference's Pallas kernel, which is why its
    trainer runs the plain version), and their output would carry no
    ``grad_fn``, cutting the graph without an error."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: q/k/v require grad while "
            "autograd is enabled; train through attention='xla' (the plain "
            "version), or run the forward under torch.no_grad()")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, L, H, D], got shape {tuple(q.shape)}")
    b, l, _, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} {tuple(x.shape)} {x.dtype} {x.device} does not "
                f"match q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported: the kernels take 1 "
                         f"to {MAX_HEAD_DIM}")
    if b * l > _INT_MAX:
        raise ValueError(f"{b * l} tokens exceed int32")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if max(x.stride()[:3]) > _INT_MAX:
            raise ValueError(f"{name}'s strides exceed int32")
    for name, x in (("kv_mask", kv_mask), ("segment_ids", segment_ids)):
        if x is None:
            continue
        if tuple(x.shape) != (b, l):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(b, l)}")
        if x.dtype not in (torch.bool, torch.int32):
            raise TypeError(f"{name} must be bool or int32, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    chosen = choose_path(q, k, v)
    if path is None:
        return chosen
    if path not in PATHS:
        raise ValueError(f"path {path!r} is not one of {PATHS}")
    if (path == "simt") != (chosen == "simt") or (
            path == "sm90" and chosen != "sm90"):
        raise ValueError(f"the {path} kernel cannot take these operands "
                         f"({q.dtype}, head dim {d}, strides "
                         f"{q.stride()}); choose_path gives {chosen}")
    return path


def key_tile_plan(kv_mask: Optional[torch.Tensor],
                  segment_ids: Optional[torch.Tensor],
                  batch: int, seq_len: int,
                  block_n: int = SM90_BLOCK_N) -> List[List[Tuple[int, int]]]:
    """The kernels' tile-skip rule, in plain PyTorch.

    Tokens are one flat axis of ``batch * seq_len``.  Query block ``i``
    holds tokens ``[128 i, 128 i + 128)``; its candidate keys are the
    tokens of the batch rows those queries belong to, cut into tiles of
    ``block_n`` (:func:`block_n` of the route) from the first of them.  A
    key is allowed for a query when it is unmasked and has the query's
    batch row and segment id.  Entry ``i`` of the result lists ``(first key
    token, bits)`` for every tile the block computes, bit ``w`` set when
    some key of the tile is allowed for some query of warpgroup ``w`` (rows
    ``[64 w, 64 w + 64)`` of the block).  A tile that is not listed is
    never loaded."""
    t = batch * seq_len
    valid = (kv_mask.reshape(-1).bool().cpu() if kv_mask is not None
             else torch.ones(t, dtype=torch.bool))
    seg = (segment_ids.reshape(-1).to(torch.int64).cpu()
           if segment_ids is not None else torch.zeros(t, dtype=torch.int64))
    row = torch.arange(t) // seq_len
    tag = row * 2 ** 32 + (seg & 0xFFFFFFFF)  # (batch row, segment id)
    plan = []
    for q0 in range(0, t, SM90_BLOCK_M):
        q1 = min(q0 + SM90_BLOCK_M, t)
        k_begin = (q0 // seq_len) * seq_len
        k_end = ((q1 - 1) // seq_len + 1) * seq_len
        n_tiles = -(-(k_end - k_begin) // block_n)
        bits = torch.zeros(n_tiles, dtype=torch.int64)
        for w, w0 in enumerate(range(q0, q1, SM90_WG_ROWS)):
            q_tags = tag[w0:min(w0 + SM90_WG_ROWS, q1)]
            seen = valid[k_begin:k_end] & torch.isin(tag[k_begin:k_end],
                                                     q_tags)
            pad = n_tiles * block_n - seen.numel()
            seen = torch.nn.functional.pad(seen, (0, pad))
            bits |= seen.view(n_tiles, block_n).any(dim=1).long() << w
        plan.append([(k_begin + block_n * j, int(b))
                     for j, b in enumerate(bits.tolist()) if b])
    return plan


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does; infinities and NaN pass through."""
    x = x.float()
    bits = x.view(torch.int32)
    # On the magnitude bits (sign apart): add half a unit of the 13 bits
    # dropped, then clear them; a carry into the exponent is the rounding.
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): ``hi = tf32_round(x)``, ``lo = tf32_round(x - hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _einsum_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the f32 kernel forms it: three products of
    TF32 halves, a_lo b_hi + a_hi b_lo + a_hi b_hi, each exact in f32 before
    it is summed (a TF32 product has 22 significant bits)."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def attend_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`attend` in f32 with both products as the ``simt`` kernel
    computes them (3xTF32); the softmax in f32 as :func:`attend`'s.  The
    plain model of the kernel's arithmetic, not a path of the port."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = _einsum_3xtf32("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    allowed = _allowed_mask(kv_mask, segment_ids)
    if allowed is not None:
        s = torch.where(allowed, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return _einsum_3xtf32("bhqk,bkhd->bqhd", p, v.float())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    path: Optional[str] = None) -> torch.Tensor:
    """A CUDA kernel for a CUDA tensor; :func:`attend` for a CPU one.

    ``path`` names the kernel instead of :func:`choose_path` (the times
    phase of chip_smoke.py reaches the generic bf16 kernel so); it raises
    when that kernel cannot take the operands."""
    if q.device.type == "cpu":
        return attend(q, k, v, kv_mask, scale, segment_ids=segment_ids)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    path = check_operands(q, k, v, kv_mask, segment_ids, path)
    b, l, h, d = q.shape
    if b * l * h * d == 0:
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    scale = float(scale) if scale is not None else d ** -0.5
    mask_i = (kv_mask.to(torch.int32).contiguous()
              if kv_mask is not None else None)
    seg_i = (segment_ids.to(torch.int32).contiguous()
             if segment_ids is not None else None)
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    mask_p = mask_i.data_ptr() if mask_i is not None else None
    seg_p = seg_i.data_ptr() if seg_i is not None else None
    if path == "sm90":
        lib = kernels.load("flash_attention_sm90", SM90_SIGNATURES)
        sl_sh = [s for i, s in enumerate(strides) if i % 3]  # drop batch
        rc = lib.flash_attention_sm90_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_p, seg_p,
            out.data_ptr(), b, l, h, d, *sl_sh, scale, stream)
        err = lib.flash_attention_sm90_error_string
    else:
        lib = kernels.load("flash_attention", SIGNATURES)
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_p, seg_p,
            out.data_ptr(), b, l, h, d, *strides, scale,
            _DTYPE_CODES[q.dtype], stream)
        err = lib.flash_attention_error_string
    if rc != 0:
        raise RuntimeError(f"flash_attention ({path}) launch failed: "
                           f"{err(rc).decode()} ({rc})")
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    REGISTRY.counter(
        "attention_kernel_launches_total",
        "attention kernel launches per kernel path (sm90, mma_sync, simt)"
    ).labels(path=path).inc()
    return out


# Kernel launches, in all and per path, read by chip_smoke.py.
flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None,
        segment_ids: Optional[torch.Tensor] = None,
        attention: str = "auto") -> torch.Tensor:
    """Dispatch by device: a CUDA tensor goes to the kernel at every
    length, a CPU tensor to :func:`attend`.  ``attention="xla"`` (the
    reference's name for its plain path) takes :func:`attend` on any
    device: only the trainer builds such a model, since the kernels have no
    backward; the engine refuses it on the card."""
    if attention == "xla":
        return attend(q, k, v, kv_mask, scale, segment_ids=segment_ids)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, kv_mask, scale,
                               segment_ids=segment_ids)
    if q.device.type == "cpu":
        return attend(q, k, v, kv_mask, scale, segment_ids=segment_ids)
    raise RuntimeError(f"mha: unsupported device {q.device}")

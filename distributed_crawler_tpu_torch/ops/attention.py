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
  :func:`choose_path` picks the kernel from the layout, before launch:
  ``"sm90"`` (`csrc/flash_attention_sm90.cu`: TMA, wgmma, a producer warp)
  for bf16 at head dims 32/64 with TMA-legal operands; ``"mma_sync"``
  (`csrc/flash_attention.cu`) for other bf16 layouts; ``"simt"`` (the same
  source) for f32.  ``flash_attention.launches`` counts launches, and
  ``flash_attention.launches_by_path`` counts them per path; the same
  per-path count is the ``attention_kernel_launches_total{path}`` series
  of the process's ``/metrics`` (registered at the first launch), so a
  worker process's launches can be read from outside it.
- :func:`key_tile_plan` — the sm90 kernel's tile-skip rule in plain
  PyTorch: which key tiles each query block computes.
- :func:`mha` — dispatch by the tensor's device.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from .. import kernels
from ..utils.metrics import REGISTRY

_NEG_INF = -1e30

HEAD_DIMS = (16, 32, 64)
SM90_HEAD_DIMS = (32, 64)
PATHS = ("sm90", "mma_sync", "simt")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1

# The sm90 kernel's tiling (csrc/flash_attention_sm90.cu): a block owns
# SM90_BLOCK_M consecutive query tokens of the flat [B*L] axis, split over
# consumer warpgroups of SM90_WG_ROWS rows; keys come in tiles of
# SM90_BLOCK_N tokens.
SM90_BLOCK_M, SM90_WG_ROWS, SM90_BLOCK_N = 128, 64, 64

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


def _as_int32(x: torch.Tensor, name: str, shape) -> torch.Tensor:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if x.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"{name} must be bool or int32, got {x.dtype}")
    return x.to(torch.int32).contiguous()


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


def key_tile_plan(kv_mask: Optional[torch.Tensor],
                  segment_ids: Optional[torch.Tensor],
                  batch: int, seq_len: int) -> List[List[Tuple[int, int]]]:
    """The sm90 kernel's tile-skip rule, in plain PyTorch.

    Tokens are one flat axis of ``batch * seq_len``.  Query block ``i``
    holds tokens ``[128 i, 128 i + 128)``; its candidate keys are the
    tokens of the batch rows those queries belong to, cut into tiles of 64
    from the first of them.  A key is allowed for a query when it is
    unmasked and has the query's batch row and segment id.  Entry ``i`` of
    the result lists ``(first key token, bits)`` for every tile the block
    computes, bit ``w`` set when some key of the tile is allowed for some
    query of warpgroup ``w`` (rows ``[64 w, 64 w + 64)`` of the block).  A
    tile that is not listed is never loaded."""
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
        n_tiles = -(-(k_end - k_begin) // SM90_BLOCK_N)
        bits = torch.zeros(n_tiles, dtype=torch.int64)
        for w, w0 in enumerate(range(q0, q1, SM90_WG_ROWS)):
            q_tags = tag[w0:min(w0 + SM90_WG_ROWS, q1)]
            seen = valid[k_begin:k_end] & torch.isin(tag[k_begin:k_end],
                                                     q_tags)
            pad = n_tiles * SM90_BLOCK_N - seen.numel()
            seen = torch.nn.functional.pad(seen, (0, pad))
            bits |= seen.view(n_tiles, SM90_BLOCK_N).any(dim=1).long() << w
        plan.append([(k_begin + SM90_BLOCK_N * j, int(b))
                     for j, b in enumerate(bits.tolist()) if b])
    return plan


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    path: Optional[str] = None) -> torch.Tensor:
    """A CUDA kernel for a CUDA tensor; :func:`attend` for a CPU one.

    ``path`` names the kernel instead of :func:`choose_path` (the times
    phase of chip_smoke.py reaches the mma.sync kernel so); it raises when
    that kernel cannot take the operands."""
    if q.device.type == "cpu":
        return attend(q, k, v, kv_mask, scale, segment_ids=segment_ids)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, L, H, D], got shape {tuple(q.shape)}")
    b, l, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} {tuple(x.shape)} {x.dtype} {x.device} does not "
                f"match q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; one of {HEAD_DIMS}")
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        sb, sl, sh, _ = x.stride()
        if max(sb, sl, sh) > _INT_MAX:
            raise ValueError(f"{name}'s strides exceed int32")
        strides += [sb, sl, sh]
    if b * l * h * d == 0:
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    scale = float(scale) if scale is not None else d ** -0.5
    mask_i = (_as_int32(kv_mask, "kv_mask", (b, l))
              if kv_mask is not None else None)
    seg_i = (_as_int32(segment_ids, "segment_ids", (b, l))
             if segment_ids is not None else None)
    for name, x in (("kv_mask", mask_i), ("segment_ids", seg_i)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    chosen = choose_path(q, k, v)
    if path is None:
        path = chosen
    elif path not in PATHS:
        raise ValueError(f"path {path!r} is not one of {PATHS}")
    elif (path == "simt") != (chosen == "simt") or (
            path == "sm90" and chosen != "sm90"):
        raise ValueError(f"the {path} kernel cannot take these operands "
                         f"({q.dtype}, head dim {d}, strides "
                         f"{q.stride()}); choose_path gives {chosen}")
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
        segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch by device: a CUDA tensor goes to the kernel at every
    length, a CPU tensor to :func:`attend`."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, kv_mask, scale,
                               segment_ids=segment_ids)
    if q.device.type == "cpu":
        return attend(q, k, v, kv_mask, scale, segment_ids=segment_ids)
    raise RuntimeError(f"mha: unsupported device {q.device}")

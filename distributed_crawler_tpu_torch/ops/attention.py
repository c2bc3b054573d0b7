"""Attention: the plain PyTorch version and the hand-written CUDA kernel.

Layout convention, as in the reference: [batch, seq, heads, head_dim]
("BLHD") for q/k/v, [batch, seq] padding masks (True/nonzero = real token),
optional [batch, seq] int32 ``segment_ids`` for packed rows (0 = padding).
Scores and softmax are f32 whatever the input dtype; outputs are in the
input dtype.  A fully masked row gives zeros, never a uniform average.

- :func:`attend` — the plain version (`distributed_crawler_tpu/ops/
  attention.py:44-68` in torch).  The serving path sends it CPU tensors
  only; on the card it is called only to check the kernel against it.
- :func:`flash_attention` — the wrapper of `csrc/flash_attention.cu`.  For
  a CUDA tensor it launches the kernel or raises; a CPU tensor takes
  :func:`attend`.  ``flash_attention.launches`` counts kernel launches.
- :func:`mha` — dispatch by the tensor's device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels

_NEG_INF = -1e30

HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor; :func:`attend` for a CPU one."""
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
    lib = kernels.load("flash_attention", SIGNATURES)
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask_i.data_ptr() if mask_i is not None else None,
        seg_i.data_ptr() if seg_i is not None else None,
        out.data_ptr(), b, l, h, d, *strides, scale, _DTYPE_CODES[q.dtype],
        stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches, read by chip_smoke.py


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

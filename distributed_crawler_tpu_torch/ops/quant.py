"""Int8 projections: symmetric quantization and int8×int8→int32 products.

The counterpart of `distributed_crawler_tpu/ops/quant.py` (dense, fused
QKV and the Switch-MoE expert products), on the same grid so that the int8
values, the scales and the int32 accumulators are equal to the reference's
bit for bit:

- **weights**: per-output-channel symmetric int8, quantized once when the
  engine starts (`models/quant.quantize_encoder_params`);
- **activations**: per-token dynamic symmetric int8, or one calibrated
  per-tensor scale (``int8_static``);
- **scale**: ``max(amax, 1e-8) / 127`` in f32; values are rounded half to
  even (``torch.round``, as ``jnp.round``) and clipped to [-127, 127];
- **accumulation**: int32, dequantized in f32 in the reference's order:
  ``acc * a_scale * w_scale``, then the f32 bias, then the cast.

Weights are stored ``[out, in]`` (``nn.Linear``'s layout; the reference's
flax kernels are ``[in, out]``), expert weights ``[E, out, in]``.  The
product is :func:`int8_matmul`: one ``torch._int_mm`` call.  It is XLA's
in the reference, not a Pallas kernel, so a library call carries it.  On
the card that call goes to cuBLASLt, which takes only more than 16 rows
and k, n multiples of 8: a shape it refuses raises here, before any
launch; nothing falls back to a dequantized float product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# 127 (not 128) so the grid is symmetric: -127..127 both representable.
_QMAX = 127.0


def quant_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` in f32, correctly rounded on every device.
    The divisor is a tensor on ``amax``'s device: PyTorch's CUDA division
    by a Python (or CPU) scalar multiplies by its rounded reciprocal
    instead, which moves some scales one ulp off the reference's."""
    qmax = torch.full((), _QMAX, dtype=torch.float32, device=amax.device)
    return torch.clamp(amax.to(torch.float32), min=1e-8) / qmax


def quantize_weights(w: torch.Tensor, contract_axis: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a kernel: every
    axis but ``contract_axis`` (the one the product sums over) gets its own
    scale.  Returns ``(w_q int8, scale f32)`` with ``w ≈ w_q * scale``."""
    w = w.to(torch.float32)
    scale = quant_scale(torch.amax(torch.abs(w), dim=contract_axis,
                                   keepdim=True))
    w_q = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX).to(torch.int8)
    return w_q, scale.squeeze(contract_axis)


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last-axis) dynamic symmetric int8 quantization.  Returns
    ``(x_q int8, a_scale f32)``, ``a_scale`` keeping the last axis as 1."""
    # abs and max are exact in bf16, so the amax is taken before the cast.
    a_scale = quant_scale(torch.amax(torch.abs(x), dim=-1, keepdim=True))
    return _to_int8(x.to(torch.float32) / a_scale), a_scale


def quantize_activations_static(x: torch.Tensor, a_scale: torch.Tensor
                                ) -> torch.Tensor:
    """Static symmetric int8 quantization with a calibrated per-tensor
    scale (``x ≈ x_q * a_scale``)."""
    return _to_int8(x.to(torch.float32) / a_scale)


def _to_int8(scaled: torch.Tensor) -> torch.Tensor:
    return scaled.round_().clamp_(-_QMAX, _QMAX).to(torch.int8)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q @ w_q.T`` in int32: x_q ``[m, k]`` int8, w_q ``[n, k]`` int8
    (row-major ``[out, in]``, handed to the product as its transpose).
    Raises for a shape the card's int8 product does not take."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_matmul shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)}.T do not compose")
    if x_q.device != w_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_q.device}")
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.device.type == "cuda" and (m <= 16 or k % 8 or n % 8):
        raise ValueError(
            f"the card's int8 product takes m > 16 and k, n multiples of 8; "
            f"got m={m}, k={k}, n={n}")
    return torch._int_mm(x_q.contiguous(), w_q.contiguous().t())


def dequantize(acc: torch.Tensor, a_scale: torch.Tensor,
               w_scale: torch.Tensor, bias: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """int32 accumulators → ``out_dtype``: ``acc * a_scale * w_scale``,
    then the f32 bias, then the cast, in the reference's order."""
    out = acc.to(torch.float32).mul_(a_scale).mul_(w_scale)
    if bias is not None:
        out.add_(bias)
    return out.to(out_dtype)


def int8_dense(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.bfloat16,
               a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` with both sides int8: x ``[..., in]`` float, w_q
    ``[out, in]`` int8, w_scale and bias ``[out]`` f32.  Returns
    ``[..., out]`` in ``out_dtype``.  A calibrated scalar ``a_scale``
    switches the activations from dynamic per-token to static."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if a_scale is not None:
        x_q = quantize_activations_static(x2, a_scale)
    else:
        x_q, a_scale = quantize_activations(x2)
    acc = int8_matmul(x_q, w_q)
    out = dequantize(acc, a_scale, w_scale, bias, out_dtype)
    return out.view(*lead, w_q.shape[0])


def int8_qkv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             out_dtype: torch.dtype = torch.bfloat16,
             a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused QKV projection, int8: ``[..., h]`` → a fresh contiguous
    ``[..., 3, h]``.  w_q is ``[3h, h]``, q/k/v major (the reference's
    ``[h, 3, h]`` kernel, transposed); w_scale and bias are ``[3, h]``.
    Each output element is dequantized exactly as the reference's
    ``[..., 3, h]`` broadcast does it."""
    h = w_scale.shape[-1]
    out = int8_dense(x, w_q, w_scale.reshape(-1),
                     None if bias is None else bias.reshape(-1),
                     out_dtype=out_dtype, a_scale=a_scale)
    return out.view(*x.shape[:-1], 3, h)


def int8_experts_up(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Switch-MoE up projection, int8: ``[..., h]`` → ``[..., E, m]`` for
    every expert.  w_q is ``[E, m, h]`` int8, w_scale ``[E, m]``.  The
    activations quantize per token over h; one int8 product against all
    ``E*m`` output channels."""
    e, m, h = w_q.shape
    out = int8_dense(x, w_q.reshape(e * m, h), w_scale.reshape(e * m),
                     out_dtype=out_dtype)
    return out.view(*x.shape[:-1], e, m)


def int8_experts_down(hid: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Switch-MoE down projection, int8: ``[..., E, m]`` → ``[..., E, h]``.
    w_q is ``[E, h, m]`` int8, w_scale ``[E, h]``.  The activations
    re-quantize per (token, expert) over m; one int8 product per expert."""
    e, h, m = w_q.shape
    lead = hid.shape[:-2]
    h_q, h_scale = quantize_activations(hid.reshape(-1, e, m))
    out = torch.empty((h_q.shape[0], e, h), dtype=out_dtype,
                      device=hid.device)
    for i in range(e):
        acc = int8_matmul(h_q[:, i], w_q[i])
        out[:, i] = dequantize(acc, h_scale[:, i], w_scale[i], None,
                               out_dtype)
    return out.view(*lead, e, h)

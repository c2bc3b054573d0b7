"""Float→int8 conversion of encoder param trees (serving-time, one-shot).

The counterpart of `distributed_crawler_tpu/models/quant.py`, on the same
flax-layout tree of numpy arrays that `models/from_jax.load_flax_params`
consumes.  `quantize_encoder_params` rewrites the projections:

    layers_i/attn/qkv/kernel [h,3,h] f32 → qkv/kernel_q int8 + qkv/scale
    layers_i/{attn/attn_out, mlp/mlp_up, mlp/mlp_down}/kernel
                                          → kernel_q int8 [in,out] + scale

    layers_i/moe/experts_{up,down}/kernel [E,in,out]
                                          → experts_*/kernel_q int8 + scale
                                            [E,out] (per expert and output
                                            channel)

with the biases kept (as f32), and under ``int8_static`` a calibrated
scalar ``a_scale`` beside each projection but the experts, which stay
dynamic.  Embeddings, LayerNorms, the MoE router and the head pass
through.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.quant import quant_scale, quantize_weights

_PROJ_MODULES = ("attn_out", "mlp_up", "mlp_down")


def _quantize(kernel: Any, contract_axis: int = 0) -> Dict[str, np.ndarray]:
    """A flax kernel → ``kernel_q`` and ``scale``."""
    w_q, scale = quantize_weights(
        torch.from_numpy(np.array(kernel, dtype=np.float32)),
        contract_axis=contract_axis)
    return {"kernel_q": w_q.numpy(), "scale": scale.numpy()}


def _f32(x: Any) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _act_scale(absmax: Any) -> np.ndarray:
    """Calibrated abs-max → static activation scale (x ≈ x_q * scale)."""
    return quant_scale(torch.from_numpy(
        np.array(absmax, dtype=np.float32))).numpy()


def _calib_value(calib: Optional[Mapping[str, Any]], layer: str,
                 holder: str, name: str) -> Any:
    """One recorded abs-max from the calib tree; None when absent.  The
    tree may or may not have the top ``encoder`` level, and a value may be
    a 1-tuple (flax's ``sow`` without ``init_fn`` keeps one)."""
    if calib is None:
        return None
    node: Any = calib.get("encoder", calib)
    for key in (layer, holder):
        if not isinstance(node, Mapping) or key not in node:
            return None
        node = node[key]
    val = node.get(f"{name}_in") if isinstance(node, Mapping) else None
    if isinstance(val, (tuple, list)):
        val = val[0]
    return val


def quantize_encoder_params(params: Mapping[str, Any],
                            act_scales: Optional[Mapping[str, Any]] = None
                            ) -> Dict[str, Any]:
    """A new tree with the projection kernels int8-quantized.

    Takes the ``{"params": {...}}`` wrapper or a bare tree, the encoder at
    the top or under ``encoder``; idempotent on a quantized tree.
    ``act_scales`` (a `calibrate_activation_scales` result) selects the
    ``int8_static`` layout: each projection also carries ``a_scale``."""
    wrapped = set(params) == {"params"}
    tree = dict(params["params"] if wrapped else params)
    enc_key = "encoder" if "encoder" in tree else None
    enc = dict(tree[enc_key]) if enc_key else tree

    for name, layer in list(enc.items()):
        if not name.startswith("layers_"):
            continue
        layer = {k: dict(v) if isinstance(v, Mapping) else v
                 for k, v in layer.items()}
        attn = layer.get("attn")
        if isinstance(attn, dict) and "qkv/kernel" in attn:
            q = _quantize(attn.pop("qkv/kernel"))
            attn["qkv/kernel_q"] = q["kernel_q"]    # [h, 3, h] int8
            attn["qkv/scale"] = q["scale"]          # [3, h] f32
            attn["qkv/bias"] = _f32(attn["qkv/bias"])
            absmax = _calib_value(act_scales, name, "attn", "qkv")
            if absmax is not None:
                attn["qkv/a_scale"] = _act_scale(absmax)
        for holder_name in ("attn", "mlp"):
            holder = layer.get(holder_name)
            if not isinstance(holder, dict):
                continue
            for mod_name in _PROJ_MODULES:
                mod = holder.get(mod_name)
                if isinstance(mod, Mapping) and "kernel" in mod:
                    out = _quantize(mod["kernel"])
                    if "bias" in mod:
                        out["bias"] = _f32(mod["bias"])
                    absmax = _calib_value(act_scales, name, holder_name,
                                          mod_name)
                    if absmax is not None:
                        out["a_scale"] = _act_scale(absmax)
                    holder[mod_name] = out
        moe = layer.get("moe")
        if isinstance(moe, dict):
            # Expert kernels [E, in, out] contract their middle axis.
            for kname in ("experts_up/kernel", "experts_down/kernel"):
                if kname in moe:
                    q = _quantize(moe.pop(kname), contract_axis=1)
                    moe[kname + "_q"] = q["kernel_q"]
                    moe[kname.replace("/kernel", "/scale")] = q["scale"]
        enc[name] = layer

    if enc_key:
        tree[enc_key] = enc
    else:
        tree = enc
    return {"params": tree} if wrapped else tree


@torch.no_grad()
def calibrate_activation_scales(model: torch.nn.Module, ids: torch.Tensor,
                                mask: torch.Tensor) -> Dict[str, Any]:
    """One float forward with the calibration hooks on: each projection's
    input abs-max (f32), as a tree keyed like the reference's ``calib``
    collection (``encoder/layers_i/attn/qkv_in``, ...).

    ``model`` is an `EmbedderClassifier` built with ``calibrate=True`` (and
    ``quant="none"``); feed a representative batch — the scales clip
    whatever exceeds them when serving."""
    if not model.cfg.calibrate:
        raise ValueError("calibrate_activation_scales needs a model built "
                         "with calibrate=True")
    # A MoE layer's experts record nothing (the reference's SwitchMoE
    # sows no abs-max), so its entry holds the attention only.
    holders = [{name: getattr(layer, name) for name in ("attn", "mlp")
                if hasattr(layer, name)} for layer in model.encoder.layers]
    for held in holders:
        for mod in held.values():
            mod.absmax.clear()
    model(ids, mask)
    return {"encoder": {
        f"layers_{i}": {
            name: {k: v.cpu().numpy() for k, v in mod.absmax.items()}
            for name, mod in held.items()}
        for i, held in enumerate(holders)}}


def quantized_size_bytes(params: Mapping[str, Any]) -> int:
    """Total bytes of the tree's leaves (int8 trees are about 4× smaller on
    the projection kernels than their f32 source)."""
    total = 0
    for value in params.values():
        if isinstance(value, Mapping):
            total += quantized_size_bytes(value)
        elif hasattr(value, "shape"):
            total += int(np.prod(value.shape)) * np.dtype(value.dtype).itemsize
    return total

"""Load the reference's flax param tree into the port's modules.

The tree is plain numpy (``jax.tree.map(np.asarray, params)`` on the
reference side), so this module imports no JAX.  Every leaf is mapped by
name; a missing leaf, an unknown leaf or a shape mismatch raises — no leaf is
ever skipped.  Flax kernels are ``[in, out]`` and are transposed into
``nn.Linear``'s ``[out, in]``; the fused ``qkv/kernel`` ``[h, 3, h]`` is
reshaped to ``[h, 3h]`` (q/k/v major) first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from .encoder import Dense, EmbedderClassifier

# flax path -> (torch tensor, expected flax shape, numpy transform)
_Leaf = Tuple[torch.Tensor, Tuple[int, ...],
              Callable[[np.ndarray], np.ndarray]]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


def _dense(prefix: str, module: Dense) -> Dict[str, _Leaf]:
    out_f, in_f = module.weight.shape
    return {f"{prefix}/kernel": (module.weight, (in_f, out_f), _transpose),
            f"{prefix}/bias": (module.bias, (out_f,), _same)}


def _layer_norm(prefix: str, module: torch.nn.LayerNorm) -> Dict[str, _Leaf]:
    n = module.weight.shape[0]
    return {f"{prefix}/scale": (module.weight, (n,), _same),
            f"{prefix}/bias": (module.bias, (n,), _same)}


def flax_leaves(model: EmbedderClassifier) -> Dict[str, _Leaf]:
    """Every flax leaf path the model expects, with its target."""
    cfg = model.cfg
    h = cfg.hidden
    enc = model.encoder
    leaves: Dict[str, _Leaf] = {
        "encoder/embed_tokens": (enc.embed_tokens,
                                 tuple(enc.embed_tokens.shape), _same),
        "encoder/embed_positions": (enc.embed_positions,
                                    tuple(enc.embed_positions.shape), _same),
    }
    leaves.update(_layer_norm("encoder/ln_embed", enc.ln_embed))
    for i, layer in enumerate(enc.layers):
        p = f"encoder/layers_{i}"
        leaves[f"{p}/attn/qkv/kernel"] = (
            layer.attn.qkv.weight, (h, 3, h),
            lambda a: a.reshape(a.shape[0], -1).T)
        leaves[f"{p}/attn/qkv/bias"] = (
            layer.attn.qkv.bias, (3, h), lambda a: a.reshape(-1))
        leaves.update(_dense(f"{p}/attn/attn_out", layer.attn.attn_out))
        leaves.update(_layer_norm(f"{p}/ln_attn", layer.ln_attn))
        leaves.update(_dense(f"{p}/mlp/mlp_up", layer.mlp.mlp_up))
        leaves.update(_dense(f"{p}/mlp/mlp_down", layer.mlp.mlp_down))
        leaves.update(_layer_norm(f"{p}/ln_mlp", layer.ln_mlp))
    leaves.update(_dense("cls_head/pooler", model.cls_head.pooler))
    leaves.update(_dense("cls_head/head", model.cls_head.head))
    return leaves


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def load_flax_params(model: EmbedderClassifier,
                     tree: Mapping[str, Any]) -> EmbedderClassifier:
    """Copy a flax ``EmbedderClassifier`` param tree (numpy leaves, with or
    without the top-level ``params`` key) into ``model``, in place."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    given = _flatten(tree)
    expected = flax_leaves(model)
    missing = sorted(set(expected) - set(given))
    unknown = sorted(set(given) - set(expected))
    if missing or unknown:
        raise ValueError(f"flax param tree does not match the model: "
                         f"missing {missing}, unknown {unknown}")
    arrays = {}
    for path, (_, shape, _) in expected.items():
        arr = np.asarray(given[path])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, "
                             f"expected {shape}")
        arrays[path] = arr
    with torch.no_grad():
        for path, (target, _, transform) in expected.items():
            src = np.array(transform(arrays[path]), dtype=np.float32,
                           order="C")  # a writable copy
            target.copy_(torch.from_numpy(src))
    return model

"""Move the reference's flax param trees into and out of the port's modules:
the text `EmbedderClassifier` or `Classifier` (`load_flax_params`,
`flax_tree`, and `flax_grads` for the gradients), `Whisper`
(`load_whisper_params`, `whisper_flax_tree`), and the leaves themselves
(`load_leaves`, `leaves_tree`), which the trainer also uses for tensors laid
out as the weights (AdamW's moments).

The tree is plain numpy (``jax.tree.map(np.asarray, params)`` on the
reference side, or `models/hf_convert` / `models/quant` here), so this
module imports no JAX.  Every leaf is mapped by name; a missing leaf, an
unknown leaf, a shape mismatch or a float leaf where int8 is expected
raises — no leaf is ever skipped.  Flax kernels are ``[in, out]`` and are
transposed into ``nn.Linear``'s ``[out, in]``; the fused ``qkv`` kernel
``[h, 3, h]`` is reshaped to ``[h, 3h]`` (q/k/v major) first.  Flax conv
kernels ``[k, in, out]`` become ``nn.Conv1d``'s ``[out, in, k]``, and
Switch-MoE expert kernels ``[E, in, out]`` become ``[E, out, in]``.  Float
leaves take the target's dtype (bf16 for Whisper's Dense and conv
weights, as flax casts them at use).  The int8 layout
(``quant="int8"``/``"int8_static"``) has ``kernel_q`` int8 in place of
``kernel``, plus ``scale``, an f32 ``bias`` and, static, ``a_scale``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .encoder import (
    ClassificationHead,
    EmbedderClassifier,
    QuantDense,
    SwitchMoE,
)
from .whisper import MHA, MLP, Whisper

# flax path -> (torch tensor, flax shape, kind): a "kernel" leaf is the
# flax array reshaped to [shape[0], -1] and transposed; a "conv" leaf is
# the flax array with its axes reversed; an "experts" leaf is the flax
# array with its last two axes swapped; a "plain" leaf is the flax array
# reshaped to the tensor's shape.
_Leaf = Tuple[torch.Tensor, Tuple[int, ...], str]


def _kernel(t: torch.Tensor, flax_shape: Tuple[int, ...]) -> _Leaf:
    return (t, flax_shape, "kernel")


def _plain(t: torch.Tensor, flax_shape: Tuple[int, ...]) -> _Leaf:
    return (t, flax_shape, "plain")


def _proj(prefix: str, module: nn.Module,
          flax_kernel_shape: Tuple[int, ...]) -> Dict[str, _Leaf]:
    """A projection's leaves: `Dense` (``kernel``, ``bias``) or `QuantDense`
    (``kernel_q``, ``scale``, ``bias`` [, ``a_scale``])."""
    if isinstance(module, QuantDense):
        out_shape = tuple(module.scale.shape)
        leaves = {
            f"{prefix}kernel_q": _kernel(module.kernel_q, flax_kernel_shape),
            f"{prefix}scale": _plain(module.scale, out_shape),
            f"{prefix}bias": _plain(module.bias, out_shape)}
        if module.a_scale is not None:
            leaves[f"{prefix}a_scale"] = _plain(module.a_scale, ())
        return leaves
    leaves = {f"{prefix}kernel": _kernel(module.weight, flax_kernel_shape)}
    if module.bias is not None:
        leaves[f"{prefix}bias"] = _plain(module.bias, flax_kernel_shape[1:])
    return leaves


def _dense(prefix: str, module: nn.Module) -> Dict[str, _Leaf]:
    w = module.kernel_q if isinstance(module, QuantDense) else module.weight
    out_f, in_f = w.shape
    return _proj(prefix + "/", module, (in_f, out_f))


def _moe(prefix: str, moe: SwitchMoE) -> Dict[str, _Leaf]:
    """The router and the expert kernels (float ``kernel``, or int8
    ``kernel_q`` with its ``[E, out]`` ``scale``)."""
    leaves = _dense(f"{prefix}/router", moe.router)
    quantized = moe.cfg.quantized
    for name in ("experts_up", "experts_down"):
        t = getattr(moe, f"{name}_q" if quantized else name)
        e, out_f, in_f = t.shape
        key = f"{prefix}/{name}/kernel"
        if quantized:
            leaves[f"{key}_q"] = (t, (e, in_f, out_f), "experts")
            leaves[f"{prefix}/{name}/scale"] = _plain(
                getattr(moe, f"{name}_scale"), (e, out_f))
        else:
            leaves[key] = (t, (e, in_f, out_f), "experts")
    return leaves


def _layer_norm(prefix: str, module: nn.LayerNorm) -> Dict[str, _Leaf]:
    n = module.weight.shape[0]
    return {f"{prefix}/scale": _plain(module.weight, (n,)),
            f"{prefix}/bias": _plain(module.bias, (n,))}


def flax_leaves(model: EmbedderClassifier) -> Dict[str, _Leaf]:
    """Every flax leaf path the model expects, with its target."""
    h = model.cfg.hidden
    enc = model.encoder
    leaves: Dict[str, _Leaf] = {
        "encoder/embed_tokens": _plain(enc.embed_tokens,
                                       tuple(enc.embed_tokens.shape)),
        "encoder/embed_positions": _plain(enc.embed_positions,
                                          tuple(enc.embed_positions.shape)),
    }
    leaves.update(_layer_norm("encoder/ln_embed", enc.ln_embed))
    for i, layer in enumerate(enc.layers):
        p = f"encoder/layers_{i}"
        leaves.update(_proj(f"{p}/attn/qkv/", layer.attn.qkv, (h, 3, h)))
        leaves.update(_dense(f"{p}/attn/attn_out", layer.attn.attn_out))
        leaves.update(_layer_norm(f"{p}/ln_attn", layer.ln_attn))
        if model.cfg.n_experts:
            leaves.update(_moe(f"{p}/moe", layer.moe))
        else:
            leaves.update(_dense(f"{p}/mlp/mlp_up", layer.mlp.mlp_up))
            leaves.update(_dense(f"{p}/mlp/mlp_down", layer.mlp.mlp_down))
        leaves.update(_layer_norm(f"{p}/ln_mlp", layer.ln_mlp))
    leaves.update({f"cls_head/{path}": leaf for path, leaf
                   in head_leaves(model.cls_head).items()})
    return leaves


def head_leaves(head: ClassificationHead) -> Dict[str, _Leaf]:
    """The classification head's flax leaves (``pooler``, ``head``)."""
    return {**_dense("pooler", head.pooler), **_dense("head", head.head)}


def flatten_tree(tree: Mapping[str, Any],
                 prefix: str = "") -> Dict[str, Any]:
    """A nested tree as ``{flax path joined by "/": leaf}``."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = value
    return flat


def nest_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """`flatten_tree`'s inverse (`split_flax_path` keeps the keys the
    reference names with a "/")."""
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = split_flax_path(path)
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def load_leaves(tree: Mapping[str, Any],
                expected: Dict[str, _Leaf]) -> None:
    """Copy the tree's leaves into ``expected``'s targets (a model's
    weights, or tensors laid out as them, such as optimizer moments), all
    checked before any is written."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    given = flatten_tree(tree)
    missing = sorted(set(expected) - set(given))
    unknown = sorted(set(given) - set(expected))
    if missing or unknown:
        raise ValueError(f"flax param tree does not match the model: "
                         f"missing {missing}, unknown {unknown}")
    arrays = {}
    for path, (target, shape, _) in expected.items():
        arr = np.asarray(given[path])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, "
                             f"expected {shape}")
        want_int8 = target.dtype == torch.int8
        if want_int8 != (arr.dtype == np.int8):
            raise ValueError(f"{path}: dtype {arr.dtype}, expected "
                             f"{'int8' if want_int8 else 'a float'}")
        arrays[path] = arr
    with torch.no_grad():
        for path, (target, _, kind) in expected.items():
            arr = arrays[path]
            if kind == "kernel":
                arr = arr.reshape(arr.shape[0], -1).T
            elif kind == "conv":
                arr = arr.transpose(2, 1, 0)
            elif kind == "experts":
                arr = arr.transpose(0, 2, 1)
            src = np.array(arr.reshape(target.shape), order="C",
                           dtype=np.int8 if arr.dtype == np.int8
                           else np.float32)  # a writable copy
            target.copy_(torch.from_numpy(src))


def leaves_tree(expected: Dict[str, _Leaf]) -> Dict[str, Any]:
    """``{"params": tree}`` of the targets' values in flax layout
    (`load_leaves`'s inverse): f32 numpy, or int8 for int8 targets."""
    flat: Dict[str, Any] = {}
    for path, (t, shape, kind) in expected.items():
        a = t.detach().cpu()
        a = a if a.dtype == torch.int8 else a.float()
        if kind == "kernel":
            a = a.T
        elif kind == "conv":
            a = a.permute(2, 1, 0)
        elif kind == "experts":
            a = a.transpose(1, 2)
        flat[path] = a.reshape(shape).numpy().copy()
    return {"params": nest_tree(flat)}


def load_flax_params(model: EmbedderClassifier,
                     tree: Mapping[str, Any]) -> EmbedderClassifier:
    """Copy a flax ``EmbedderClassifier`` param tree (numpy leaves, with or
    without the top-level ``params`` key) into ``model``, in place.  Float
    leaves are cast to each target's dtype; int8 targets take int8 leaves
    only."""
    load_leaves(tree, flax_leaves(model))
    return model


def flax_tree(model: EmbedderClassifier) -> Dict[str, Any]:
    """The model's weights as a flax ``{"params": ...}`` tree of numpy
    arrays (f32, or int8 for ``kernel_q``): `load_flax_params`'s
    inverse."""
    return leaves_tree(flax_leaves(model))


def flax_grads(model: nn.Module) -> Dict[str, Any]:
    """The gradients of the model's weights as a flax ``{"params": ...}``
    tree of f32 numpy arrays (zeros where a weight has no gradient)."""
    return leaves_tree({
        path: (t.grad if t.grad is not None else torch.zeros_like(t),
               shape, kind)
        for path, (t, shape, kind) in flax_leaves(model).items()})


def _mha(prefix: str, mha: MHA) -> Dict[str, _Leaf]:
    leaves: Dict[str, _Leaf] = {}
    for name in ("q", "k", "v", "attn_out"):
        leaves.update(_dense(f"{prefix}/{name}", getattr(mha, name)))
    return leaves


def _mlp(prefix: str, mlp: MLP) -> Dict[str, _Leaf]:
    return {**_dense(f"{prefix}/mlp_up", mlp.mlp_up),
            **_dense(f"{prefix}/mlp_down", mlp.mlp_down)}


def _conv(prefix: str, conv: nn.Conv1d) -> Dict[str, _Leaf]:
    out_c, in_c, k = conv.weight.shape
    return {f"{prefix}/kernel": (conv.weight, (k, in_c, out_c), "conv"),
            f"{prefix}/bias": _plain(conv.bias, (out_c,))}


def whisper_leaves(model: Whisper) -> Dict[str, _Leaf]:
    """Every flax leaf path of the reference's ``Whisper``, with its
    target."""
    enc, dec = model.encoder, model.decoder
    leaves: Dict[str, _Leaf] = {}
    leaves.update(_conv("encoder/conv1", enc.conv1))
    leaves.update(_conv("encoder/conv2", enc.conv2))
    for i, layer in enumerate(enc.layers):
        p = f"encoder/layers_{i}"
        leaves.update(_mha(f"{p}/attn", layer.attn))
        leaves.update(_mlp(f"{p}/mlp", layer.mlp))
        leaves.update(_layer_norm(f"{p}/ln_attn", layer.ln_attn))
        leaves.update(_layer_norm(f"{p}/ln_mlp", layer.ln_mlp))
    leaves.update(_layer_norm("encoder/ln_post", enc.ln_post))
    for name in ("embed_tokens", "embed_positions"):
        t = getattr(dec, name)
        leaves[f"decoder/{name}"] = _plain(t, tuple(t.shape))
    for i, layer in enumerate(dec.layers):
        p = f"decoder/layers_{i}"
        leaves.update(_mha(f"{p}/attn", layer.attn))
        leaves.update(_mha(f"{p}/cross_attn", layer.cross_attn))
        leaves.update(_mlp(f"{p}/mlp", layer.mlp))
        for ln in ("ln_attn", "ln_cross", "ln_mlp"):
            leaves.update(_layer_norm(f"{p}/{ln}", getattr(layer, ln)))
    leaves.update(_layer_norm("decoder/ln_post", dec.ln_post))
    return leaves


def load_whisper_params(model: Whisper, tree: Mapping[str, Any]) -> Whisper:
    """Copy a flax ``Whisper`` param tree (numpy leaves, with or without
    the top-level ``params`` key) into ``model``, in place: Dense and conv
    weights in the model's activation dtype, LayerNorms and the decoder's
    embedding tables in f32."""
    load_leaves(tree, whisper_leaves(model))
    return model


def whisper_flax_tree(model: Whisper) -> Dict[str, Any]:
    """The model's weights as a flax ``{"params": ...}`` tree of f32 numpy
    arrays: `load_whisper_params`'s inverse."""
    return leaves_tree(whisper_leaves(model))


# Params the reference declares with a "/" in their name: one key of
# their module's subtree (``attn/qkv/kernel``, ``moe/experts_up/scale``).
_SLASHED = ("qkv", "experts_up", "experts_down")


def split_flax_path(path: str):
    """A flax path into tree keys."""
    parts = path.split("/")
    if len(parts) >= 2 and parts[-2] in _SLASHED:
        return parts[:-2] + [f"{parts[-2]}/{parts[-1]}"]
    return parts

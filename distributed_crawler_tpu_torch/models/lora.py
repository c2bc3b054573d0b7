"""LoRA fine-tuning for the encoder projections (serving-compatible).

The counterpart of `distributed_crawler_tpu/models/lora.py`: low-rank
adapters on the four projection GEMMs of every layer (``qkv``,
``attn_out``, ``mlp_up``, ``mlp_down``) trained jointly with the head, the
effective kernel ``W + (alpha / rank) * A @ B`` with ``B`` zero at the
start, so step 0 is the pretrained model.  The adapters are merged into the
kernels inside every step (two small products per projection), so the
trained graph keeps the serving layout, and the result is a plain f32
param tree the engine's ``checkpoint_dir`` and the int8 converter take
unchanged.  MoE expert kernels get no adapters, as in the reference.

Adapters are flax-layout numpy trees, ``{layers_i: {"attn/qkv/kernel":
{"a": [in, r], "b": [r, *out]}, ...}}``.  `init_lora_params` draws ``a``
from a ``torch.Generator`` (the reference draws from JAX's PRNG, so the
tests feed the reference's adapters in through ``finetune_lora(lora=...)``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .encoder import Classifier, EncoderConfig
from .from_jax import flax_tree, head_leaves, leaves_tree, load_flax_params
from .train import (
    TrainConfig,
    accuracy,
    cross_entropy,
    epoch_batches,
    full_f32,
    make_optimizer,
    prepare_finetune_arrays,
    train_config,
)

# Adapted kernels as key paths into a layer dict: the fused QKV is a flat
# "qkv/kernel" leaf of the attn dict, the others Dense subtrees.
_TARGETS = (("attn", "qkv/kernel"), ("attn", "attn_out", "kernel"),
            ("mlp", "mlp_up", "kernel"), ("mlp", "mlp_down", "kernel"))
_TARGET_BY_KEY = {"/".join(p): p for p in _TARGETS}
# The port module holding each target's weight ([out, in]).
_MODULE_BY_KEY = {"attn/qkv/kernel": "attn.qkv",
                  "attn/attn_out/kernel": "attn.attn_out",
                  "mlp/mlp_up/kernel": "mlp.mlp_up",
                  "mlp/mlp_down/kernel": "mlp.mlp_down"}


def _get_path(tree: Any, path: Tuple[str, ...]) -> Any:
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _copy_and_set(tree: Dict, path: Tuple[str, ...], value: Any) -> Dict:
    """A copy of ``tree`` with ``path`` replaced (containers along the path
    copied, everything else shared)."""
    out = dict(tree)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = _copy_and_set(out[path[0]], path[1:], value)
    return out


def init_lora_params(generator: torch.Generator, params: Any,
                     rank: int) -> Dict:
    """Adapters for every target kernel of ``params`` (a flax tree, or a
    model whose `flax_tree` is taken): ``a`` normal / sqrt(in) drawn from
    ``generator`` in layer and target order, ``b`` zeros."""
    if isinstance(params, nn.Module):
        params = flax_tree(params)
    enc = params["params"]["encoder"]
    lora: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for lname, layer in enc.items():
        if not lname.startswith("layers_"):
            continue
        adapters: Dict[str, Dict[str, np.ndarray]] = {}
        for path in _TARGETS:
            kern = _get_path(layer, path)
            if kern is None:
                continue
            in_dim, out_shape = kern.shape[0], tuple(kern.shape[1:])
            a = torch.randn((in_dim, rank), generator=generator,
                            dtype=torch.float32) / math.sqrt(in_dim)
            adapters["/".join(path)] = {
                "a": a.numpy(),
                "b": np.zeros((rank,) + out_shape, np.float32)}
        if adapters:
            lora[lname] = adapters
    if not lora:
        raise ValueError("no LoRA target kernels found in params")
    return lora


def lora_rank_of(lora: Dict) -> int:
    """The rank the adapters were initialized with (the ``a`` column dim)."""
    first_layer = next(iter(lora.values()))
    first = next(iter(first_layer.values()))
    return int(np.shape(first["a"])[1])


def _merge_encoder(enc: Dict, lora: Dict, scale: float) -> Dict:
    """Fold adapters into a copy of an encoder subtree (numpy, f32)."""
    enc = dict(enc)
    for lname, adapters in lora.items():
        layer = enc[lname]
        for key, ab in adapters.items():
            path = _TARGET_BY_KEY[key]
            kern = np.asarray(_get_path(layer, path), np.float32)
            delta = np.tensordot(np.asarray(ab["a"], np.float32),
                                 np.asarray(ab["b"], np.float32),
                                 axes=([1], [0]))
            layer = _copy_and_set(layer, path,
                                  kern + np.float32(scale) * delta)
        enc[lname] = layer
    return enc


def _copy_tree(tree: Any) -> Any:
    return ({k: _copy_tree(v) for k, v in tree.items()}
            if isinstance(tree, Mapping) else tree)


def merge_lora(params: Any, lora: Dict, rank: Optional[int] = None,
               alpha: float = 16.0) -> Any:
    """Fold the adapters into a new plain float param tree (the base is
    untouched).  ``rank`` defaults to the adapters' own; another value is
    refused rather than mis-scaling every merged kernel."""
    actual = lora_rank_of(lora)
    if rank is not None and rank != actual:
        raise ValueError(f"rank {rank} does not match the adapters' "
                         f"rank {actual}")
    tree = _copy_tree(params)
    tree["params"]["encoder"] = _merge_encoder(
        tree["params"]["encoder"], lora, alpha / float(actual))
    return tree


class LoraStep:
    """One update of the adapters and the head: the frozen base weights,
    each adapted kernel replaced by ``W + scale * (A @ B)`` in the forward
    (``torch.func.functional_call``), clipping over (adapters, head)."""

    def __init__(self, ecfg: EncoderConfig, params: Any, lora: Dict,
                 alpha: float, tc: TrainConfig,
                 device: Optional[Any] = None):
        self.device = resolve_device(device)
        self.tc = tc
        self.rank = lora_rank_of(lora)
        self.scale = alpha / float(self.rank)
        with torch.device(self.device):
            self.model = Classifier(train_config(ecfg, attention="xla"))
        load_flax_params(self.model, params)
        self.model.train()
        for p in self.model.encoder.parameters():
            p.requires_grad_(False)
        # (weight name, a, b) per adapted kernel, and the optimizer's
        # leaves: the adapters in flax layout, then the head.
        self.targets: List[Tuple[str, torch.Tensor, torch.Tensor]] = []
        leaves: Dict[str, tuple] = {}
        for lname, adapters in lora.items():
            i = int(lname.split("_", 1)[1])
            for key, ab in adapters.items():
                ts = []
                for part in ("a", "b"):
                    t = nn.Parameter(torch.tensor(
                        np.asarray(ab[part], np.float32),
                        device=self.device))
                    leaves[f"{lname}/{key}/{part}"] = (
                        t, tuple(t.shape), "plain")
                    ts.append(t)
                name = f"encoder.layers.{i}.{_MODULE_BY_KEY[key]}.weight"
                self.targets.append((name, ts[0], ts[1]))
        self.head_leaves = head_leaves(self.model.cls_head)
        leaves.update({f"cls_head/{p}": leaf
                       for p, leaf in self.head_leaves.items()})
        self.leaves = leaves
        self.optimizer = make_optimizer(tc, leaves)
        self._weights = dict(self.model.named_parameters())

    def merged(self) -> Dict[str, torch.Tensor]:
        """The adapted weights ``W + scale * (A @ B)`` in the model's
        ``[out, in]`` layout."""
        out = {}
        for name, a, b in self.targets:
            delta = (a @ b.reshape(b.shape[0], -1)).T
            out[name] = self._weights[name] + self.scale * delta
        return out

    @full_f32()
    def __call__(self, ids, mask, labels) -> Dict[str, torch.Tensor]:
        dev = self.device
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool,
                               device=dev)
        y = torch.as_tensor(np.asarray(labels), dtype=torch.long,
                            device=dev)
        self.optimizer.zero_grad()
        logits = torch.func.functional_call(self.model, self.merged(),
                                            (ids, mask))
        loss = cross_entropy(logits, y, self.tc.label_smoothing)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), y)}

    def lora(self) -> Dict:
        """The adapters as a flax-layout numpy tree."""
        out: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        for path, (t, _, _) in self.leaves.items():
            if path.startswith("cls_head/"):
                continue
            lname, rest = path.split("/", 1)
            key, part = rest.rsplit("/", 1)
            out.setdefault(lname, {}).setdefault(key, {})[part] = \
                t.detach().cpu().numpy().copy()
        return out

    def head(self) -> Dict[str, Any]:
        return leaves_tree(self.head_leaves)["params"]


def finetune_lora(ecfg: EncoderConfig, params: Any,
                  token_lists: Sequence[Sequence[int]],
                  labels: Sequence[int],
                  rank: int = 8, alpha: float = 16.0,
                  tc: TrainConfig = TrainConfig(learning_rate=1e-4,
                                                warmup_steps=10),
                  epochs: int = 10, batch_size: int = 16,
                  seed: int = 0,
                  max_len: Optional[int] = None,
                  lora: Optional[Dict] = None,
                  device: Optional[Any] = None
                  ) -> Tuple[Any, List[Dict[str, float]]]:
    """LoRA + head fine-tune; returns ``(merged_params, history)``, the
    merged tree engine-loadable like any full fine-tune.  ``lora`` gives
    the starting adapters (default: `init_lora_params` from
    ``torch.Generator().manual_seed(seed)``)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    ids_np, mask_np, labels_np = prepare_finetune_arrays(
        ecfg, token_lists, labels, epochs, max_len)
    if lora is None:
        lora = init_lora_params(torch.Generator().manual_seed(seed), params,
                                rank)
    elif lora_rank_of(lora) != rank:
        raise ValueError(f"rank {rank} does not match the adapters' "
                         f"rank {lora_rank_of(lora)}")
    step = LoraStep(ecfg, params, lora, alpha, tc, device)
    rng = np.random.default_rng(seed)
    history: List[Dict[str, float]] = []
    for _ in range(epochs):
        losses, accs = [], []
        for idx in epoch_batches(rng, len(token_lists), batch_size):
            m = step(ids_np[idx], mask_np[idx], labels_np[idx])
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        history.append({"loss": float(np.mean(losses)),
                        "accuracy": float(np.mean(accs))})
    merged = merge_lora(params, step.lora(), rank, alpha)
    merged = {"params": {**merged["params"], "cls_head": step.head()}}
    return merged, history

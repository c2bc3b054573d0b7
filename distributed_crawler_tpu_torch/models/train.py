"""Training: classifier fine-tuning on the crawl stream, in PyTorch.

The counterpart of `distributed_crawler_tpu/models/train.py`, with the
same configuration, batch order and update rule:

- `make_optimizer`: optax's ``chain(clip_by_global_norm(max_grad_norm),
  adamw(linear_schedule(0, lr, warmup_steps), weight_decay))`` written on
  ``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8, decay on every
  parameter, biases and LayerNorms included).  The learning rate is the
  schedule at the number of updates made before the step, so the first
  update moves nothing; clipping scales by ``max / ||g||`` only when
  ``||g|| >= max``, with no epsilon, over the whole trained tree;
- `make_train_step`: one update of the full model per call (the
  reference's ``step_fn``), the Switch-MoE aux loss at ``moe_aux_weight``,
  gradient accumulation as the sum of the microbatches' gradients scaled
  by ``1 / grad_accum_steps``;
- `finetune_head` (frozen-encoder features, then the head alone) and
  `finetune_full` (every weight, resumable per epoch through
  ``state_dir``); `models/lora.finetune_lora` is the third scope.

The trainer's model is f32 throughout: the port's projections hold their
weights in the activation dtype, so f32 master weights mean f32
activations (the reference keeps f32 weights and casts them to its
activation dtype at use).  The full and LoRA scopes differentiate the
model, and the attention kernels have no backward, so they build it with
``attention="xla"`` (the plain version), as the reference's trainer pins
XLA attention for its Pallas kernel; `encode_cls_features` runs under
``torch.no_grad()`` through the model's own attention, which on the card is
the kernel.  On the card every product is f32 without TF32 while a trainer
runs (`full_f32`).  Parameters move in and out as the reference's flax
trees of numpy arrays (`models/from_jax.py`); batch order comes from numpy
``Generator``s, as in the reference.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .encoder import Classifier, ClassificationHead, EncoderConfig
from .from_jax import (
    flax_leaves,
    head_leaves,
    leaves_tree,
    load_flax_params,
    load_leaves,
)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    label_smoothing: float = 0.0
    # Switch load-balancing aux-loss weight; no effect on dense models.
    moe_aux_weight: float = 0.01
    # Microbatches per step: their gradients are summed, then scaled by
    # 1 / grad_accum_steps before the one update.
    grad_accum_steps: int = 1


@contextlib.contextmanager
def full_f32():
    """f32 products without TF32 on the card while the block runs (the
    previous settings come back after), whatever another caller set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train_config(ecfg: EncoderConfig, attention: Optional[str] = None
                 ) -> EncoderConfig:
    """The model the trainer builds: f32 float projections, and
    ``attention`` when given."""
    cfg = replace(ecfg, dtype="float32", quant="none", calibrate=False)
    return replace(cfg, attention=attention) if attention else cfg


def learning_rate(tc: TrainConfig, count: int) -> float:
    """``optax.linear_schedule(0, tc.learning_rate, tc.warmup_steps)`` at
    ``count``: 0 at count 0, the full rate from ``warmup_steps`` on, and 0
    throughout when ``warmup_steps`` is not positive (optax's rule)."""
    if tc.warmup_steps <= 0:
        return 0.0
    frac = 1.0 - min(max(count, 0), tc.warmup_steps) / tc.warmup_steps
    return -tc.learning_rate * frac + tc.learning_rate


class Optimizer:
    """The reference's optimizer over named parameters: clipping by the
    global norm, then AdamW at the scheduled rate.  ``leaves`` maps each
    flax path to ``(parameter, flax shape, kind)`` (`models/from_jax`), so
    the moments can be written and read under their parameters' paths."""

    def __init__(self, tc: TrainConfig, leaves: Mapping[str, tuple]):
        self.tc = tc
        self.leaves = dict(leaves)
        self.params = [leaf[0] for leaf in self.leaves.values()]
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=tc.weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def clip(self) -> torch.Tensor:
        """Scale every gradient by ``max / ||g||`` when the global norm
        ``||g||`` reaches ``max_grad_norm``; returns the norm."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.tc.max_grad_norm,
                            torch.ones_like(norm),
                            self.tc.max_grad_norm / norm)
        for g in grads:
            g.mul_(scale)
        return norm

    def step(self) -> None:
        """One update from the gradients in ``.grad`` (a parameter with
        none counts as zero: optax still decays it)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip()
        lr = learning_rate(self.tc, self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1

    def state_tree(self) -> Dict[str, Any]:
        """``{"exp_avg": tree, "exp_avg_sq": tree, "step", "count"}``: each
        moment under its parameter's flax path, AdamW's step count and the
        schedule's count (equal: one of each per update)."""
        out: Dict[str, Any] = {}
        for moment in ("exp_avg", "exp_avg_sq"):
            out[moment] = leaves_tree({
                path: (self._moment(p, moment), shape, kind)
                for path, (p, shape, kind) in self.leaves.items()
            })["params"]
        out["step"] = np.asarray(self.count, np.int64)
        out["count"] = np.asarray(self.count, np.int64)
        return out

    def _moment(self, p: torch.Tensor, name: str) -> torch.Tensor:
        state = self.adamw.state.get(p)
        return state[name] if state else torch.zeros_like(p)

    def load_state_tree(self, tree: Mapping[str, Any]) -> None:
        """Restore `state_tree`'s output exactly."""
        count = int(np.asarray(tree["count"]))
        if int(np.asarray(tree["step"])) != count:
            raise ValueError(f"optimizer state: step {tree['step']} != "
                             f"count {tree['count']}")
        moments = {}
        for name in ("exp_avg", "exp_avg_sq"):
            moments[name] = {path: torch.empty_like(p)
                             for path, (p, _, _) in self.leaves.items()}
            load_leaves(tree[name], {
                path: (moments[name][path], shape, kind)
                for path, (_, shape, kind) in self.leaves.items()})
        for path, (p, _, _) in self.leaves.items():
            self.adamw.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moments["exp_avg"][path],
                "exp_avg_sq": moments["exp_avg_sq"][path]}
        self.count = count


def make_optimizer(tc: TrainConfig, leaves: Mapping[str, tuple]
                   ) -> Optimizer:
    return Optimizer(tc, leaves)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    n = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n).float()
    if smoothing:
        onehot = onehot * (1.0 - smoothing) + smoothing / n
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax is the label (f32 scalar)."""
    return torch.mean((torch.argmax(logits, -1) == labels).float())


class TrainStep:
    """The reference's ``make_train_step``: a `Classifier` with the
    params, its optimizer, and one update per call of ``(ids, mask,
    labels)`` (numpy or tensors), returning ``{"loss", "accuracy",
    "moe_aux"}`` as f32 scalars on the device."""

    def __init__(self, cfg: EncoderConfig, tc: TrainConfig, params: Any,
                 device: Optional[Any] = None):
        self.device = resolve_device(device)
        self.cfg = train_config(cfg, attention="xla")
        self.tc = tc
        with torch.device(self.device):
            self.model = Classifier(self.cfg).train()
        load_flax_params(self.model, params)
        self.leaves = flax_leaves(self.model)
        self.optimizer = make_optimizer(tc, self.leaves)

    def _tensors(self, ids, mask, labels):
        dev = self.device
        return (torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                device=dev),
                torch.as_tensor(np.asarray(mask), dtype=torch.bool,
                                device=dev),
                torch.as_tensor(np.asarray(labels), dtype=torch.long,
                                device=dev))

    def loss(self, ids: torch.Tensor, mask: torch.Tensor,
             labels: torch.Tensor):
        """(loss with the aux term, accuracy, aux) of one forward."""
        logits, aux = self.model(ids, mask, with_aux=True)
        loss = cross_entropy(logits, labels, self.tc.label_smoothing)
        return (loss + self.tc.moe_aux_weight * aux,
                accuracy(logits, labels), aux)

    @full_f32()
    def grads(self, ids, mask, labels) -> Dict[str, torch.Tensor]:
        """The step's gradients into ``.grad`` (summed over microbatches,
        then scaled by 1/a) and its metrics, without the update."""
        ids, mask, labels = self._tensors(ids, mask, labels)
        a = max(self.tc.grad_accum_steps, 1)
        b = ids.shape[0]
        if b % a:
            raise ValueError(
                f"batch {b} not divisible by grad_accum_steps {a}")
        m = b // a
        self.optimizer.zero_grad()
        sums = [torch.zeros((), device=self.device) for _ in range(3)]
        for i in range(a):
            sl = slice(i * m, (i + 1) * m)
            loss, acc, aux = self.loss(ids[sl], mask[sl], labels[sl])
            loss.backward()
            for s, v in zip(sums, (loss, acc, aux)):
                s += v.detach()
        if a > 1:
            inv = 1.0 / a
            for p in self.optimizer.params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            sums = [s * inv for s in sums]
        return dict(zip(("loss", "accuracy", "moe_aux"), sums))

    @full_f32()
    def __call__(self, ids, mask, labels) -> Dict[str, torch.Tensor]:
        metrics = self.grads(ids, mask, labels)
        self.optimizer.step()
        return metrics

    def params(self) -> Dict[str, Any]:
        """The trained weights as the reference's ``params`` subtree
        (``{"encoder", "cls_head"}``, f32 numpy)."""
        return leaves_tree(self.leaves)["params"]

    def opt_state(self) -> Dict[str, Any]:
        return self.optimizer.state_tree()

    def load(self, params: Any, opt_state: Any) -> None:
        load_flax_params(self.model, params)
        self.optimizer.load_state_tree(opt_state)


def make_train_step(cfg: EncoderConfig, tc: TrainConfig, params: Any,
                    device: Optional[Any] = None) -> TrainStep:
    return TrainStep(cfg, tc, params, device)


# ---------------------------------------------------------------------------
# Head-only fine-tune on a frozen encoder (BASELINE config #3 closing loop)
# ---------------------------------------------------------------------------

@full_f32()
def encode_cls_features(ecfg: EncoderConfig, params: Any,
                        token_lists: Sequence[Sequence[int]],
                        batch_size: int = 64,
                        buckets: Optional[Sequence[int]] = None,
                        device: Optional[Any] = None) -> np.ndarray:
    """The frozen encoder's first-token state ``[N, H]`` (f32) over the
    tokenized texts: the model in ``ecfg``'s dtype, through its own
    attention, on ``device`` (`cls_features`)."""
    with torch.device(resolve_device(device)):
        model = Classifier(replace(ecfg, quant="none", calibrate=False))
    load_flax_params(model, params)
    return cls_features(model.encoder, token_lists, batch_size, buckets)


@full_f32()
def cls_features(encoder: nn.Module, token_lists: Sequence[Sequence[int]],
                 batch_size: int = 64,
                 buckets: Optional[Sequence[int]] = None) -> np.ndarray:
    """`encode_cls_features` with a loaded `Encoder`, on its device: the
    texts grouped into length buckets (default the engine's ladder capped
    at the context), ``batch_size`` rows per forward, under
    ``torch.no_grad()``."""
    from ..ops.padding import BucketSpec, bucket_for, pack_batch

    ecfg = encoder.cfg
    dev = encoder.embed_tokens.device
    encoder.eval()
    if buckets is None:
        buckets = (32, 64, 128, 256, 512)
    lengths = tuple(b for b in sorted(buckets) if b <= ecfg.max_len) \
        or (ecfg.max_len,)
    spec = BucketSpec(lengths)
    feats = np.zeros((len(token_lists), ecfg.hidden), np.float32)
    groups: Dict[int, List[int]] = {}
    for i, toks in enumerate(token_lists):
        groups.setdefault(bucket_for(len(toks), spec), []).append(i)
    with torch.no_grad():
        for bucket, indices in sorted(groups.items()):
            for start in range(0, len(indices), batch_size):
                chunk = indices[start:start + batch_size]
                ids, mask = pack_batch(
                    [list(token_lists[i]) for i in chunk],
                    BucketSpec((bucket,)), batch_pad_to=batch_size)
                hidden = encoder(
                    torch.as_tensor(ids, dtype=torch.long, device=dev),
                    torch.as_tensor(mask, device=dev))
                out = hidden[:, 0, :].float().cpu().numpy()
                feats[chunk] = out[:len(chunk)]
    return feats


def _check_dataset(ecfg: EncoderConfig, token_lists: Sequence,
                   labels: Sequence[int], epochs: int) -> None:
    if len(token_lists) != len(labels):
        raise ValueError(f"{len(token_lists)} texts vs {len(labels)} labels")
    if not token_lists:
        raise ValueError("empty training set")
    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    if min(labels) < 0:
        raise ValueError(f"negative label id {min(labels)} is not a class")
    n_labels = int(max(labels)) + 1
    if n_labels > ecfg.n_labels:
        raise ValueError(
            f"label id {n_labels - 1} exceeds head width {ecfg.n_labels}")


def prepare_finetune_arrays(ecfg: EncoderConfig,
                            token_lists: Sequence[Sequence[int]],
                            labels: Sequence[int], epochs: int,
                            max_len: Optional[int] = None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Validate the dataset, then pack the tokens into one static
    ``[N, L]`` shape: L the longest sequence rounded up to a multiple of
    32, capped at the encoder's context.  Returns ``(ids, mask, labels)``."""
    _check_dataset(ecfg, token_lists, labels, epochs)
    seq = max(len(t) for t in token_lists)
    seq = min(ecfg.max_len, max_len or ecfg.max_len, ((seq + 31) // 32) * 32)
    ids_np = np.zeros((len(token_lists), seq), np.int32)
    mask_np = np.zeros((len(token_lists), seq), bool)
    for i, toks in enumerate(token_lists):
        toks = list(toks)[:seq]
        ids_np[i, :len(toks)] = toks
        mask_np[i, :len(toks)] = True
    return ids_np, mask_np, np.asarray(labels, np.int32)


def epoch_batches(rng: np.random.Generator, n: int, batch_size: int):
    """Shuffled minibatch index arrays for one epoch, every batch padded to
    ``batch_size`` (tail batches repeat earlier rows)."""
    order = rng.permutation(n)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size:
            idx = (np.concatenate([idx, order[:batch_size - len(idx)]])
                   if n >= batch_size else np.resize(idx, batch_size))
        yield idx


class HeadStep:
    """One update of the classification head alone on feature rows: the
    step of `finetune_head`."""

    def __init__(self, ecfg: EncoderConfig, tc: TrainConfig, head: Any,
                 device: Optional[Any] = None):
        self.device = resolve_device(device)
        self.tc = tc
        self.head = ClassificationHead(ecfg)
        self.leaves = head_leaves(self.head)
        load_leaves(head, self.leaves)
        self.head.to(self.device)
        self.optimizer = make_optimizer(tc, self.leaves)

    @full_f32()
    def __call__(self, x: torch.Tensor,
                 y: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad()
        logits = self.head(x)
        loss = cross_entropy(logits, y, self.tc.label_smoothing)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), y)}

    def params(self) -> Dict[str, Any]:
        return leaves_tree(self.leaves)["params"]


def finetune_head(ecfg: EncoderConfig, params: Any,
                  token_lists: Sequence[Sequence[int]],
                  labels: Sequence[int],
                  tc: TrainConfig = TrainConfig(learning_rate=1e-3,
                                                warmup_steps=10),
                  epochs: int = 20, batch_size: int = 32,
                  seed: int = 0,
                  buckets: Optional[Sequence[int]] = None,
                  device: Optional[Any] = None
                  ) -> Tuple[Any, List[Dict[str, float]]]:
    """Fine-tune only the classification head on a frozen encoder.

    Returns ``(new_params, history)``: the whole tree with the trained
    ``cls_head`` in it, and one ``{"loss", "accuracy"}`` per epoch."""
    _check_dataset(ecfg, token_lists, labels, epochs)
    dev = resolve_device(device)
    feats = torch.from_numpy(encode_cls_features(
        ecfg, params, token_lists, batch_size=batch_size, buckets=buckets,
        device=dev)).to(dev)
    labels_t = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    step = HeadStep(ecfg, tc, params["params"]["cls_head"], dev)
    rng = np.random.default_rng(seed)
    history: List[Dict[str, float]] = []
    for _ in range(epochs):
        losses, accs = [], []
        for idx in epoch_batches(rng, len(feats), batch_size):
            idx_t = torch.as_tensor(idx, device=dev)
            m = step(feats[idx_t], labels_t[idx_t])
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        history.append({"loss": float(np.mean(losses)),
                        "accuracy": float(np.mean(accs))})
    return {"params": {**params["params"], "cls_head": step.params()}}, \
        history


def finetune_full(ecfg: EncoderConfig, params: Any,
                  token_lists: Sequence[Sequence[int]],
                  labels: Sequence[int],
                  tc: TrainConfig = TrainConfig(warmup_steps=10),
                  epochs: int = 10, batch_size: int = 16,
                  seed: int = 0,
                  max_len: Optional[int] = None,
                  state_dir: Optional[str] = None,
                  device: Optional[Any] = None
                  ) -> Tuple[Any, List[Dict[str, float]]]:
    """Full fine-tune: every encoder weight and the head through
    `make_train_step`.  With ``state_dir`` params, optimizer state and
    history are saved to ``{state_dir}/epoch_N`` after every epoch, and a
    restart resumes from the newest complete one; each epoch's batch order
    is seeded with ``seed + epoch``, so a resumed run repeats an
    uninterrupted one.

    Returns ``(new_params, history)`` with one ``{"loss", "accuracy",
    "moe_aux"}`` per epoch."""
    ids_np, mask_np, labels_np = prepare_finetune_arrays(
        ecfg, token_lists, labels, epochs, max_len)
    step = make_train_step(ecfg, tc, params, device)
    start_epoch = 0
    history: List[Dict[str, float]] = []
    if state_dir:
        from ..inference.checkpoint import (
            latest_train_state,
            load_train_state,
        )

        prior = latest_train_state(state_dir)
        if prior is not None:
            done_epoch, train_params, opt_state, history = \
                load_train_state(prior)
            step.load(train_params, opt_state)
            start_epoch = done_epoch + 1
            if start_epoch > epochs:
                raise ValueError(
                    f"state_dir holds {start_epoch} completed epochs but "
                    f"only {epochs} were requested — raise epochs to "
                    f"continue or point state_dir elsewhere")

    for epoch in range(start_epoch, epochs):
        rng = np.random.default_rng(seed + epoch)
        losses, accs, auxes = [], [], []
        for idx in epoch_batches(rng, len(token_lists), batch_size):
            m = step(ids_np[idx], mask_np[idx], labels_np[idx])
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
            auxes.append(float(m["moe_aux"]))
        history.append({"loss": float(np.mean(losses)),
                        "accuracy": float(np.mean(accs)),
                        "moe_aux": float(np.mean(auxes))})
        if state_dir:
            from ..inference.checkpoint import save_train_state

            save_train_state(state_dir, epoch, step.params(),
                             step.opt_state(), history)
    return {"params": step.params()}, history

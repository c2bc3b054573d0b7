"""Model checkpoints in the port's own format.

The counterpart of `distributed_crawler_tpu/inference/checkpoint.py`, whose
checkpoints are orbax OCDBT stores: reading those needs orbax and
tensorstore, which the card's machine does not have.  A port checkpoint is
a directory holding

- ``params.safetensors``: every leaf of the flax-layout tree (numpy, as
  `models/from_jax.flax_tree` gives it) under its flax path joined by
  ``/`` (``params/encoder/layers_0/attn/qkv/kernel``, ...), written by
  `models/hf_convert.write_safetensors` and read by ``read_safetensors``;
- ``format.json``: ``{"format": FORMAT, "version": VERSION}``, written
  after the tensors, so a directory without it is not a checkpoint.

`save_params`/`load_params`, `latest_step_dir` (``step_N``) and the
training state (`save_train_state` writes ``epoch_N/`` with params and
the optimizer state, then ``history.json`` as its completion marker;
`latest_train_state`, `load_train_state`) follow the reference.  Nothing
here reads an orbax store; the tests bridge the two formats.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np

from ..models.from_jax import flatten_tree, nest_tree
from ..models.hf_convert import read_safetensors, write_safetensors

FORMAT = "distributed_crawler_tpu_torch.params"
VERSION = 1
PARAMS_FILE = "params.safetensors"
FORMAT_FILE = "format.json"


def save_params(path: str, params: Any, force: bool = True) -> int:
    """Write a param tree (numpy or CPU tensor leaves) as a checkpoint
    directory at ``path``; returns the bytes of its tensor file."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, FORMAT_FILE)) and not force:
        raise FileExistsError(f"checkpoint at {path} exists")
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, FORMAT_FILE)
    if os.path.exists(marker):
        os.remove(marker)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    nbytes = write_safetensors(tmp, flat)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))
    with open(marker + ".tmp", "w", encoding="utf-8") as f:
        json.dump({"format": FORMAT, "version": VERSION}, f)
    os.replace(marker + ".tmp", marker)
    return nbytes


def load_params(path: str, like: Optional[Any] = None) -> Any:
    """Read a checkpoint directory into a nested dict of numpy arrays.
    With ``like`` (a tree of arrays) every leaf must be there with its
    shape, and takes its dtype."""
    path = os.path.abspath(path)
    marker = os.path.join(path, FORMAT_FILE)
    if not os.path.exists(marker):
        raise FileNotFoundError(f"Checkpoint at {path} not found.")
    with open(marker, encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT or meta.get("version") != VERSION:
        raise ValueError(f"{marker}: format {meta.get('format')!r} version "
                         f"{meta.get('version')!r}, expected {FORMAT!r} "
                         f"version {VERSION}")
    flat = read_safetensors(os.path.join(path, PARAMS_FILE))
    if like is not None:
        want = flatten_tree(like)
        if set(want) != set(flat):
            raise ValueError(
                f"checkpoint at {path} does not match: missing "
                f"{sorted(set(want) - set(flat))}, unknown "
                f"{sorted(set(flat) - set(want))}")
        for key, ref in want.items():
            ref = np.asarray(ref)
            if flat[key].shape != ref.shape:
                raise ValueError(f"{key}: shape {flat[key].shape}, "
                                 f"expected {ref.shape}")
            flat[key] = flat[key].astype(ref.dtype, copy=False)
    return nest_tree(flat)


def _indexed_dirs(root: str, prefix: str) -> list:
    """All ``{prefix}N`` subdirectories of ``root`` as (N, path), sorted."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith(prefix):
            try:
                out.append((int(name[len(prefix):]),
                            os.path.join(root, name)))
            except ValueError:
                continue
    return sorted(out)


def latest_step_dir(root: str) -> Optional[str]:
    """Newest step_N subdirectory under a checkpoint root, or None."""
    dirs = _indexed_dirs(root, "step_")
    return dirs[-1][1] if dirs else None


def save_train_state(root: str, epoch: int, params: Any, opt_state: Any,
                     history: Any) -> str:
    """Persist a training state (params, optimizer state, history) as
    ``{root}/epoch_N``; returns the directory.

    ``history.json`` is written last, through a temporary file and
    ``os.replace``: it is the completion marker, so a crash mid-save
    leaves a directory `latest_train_state` skips.  Older complete epochs
    are pruned after the save (only the newest is ever read)."""
    path = os.path.abspath(os.path.join(root, f"epoch_{epoch}"))
    save_params(path, {"params": params, "opt_state": opt_state})
    tmp = os.path.join(path, "history.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"epoch": epoch, "history": history}, f)
    os.replace(tmp, os.path.join(path, "history.json"))
    for n, older in _indexed_dirs(os.path.abspath(root), "epoch_"):
        if n < epoch:
            shutil.rmtree(older, ignore_errors=True)
    return path


def latest_train_state(root: str) -> Optional[str]:
    """Newest complete epoch_N directory under a train-state root, or
    None; directories without ``history.json`` are skipped."""
    for _, path in reversed(_indexed_dirs(root, "epoch_")):
        if os.path.exists(os.path.join(path, "history.json")):
            return path
    return None


def load_train_state(path: str, like_params: Optional[Any] = None,
                     like_opt_state: Optional[Any] = None) -> tuple:
    """``(epoch, params, opt_state, history)`` from an epoch directory
    written by `save_train_state`; the ``like_*`` trees, when given, check
    the leaves and set their dtypes."""
    like = None
    if like_params is not None and like_opt_state is not None:
        like = {"params": like_params, "opt_state": like_opt_state}
    tree = load_params(path, like)
    with open(os.path.join(path, "history.json"), encoding="utf-8") as f:
        meta = json.load(f)
    return (int(meta["epoch"]), tree["params"], tree["opt_state"],
            list(meta["history"]))

"""HuggingFace RoBERTa/XLM-R/E5 and Whisper checkpoints -> the flax-layout
param trees.

The counterpart of `distributed_crawler_tpu/models/hf_convert.py`.  It
produces the same trees of numpy arrays the reference produces, which
`models/from_jax.load_flax_params` / `load_whisper_params` load into the
port's modules.  Local files only:

- ``model.safetensors``, read by :func:`read_safetensors` (a plain reader
  of the format: no ``safetensors`` package needed; :func:`write_safetensors`
  is its writer, for the port's own checkpoints);
- ``pytorch_model.bin``, read with ``torch.load(weights_only=True)``.

Layout notes (RoBERTa family; E5 is an XLM-R encoder):

- torch ``nn.Linear.weight`` is [out, in]; flax ``Dense.kernel`` is
  [in, out] -> transpose;
- RoBERTa position ids start at ``padding_idx + 1 = 2``, so rows 0-1 of the
  HF position table are dead for right-padded input -> slice them off;
- token-type embeddings have one row for these models and every token adds
  row 0 once -> fold it into the position table.

Whisper: ``k_proj`` has no bias; conv weights [out, in, k] become flax's
[k, in, out]; the ``model.`` and ``proj_out.`` prefixes are stripped; the
decoder's tables are f32 and the position table is cut to
``max_target_positions``.  HF's stored ``encoder.embed_positions`` is not
read: the encoder's positions are the fixed sinusoids.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Mapping, Optional

import numpy as np

from .encoder import EncoderConfig
from .whisper import WhisperConfig

_POS_OFFSET = 2  # RoBERTa: padding_idx (1) + 1

# The dtypes ``safetensors.numpy`` reads as they are stored.  BF16 has no
# numpy dtype of its own: the reference's process has JAX imported, which
# registers ml_dtypes' ``bfloat16``, so the library reads it there and the
# converters widen it to f32; this reader widens it to f32 at once (the
# same values).  The F8 family and the rest raise, as in the library.
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "U64": "<u8", "I32": "<i4", "U32": "<u4",
    "I16": "<i2", "U16": "<u2", "I8": "i1", "U8": "u1",
    "BOOL": "?", "C64": "<c8",
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.safetensors`` file into writable numpy arrays: a
    little-endian u64 header length, a JSON header of ``dtype``, ``shape``
    and ``data_offsets`` per tensor, then the raw bytes.  BF16 tensors come
    back as f32, widened exactly."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dt = info["dtype"]
            if dt == "BF16":
                dtype = np.dtype("<u2")
            elif dt in _ST_DTYPES:
                dtype = np.dtype(_ST_DTYPES[dt])
            else:
                raise TypeError(f"data type {dt.lower()!r} not understood")
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(x) for x in info["data_offsets"])
            count = int(np.prod(shape))
            if end - begin != count * dtype.itemsize:
                raise ValueError(f"{path}: tensor {name!r} has {end - begin} "
                                 f"bytes for shape {shape} of {dt}")
            f.seek(base + begin)
            arr = np.fromfile(f, dtype=dtype, count=count)
            if arr.size != count:
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            if dt == "BF16":
                # The upper half of an f32: shift the 16 bits into place.
                arr = (arr.astype("<u4") << 16).view("<f4")
            out[name] = arr.reshape(shape)
    return out


_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> int:
    """Write numpy arrays as a ``.safetensors`` file that
    :func:`read_safetensors` (and the ``safetensors`` package) reads: the
    u64 header length, the JSON header padded with spaces to 8 bytes, then
    each tensor's little-endian bytes in header order.  Returns the bytes
    written."""
    header: Dict[str, Any] = {}
    arrays = []
    off = 0
    for name, a in tensors.items():
        a = np.asarray(a)
        le = a.dtype.newbyteorder("<") if a.dtype.itemsize > 1 else a.dtype
        if le not in _ST_NAMES:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors "
                            f"name")
        a = a.astype(le, order="C", copy=False)
        header[name] = {"dtype": _ST_NAMES[le], "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        arrays.append(a)
        off += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in arrays:
            f.write(a.tobytes())
    return 8 + len(raw) + off


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read an HF checkpoint dir (or a single weight file) into numpy."""
    if os.path.isdir(path):
        st = os.path.join(path, "model.safetensors")
        pt = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(st):
            path = st
        elif os.path.exists(pt):
            path = pt
        else:
            raise FileNotFoundError(
                f"no model.safetensors or pytorch_model.bin under {path}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in state.items()}


def load_hf_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
        return json.load(f)


def encoder_config_from_hf(hf_cfg: Mapping[str, Any],
                           n_labels: int = 2,
                           dtype: str = "bfloat16") -> EncoderConfig:
    """EncoderConfig matching an HF RoBERTa/XLM-R/BERT config.json."""
    return EncoderConfig(
        vocab_size=int(hf_cfg["vocab_size"]),
        hidden=int(hf_cfg["hidden_size"]),
        n_layers=int(hf_cfg["num_hidden_layers"]),
        n_heads=int(hf_cfg["num_attention_heads"]),
        mlp_dim=int(hf_cfg["intermediate_size"]),
        max_len=int(hf_cfg["max_position_embeddings"]) - _POS_OFFSET,
        layer_norm_eps=float(hf_cfg.get("layer_norm_eps", 1e-5)),
        n_labels=n_labels,
        dtype=dtype,
    )


def _strip_prefix(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop a leading model-name prefix (``roberta.``, ``bert.``) if every
    encoder key carries one (classification checkpoints do)."""
    for prefix in ("roberta.", "bert.", "xlm_roberta.", "model."):
        if any(k.startswith(prefix + "embeddings.") for k in state):
            return {k[len(prefix):] if k.startswith(prefix) else k: v
                    for k, v in state.items()}
    return dict(state)


def _dense(state: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(state[f"{key}.weight"].T),
            "bias": state[f"{key}.bias"]}


def _ln(state: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    return {"scale": state[f"{key}.weight"], "bias": state[f"{key}.bias"]}


def convert_roberta_encoder(state: Mapping[str, np.ndarray],
                            cfg: EncoderConfig) -> Dict[str, Any]:
    """HF RoBERTa-family state dict -> the encoder subtree (the value of
    ``params["params"]["encoder"]``)."""
    state = _strip_prefix(state)
    pos = state["embeddings.position_embeddings.weight"][_POS_OFFSET:]
    pos = pos[:cfg.max_len].astype(np.float32).copy()
    type_emb = state.get("embeddings.token_type_embeddings.weight")
    if type_emb is not None:
        pos += type_emb[0][None, :]
    tree: Dict[str, Any] = {
        "embed_tokens": state["embeddings.word_embeddings.weight"].astype(
            np.float32),
        "embed_positions": pos,
        "ln_embed": _ln(state, "embeddings.LayerNorm"),
    }
    for i in range(cfg.n_layers):
        base = f"encoder.layer.{i}"
        # The attention projection is fused: stack HF's separate
        # query/key/value onto the middle axis of one [h, 3, h] kernel.
        q = _dense(state, f"{base}.attention.self.query")
        k = _dense(state, f"{base}.attention.self.key")
        v = _dense(state, f"{base}.attention.self.value")
        tree[f"layers_{i}"] = {
            "attn": {
                "qkv/kernel": np.stack(
                    [q["kernel"], k["kernel"], v["kernel"]], axis=1),
                "qkv/bias": np.stack(
                    [q["bias"], k["bias"], v["bias"]], axis=0),
                "attn_out": _dense(state, f"{base}.attention.output.dense"),
            },
            "ln_attn": _ln(state, f"{base}.attention.output.LayerNorm"),
            "mlp": {
                "mlp_up": _dense(state, f"{base}.intermediate.dense"),
                "mlp_down": _dense(state, f"{base}.output.dense"),
            },
            "ln_mlp": _ln(state, f"{base}.output.LayerNorm"),
        }
    return tree


def convert_classification_head(state: Mapping[str, np.ndarray]
                                ) -> Optional[Dict[str, Any]]:
    """HF RobertaClassificationHead (classifier.dense + classifier.out_proj)
    or BERT pooler+classifier -> the ``cls_head`` subtree; None if the
    checkpoint has no head."""
    if "classifier.dense.weight" in state:
        return {"pooler": _dense(state, "classifier.dense"),
                "head": _dense(state, "classifier.out_proj")}
    if "pooler.dense.weight" in state and "classifier.weight" in state:
        return {"pooler": _dense(state, "pooler.dense"),
                "head": _dense(state, "classifier")}
    return None


def load_hf_encoder(path: str, arch: str = "embedder_classifier",
                    n_labels: Optional[int] = None,
                    dtype: str = "bfloat16"):
    """Load an HF RoBERTa/XLM-R/E5 checkpoint dir into (cfg, params).

    ``arch``: "embedder" (the encoder alone) or "classifier" /
    "embedder_classifier" (encoder and head; raises ValueError when the
    checkpoint has none).  ``n_labels`` None takes the head's width."""
    hf_cfg = load_hf_config(path)
    state = _strip_prefix(load_state_dict(path))
    head = convert_classification_head(state)
    if n_labels is None:
        n_labels = (head["head"]["bias"].shape[0] if head is not None
                    else int(hf_cfg.get("num_labels", 2)))
    cfg = encoder_config_from_hf(hf_cfg, n_labels=n_labels, dtype=dtype)
    encoder = convert_roberta_encoder(state, cfg)
    if arch == "embedder":
        params = {"encoder": encoder}
    else:
        if head is None:
            raise ValueError(
                f"checkpoint at {path} has no classification head; "
                f"load with arch='embedder' or fine-tune a head")
        params = {"encoder": encoder, "cls_head": head}
    return cfg, {"params": params}


# -- Whisper -> models.whisper ------------------------------------------------
def _whisper_attn(state: Mapping[str, np.ndarray],
                  base: str) -> Dict[str, Any]:
    """HF WhisperAttention: ``k_proj`` has no bias."""
    return {
        "q": _dense(state, f"{base}.q_proj"),
        "k": {"kernel": np.ascontiguousarray(
            state[f"{base}.k_proj.weight"].T)},
        "v": _dense(state, f"{base}.v_proj"),
        "attn_out": _dense(state, f"{base}.out_proj"),
    }


def whisper_config_from_hf(hf_cfg: Mapping[str, Any]) -> WhisperConfig:
    """WhisperConfig matching an HF Whisper config.json."""
    return WhisperConfig(
        n_mels=int(hf_cfg["num_mel_bins"]),
        n_vocab=int(hf_cfg["vocab_size"]),
        n_audio_ctx=int(hf_cfg["max_source_positions"]),
        n_audio_state=int(hf_cfg["d_model"]),
        n_audio_head=int(hf_cfg["encoder_attention_heads"]),
        n_audio_layer=int(hf_cfg["encoder_layers"]),
        n_text_ctx=int(hf_cfg["max_target_positions"]),
        n_text_state=int(hf_cfg["d_model"]),
        n_text_head=int(hf_cfg["decoder_attention_heads"]),
        n_text_layer=int(hf_cfg["decoder_layers"]),
    )


def _conv(state: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    """torch Conv1d weight [out, in, k] -> flax Conv kernel [k, in, out]."""
    return {"kernel": np.ascontiguousarray(
                state[f"{key}.weight"].transpose(2, 1, 0)),
            "bias": state[f"{key}.bias"]}


def convert_whisper(state: Mapping[str, np.ndarray],
                    cfg: WhisperConfig) -> Dict[str, Any]:
    """HF WhisperModel/WhisperForConditionalGeneration state dict -> the
    `Whisper` param tree (the value of ``params["params"]``)."""
    s = {re.sub(r"^(model\.|proj_out\.)", "", k): v
         for k, v in state.items()}

    def block(base: str, cross: bool) -> Dict[str, Any]:
        out = {
            "attn": _whisper_attn(s, f"{base}.self_attn"),
            "ln_attn": _ln(s, f"{base}.self_attn_layer_norm"),
            "mlp": {"mlp_up": _dense(s, f"{base}.fc1"),
                    "mlp_down": _dense(s, f"{base}.fc2")},
            "ln_mlp": _ln(s, f"{base}.final_layer_norm"),
        }
        if cross:
            out["cross_attn"] = _whisper_attn(s, f"{base}.encoder_attn")
            out["ln_cross"] = _ln(s, f"{base}.encoder_attn_layer_norm")
        return out

    enc: Dict[str, Any] = {
        "conv1": _conv(s, "encoder.conv1"),
        "conv2": _conv(s, "encoder.conv2"),
        "ln_post": _ln(s, "encoder.layer_norm"),
    }
    for i in range(cfg.n_audio_layer):
        enc[f"layers_{i}"] = block(f"encoder.layers.{i}", cross=False)

    dec: Dict[str, Any] = {
        "embed_tokens": s["decoder.embed_tokens.weight"].astype(np.float32),
        "embed_positions": s["decoder.embed_positions.weight"].astype(
            np.float32)[:cfg.n_text_ctx],
        "ln_post": _ln(s, "decoder.layer_norm"),
    }
    for i in range(cfg.n_text_layer):
        dec[f"layers_{i}"] = block(f"decoder.layers.{i}", cross=True)
    return {"encoder": enc, "decoder": dec}


def load_hf_whisper(path: str):
    """Load an HF Whisper checkpoint dir into (cfg, params)."""
    cfg = whisper_config_from_hf(load_hf_config(path))
    params = convert_whisper(load_state_dict(path), cfg)
    return cfg, {"params": params}

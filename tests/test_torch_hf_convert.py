"""The port's HF checkpoint loading against the JAX package's, on the CPU.

The same synthetic HF RoBERTa checkpoints (`tests/test_hf_convert.py`'s
``make_roberta_state``/``write_checkpoint``) go through both converters;
the trees must be equal leaf by leaf, exactly (same keys, dtypes, shapes
and values): the conversion is slicing, stacking, transposing and one f32
add, done by numpy on both sides.  The port's safetensors reader must
equal ``safetensors.numpy`` on the same file, and raise where it raises.
The tokenizer loader must give the reference's ids.
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from distributed_crawler_tpu.inference import tokenizer as jtok  # noqa: E402
from distributed_crawler_tpu.models import hf_convert as jhf  # noqa: E402
from distributed_crawler_tpu_torch.inference import (  # noqa: E402
    tokenizer as ttok,
)
from distributed_crawler_tpu_torch.models import hf_convert as thf  # noqa: E402
from tests.test_hf_convert import (  # noqa: E402
    HF_CFG,
    make_roberta_state,
    write_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype, k
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("prefix", ["", "roberta."])
@pytest.mark.parametrize("with_head", [True, False])
def test_converted_trees_equal(tmp_path, fmt, prefix, with_head):
    path = write_checkpoint(tmp_path, make_roberta_state(with_head, prefix),
                            fmt=fmt)
    assert_trees_equal(thf.load_state_dict(path), jhf.load_state_dict(path))
    for arch in ("embedder", "embedder_classifier"):
        if arch != "embedder" and not with_head:
            with pytest.raises(ValueError):
                jhf.load_hf_encoder(path, arch=arch)
            with pytest.raises(ValueError):
                thf.load_hf_encoder(path, arch=arch)
            continue
        tcfg, tparams = thf.load_hf_encoder(path, arch=arch)
        jcfg, jparams = jhf.load_hf_encoder(path, arch=arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert_trees_equal(tparams, jparams)
    if with_head:
        assert tcfg.n_labels == HF_CFG["num_labels"]
        assert tcfg.max_len == HF_CFG["max_position_embeddings"] - 2


@pytest.mark.parametrize("prefix", ["bert.", "xlm_roberta.", "model."])
def test_other_prefixes_and_bert_head(tmp_path, prefix):
    """BERT's head layout (``pooler.dense`` + ``classifier``) and the other
    name prefixes the reference strips."""
    state = make_roberta_state(False, prefix)
    h = HF_CFG["hidden_size"]
    rng = np.random.default_rng(3)
    for key, shape in (("pooler.dense.weight", (h, h)),
                       ("pooler.dense.bias", (h,)),
                       ("classifier.weight", (5, h)),
                       ("classifier.bias", (5,))):
        state[key] = rng.standard_normal(shape).astype(np.float32)
    path = write_checkpoint(tmp_path, state)
    tcfg, tparams = thf.load_hf_encoder(path)
    jcfg, jparams = jhf.load_hf_encoder(path)
    assert tcfg.n_labels == jcfg.n_labels == 5
    assert_trees_equal(tparams, jparams)
    stripped = thf._strip_prefix(state)
    assert stripped.keys() == jhf._strip_prefix(state).keys()
    assert "embeddings.word_embeddings.weight" in stripped


def test_encoder_config_from_hf_equal():
    for dtype in ("bfloat16", "float32"):
        for n_labels in (2, 7):
            assert dataclasses.asdict(thf.encoder_config_from_hf(
                HF_CFG, n_labels=n_labels, dtype=dtype)) == \
                dataclasses.asdict(jhf.encoder_config_from_hf(
                    HF_CFG, n_labels=n_labels, dtype=dtype))


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        thf.load_state_dict(str(tmp_path))


def _write_raw(path, tensors, metadata=None):
    """A safetensors file by hand: (name, dtype code, shape, bytes)."""
    header, blobs, off = {}, [], 0
    if metadata is not None:
        header["__metadata__"] = metadata
    for name, code, shape, data in tensors:
        header[name] = {"dtype": code, "shape": list(shape),
                        "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for b in blobs:
            f.write(b)


def test_safetensors_reader_equals_library(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f64": rng.standard_normal((4,)),
        "f16": rng.standard_normal((2, 2, 2)).astype(np.float16),
        "i64": rng.integers(-9, 9, size=(6,)),
        "i32": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
        "i8": rng.integers(-127, 127, size=(7,)).astype(np.int8),
        "u8": rng.integers(0, 255, size=(3,)).astype(np.uint8),
        "bool": rng.integers(0, 2, size=(4,)).astype(bool),
        "scalar": np.array(2.5, dtype=np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    path = str(tmp_path / "m.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    ours, lib = thf.read_safetensors(path), load_file(path)
    assert_trees_equal(ours, lib)
    for a in ours.values():
        assert a.flags.writeable


@pytest.mark.parametrize("code, width", [("F8_E4M3", 1)])
def test_safetensors_reader_raises_where_library_does(tmp_path, code, width):
    """Types numpy has no dtype for, which the library refuses too.  The
    library is asked in a process without JAX, as the port's machine has
    none."""
    path = str(tmp_path / "x.safetensors")
    _write_raw(path, [("x", code, (2, 3), bytes(6 * width))])
    code_lib = ("from safetensors.numpy import load_file\n"
                "try:\n"
                f"    load_file({path!r})\n"
                "except Exception as e:\n"
                "    print(type(e).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code_lib],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lib_error = out.stdout.strip()
    assert lib_error, "the library read it"
    with pytest.raises(TypeError):
        thf.read_safetensors(path)


def write_bf16_checkpoint(tmp_path, state):
    """`write_checkpoint`'s layout with every tensor stored as BF16 (JAX
    is imported here, so numpy knows ml_dtypes' ``bfloat16``)."""
    import jax.numpy as jnp

    return write_checkpoint(tmp_path, {k: v.astype(jnp.bfloat16)
                                       for k, v in state.items()})


@pytest.mark.parametrize("with_head", [True, False])
def test_bf16_checkpoint_converts_as_the_reference(tmp_path, with_head):
    """A BF16 checkpoint: the port's reader widens each tensor to f32 at
    once, the reference's converter keeps BF16 leaves that its engine
    widens later.  As f32, the trees are equal exactly, and every value
    is a bf16 value."""
    path = write_bf16_checkpoint(tmp_path,
                                 make_roberta_state(with_head, "roberta."))
    raw = thf.load_state_dict(path)
    assert {a.dtype for a in raw.values()} == {np.dtype(np.float32)}
    for a in raw.values():
        assert not (a.view(np.uint32) & 0xFFFF).any()
    arch = "embedder_classifier" if with_head else "embedder"
    tcfg, tparams = thf.load_hf_encoder(path, arch=arch)
    jcfg, jparams = jhf.load_hf_encoder(path, arch=arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(tparams, jax.tree.map(
        lambda a: np.asarray(a, dtype=np.float32), jparams))


def test_safetensors_reader_rejects_bad_offsets(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    _write_raw(path, [("x", "F32", (2, 3), bytes(20))])
    with pytest.raises(ValueError):
        thf.read_safetensors(path)


class TestTokenizer:
    def test_tokenizer_json_ids_equal(self, tmp_path):
        from tokenizers import Tokenizer as RustTokenizer
        from tokenizers.models import WordLevel
        from tokenizers.pre_tokenizers import Whitespace

        vocab = {"[UNK]": 0, "hello": 1, "world": 2, "tpu": 3, "cuda": 4}
        tok = RustTokenizer(WordLevel(vocab, unk_token="[UNK]"))
        tok.pre_tokenizer = Whitespace()
        tok.save(str(tmp_path / "tokenizer.json"))
        ours = ttok.from_pretrained_dir(str(tmp_path))
        ref = jtok.from_pretrained_dir(str(tmp_path))
        texts = ["hello tpu", "world hello cuda", "unknown words", ""]
        assert ours.vocab_size == ref.vocab_size == 5
        assert [ours.encode(t) for t in texts] == \
            [ref.encode(t) for t in texts]
        assert ours.encode_batch(texts) == ref.encode_batch(texts)
        assert ours.decode([1, 3]) == ref.decode([1, 3])

    def test_transformers_branch_ids_equal_and_load_no_jax(self, tmp_path):
        """Without ``tokenizer.json`` both go through ``AutoTokenizer``;
        in a process of its own, the port's loader brings no JAX in."""
        (tmp_path / "vocab.txt").write_text(
            "[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\nhello\nworld\ntpu\n")
        (tmp_path / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
        code = (
            "import json, sys\n"
            "from distributed_crawler_tpu_torch.inference.tokenizer import "
            "from_pretrained_dir\n"
            f"t = from_pretrained_dir({str(tmp_path)!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'distributed_crawler_tpu'))\n"
            "print(json.dumps([t.vocab_size, t.encode_batch(['hello tpu', "
            "'world x']), bad]))\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        vocab_size, ids, bad = json.loads(out.stdout.splitlines()[-1])
        assert bad == []
        ref = jtok.from_pretrained_dir(str(tmp_path))
        assert vocab_size == ref.vocab_size
        assert ids == ref.encode_batch(["hello tpu", "world x"])

    def test_no_tokenizer_files_raise(self, tmp_path):
        """A checkpoint dir without tokenizer files: the port raises (the
        engine then falls back to `HashingTokenizer`) before asking
        ``transformers``, whose newer releases build an empty tokenizer
        from ``config.json``'s model type."""
        (tmp_path / "config.json").write_text(
            json.dumps({"model_type": "xlm-roberta", **HF_CFG}))
        with pytest.raises(FileNotFoundError):
            ttok.from_pretrained_dir(str(tmp_path))

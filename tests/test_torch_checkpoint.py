"""The port's checkpoints (`inference/checkpoint.py`) and the engine's
``checkpoint_dir`` against the JAX package's, on the CPU.

The reference writes orbax OCDBT stores; the port writes its own format
(``params.safetensors`` under flax paths, ``format.json``).  Nothing in the
port reads an orbax store, so the bridge is here: a reference checkpoint
restored with the reference's `load_params` and written with the port's
`save_params` serves through the port's engine as the reference's engine
serves the orbax store, and a port checkpoint read back and written with
orbax serves through the reference's engine as the port's serves it.
Engines serve the tiny model in f32: labels and label names equal,
embeddings and scores within 1e-5 abs / 1e-4 rel (the tolerance of
`tests/test_torch_engine.py`).
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")

import numpy as np  # noqa: E402

from distributed_crawler_tpu.inference import checkpoint as jck  # noqa: E402
from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch.inference import checkpoint as tck  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)
from tests.test_torch_train import leaves, np_tree  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = dict(model="tiny", batch_size=4, buckets=(16, 32, 64))
TEXTS = ["hello world", "", "alpha beta gamma " * 6, "omega", "x y z " * 12]
NAMES = ["benign", "spam"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_engine(**kw):
    return jeng.InferenceEngine(jeng.EngineConfig(**{**CFG, **kw}),
                                registry=JaxRegistry())


def port_engine(**kw):
    return teng.InferenceEngine(teng.EngineConfig(**{**CFG, **kw}),
                                registry=MetricsRegistry(), device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The reference's tiny params with a 2-wide head moved off its init,
    as a fine-tune leaves it."""
    params = np_tree(ref_engine(n_labels=2).params)
    rng = np.random.default_rng(0)
    head = params["params"]["cls_head"]
    for sub in head.values():
        for k in sub:
            sub[k] = (sub[k] + rng.standard_normal(sub[k].shape)
                      .astype(np.float32) * 0.1)
    return params


def write_labels(path, names=NAMES):
    with open(os.path.join(path, "labels.json"), "w") as f:
        json.dump({"labels": names}, f)


def assert_served_equal(got, want):
    assert len(got) == len(want)
    assert [r["label"] for r in got] == [r["label"] for r in want]
    assert [r.get("label_name") for r in got] == \
        [r.get("label_name") for r in want]
    np.testing.assert_allclose([r["embedding"] for r in got],
                               [r["embedding"] for r in want], **TOL)
    np.testing.assert_allclose([r["scores"] for r in got],
                               [r["scores"] for r in want], **TOL)


# -- the format ---------------------------------------------------------------
def test_round_trip_is_exact(tmp_path, trained):
    nbytes = tck.save_params(str(tmp_path / "c"), trained)
    assert sorted(os.listdir(tmp_path / "c")) == ["format.json",
                                                  "params.safetensors"]
    assert nbytes == os.path.getsize(tmp_path / "c" / "params.safetensors")
    with open(tmp_path / "c" / "format.json") as f:
        assert json.load(f) == {"format": tck.FORMAT, "version": tck.VERSION}
    back = tck.load_params(str(tmp_path / "c"))
    g, w = leaves(back), leaves(trained)
    assert g.keys() == w.keys()
    assert "params/encoder/layers_0/attn/qkv/kernel" in g
    for k in w:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_tensor_names_are_the_flax_paths(tmp_path, trained):
    from distributed_crawler_tpu_torch.models.hf_convert import (
        read_safetensors,
    )

    tck.save_params(str(tmp_path / "c"), trained)
    names = set(read_safetensors(str(tmp_path / "c" /
                                     "params.safetensors")))
    assert names == set(leaves(trained))


def test_missing_checkpoint_raises_as_the_reference(tmp_path):
    path = str(tmp_path / "nothing")
    with pytest.raises(FileNotFoundError) as ref:
        jck.load_params(path)
    with pytest.raises(FileNotFoundError, match="not found") as got:
        tck.load_params(path)
    assert type(got.value) is type(ref.value)


def test_other_format_or_version_refused(tmp_path, trained):
    path = str(tmp_path / "c")
    tck.save_params(path, trained)
    with open(os.path.join(path, "format.json"), "w") as f:
        json.dump({"format": tck.FORMAT, "version": tck.VERSION + 1}, f)
    with pytest.raises(ValueError, match="version"):
        tck.load_params(path)


def test_like_checks_leaves_and_sets_dtypes(tmp_path, trained):
    path = str(tmp_path / "c")
    tck.save_params(path, trained)
    like = jax.tree.map(lambda a: a.astype(np.float64), trained)
    back = tck.load_params(path, like)
    assert all(v.dtype == np.float64 for v in leaves(back).values())
    bad = jax.tree.map(lambda a: a, trained)
    bad["params"]["cls_head"]["head"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        tck.load_params(path, bad)
    del bad["params"]["cls_head"]["head"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        tck.load_params(path, bad)


def test_latest_step_dir_equals_the_references(tmp_path):
    for name in ("step_1", "step_10", "step_2", "step_x", "other"):
        os.makedirs(tmp_path / name)
    assert tck.latest_step_dir(str(tmp_path)) == \
        jck.latest_step_dir(str(tmp_path))
    assert tck.latest_step_dir(str(tmp_path)).endswith("step_10")
    assert tck.latest_step_dir(str(tmp_path / "none")) is None


def test_save_refuses_an_existing_checkpoint_without_force(tmp_path,
                                                          trained):
    path = str(tmp_path / "c")
    tck.save_params(path, trained)
    with pytest.raises(FileExistsError):
        tck.save_params(path, trained, force=False)
    tck.save_params(path, trained)  # force=True overwrites


# -- the bridge, both ways ----------------------------------------------------
def test_reference_checkpoint_served_by_the_port(tmp_path, trained):
    """orbax store -> the reference's `load_params` -> the port's
    `save_params` -> the port's engine, equal to the reference's engine on
    the orbax store."""
    orbax_root = str(tmp_path / "orbax")
    jck.save_params(orbax_root + "/step_3", trained)
    write_labels(orbax_root)
    restored = np_tree(jck.load_params(orbax_root + "/step_3"))
    port_root = str(tmp_path / "port")
    tck.save_params(port_root + "/step_3", restored)
    write_labels(port_root)
    want = ref_engine(checkpoint_dir=orbax_root)
    got = port_engine(checkpoint_dir=port_root)
    assert got.ecfg.n_labels == want.ecfg.n_labels == 2
    assert got.label_names == want.label_names == NAMES
    for pack in (False, True):
        assert_served_equal(got.run(TEXTS, pack=pack),
                            want.run(TEXTS, pack=pack))


def test_port_checkpoint_served_by_the_reference(tmp_path, trained):
    """The port's `save_params` -> its `load_params` -> orbax -> the
    reference's engine, equal to the port's engine on its own store."""
    port_root = str(tmp_path / "port")
    tck.save_params(port_root + "/step_1", trained)
    write_labels(os.path.join(port_root, "step_1"))  # in the step dir
    orbax_root = str(tmp_path / "orbax")
    jck.save_params(orbax_root + "/step_1",
                    tck.load_params(port_root + "/step_1"))
    write_labels(os.path.join(orbax_root, "step_1"))
    got = port_engine(checkpoint_dir=port_root)
    want = ref_engine(checkpoint_dir=orbax_root)
    assert got.label_names == want.label_names == NAMES
    assert_served_equal(got.run(TEXTS), want.run(TEXTS))


def test_a_root_without_steps_is_the_checkpoint(tmp_path, trained):
    root = str(tmp_path / "flat")
    tck.save_params(root, trained)
    got = port_engine(checkpoint_dir=root)
    assert got.label_names is None
    out = got.run(TEXTS)
    assert "label_name" not in out[0]
    eng = teng.InferenceEngine(teng.EngineConfig(**CFG, n_labels=2),
                               params=trained, registry=MetricsRegistry(),
                               device="cpu")
    assert_served_equal(out, eng.run(TEXTS))


# -- the engine's checkpoint rules --------------------------------------------
def _legacy(tree):
    legacy = jax.tree.map(lambda a: np.array(a), tree)
    for name, layer in legacy["params"]["encoder"].items():
        if not name.startswith("layers_"):
            continue
        attn = layer["attn"]
        k, b = attn.pop("qkv/kernel"), attn.pop("qkv/bias")
        for i, proj in enumerate(("q", "k", "v")):
            attn[proj] = {"kernel": k[:, i, :], "bias": b[i]}
    return legacy


def test_migrate_split_qkv_equals_the_references(trained):
    legacy = _legacy(trained)
    want = jeng._migrate_split_qkv(_legacy(trained))
    got = teng._migrate_split_qkv(legacy)
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys() == leaves(trained).keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_legacy_split_checkpoint_serves_as_the_fused(tmp_path, trained):
    root = str(tmp_path / "legacy")
    tck.save_params(root + "/step_1", _legacy(trained))
    fused = str(tmp_path / "fused")
    tck.save_params(fused + "/step_1", trained)
    assert_served_equal(port_engine(checkpoint_dir=root).run(TEXTS),
                        port_engine(checkpoint_dir=fused).run(TEXTS))


def test_head_width_comes_from_the_checkpoint(tmp_path, trained):
    root = str(tmp_path / "c")
    tck.save_params(root + "/step_1", trained)
    eng = port_engine(n_labels=8, checkpoint_dir=root)
    assert eng.ecfg.n_labels == 2
    assert len(eng.run(["hello"])[0]["scores"]) == 2


def test_hidden_mismatch_raises_the_references_error(tmp_path, trained):
    bad = jax.tree.map(lambda a: np.array(a), trained)
    bad["params"]["cls_head"]["pooler"]["kernel"] = np.zeros((32, 32),
                                                             np.float32)
    for save, root, make in (
            (jck.save_params, str(tmp_path / "orbax"), ref_engine),
            (tck.save_params, str(tmp_path / "port"), port_engine)):
        save(root + "/step_1", bad)
        with pytest.raises(ValueError) as err:
            make(checkpoint_dir=root)
        msg = str(err.value).replace(str(tmp_path / "orbax"), "ROOT") \
            .replace(str(tmp_path / "port"), "ROOT")
        assert msg == ("checkpoint at ROOT was trained on a hidden=32 "
                       "encoder but the engine model 'tiny' has hidden=64")


def test_label_names_in_every_result_as_the_reference(tmp_path, trained):
    """Unpacked, packed and empty texts all carry ``label_name``."""
    orbax_root = str(tmp_path / "orbax")
    jck.save_params(orbax_root + "/step_1", trained)
    write_labels(orbax_root, ["a", "b"])
    port_root = str(tmp_path / "port")
    tck.save_params(port_root + "/step_1", trained)
    write_labels(port_root, ["a", "b"])
    got, want = (port_engine(checkpoint_dir=port_root),
                 ref_engine(checkpoint_dir=orbax_root))
    for pack in (False, True):
        g, w = got.run(TEXTS, pack=pack), want.run(TEXTS, pack=pack)
        assert all("label_name" in r for r in g)
        assert [r["label_name"] for r in g] == [r["label_name"] for r in w]


def test_engine_params_round_trip(trained):
    eng = teng.InferenceEngine(teng.EngineConfig(**CFG, n_labels=2),
                               params=trained, registry=MetricsRegistry(),
                               device="cpu")
    g, w = leaves(eng.params), leaves(trained)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    moved = jax.tree.map(lambda a: np.array(a) * 0.5, trained)
    eng.params = moved
    np.testing.assert_array_equal(
        eng.params["params"]["cls_head"]["head"]["bias"],
        moved["params"]["cls_head"]["head"]["bias"])


def test_train_state_round_trip_and_pruning(tmp_path, trained):
    params = trained["params"]
    opt = {"exp_avg": params, "exp_avg_sq": params,
           "step": np.asarray(3, np.int64), "count": np.asarray(3, np.int64)}
    root = str(tmp_path / "state")
    tck.save_train_state(root, 0, params, opt, [{"loss": 1.0}])
    path = tck.save_train_state(root, 1, params, opt,
                                [{"loss": 1.0}, {"loss": 0.5}])
    assert sorted(os.listdir(root)) == ["epoch_1"]
    assert sorted(os.listdir(path)) == ["format.json", "history.json",
                                        "params.safetensors"]
    epoch, p, o, hist = tck.load_train_state(tck.latest_train_state(root))
    assert epoch == 1 and hist == [{"loss": 1.0}, {"loss": 0.5}]
    assert int(o["count"]) == 3
    for k, v in leaves(params).items():
        np.testing.assert_array_equal(leaves(p)[k], v)
        np.testing.assert_array_equal(leaves(o["exp_avg"])[k], v)
    os.makedirs(os.path.join(root, "epoch_7"))
    assert tck.latest_train_state(root) == path
    assert tck.latest_train_state(str(tmp_path / "none")) is None

"""``--mode train-head`` of the port's CLI against the JAX package's, on
the CPU, and ``tpu-worker --head-checkpoint`` serving what it wrote.

- Same weights: both CLIs train the tiny model from the reference's
  seeded params (the port's `engine.random_tree` replaced by them, as its
  docstring allows) on the same posts and labels, in the head and full
  scopes.  Summaries equal, losses within 1e-4 abs + 1e-3 rel, the two
  checkpoints' params within the same, the vocabularies equal; each CLI's
  own `tpu-worker` serves its checkpoint with the rows of
  `tests/test_torch_cli.py` (embeddings 1e-2, labels off a 2e-2 margin).
- A local HF checkpoint (``inference.pretrained_dir``): the reference runs
  that model in bf16 activations, the port trains in f32, so the frozen
  encoder's leaves are equal exactly and the summaries within 5e-2.
- Every validation of the reference's ``_run_train_head``: the same exit
  code and the same ``error:`` line.

Every test restores the "dct" logger tree (`restored_logging`).
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")

import numpy as np  # noqa: E402

from distributed_crawler_tpu import cli as jcli  # noqa: E402
from distributed_crawler_tpu.inference import checkpoint as jck  # noqa: E402
from distributed_crawler_tpu.inference import engine as jeng  # noqa: E402
from distributed_crawler_tpu.utils.metrics import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from distributed_crawler_tpu_torch import cli as tcli  # noqa: E402
from distributed_crawler_tpu_torch.inference import checkpoint as tck  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from tests.test_torch_cli import (  # noqa: E402
    assert_rows_match,
    resolve,
    serve_batch,
    xlmr_ckpt,  # noqa: F401  (the module's HF checkpoint fixture)
)
from tests.test_torch_structlog import restored_logging  # noqa: E402
from tests.test_torch_train import FIT, dataset, leaves, np_tree  # noqa: E402

NAMES = ["benign", "spam"]
# The reference's bf16 activations (HF checkpoints) against f32.
BF16_TOL = 5e-2


@pytest.fixture(autouse=True)
def _logging_restored():
    with restored_logging():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_data(tmp, texts, labels, label_uids=None):
    posts, lab = tmp / "posts.jsonl", tmp / "labels.jsonl"
    uids = [f"p{i}" for i in range(len(texts))]
    with open(posts, "w") as f, open(lab, "w") as g:
        for uid, t in zip(uids, texts):
            f.write(json.dumps({"post_uid": uid, "all_text": t}) + "\n")
        for uid, y in zip(label_uids or uids, labels):
            g.write(json.dumps({"post_uid": uid, "label": y}) + "\n")
    return str(posts), str(lab)


def run(cli, argv, capsys, env=None, **kw):
    rc = cli.main(argv, env=env or {}, **kw)
    out, err = capsys.readouterr()
    summary = None
    lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
    if lines:
        summary = json.loads(lines[-1])
    errors = [ln for ln in err.splitlines() if ln.startswith("error:")]
    return rc, summary, errors


def train_argv(tmp, posts, labels, ckpt, *extra, model="tiny"):
    return ["--mode", "train-head", "--infer-model", model,
            "--train-posts", posts, "--train-labels", labels,
            "--head-checkpoint", ckpt,
            "--storage-root", str(tmp / "store"), *extra]


@pytest.fixture
def same_weights(monkeypatch):
    """The port's tiny engine draws the reference CLI's tiny params."""
    params = np_tree(jeng.InferenceEngine(
        jeng.EngineConfig(model="tiny", n_labels=2),
        registry=JaxRegistry()).params)
    monkeypatch.setattr(teng, "random_tree", lambda ecfg, seed: params)
    return params


SCOPES = {
    "head": ["--train-epochs", "6", "--train-lr", "5e-3"],
    "full": ["--train-scope", "full", "--train-grad-accum", "2",
             "--train-epochs", "2", "--train-lr", "5e-4",
             "--train-state-dir", "STATE"],
}


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_train_head_equals_the_references(tmp_path, capsys, same_weights,
                                          scope):
    texts, labels = dataset(n_per_class=10)
    posts, labs = write_data(tmp_path, texts, [NAMES[y] for y in labels])
    out = {}
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        extra = [str(tmp_path / f"state_{name}") if a == "STATE" else a
                 for a in SCOPES[scope]]
        ckpt = str(tmp_path / f"ckpt_{name}")
        rc, summary, errors = run(cli, train_argv(
            tmp_path, posts, labs, ckpt, *extra), capsys, **kw)
        assert rc == 0, errors
        out[name] = (summary, ckpt)
    (ps, pc), (js, jc) = out["port"], out["ref"]
    assert {k: v for k, v in ps.items() if k not in
            ("final_loss", "final_accuracy", "checkpoint")} == \
        {k: v for k, v in js.items() if k not in
         ("final_loss", "final_accuracy", "checkpoint")}
    assert os.path.basename(ps["checkpoint"]) == \
        os.path.basename(js["checkpoint"]) == "step_1"
    for key in ("final_loss", "final_accuracy"):
        np.testing.assert_allclose(ps[key], js[key], **FIT)
    got = leaves(tck.load_params(ps["checkpoint"]))
    want = leaves(np_tree(jck.load_params(js["checkpoint"])))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT)
    for root in (pc, jc):
        with open(os.path.join(root, "labels.json")) as f:
            assert json.load(f) == {"labels": NAMES}
    if scope == "full":
        assert sorted(os.listdir(tmp_path / "state_port")) == ["epoch_1"]


def test_card_scripts_straight_run_is_the_clis(tmp_path, capsys,
                                               same_weights):
    """`chip_smoke.uninterrupted_full_run`, the straight full-scope run
    the card script holds a resumed one against, goes through the CLI's
    own steps: its losses and weights equal a ``train-head --train-scope
    full`` run's from the same flags."""
    import chip_smoke

    texts, labels = dataset(n_per_class=10)
    posts, labs = write_data(tmp_path, texts, [NAMES[y] for y in labels])
    argv = train_argv(tmp_path, posts, labs, str(tmp_path / "ckpt"),
                      *SCOPES["full"][:-2])  # no --train-state-dir
    rc, summary, errors = run(tcli, argv, capsys, device="cpu")
    assert rc == 0, errors
    tree, losses, _ = chip_smoke.uninterrupted_full_run(argv, {},
                                                        device="cpu")
    assert len(losses) == 2
    np.testing.assert_allclose(losses[-1], summary["final_loss"], **FIT)
    got = leaves(tree)
    want = leaves(tck.load_params(summary["checkpoint"])["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT)


def test_each_cli_serves_its_checkpoint_alike(tmp_path, capsys,
                                              same_weights):
    """`tpu-worker --head-checkpoint` in both packages, each on its own
    CLI's checkpoint of the same training: the rows match, and carry the
    vocabulary's label names."""
    from tests.test_torch_cli import text_batch

    texts, labels = dataset(n_per_class=10)
    posts, labs = write_data(tmp_path, texts, [NAMES[y] for y in labels])
    rows = {}
    batch = text_batch(n=16)
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        ckpt = str(tmp_path / f"ckpt_{name}")
        rc, _, errors = run(cli, train_argv(
            tmp_path, posts, labs, ckpt, *SCOPES["head"]), capsys, **kw)
        assert rc == 0, errors
        root = str(tmp_path / f"serve_{name}")
        cfg, r = resolve(cli, ["--mode", "tpu-worker", "--infer-model",
                               "tiny", "--infer-batch-size", "4",
                               "--head-checkpoint", ckpt,
                               "--storage-root", root])
        worker = cli._build_tpu_worker(cfg, r, **kw)
        assert worker.engine.label_names == NAMES
        rows[name] = serve_batch(worker, batch, root)
    assert_rows_match(rows["port"], rows["ref"])
    assert [r["label_name"] for r in rows["port"]] == \
        [NAMES[r["label"]] for r in rows["port"]]


def test_pretrained_dir_head_scope_against_the_reference(tmp_path, capsys,
                                                         xlmr_ckpt):
    texts, labels = dataset(n_per_class=10)
    posts, labs = write_data(tmp_path, texts, labels)
    env = {"CRAWLER_INFERENCE_PRETRAINED_DIR": str(xlmr_ckpt)}
    out = {}
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        rc, summary, errors = run(cli, train_argv(
            tmp_path, posts, labs, str(tmp_path / f"ckpt_{name}"),
            "--train-epochs", "4", "--train-lr", "5e-3"), capsys, env=env,
            **kw)
        assert rc == 0, errors
        out[name] = summary
    ps, js = out["port"], out["ref"]
    assert (ps["trained_examples"], ps["n_labels"], ps["epochs"]) == \
        (js["trained_examples"], js["n_labels"], js["epochs"])
    assert abs(ps["final_loss"] - js["final_loss"]) <= \
        BF16_TOL * abs(js["final_loss"])
    got = leaves(tck.load_params(ps["checkpoint"])["params"]["encoder"])
    want = leaves(np_tree(jck.load_params(js["checkpoint"])["params"]
                          ["encoder"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not os.path.exists(tmp_path / "ckpt_port" / "labels.json")


def _validation_cases(tmp):
    """name -> (texts, labels, the labels' uids or None, extra argv,
    env)."""
    t, y = ["alpha beta", "omega zeta", "alpha", "zeta"], [0, 1, 0, 1]
    return {
        "missing_flags": (t, y, None, ["--no-labels"], {}),
        "no_match": (t, y, ["q0", "q1", "q2", "q3"], [], {}),
        "mixed_labels": (t, [0, 1, 0, "spam"], None, [], {}),
        "negative_label": (t, [0, -1, 0, 1], None, [], {}),
        "zero_epochs": (t, y, None, ["--train-epochs", "0"], {}),
        "negative_rank": (t, y, None, ["--train-lora-rank", "-1"], {}),
        "scope_typo": (t, y, None, [], {"CRAWLER_TRAIN_SCOPE": "bogus"}),
        "lora_without_rank": (t, y, None, ["--train-scope", "lora"], {}),
        "rank_with_full": (t, y, None, ["--train-scope", "full",
                                        "--train-lora-rank", "4"], {}),
        "rank_with_head": (t, y, None, ["--train-scope", "head",
                                        "--train-lora-rank", "2"], {}),
        "accum_zero": (t, y, None, ["--train-grad-accum", "0"], {}),
        "accum_with_head": (t, y, None, ["--train-grad-accum", "2"], {}),
        "accum_with_lora": (t, y, None, ["--train-scope", "lora",
                                         "--train-lora-rank", "2",
                                         "--train-grad-accum", "2"], {}),
        "state_dir_with_head": (t, y, None, ["--train-state-dir",
                                             str(tmp / "state")], {}),
        "state_dir_with_lora": (t, y, None, ["--train-lora-rank", "2",
                                             "--train-state-dir",
                                             str(tmp / "state")], {}),
    }


@pytest.mark.parametrize("case", sorted(_validation_cases(
    __import__("pathlib").Path("/x"))))
def test_validation_exits_as_the_reference(tmp_path, capsys, case):
    texts, labels, uids, extra, env = _validation_cases(tmp_path)[case]
    posts, labs = write_data(tmp_path, texts, labels, uids)
    results = {}
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        ckpt = tmp_path / f"ckpt_{name}"
        argv = train_argv(tmp_path, posts, labs, str(ckpt),
                          *[a for a in extra if a != "--no-labels"])
        if "--no-labels" in extra:
            i = argv.index("--train-labels")
            del argv[i:i + 2]
        rc, summary, errors = run(cli, argv, capsys, env=env, **kw)
        results[name] = (rc, errors)
        assert summary is None
        assert not ckpt.exists()  # nothing written on a refusal
    assert results["port"] == results["ref"]
    assert results["port"][0] == 2 and len(results["port"][1]) == 1


def test_retrain_advances_step_and_int_labels_drop_the_vocabulary(
        tmp_path, capsys):
    texts, labels = dataset(n_per_class=4)
    ckpt = str(tmp_path / "ckpt")
    posts, labs = write_data(tmp_path, texts, [NAMES[y] for y in labels])
    base = train_argv(tmp_path, posts, labs, ckpt, "--train-epochs", "2")
    assert run(tcli, base, capsys, device="cpu")[0] == 0
    assert os.path.exists(os.path.join(ckpt, "labels.json"))
    posts, labs = write_data(tmp_path, texts, labels)
    rc, summary, _ = run(tcli, train_argv(tmp_path, posts, labs, ckpt,
                                          "--train-epochs", "1"),
                         capsys, device="cpu")
    assert rc == 0 and summary["checkpoint"].endswith("step_2")
    assert tck.latest_step_dir(ckpt).endswith("step_2")
    assert not os.path.exists(os.path.join(ckpt, "labels.json"))


def test_param_dtype_config_never_degrades_the_checkpoint(tmp_path, capsys,
                                                          same_weights):
    """A config that serves bf16 trains on, and saves, the f32 weights."""
    texts, labels = dataset(n_per_class=4)
    posts, labs = write_data(tmp_path, texts, labels)
    ckpt = str(tmp_path / "ckpt")
    rc, summary, _ = run(tcli, train_argv(
        tmp_path, posts, labs, ckpt, "--infer-param-dtype", "bfloat16",
        "--infer-quantize", "int8", "--train-epochs", "1"), capsys,
        device="cpu")
    assert rc == 0
    saved = leaves(tck.load_params(summary["checkpoint"])["params"]
                   ["encoder"])
    for k, v in leaves(same_weights["params"]["encoder"]).items():
        assert saved[k].dtype == np.float32
        np.testing.assert_array_equal(saved[k], v, err_msg=k)


def test_lora_scope_writes_a_checkpoint_that_serves(tmp_path, capsys):
    texts, labels = dataset(n_per_class=6)
    posts, labs = write_data(tmp_path, texts, [NAMES[y] for y in labels])
    ckpt = str(tmp_path / "ckpt")
    rc, summary, errors = run(tcli, train_argv(
        tmp_path, posts, labs, ckpt, "--train-scope", "lora",
        "--train-lora-rank", "2", "--train-epochs", "2"), capsys,
        device="cpu")
    assert rc == 0, errors
    assert summary["lora_rank"] == 2
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    eng = teng.InferenceEngine(
        teng.EngineConfig(model="tiny", checkpoint_dir=ckpt, batch_size=4,
                          buckets=(16,)), registry=MetricsRegistry(),
        device="cpu")
    out = eng.run(texts[:3])
    assert [r["label_name"] for r in out] == [NAMES[r["label"]]
                                               for r in out]


def test_train_head_is_a_device_mode():
    assert "train-head" in tcli.DEVICE_MODES
    assert "train-head" not in tcli.CRAWLER_MODES

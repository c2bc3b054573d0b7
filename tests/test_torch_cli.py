"""The port's CLI (`distributed_crawler_tpu_torch/cli.py`) against the JAX
package's, on the CPU.

- The parser: every flag of the port is the reference's flag (option
  strings, dest, type, default, action, const, nargs, choices) and maps to
  the same config key.
- `resolve_config`: the same argv, ``CRAWLER_*`` environment and YAML file
  give equal inference, media and sink settings and equal resolver values
  for every key the port's CLI reads, in each of the six modes.
- ``tpu-worker`` on the in-memory bus: both packages' `_build_tpu_worker`
  serve one small HF XLM-R checkpoint (2 layers, hidden 32) on the same
  RecordBatch; embeddings within 1e-2, labels equal where the reference's
  top score leads by more than 2e-2 (the tolerances of the ``pretrained``
  case of `tests/test_torch_engine.py::test_serving_modes_match`).
- ``transcribe``: the same tiny Whisper checkpoint and WAV tree give equal
  JSONL rows (tokens, windows, errors) and equal exit codes.
- ``cluster``: equal exit codes and messages on bad input; on a
  well-separated seeded mixture the same partition up to a relabelling
  and inertia within 1e-4 relative (the k-means++ seeds differ); text
  rows embedded as the reference embeds them.
- The process lifecycle: ``/logs`` answers, SIGTERM gives exit code 130
  and a postmortem bundle that the reference's `tools/postmortem.py`
  renders.
- Each feature that waits, and each crawler mode, exits 2 and names what
  it waits for.
- The bus: each of the reference's shard-configuration errors with its
  exit code and message; the durable outbox's WAL under
  ``<spool-dir>/outbox/<who>``; ``--mode bus --bus-spool-dir`` serving
  ``/dlq``; ``--bus-shard-addresses`` building a `PartitionedBus` whose
  ``/shards`` body equals the reference's.

Every test runs under `restored_logging`: both packages' `main()` run
`setup_logging`, which stops the "dct" logger tree from propagating to
``caplog``; the fixture puts the tree and both rings back.
"""

import dataclasses
import glob
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu import cli as jcli  # noqa: E402
from distributed_crawler_tpu_torch import cli as tcli  # noqa: E402
from distributed_crawler_tpu_torch.bus import outbox as toutbox  # noqa: E402
from distributed_crawler_tpu_torch.inference import engine as teng  # noqa: E402
from distributed_crawler_tpu_torch.utils import structlog as tstruct  # noqa: E402
from tests.test_torch_structlog import (  # noqa: E402
    logging_state,
    restored_logging,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPIC_INFERENCE_BATCHES = "tpu-inference-batches"
# The `pretrained` case of test_serving_modes_match.
EMB_ATOL = 1e-2
LABEL_MARGIN = 2e-2


@pytest.fixture(autouse=True)
def _logging_restored():
    with restored_logging():
        yield


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve(cli, argv, env=None):
    return cli.resolve_config(cli.build_parser().parse_args(argv),
                              env=env if env is not None else {})


# -- the parser ---------------------------------------------------------------
def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


PORT_ACTIONS = _actions(tcli.build_parser())


@pytest.mark.parametrize("dest", sorted(PORT_ACTIONS))
def test_flag_is_the_references(dest):
    mine = PORT_ACTIONS[dest]
    ref = _actions(jcli.build_parser())[dest]
    assert mine.option_strings == ref.option_strings
    for attr in ("dest", "type", "default", "const", "nargs", "choices"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert type(mine) is type(ref)
    assert tcli._KEY_MAP.get(dest) == jcli._KEY_MAP.get(dest)


def test_every_key_map_entry_has_a_flag():
    assert set(tcli._KEY_MAP) <= set(PORT_ACTIONS)
    assert set(PORT_ACTIONS) - set(tcli._KEY_MAP) == {
        "config", "generate_code", "version"}


# -- resolve_config -----------------------------------------------------------
def _keys_read():
    """Every dotted key the port's CLI reads through its resolver."""
    with open(tcli.__file__, encoding="utf-8") as f:
        src = f.read()
    keys = set(re.findall(
        r'r\.get(?:_str|_int|_float|_bool|_list)?\(\s*"([a-z_.]+)"', src))
    assert len(keys) > 40
    return sorted(keys)


CONFIG_YAML = """\
crawler:
  crawlid: crawl-from-file
  tenant: tenant-a
  crawllabel: label-file
inference:
  bucket_sizes: [16, 32, 64]
  stall_warn_s: 60
  compilation_cache_dir: /var/cache/x
  publish_embeddings: true
media:
  coalesce_batches: 3
  max_windows_per_file: 4
cluster:
  buckets: [32, 128]
  k: 5
observability:
  span_sample_rate: 0.5
  slo_queue_wait_ms: 12.5
distributed:
  shutdown_drain_s: 4
"""
CONFIG_ENV = {
    "CRAWLER_INFERENCE_MODEL": "xlmr-base",
    "CRAWLER_INFERENCE_PRETRAINED_DIR": "/ckpt/xlmr",
    "CRAWLER_MEDIA_WINDOW_BUCKETS": "1,2,4",
    "CRAWLER_OBSERVABILITY_TELEMETRY_INTERVAL_S": "5",
    "CRAWLER_CLUSTER_K": "4",
    "CRAWLER_STORAGE_ROOT": "/from/env",
    "CRAWLER_CRAWLER_TENANT": "tenant-env",
    "CRAWLER_INFERENCE_QUANTIZE": "int8",
    "CRAWLER_PARALLEL_SEQ": "1",
}
MODES = ("tpu-worker", "asr-worker", "cluster-worker", "transcribe",
         "cluster", "train-head", "bus")


@pytest.mark.parametrize("mode", MODES)
def test_resolve_config_equals_the_references(tmp_path, mode):
    path = tmp_path / "config.yaml"
    path.write_text(CONFIG_YAML)
    argv = ["--mode", mode, "--config", str(path), "--infer-batch-size",
            "4", "--storage-root", "/flag/wins", "--asr-batch-size", "2",
            "--cluster-iters", "3", "--slo-batch-p95-ms", "7.5",
            "--no-publish-embeddings", "--cluster-buckets", "64", "128",
            "--asr-window-buckets", "1,2", "--infer-attention", "flash",
            "--bus-address", "127.0.0.1:1", "--telemetry-interval", "2"]
    (t_cfg, t_r), (j_cfg, j_r) = (resolve(c, argv, dict(CONFIG_ENV))
                                  for c in (tcli, jcli))
    assert dataclasses.asdict(t_cfg.inference) == \
        dataclasses.asdict(j_cfg.inference)
    assert dataclasses.asdict(t_cfg.media) == dataclasses.asdict(j_cfg.media)
    for name in ("storage_root", "crawl_id", "crawl_label", "tenant",
                 "platform", "object_store_url"):
        assert getattr(t_cfg, name) == getattr(j_cfg, name), name
    for key in _keys_read():
        assert t_r.get(key) == j_r.get(key), key
    # Each layer of the chain was read.
    assert t_cfg.storage_root == "/flag/wins"
    assert t_cfg.tenant == "tenant-env"
    assert t_cfg.crawl_id == "crawl-from-file"
    assert t_cfg.inference.bucket_sizes == [16, 32, 64]
    assert t_cfg.inference.embed_model == "xlmr-base"
    assert t_cfg.media.window_buckets == [1, 2]
    assert t_cfg.media.coalesce_batches == 3


def test_defaults_equal_the_references():
    (t_cfg, t_r), (j_cfg, j_r) = (resolve(c, ["--mode", "tpu-worker"])
                                  for c in (tcli, jcli))
    assert dataclasses.asdict(t_cfg.inference) == \
        dataclasses.asdict(j_cfg.inference)
    assert dataclasses.asdict(t_cfg.media) == dataclasses.asdict(j_cfg.media)
    assert t_cfg.storage_root == j_cfg.storage_root == "/tmp/crawl"
    assert t_cfg.inference.embed_model == "e5-small"
    assert t_cfg.inference.batch_size == 256
    assert tcli._heartbeat_interval(t_r) == jcli._heartbeat_interval(j_r)


def test_a_named_config_file_must_exist(capsys):
    assert tcli.main(["--mode", "cluster", "--config", "/no/such.yaml"],
                     env={}) == 2
    assert "config file not found" in capsys.readouterr().err


def test_yaml_is_imported_only_for_a_config_file(tmp_path, monkeypatch,
                                                 capsys):
    """Without PyYAML, flags and env still resolve; a config file is an
    error that names the package."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.chdir(tmp_path)  # no ./config.yaml on the search path
    cfg, r = resolve(tcli, ["--mode", "tpu-worker", "--crawl-id", "c"],
                     {"CRAWLER_INFERENCE_MODEL": "tiny"})
    assert cfg.inference.embed_model == "tiny" and cfg.crawl_id == "c"
    (tmp_path / "config.yaml").write_text("crawler: {crawlid: x}\n")
    assert tcli.main(["--mode", "cluster"], env={}) == 2
    assert "PyYAML" in capsys.readouterr().err


# -- tpu-worker on the in-memory bus ------------------------------------------
@pytest.fixture(scope="module")
def xlmr_ckpt(tmp_path_factory):
    """The reference tests' tiny HF XLM-R checkpoint with a classification
    head, drawn from test_hf_convert's module RNG started where a fresh
    process has it."""
    pytest.importorskip("safetensors")
    import tests.test_hf_convert as hf_tests

    saved = hf_tests.RNG.bit_generator.state
    hf_tests.RNG.bit_generator.state = \
        np.random.default_rng(42).bit_generator.state
    try:
        return hf_tests.write_checkpoint(
            tmp_path_factory.mktemp("xlmr"),
            hf_tests.make_roberta_state(True, "roberta."))
    finally:
        hf_tests.RNG.bit_generator.state = saved


def worker_env(ckpt):
    return {"CRAWLER_INFERENCE_PRETRAINED_DIR": str(ckpt),
            "CRAWLER_INFERENCE_BUCKET_SIZES": "16,32,64"}


def text_batch(n=32, batch_id="b-cli"):
    rng = np.random.default_rng(3)
    words = ["crawl", "Channel", "post!", "видео", "naïve", "e5", "42",
             "https://t.me/some_channel/123"]
    records = [{"post_uid": f"p{i}", "channel_name": "chan",
                "description": " ".join(
                    rng.choice(words, size=int(rng.integers(1, 20))))}
               for i in range(n)]
    return {"batch_id": batch_id, "crawl_id": "c-cli", "trace_id": "ab" * 16,
            "records": records}


def wait_rows(root, batch, timeout_s=120.0):
    path = os.path.join(root, "inference", batch["crawl_id"], "batches",
                        f"{batch['batch_id']}.jsonl")
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def serve_batch(worker, batch, root, publish=None):
    worker.start()
    try:
        (publish or worker.bus.publish)(TOPIC_INFERENCE_BATCHES, batch)
        return wait_rows(root, batch)
    finally:
        worker.stop()
        worker.bus.close()


def assert_rows_match(got, want):
    assert [r["post_uid"] for r in got] == [r["post_uid"] for r in want]
    assert [r["batch_id"] for r in got] == [r["batch_id"] for r in want]
    assert [r["trace_id"] for r in got] == [r["trace_id"] for r in want]
    np.testing.assert_allclose([r["embedding"] for r in got],
                               [r["embedding"] for r in want],
                               atol=EMB_ATOL, rtol=0)
    scores = np.asarray([r["scores"] for r in want])
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LABEL_MARGIN
    assert clear.any()
    assert [r["label"] for r, c in zip(got, clear) if c] == \
        [r["label"] for r, c in zip(want, clear) if c]


def test_tpu_worker_serves_as_the_reference(xlmr_ckpt, tmp_path):
    batch = text_batch()
    rows = {}
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        root = str(tmp_path / name)
        cfg, r = resolve(cli, ["--mode", "tpu-worker", "--infer-batch-size",
                               "4", "--storage-root", root],
                         worker_env(xlmr_ckpt))
        worker = cli._build_tpu_worker(cfg, r, **kw)
        assert worker.cfg.worker_id == "tpu-worker-0"
        rows[name] = serve_batch(worker, batch, root)
    assert_rows_match(rows["port"], rows["ref"])
    assert len(rows["port"]) == len(batch["records"])


# -- transcribe ---------------------------------------------------------------
@pytest.fixture(scope="module")
def whisper_ckpt(tmp_path_factory):
    """tests/test_transcribe_mode.py's checkpoint: WH_CFG widths."""
    save_file = pytest.importorskip("safetensors.numpy").save_file
    import tests.test_hf_convert as hf_tests

    path = str(tmp_path_factory.mktemp("whisper"))
    saved = hf_tests.RNG.bit_generator.state
    hf_tests.RNG.bit_generator.state = \
        np.random.default_rng(42).bit_generator.state
    try:
        state = hf_tests.make_whisper_state()
    finally:
        hf_tests.RNG.bit_generator.state = saved
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_tests.WH_CFG, f)
    save_file(state, os.path.join(path, "model.safetensors"))
    return path


def write_wav(path, seconds=0.3, rate=16_000, freq=440.0):
    t = np.arange(int(seconds * rate)) / rate
    pcm = (np.sin(2 * np.pi * freq * t) * 0.3 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def run_main(cli, argv, capsys, **kw):
    rc = cli.main(argv, env={}, **kw)
    out, err = capsys.readouterr()
    return rc, out, err


def test_transcribe_rows_equal_the_references(tmp_path, whisper_ckpt,
                                              capsys):
    media = tmp_path / "media"
    (media / "chan_a").mkdir(parents=True)
    write_wav(media / "chan_a" / "voice1.wav")
    write_wav(media / "chan_a" / "voice2.wav", seconds=0.7, freq=880.0)
    (media / "notes.txt").write_text("not audio")           # ignored
    (media / "bad.wav").write_bytes(b"RIFFgarbage")         # a failed row
    got = {}
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        out_path = str(tmp_path / f"{name}.jsonl")
        rc, out, _ = run_main(cli, [
            "--mode", "transcribe", "--transcribe-input", str(media),
            "--asr-pretrained-dir", whisper_ckpt, "--asr-batch-size", "2",
            "--transcribe-output", out_path,
            "--storage-root", str(tmp_path / "store")], capsys, **kw)
        with open(out_path, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        summary = json.loads(out.strip().splitlines()[-1])
        got[name] = (rc, rows, summary)
    (rc, rows, summary), (j_rc, j_rows, j_summary) = got["port"], got["ref"]
    assert rc == j_rc == 0
    assert rows == j_rows
    assert {k: v for k, v in summary.items() if k != "output"} == \
        {k: v for k, v in j_summary.items() if k != "output"} == \
        {"transcribed": 2, "failed": 1}
    by = {r["path"]: r for r in rows}
    assert by["bad.wav"]["error"] and by["bad.wav"]["windows"] == 0
    assert by["chan_a/voice1.wav"]["tokens"]
    assert by["chan_a/voice2.wav"]["windows"] >= 1


@pytest.mark.parametrize("case", ["missing_args", "empty_tree", "all_failed"])
def test_transcribe_exit_codes_equal_the_references(tmp_path, whisper_ckpt,
                                                     capsys, case):
    media = tmp_path / "media"
    media.mkdir()
    argv = ["--mode", "transcribe", "--asr-pretrained-dir", whisper_ckpt]
    if case != "missing_args":
        argv += ["--transcribe-input", str(media)]
    if case == "all_failed":
        (media / "bad.wav").write_bytes(b"RIFFgarbage")
    results = []
    for cli, kw in ((tcli, {"device": "cpu"}), (jcli, {})):
        rc, _, err = run_main(cli, argv, capsys, **kw)
        results.append((rc, [ln for ln in err.splitlines()
                             if ln.startswith("error:")]))
    assert results[0] == results[1]
    assert results[0][0] == (1 if case == "all_failed" else 2)


# -- cluster ------------------------------------------------------------------
def write_rows(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def mixture(n_per=16, k=4, dim=8, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)) * 10
    x = np.concatenate([c + rng.standard_normal((n_per, dim)) * 0.1
                        for c in centers])
    order = rng.permutation(len(x))
    return x[order].astype(np.float32), np.repeat(np.arange(k), n_per)[order]


CLUSTER_ERRORS = {
    "k_below_2": (["--cluster-k", "1"], None),
    "iters_below_1": (["--cluster-iters", "0"], None),
    "missing_output": (["--no-output"], None),
    "mixed_rows": ([], [{"post_uid": "a", "embedding": [1.0, 0.0]},
                        {"post_uid": "b", "description": "text row"}]),
    "inconsistent_widths": ([], [{"embedding": [1.0, 0.0]},
                                 {"embedding": [1.0, 0.0, 2.0]}]),
    "empty_embedding": ([], [{"embedding": []}, {"embedding": []}]),
    "too_few_rows": (["--cluster-k", "3"], [{"embedding": [1.0, 0.0]},
                                            {"embedding": [0.0, 1.0]}]),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_ERRORS))
def test_cluster_errors_equal_the_references(tmp_path, capsys, case):
    extra, rows = CLUSTER_ERRORS[case]
    inp = tmp_path / "in.jsonl"
    write_rows(inp, rows or [{"embedding": [1.0, 0.0]}] * 4)
    argv = ["--mode", "cluster", "--cluster-input", str(inp)]
    if extra != ["--no-output"]:
        argv += ["--cluster-output", str(tmp_path / "out.json")] + extra
    results = []
    for cli, kw in ((tcli, {"device": "cpu"}), (jcli, {})):
        rc, _, err = run_main(cli, argv, capsys, **kw)
        results.append((rc, [ln for ln in err.splitlines()
                             if ln.startswith("error:")]))
    assert results[0] == results[1]
    assert results[0][0] == 2 and len(results[0][1]) == 1


def _same_partition(a, b):
    """Equal up to a relabelling: a one-to-one map between labels."""
    pairs = set(zip(a, b))
    return len(pairs) == len(set(a)) == len(set(b))


def test_cluster_partition_equals_the_references(tmp_path, capsys):
    x, truth = mixture()
    inp = tmp_path / "in.jsonl"
    write_rows(inp, [{"post_uid": f"u{i}", "embedding": row.tolist()}
                     for i, row in enumerate(x)])
    got = {}
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        out = tmp_path / f"{name}.json"
        rc, stdout, _ = run_main(cli, [
            "--mode", "cluster", "--cluster-input", str(inp),
            "--cluster-output", str(out), "--cluster-k", "4",
            "--cluster-iters", "10"], capsys, **kw)
        assert rc == 0
        got[name] = (json.loads(out.read_text()),
                     json.loads(stdout.strip().splitlines()[-1]))
    (res, summary), (j_res, j_summary) = got["port"], got["ref"]
    assert [a["post_uid"] for a in res["assignments"]] == \
        [a["post_uid"] for a in j_res["assignments"]]
    labels = [a["cluster"] for a in res["assignments"]]
    j_labels = [a["cluster"] for a in j_res["assignments"]]
    assert _same_partition(labels, j_labels)
    assert _same_partition(labels, truth.tolist())
    np.testing.assert_allclose(res["inertia"], j_res["inertia"], rtol=1e-4)
    assert sorted(res["cluster_sizes"]) == sorted(j_res["cluster_sizes"])
    assert (res["k"], res["iters"]) == (j_res["k"], j_res["iters"]) == (4, 10)
    assert {k: summary[k] for k in ("clustered", "k")} == \
        {k: j_summary[k] for k in ("clustered", "k")}
    assert set(summary["seconds"]) == {"read", "fit", "write"}


def test_cluster_text_rows_are_embedded_as_the_reference(xlmr_ckpt,
                                                         tmp_path, capsys):
    batch = text_batch(n=12)
    inp = tmp_path / "in.jsonl"
    write_rows(inp, batch["records"] + [{"post_uid": "empty"}])
    env = worker_env(xlmr_ckpt)
    argv = ["--mode", "cluster", "--cluster-input", str(inp),
            "--cluster-k", "2", "--cluster-iters", "5"]
    texts = [r["description"] for r in batch["records"]]
    embs, outs = [], []
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        cfg, r = resolve(cli, argv, env)
        embs.append(np.asarray(cli._make_engine(cfg, r, **kw).embed(texts)))
        out = tmp_path / f"{name}.json"
        rc = cli.main(argv + ["--cluster-output", str(out)], env=env, **kw)
        assert rc == 0
        outs.append(json.loads(out.read_text()))
    capsys.readouterr()
    np.testing.assert_allclose(embs[0], embs[1], atol=EMB_ATOL, rtol=0)
    assert [a["post_uid"] for a in outs[0]["assignments"]] == \
        [a["post_uid"] for a in outs[1]["assignments"]] == \
        [r["post_uid"] for r in batch["records"]]


# -- lifecycle ----------------------------------------------------------------
def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_worker_process_serves_logs_and_dumps_on_sigterm(tmp_path):
    port = free_port()
    dump = tmp_path / "dump"
    code = ("import sys; from distributed_crawler_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CRAWLER_INFERENCE_BUCKET_SIZES="16,32")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--mode", "tpu-worker",
         "--infer-model", "tiny", "--infer-batch-size", "4",
         "--metrics-port", str(port), "--dump-dir", str(dump),
         "--storage-root", str(tmp_path / "store"),
         # Clamped to 1 s with a WARNING: the record /logs and the bundle
         # must carry.
         "--telemetry-interval", "0.5"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                if http_get(url + "/healthz")[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        assert proc.poll() is None, proc.communicate()[1].decode()[-2000:]
        code_, body = http_get(url + "/logs")
        assert code_ == 200
        messages = [r["message"] for r in json.loads(body)["records"]]
        assert any("clamped" in m for m in messages)
        for route in ("/status", "/metrics", "/costs"):
            assert http_get(url + route)[0] == 200, route
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 130
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    bundles = glob.glob(str(dump / "postmortem_*_sigterm.json"))
    assert len(bundles) == 1
    with open(bundles[0], encoding="utf-8") as f:
        bundle = json.load(f)
    assert bundle["config"]["mode"] == "tpu-worker"
    assert any("clamped" in r["message"]
               for r in bundle["logs"]["records"])
    out = subprocess.run([sys.executable, "tools/postmortem.py", bundles[0]],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_serve_forever_restores_the_sigterm_handler():
    before = signal.getsignal(signal.SIGTERM)
    ticks = iter([True, True, False])
    tcli._serve_forever(poll_s=0.001, running=lambda: next(ticks))
    assert signal.getsignal(signal.SIGTERM) is before


# -- what waits ---------------------------------------------------------------
def _waiting_cases(tmp):
    store = ["--storage-root", str(tmp / "store")]
    tiny = ["--mode", "tpu-worker", "--infer-model", "tiny"] + store
    asr = ["--mode", "asr-worker", "--asr-pretrained-dir", str(tmp)] + store
    bus = ["--mode", "bus", "--bus-address", "127.0.0.1:1"]
    return {
        "mesh_data": (tiny + ["--mesh-data", "2"], {}, "ROADMAP item 9"),
        "mesh_devices": (tiny + ["--mesh-devices", "-1"], {},
                         "ROADMAP item 9"),
        "mesh_bad_value": (tiny + ["--mesh-seq", "0"], {}, "--mesh-seq"),
        "cluster_worker_mesh": (["--mode", "cluster-worker", "--mesh-tensor",
                                 "2"] + store, {}, "ROADMAP item 9"),
        "multihost": (tiny, {"DCT_NUM_PROCESSES": "2"}, "ROADMAP item 9"),
        "coordinator": (tiny, {"DCT_COORDINATOR": "10.0.0.1:1234"},
                        "ROADMAP item 9"),
        "object_store_tpu": (tiny + ["--object-store", "memory://"], {},
                             "object-store"),
        "object_store_asr": (asr + ["--object-store", "memory://"], {},
                             "object-store"),
        "object_store_cluster": (["--mode", "cluster-worker",
                                  "--object-store", "file:///x"] + store,
                                 {}, "object-store"),
        "asr_infer": (asr + ["--infer"], {}, "re-entry"),
        "transcribe_infer": (["--mode", "transcribe", "--transcribe-input",
                              str(tmp), "--asr-pretrained-dir", str(tmp),
                              "--infer", "--bus-address", "127.0.0.1:1"],
                             {}, "ROADMAP Queue 1"),
        "serve_without_address": (tiny + ["--bus-serve"], {},
                                  "--bus-serve requires --bus-address"),
    }


WAITING = sorted(_waiting_cases(Path("/x")))


@pytest.mark.parametrize("case", WAITING)
def test_waiting_feature_exits_2(tmp_path, monkeypatch, capsys, case):
    argv, env_vars, needle = _waiting_cases(tmp_path)[case]
    for k, v in env_vars.items():
        monkeypatch.setenv(k, v)
    rc, _, err = run_main(tcli, argv, capsys, device="cpu")
    assert rc == 2, err
    assert needle in err


# -- the bus: durability and shards -------------------------------------------
def _shard_error_cases():
    bus = ["--mode", "bus", "--bus-address", "127.0.0.1:1"]
    tiny = ["--mode", "tpu-worker", "--infer-model", "tiny"]
    return {
        "shards_without_addresses": bus + ["--bus-shards", "3"],
        "count_mismatch": bus + ["--bus-shard-addresses", "a:1,b:2",
                                 "--bus-shards", "3"],
        "duplicate_addresses": bus + ["--bus-shard-addresses", "a:1,a:1"],
        "serve_with_shards": bus + ["--bus-shard-addresses", "a:1,b:2"],
        "address_with_shards": tiny + ["--bus-address", "c:3",
                                       "--bus-shard-addresses", "a:1,b:2"],
    }


@pytest.mark.parametrize("case", sorted(_shard_error_cases()))
def test_shard_config_error_equals_the_references(tmp_path, capsys, case):
    argv = _shard_error_cases()[case] + ["--storage-root",
                                         str(tmp_path / "store")]
    got = {}
    for name, cli, kw in (("port", tcli, {"device": "cpu"}),
                          ("ref", jcli, {})):
        rc, _, err = run_main(cli, argv, capsys, **kw)
        got[name] = (rc, [ln for ln in err.splitlines()
                          if ln.startswith("error: ")])
    assert got["port"] == got["ref"]
    assert got["port"][0] == 2 and len(got["port"][1]) == 1


@pytest.mark.parametrize("who", ["w14", "", "mode"])
def test_outbox_wal_per_publisher_equals_the_references(tmp_path, who):
    argv = ["--mode", "tpu-worker", "--bus-spool-dir", str(tmp_path),
            "--bus-outbox-max-frames", "77"]
    if who == "w14":
        argv += ["--worker-id", who]
    (_, t_r), (_, j_r) = (resolve(c, argv) for c in (tcli, jcli))
    mine = tcli._bus_outbox_config(t_r, t_r.get_str("distributed.worker_id")
                                   or ("tpu-worker" if who else ""))
    ref = jcli._bus_outbox_config(j_r, j_r.get_str("distributed.worker_id")
                                  or ("tpu-worker" if who else ""))
    ref_fields = dataclasses.asdict(ref)
    assert dataclasses.asdict(mine) == {
        k: ref_fields[k] for k in dataclasses.asdict(mine)}
    # The reference's remaining fields are the port's module constants.
    assert (ref.retry_attempts, ref.fsync, ref.fsync_every,
            ref.compact_every, ref.near_full_fraction) == (
        toutbox.RETRY_ATTEMPTS, True, toutbox.FSYNC_EVERY,
        toutbox.COMPACT_EVERY, toutbox.NEAR_FULL_FRACTION)
    want = {"w14": "w14", "mode": "tpu-worker", "": "client"}[who]
    assert mine.dir == os.path.join(str(tmp_path), "outbox", want)
    assert mine.max_frames == 77
    assert tcli._bus_outbox_config(resolve(tcli, ["--mode", "bus"])[1],
                                   "x") is None


def test_worker_bus_publishes_through_its_outbox(tmp_path):
    """A worker mode's `RemoteBus` (and a --bus-serve process's loopback
    client) buffers through a dead broker into
    ``<spool>/outbox/<worker-id>/outbox.jsonl``."""
    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus

    spool = tmp_path / "spool"
    _, r = resolve(tcli, ["--mode", "tpu-worker", "--bus-address",
                          f"127.0.0.1:{free_port()}", "--bus-spool-dir",
                          str(spool), "--worker-id", "w14"])
    bus = tcli._make_bus(r)
    try:
        assert isinstance(bus, RemoteBus) and bus.outbox is not None
        bus.publish("t", {"n": 1})  # nothing listens: buffered, no raise
        assert bus.outbox.depth() == 1
    finally:
        bus.close()
    wal = spool / "outbox" / "w14" / "outbox.jsonl"
    assert [json.loads(x)["k"] for x in wal.read_text().splitlines()] == \
        ["put"]
    _, r = resolve(tcli, ["--mode", "tpu-worker", "--bus-address",
                          f"127.0.0.1:{free_port()}", "--bus-serve",
                          "--bus-spool-dir", str(spool), "--worker-id",
                          "w15"])
    serving = tcli._make_serving_bus(r)
    try:
        assert serving._client.outbox is not None
        assert serving._client.outbox.wal_path == str(
            spool / "outbox" / "w15" / "outbox.jsonl")
    finally:
        serving.close()


def test_bus_mode_with_spool_serves_dlq(tmp_path):
    port, mport = free_port(), free_port()
    spool = tmp_path / "spool"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_crawler_tpu_torch.cli", "--mode",
         "bus", "--bus-address", f"127.0.0.1:{port}", "--bus-spool-dir",
         str(spool), "--bus-max-attempts", "1", "--metrics-port",
         str(mport)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{mport}/dlq"
    try:
        deadline = time.monotonic() + 60
        code = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                code, body = http_get(url)
                if code == 200:
                    break
            except OSError:
                pass
            time.sleep(0.05)
        assert code == 200, proc.communicate()[1].decode()[-2000:]
        assert json.loads(body) == {"topics": {}, "enabled": True,
                                    "dead_letters_total": 0}
        from distributed_crawler_tpu_torch.bus.grpc_bus import GrpcBusClient

        client = GrpcBusClient(f"127.0.0.1:{port}")
        try:
            client.publish(TOPIC_INFERENCE_BATCHES, {"batch_id": "poison"})
            it = client.pull(TOPIC_INFERENCE_BATCHES)
            delivery, _ = next(it)
            # Nack with the stream open: a stream closed first may requeue
            # the frame uncharged, and the nack then finds no delivery.
            client.ack(TOPIC_INFERENCE_BATCHES, delivery, ok=False)
            it.close()
        finally:
            client.close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            topics = json.loads(http_get(url)[1])["topics"]
            if topics.get(TOPIC_INFERENCE_BATCHES, {}).get("count"):
                break
            time.sleep(0.05)
        entry = topics[TOPIC_INFERENCE_BATCHES]["entries"][0]
        assert (entry["attempts"], entry["reason"]) == (1, "max_attempts")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 130
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_shard_addresses_build_a_partitioned_bus_serving_shards(tmp_path):
    from distributed_crawler_tpu.utils import metrics as jmetrics

    from distributed_crawler_tpu_torch.bus.partition import PartitionedBus
    from distributed_crawler_tpu_torch.utils import metrics as tmetrics

    argv = ["--mode", "tpu-worker", "--bus-shard-addresses",
            f"127.0.0.1:{free_port()},127.0.0.1:{free_port()}",
            "--bus-shards", "2", "--bus-spool-dir", str(tmp_path),
            "--worker-id", "w14"]
    buses = [jcli._make_bus(resolve(jcli, argv)[1])]
    # The port's last: its provider is the one the route serves.
    buses.append(tcli._make_bus(resolve(tcli, argv)[1]))
    http = [tmetrics.serve_metrics(0, tmetrics.MetricsRegistry()),
            jmetrics.serve_metrics(0, jmetrics.MetricsRegistry())]
    try:
        assert isinstance(buses[1], PartitionedBus)
        assert [ob.wal_path for ob in buses[1].shard_outboxes()] == [
            str(tmp_path / "outbox" / "w14" / sid / "outbox.jsonl")
            for sid in ("bus-0", "bus-1")]
        bodies = [json.loads(http_get(
            f"http://127.0.0.1:{h.server_address[1]}/shards")[1])
            for h in http]
        assert bodies[0] == bodies[1]
        assert sorted(bodies[0]["shards"]) == ["bus-0", "bus-1"]
        assert bodies[0]["name"] == "w14"
    finally:
        tmetrics.clear_shards_provider(buses[1].snapshot)
        jmetrics.clear_shards_provider(buses[0].snapshot)
        for h in http:
            h.shutdown()
            h.server_close()
        for b in buses:
            b.close(drain_s=0.0)


def test_bus_address_without_grpc_exits_2(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "grpc", None)
    rc, _, err = run_main(tcli, ["--mode", "bus", "--bus-address",
                                 "127.0.0.1:1"], capsys)
    assert rc == 2 and "grpcio" in err


def test_attention_xla_on_the_card_exits_2(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(teng, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    rc, _, err = run_main(tcli, [
        "--mode", "tpu-worker", "--infer-model", "tiny", "--infer-attention",
        "xla", "--storage-root", str(tmp_path)], capsys)
    assert rc == 2
    assert "xla" in err and "ROADMAP Queue 3" in err


@pytest.mark.parametrize("mode", list(tcli.CRAWLER_MODES) + [""])
def test_crawler_mode_exits_2(capsys, mode):
    argv = ["--mode", mode] if mode else []
    before = logging_state()
    rc, _, err = run_main(tcli, argv, capsys)
    assert rc == 2
    assert f"--mode {mode or 'standalone'} runs from " \
        f"distributed_crawler_tpu.cli" in err
    assert logging_state() == before  # refused before any set-up


def test_generate_code_is_the_gen_code_mode(capsys):
    rc, _, err = run_main(tcli, ["--generate-code"], capsys)
    assert rc == 2 and "--mode gen-code" in err


def test_spool_without_address_warns_and_serves_in_memory(tmp_path):
    from distributed_crawler_tpu_torch.bus.inmemory import InMemoryBus

    tstruct.uninstall_ring_handler()
    ring = tstruct.install_ring_handler()
    _, r = resolve(tcli, ["--mode", "tpu-worker", "--bus-spool-dir",
                          str(tmp_path)])
    bus = tcli._make_bus(r)
    try:
        assert isinstance(bus, InMemoryBus)
    finally:
        bus.close()
    assert any("durability is INACTIVE" in rec["message"]
               for rec in ring.snapshot())


def test_compilation_cache_dir_warns_and_serves(tmp_path, monkeypatch,
                                                capsys):
    served = []
    monkeypatch.setattr(tcli, "_serve_forever",
                        lambda *a, **k: served.append(True))
    env = {"CRAWLER_INFERENCE_COMPILATION_CACHE_DIR": str(tmp_path / "xla"),
           "CRAWLER_INFERENCE_BUCKET_SIZES": "16"}
    rc = tcli.main(["--mode", "tpu-worker", "--infer-model", "tiny",
                    "--infer-batch-size", "2", "--storage-root",
                    str(tmp_path / "store")], env=env, device="cpu")
    capsys.readouterr()
    assert rc == 0 and served == [True]
    assert any("compiles no XLA programs" in rec["message"]
               for rec in tstruct.ring_snapshot())


# -- logger hygiene -----------------------------------------------------------
def test_main_leaves_the_logger_tree_as_it_was(tmp_path, capsys):
    """`main()` runs `setup_logging`; under `restored_logging` the tree and
    both rings come back exactly as they were."""
    import logging

    before = logging_state()
    with restored_logging():
        rc, _, _ = run_main(tcli, ["--mode", "transcribe"], capsys,
                            device="cpu")
        assert rc == 2  # after setup_logging: missing --transcribe-input
        assert logging.getLogger("dct").propagate is False
    assert logging_state() == before

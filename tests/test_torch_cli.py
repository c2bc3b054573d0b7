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
  it waits for; ``--mode launch`` without ``--validate-only`` names part
  C for every sampling but the random walk.
- The validator pod: the tandem and validator flags resolve as the
  reference's; ``--validate-only`` needs no URLs and, bare, runs the
  validator in both CLIs; a ``--mode launch --validate-only`` process
  validates a closed batch against a t.me stand-in on loopback, writes
  the next page, and exits 130 on SIGTERM.
- The transcript re-entry and the object-store sink: each flag that used
  to exit 2 builds its mode (the provider's client, or the bridge on
  ``worker.bus`` with its batch size and deadline); ``_run_asr_worker``
  closes the bridge after the worker and before the bus; both packages'
  ``transcribe --infer --bus-address`` publish equal records into one
  broker; a URL the store refuses exits 2 with the reference's message.
- The bus: each of the reference's shard-configuration errors with its
  exit code and message; the durable outbox's WAL under
  ``<spool-dir>/outbox/<who>``; ``--mode bus --bus-spool-dir`` serving
  ``/dlq``; ``--bus-shard-addresses`` building a `PartitionedBus` whose
  ``/shards`` body equals the reference's.
- ``--mode orchestrator``: the crawl settings resolve as the reference's;
  a malformed ``--alert-rules`` or ``--tenant-budgets``, ``--autoscaler``
  without a broker address or with malformed pools, missing URLs and
  ``--sampling random-walk`` exit 2 before the broker starts; a process serves ``/status``, ``/cluster``, ``/dtraces``,
  ``/alerts``, ``/tenants`` and ``/dlq`` and journals the crawl; and
  ``python -m distributed_crawler_tpu_torch --mode orchestrator`` hosts
  the broker through which the reference's crawl `CrawlWorker` completes
  a BFS crawl of the simulated Telegram network.

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


# -- the transcript re-entry and the object-store sink ------------------------
def _close_built(worker, bridge=None):
    if bridge is not None:
        bridge.close()
    worker.bus.close()


def _built_cases(tmp, whisper_dir):
    """argv and a check of what the CLI built, for each flag that exited 2
    before the re-entry and the object store were ported."""
    from distributed_crawler_tpu_torch.inference.bridge import (
        InferenceBridge,
    )
    from distributed_crawler_tpu_torch.state import objectstore as tos
    from distributed_crawler_tpu_torch.state.azurestore import (
        AzureBlobObjectClient,
    )
    from distributed_crawler_tpu_torch.state.local import LocalStateManager
    from distributed_crawler_tpu_torch.state.s3store import S3ObjectClient

    store = ["--storage-root", str(tmp / "store"), "--crawl-id", "c-built"]
    tiny = ["--mode", "tpu-worker", "--infer-model", "tiny"] + store
    asr = ["--mode", "asr-worker", "--asr-pretrained-dir", whisper_dir] + store
    cluster = ["--mode", "cluster-worker"] + store
    s3 = ("s3://crawl/run?endpoint=http://127.0.0.1:1&access_key=AK"
          "&secret_key=SK")
    azure = ("azure://acct/crawls/run?endpoint=http://127.0.0.1:1"
             "&account_key=a2V5")

    def provider_is(client_cls, **attrs):
        def check(worker, bridge):
            assert bridge is None
            assert isinstance(worker.provider, tos.ObjectStorageProvider)
            client = worker.provider.client
            assert type(client) is client_cls
            for k, v in attrs.items():
                assert getattr(client, k) == v, k
        return check

    def reentry(batch_size, serving):
        def check(worker, bridge):
            assert isinstance(bridge, InferenceBridge)
            assert bridge._bus is worker.bus
            assert isinstance(worker.bus, tcli._ServingBus) == serving
            assert (bridge._acc.batch_size, bridge._acc.deadline_s,
                    bridge._acc.crawl_id) == (batch_size, 0.05, "c-built")
            # The post sink is the storage root's, with or without an
            # object store for the results (the reference's layout).
            assert isinstance(bridge._sm, LocalStateManager)
            assert bridge._sm.provider.base_path == str(tmp / "store")
        return check

    return {
        "object_store_tpu": (tiny + ["--object-store", "memory://"],
                             provider_is(tos.InMemoryObjectClient)),
        "object_store_asr": (asr + ["--object-store",
                                    f"file://{tmp}/objects"],
                             provider_is(tos.LocalFSObjectClient,
                                         root=f"{tmp}/objects")),
        "object_store_cluster": (cluster + ["--object-store", s3],
                                 provider_is(S3ObjectClient, bucket="crawl",
                                             prefix="run")),
        "object_store_cluster_azure": (cluster + ["--object-store", azure],
                                       provider_is(AzureBlobObjectClient,
                                                   container="crawls",
                                                   prefix="run")),
        "asr_infer": (asr + ["--infer", "--infer-batch-size", "7",
                             "--object-store", "memory://"],
                      reentry(7, serving=False)),
        "asr_infer_bus_serve": (asr + ["--infer", "--bus-serve",
                                       "--bus-address",
                                       f"127.0.0.1:{free_port()}"],
                                reentry(256, serving=True)),
    }


BUILT = sorted(_built_cases(Path("/x"), "/x"))


@pytest.mark.parametrize("case", BUILT)
def test_flag_builds_the_mode(tmp_path, whisper_ckpt, case):
    argv, check = _built_cases(tmp_path, whisper_ckpt)[case]
    cfg, r = resolve(tcli, argv)
    build = {"tpu-worker": tcli._build_tpu_worker,
               "asr-worker": tcli._build_asr_worker,
               "cluster-worker": tcli._build_cluster_worker}[argv[1]]
    built = build(cfg, r, device="cpu")
    worker, bridge = built if isinstance(built, tuple) else (built, None)
    try:
        check(worker, bridge)
    finally:
        _close_built(worker, bridge)


def test_asr_infer_reenters_a_transcript_through_the_worker_bus(
        tmp_path, whisper_ckpt):
    """The built wiring end to end on the in-memory bus: a transcript on
    the worker's bus is stored as ``media:<id>`` and shipped as a batch."""
    from distributed_crawler_tpu_torch.bus.messages import (
        TOPIC_TRANSCRIPTS,
        TranscriptMessage,
    )

    root = tmp_path / "store"
    cfg, r = resolve(tcli, ["--mode", "asr-worker", "--asr-pretrained-dir",
                            whisper_ckpt, "--storage-root", str(root),
                            "--crawl-id", "c-re", "--infer"])
    worker, bridge = tcli._build_asr_worker(cfg, r, device="cpu")
    shipped = []
    worker.bus.subscribe(TOPIC_INFERENCE_BATCHES, shipped.append)
    try:
        msg = TranscriptMessage.new("m1", crawl_id="c-re", path="ch/v.wav",
                                    channel_name="ch", text="hello")
        worker.bus.publish(TOPIC_TRANSCRIPTS, msg.to_dict())
        assert worker.bus.drain(timeout_s=10)
        bridge.flush()
        assert worker.bus.drain(timeout_s=10)
    finally:
        _close_built(worker, bridge)
    assert [[rec["post_uid"] for rec in b["records"]] for b in shipped] == \
        [["media:m1"]]
    lines = (root / "c-re" / "ch" / "posts" / "posts.jsonl").read_text(
        encoding="utf-8").splitlines()
    assert [json.loads(line)["description"] for line in lines] == ["hello"]


@pytest.mark.parametrize("close_fails", [False, True])
def test_run_asr_worker_closes_the_bridge_before_the_bus(monkeypatch,
                                                         caplog, close_fails):
    events = []

    class Bus:
        def close(self):
            events.append("bus.close")

    class Worker:
        bus = Bus()

        def warmup(self):
            events.append("warmup")

        def start(self):
            events.append("start")

        def stop(self):
            events.append("stop")

    class Bridge:
        def close(self):
            events.append("bridge.close")
            if close_fails:
                raise RuntimeError("outbox full")

    def interrupted(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli, "_build_asr_worker",
                        lambda cfg, r, device=None: (Worker(), Bridge()))
    monkeypatch.setattr(tcli, "_serve_forever", interrupted)
    cfg, r = resolve(tcli, ["--mode", "asr-worker"])
    with pytest.raises(KeyboardInterrupt):
        tcli._run_asr_worker(cfg, r)
    assert events == ["warmup", "start", "stop", "bridge.close", "bus.close"]
    assert any("reentry bridge close failed" in rec.getMessage()
               for rec in caplog.records) == close_fails


def test_transcribe_infer_publishes_the_references_records(
        tmp_path, whisper_ckpt, capsys):
    """Both packages' ``transcribe --infer --bus-address`` into one broker:
    one RecordBatch each, with equal records (error rows skipped,
    ``post_uid = media:<relpath>``, the file's directory as channel)."""
    from distributed_crawler_tpu_torch.bus import grpc_bus as tbus

    media = tmp_path / "media"
    (media / "chan_a").mkdir(parents=True)
    write_wav(media / "chan_a" / "voice1.wav")
    write_wav(media / "top.wav", seconds=0.5, freq=660.0)
    (media / "bad.wav").write_bytes(b"RIFFgarbage")
    server = tbus.GrpcBusServer("127.0.0.1:0")
    server.enable_pull(TOPIC_INFERENCE_BATCHES)
    server.start()
    address = f"127.0.0.1:{server.bound_port}"
    frames = []
    try:
        for cli, kw in ((tcli, {"device": "cpu"}), (jcli, {})):
            rc, _, err = run_main(cli, [
                "--mode", "transcribe", "--transcribe-input", str(media),
                "--asr-pretrained-dir", whisper_ckpt, "--infer",
                "--bus-address", address, "--crawl-id", "c-tr",
                "--transcribe-output", str(tmp_path / "t.jsonl")],
                capsys, **kw)
            assert rc == 0, err
        client = tbus.GrpcBusClient(address)
        stream = client.pull(TOPIC_INFERENCE_BATCHES)
        try:
            for _ in range(2):
                delivery_id, frame = next(stream)
                frames.append(json.loads(frame))
                client.ack(TOPIC_INFERENCE_BATCHES, delivery_id, True)
        finally:
            stream.close()
            client.close()
    finally:
        server.close()
    port, ref = frames
    assert port["records"] == ref["records"]
    assert port["crawl_id"] == ref["crawl_id"] == "c-tr"
    assert [(rec["post_uid"], rec["channel_name"]) for rec in
            port["records"]] == [("media:chan_a/voice1.wav", "chan_a"),
                                 ("media:top.wav", "transcripts")]
    assert all(rec["description"] for rec in port["records"])


def test_object_store_without_credentials_exits_2(monkeypatch, capsys):
    """The reference's message, before any engine is built."""
    from distributed_crawler_tpu.state import objectstore as jobj

    for k in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
              "AZURE_STORAGE_KEY"):
        monkeypatch.delenv(k, raising=False)
    built = []
    monkeypatch.setattr(tcli, "_make_engine",
                        lambda *a, **k: built.append(1))
    for url, module in (("s3://bucket/p?endpoint=http://x", "s3store"),
                        ("azure://acct/cont?endpoint=http://x",
                         "azurestore"),
                        ("gs://bucket/p", "objectstore")):
        rc, _, err = run_main(tcli, [
            "--mode", "tpu-worker", "--infer-model", "tiny",
            "--object-store", url], capsys, device="cpu")
        with pytest.raises(ValueError) as ref:
            jobj.make_object_client(url)
        assert rc == 2
        assert err.strip().splitlines()[-1] == f"error: {ref.value}", module
    assert built == []


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


# -- launch and the validator pod ------------------------------------------------
TANDEM_ARGV = ["--sampling", "random-walk", "--seed-size", "4",
               "--walkback-rate", "30", "--tandem-crawl",
               "--validator-request-rate", "120.5",
               "--validator-request-jitter-ms", "7",
               "--validator-claim-batch-size", "3", "--validator-timeout",
               "2m30s", "--validator-base-url", "http://mirror.test",
               "--validator-transport", "chrome", "--crawl-id", "tw"]
TANDEM_FIELDS = ("seed_size", "walkback_rate", "tandem_crawl",
                 "validate_only", "validator_request_rate",
                 "validator_request_jitter_ms", "validator_claim_batch_size",
                 "validator_timeout_s", "validator_base_url",
                 "validator_transport", "sampling_method", "crawl_id",
                 "max_crawl_duration_s")


@pytest.mark.parametrize("argv", [
    ["--mode", "launch", "--validate-only"],
    ["--mode", "launch", "--validate-only"] + TANDEM_ARGV,
    ["--mode", "orchestrator", "--urls", "a"] + TANDEM_ARGV[2:],
    ["--validate-only", "--sampling", "random-walk", "--max-crawl-duration",
     "15s"]])
def test_tandem_and_validator_config_resolves_as_the_references(argv):
    (t_cfg, t_r), (j_cfg, j_r) = (resolve(c, argv) for c in (tcli, jcli))
    for name in TANDEM_FIELDS:
        assert getattr(t_cfg, name) == getattr(j_cfg, name), name


def test_validate_only_needs_no_urls():
    """The reference's `test_validate_only_needs_no_urls`: no sampling
    check for the validator pod (the reference's resolver runs it for
    every crawling mode, the port's orchestrator before its broker)."""
    for cli in (tcli, jcli):
        cfg, _ = resolve(cli, ["--validate-only", "--sampling",
                               "random-walk"])
        assert cfg.validate_only
    tcli._check_sampling([], resolve(tcli, [
        "--mode", "orchestrator", "--validate-only", "--sampling",
        "random-walk"])[0], "orchestrator")


@pytest.mark.parametrize("argv", [["--validate-only"],
                                  ["--mode", "launch", "--validate-only"],
                                  ["--mode", "standalone", "--validate-only"]])
def test_validate_only_routes_to_the_validator(tmp_path, monkeypatch,
                                               capsys, argv):
    """The reference's `test_validate_only_routes_to_validator`: a bare
    ``--validate-only`` runs the validator pod, in both CLIs."""
    from distributed_crawler_tpu.modes import runner as jrouter
    from distributed_crawler_tpu_torch.modes import runner as trouter

    for cli, router in ((tcli, trouter), (jcli, jrouter)):
        ran = []
        monkeypatch.setattr(router, "run_validate_only",
                            lambda sm, cfg, validate_fn=None, **kw:
                            ran.append((type(sm).__name__,
                                        cfg.validate_only)))
        rc, _, err = run_main(cli, argv + [
            "--storage-root", str(tmp_path / cli.__name__),
            "--log-level", "error"], capsys)
        assert rc == 0, err
        assert ran == [("CompositeStateManager", True)]
        assert (tmp_path / cli.__name__ / "graph.sqlite").exists()


@pytest.mark.parametrize("sampling,part", [
    ("channel", "part C"), ("snowball", "part C"), ("random", "part C")])
def test_launch_without_validate_only_exits_2(tmp_path, capsys, sampling,
                                              part):
    """Without --validate-only the port's launch runs the random walk
    only; the other samplings wait for the crawl modes (part C): exit 2
    before any set-up."""
    before = logging_state()
    rc, _, err = run_main(tcli, [
        "--mode", "launch", "--sampling", sampling, "--urls", "alpha",
        "--storage-root", str(tmp_path / "s")], capsys)
    assert rc == 2
    assert f"ROADMAP Queue 1 {part}" in err and "--validate-only" in err
    assert logging_state() == before
    assert not (tmp_path / "s").exists()


def test_validator_process_validates_a_batch_and_exits_130(tmp_path):
    """``python -m distributed_crawler_tpu_torch --mode launch
    --validate-only`` on a graph holding one closed batch: each edge gets
    the stand-in's class, the walkback processor forwards to the valid
    channel in the batch's chain, and SIGTERM stops it with 130.  The
    stand-in is `chip_smoke.py`'s: t.me's pages by what a `SimNetwork`
    holds."""
    from chip_smoke import TmeStandIn
    from distributed_crawler_tpu_torch.clients import SimNetwork
    from distributed_crawler_tpu_torch.state import (
        CompositeStateManager,
        PendingEdge,
        PendingEdgeBatch,
        SqlConfig,
        StateConfig,
    )

    store = tmp_path / "store"
    sm = CompositeStateManager(StateConfig(
        crawl_id="tw", crawl_execution_id="e1", storage_root=str(tmp_path),
        sampling_method="random-walk",
        sql=SqlConfig(url=str(store / "graph.sqlite"))))
    sm.create_pending_batch(PendingEdgeBatch(
        batch_id="b1", crawl_id="tw", source_channel="seedchan",
        source_page_id="p1", source_depth=0, sequence_id="q1"))
    net = SimNetwork()
    net.add_channel("goodchan")
    net.add_channel("privroom", is_supergroup=False)
    names = ("goodchan", "privroom", "ghostname")  # the last one missing
    for n in names:
        sm.insert_pending_edge(PendingEdge(
            batch_id="b1", crawl_id="tw", destination_channel=n,
            source_channel="seedchan", sequence_id="q1",
            source_type="mention"))
    sm.close_pending_batch("b1")
    stand_in = TmeStandIn(net)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, NO_PROXY="127.0.0.1,localhost",
               no_proxy="127.0.0.1,localhost")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_crawler_tpu_torch", "--mode",
         "launch", "--validate-only", "--crawl-id", "tw", "--storage-root",
         str(store), "--validator-base-url", stand_in.url,
         "--validator-request-rate", "60000",
         "--validator-request-jitter-ms", "0", "--walkback-rate", "0",
         "--log-level", "error"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 90
        while sm.count_incomplete_batches("tw") and \
                time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1].decode()[-2000:]
        assert sm.count_incomplete_batches("tw") == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 130
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        stand_in.close()
    q = sm.graph.binding.query
    assert stand_in.requests == {n: 1 for n in names}
    assert [(p.url, p.sequence_id, p.depth)
            for p in sm.get_pages_from_page_buffer(9)] == \
        [("goodchan", "q1", 1)]
    assert q("SELECT destination_channel, walkback, skipped, sequence_id "
             "FROM edge_records") == [("goodchan", 0, 0, "q1")]
    assert dict(q("SELECT channel_username, reason FROM "
                  "invalid_channels")) == {"privroom": "not_supergroup",
                                           "ghostname": "not_found"}
    assert q("SELECT total, valid, not_channel, invalid FROM "
             "source_type_stats") == [(3, 1, 1, 1)]
    assert q("SELECT COUNT(*) FROM access_events") == [(0,)]
    assert q("SELECT COUNT(*) FROM pending_edges") == [(0,)]


def test_generate_code_is_the_gen_code_mode(capsys):
    """``--generate-code`` runs ``--mode gen-code``, as in the reference:
    with no TG_* environment both CLIs exit 2 with the same error."""
    errors = {}
    for name, cli in (("port", tcli), ("ref", jcli)):
        rc, _, err = run_main(cli, ["--generate-code"], capsys)
        assert rc == 2
        errors[name] = [ln for ln in err.splitlines()
                        if ln.startswith("error:")]
    assert errors["port"] == errors["ref"] == [
        "error: TG_API_ID and TG_PHONE_NUMBER are required"]


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


# -- the orchestrator -------------------------------------------------------------
ORCH_ARGV = ["--mode", "orchestrator", "--concurrency", "3", "--timeout",
             "9", "--sample-size", "5", "--min-users", "7",
             "--max-comments", "2", "--max-depth", "4", "--max-posts", "11",
             "--max-pages", "99", "--skip-media", "--youtube-api-key", "k",
             "--sampling", "snowball", "--min-channel-videos", "3",
             "--urls", "a,b", "--infer-backpressure-high", "8",
             "--infer-backpressure-low", "3", "--journal-dir", "/j",
             "--fresh"]
ORCH_FIELDS = ("concurrency", "timeout", "sample_size", "min_users",
               "max_comments", "max_depth", "max_posts", "max_pages",
               "skip_media_download", "youtube_api_key", "sampling_method",
               "min_channel_videos", "storage_root", "platform")


@pytest.mark.parametrize("argv", [["--mode", "orchestrator", "--urls", "a"],
                                  ORCH_ARGV])
def test_orchestrator_config_resolves_as_the_references(argv):
    (t_cfg, t_r), (j_cfg, j_r) = (resolve(c, argv) for c in (tcli, jcli))
    for name in ORCH_FIELDS:
        assert getattr(t_cfg, name) == getattr(j_cfg, name), name
    for key in ("distributed.inference_backpressure_high",
                "distributed.inference_backpressure_low",
                "orchestrator.journal_dir", "orchestrator.fresh",
                "crawler.urls", "resilience.state_retry_attempts"):
        assert t_r.get(key) == j_r.get(key), key
    assert tcli.collect_urls(t_r) == jcli.collect_urls(j_r)
    assert "orchestrator" in tcli.DEVICE_MODES
    assert "orchestrator" not in tcli.CRAWLER_MODES


def _orch_errors(tmp):
    bad_rules = tmp / "rules.json"
    if tmp.is_dir():
        bad_rules.write_text("[{]")
    base = ["--mode", "orchestrator", "--urls", "chana",
            "--storage-root", str(tmp / "s"), "--bus-address",
            "127.0.0.1:1"]
    return {
        "rules_json": (base + ["--alert-rules", "[{"], "--alert-rules is "
                       "not valid JSON"),
        "rules_file": (base + ["--alert-rules", f"@{bad_rules}"],
                       "--alert-rules is not valid JSON"),
        "rules_missing_file": (base + ["--alert-rules", "@/nonexistent"],
                               "cannot read --alert-rules file"),
        "rule_unknown_key": (base + ["--alert-rules", json.dumps([{
            "name": "x", "kind": "threshold", "series": "s", "bogus": 1}])],
            "bad alert rule: alert rule x: unknown key(s) bogus"),
        "rule_bad_kind": (base + ["--alert-rules", json.dumps([{
            "name": "x", "kind": "nope", "series": "s"}])],
            "bad alert rule"),
        "budgets_json": (base + ["--tenant-budgets", "{"],
                         "--tenant-budgets is not valid JSON"),
        "budgets_typo": (base + ["--tenant-budgets", json.dumps(
            {"budgetz": {}})], "bad tenant budget: unknown "
            "tenant_budgets key"),
        "budgets_negative": (base + ["--tenant-budgets", json.dumps(
            {"budgets": {"t": {"queue_wait": -1}}})],
            "bad tenant budget"),
        "autoscaler": (base[:-2] + ["--autoscaler"],
                       "--autoscaler requires --bus-address"),
        "autoscaler_pools_json": (base + ["--autoscaler",
                                          "--autoscaler-pools", "[{"],
                                  "--autoscaler-pools is not valid JSON"),
        "autoscaler_pool_unknown_key": (base + [
            "--autoscaler", "--autoscaler-pools",
            json.dumps([{"pool": "tpu", "max_wrkers": 3}])],
            "bad autoscaler pool: autoscaler pool tpu: unknown key(s) "
            "max_wrkers"),
        "no_urls": (["--mode", "orchestrator", "--storage-root",
                     str(tmp / "s")], "channel sampling requires URLs"),
        "random_walk": (base + ["--sampling", "random-walk", "--crawl-id",
                                "x" * 33],
                        "crawl IDs cannot exceed 32 characters"),
        "random_walk_no_urls": (["--mode", "orchestrator", "--sampling",
                                 "random-walk", "--storage-root",
                                 str(tmp / "s")],
                                "must provide either seed urls or seed size "
                                "in random-walk crawl, not both or neither"),
        "bad_sampling": (base + ["--sampling", "random"],
                         "sampling method 'random' is not supported for "
                         "platform 'telegram'"),
        "bad_platform": (base + ["--platform", "myspace"],
                         "unsupported platform: myspace"),
        "url_file": (["--mode", "orchestrator", "--url-file",
                      "/nonexistent"], "cannot read --url-file"),
    }


ORCH_ERRORS = sorted(_orch_errors(Path("/x")))


@pytest.mark.parametrize("case", ORCH_ERRORS)
def test_orchestrator_config_error_exits_2_before_the_broker(
        tmp_path, monkeypatch, capsys, case):
    argv, needle = _orch_errors(tmp_path)[case]

    def no_broker(*a, **k):
        raise AssertionError("the broker started")

    monkeypatch.setattr(tcli, "_make_bus", no_broker)
    rc, _, err = run_main(tcli, argv, capsys)
    assert rc == 2, err
    assert needle in err, err


def test_orchestrator_error_messages_are_the_references(tmp_path, capsys):
    """The rule and budget messages are the reference's word for word."""
    for flag, raw in (("--alert-rules", "[{"),
                      ("--alert-rules", json.dumps([{"name": "x"}])),
                      ("--tenant-budgets", json.dumps({"window_s": 0}))):
        errs = []
        for cli in (tcli, jcli):
            _, r = resolve(cli, ["--mode", "orchestrator", "--urls", "a",
                                 flag, raw])
            fn = cli._alert_rules if flag == "--alert-rules" \
                else cli._tenant_budgets
            with pytest.raises(ValueError) as e:
                fn(r)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def _orch_process(tmp_path, *extra):
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_crawler_tpu_torch", "--mode",
         "orchestrator", "--metrics-port", str(port), "--storage-root",
         str(tmp_path / "store"), "--crawl-id", "c9", "--skip-media",
         *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    return proc, f"http://127.0.0.1:{port}"


def _wait_route(proc, url, pred=lambda body: True, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            code, body = http_get(url)
            if code == 200 and pred(json.loads(body)):
                return json.loads(body)
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"{url}: {proc.poll()} "
                         f"{proc.communicate()[1].decode()[-2000:]}")


def test_orchestrator_process_serves_its_routes(tmp_path):
    """The in-process bus, a durable spool dir (served at /dlq), budgets
    and a rule: every route answers; SIGTERM gives 130; the journal,
    ``state.json`` and the graph store land where the reference puts
    them."""
    proc, url = _orch_process(
        tmp_path, "--urls", "chana,chanb", "--tenant-budgets", json.dumps(
            {"budgets": {"default": {"queue_wait": 3}}}),
        "--alert-rules", json.dumps([{"name": "deep", "kind": "threshold",
                                      "series": "fleet_queue_depth",
                                      "op": ">", "value": 2}]))
    try:
        status = _wait_route(proc, url + "/status")
        assert status["crawl_id"] == "c9" and status["resumed"] is False
        cluster = _wait_route(proc, url + "/cluster")
        assert cluster["orchestrator"]["crawl_id"] == "c9"
        assert _wait_route(proc, url + "/dtraces")["collector_process"] == \
            "orchestrator"
        alerts = _wait_route(proc, url + "/alerts")
        assert alerts["alerts"][0]["rule"] == "deep"
        tenants = _wait_route(proc, url + "/tenants")
        assert tenants["tenants"]["default"]["budgets"]["queue_wait"][
            "budget"] == 3.0
        assert http_get(url + "/autoscaler")[0] == 404
        # The first distribute tick (5 s) dispatches both seeds.
        _wait_route(proc, url + "/status",
                    lambda b: b["work_stats"]["active_work"] == 2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 130
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    base = tmp_path / "store" / "c9"
    assert sorted(os.listdir(base / "orch-journal")) == [
        "journal.jsonl", "snapshot.json"]
    with open(base / "state.json", encoding="utf-8") as f:
        state = json.load(f)
    assert [p["status"] for p in state["layers"][0]["pages"]] == [
        "processing", "processing"]
    # The mode's state manager keeps its graph store beside the crawl, as
    # the reference's does.
    assert (tmp_path / "store" / "graph.sqlite").is_file()


def test_orchestrator_process_crawls_with_the_references_worker(
        tmp_path):
    """``python -m distributed_crawler_tpu_torch --mode orchestrator``
    hosts the broker; the reference's `CrawlWorker` on a `RemoteBus`
    crawls the simulated network through it; the process exits 0 once
    the crawl completes, every page fetched."""
    pytest.importorskip("grpc")
    from distributed_crawler_tpu.bus.grpc_bus import RemoteBus
    from tests.test_torch_orchestrator import _ref_worker, install_pool
    from distributed_crawler_tpu.clients import SimNetwork
    from distributed_crawler_tpu.crawl import runner as crawl_runner
    from tests.test_crawl_engine import text_msg

    net = SimNetwork()
    net.add_channel("chana", messages=[
        text_msg("hello t.me/chanb", date=1700000000, view_count=5),
    ], member_count=100)
    net.add_channel("chanb", messages=[
        text_msg("plain message", date=1700000100, view_count=3),
    ], member_count=200)
    install_pool(net)
    address = f"127.0.0.1:{free_port()}"
    proc, url = _orch_process(tmp_path, "--urls", "chana", "--bus-address",
                              address, "--max-depth", "2")
    remote = worker = None
    try:
        _wait_route(proc, url + "/status")
        remote = RemoteBus(address)
        worker = _ref_worker(remote, tmp_path)
        worker.start(background=False)
        assert proc.wait(timeout=90) == 0, proc.communicate()[1][-2000:]
    finally:
        if worker is not None:
            worker.stop()
        if remote is not None:
            remote.close()
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        crawl_runner.shutdown_connection_pool()
    with open(tmp_path / "store" / "c9" / "state.json",
              encoding="utf-8") as f:
        layers = json.load(f)["layers"]
    assert [[(p["url"], p["status"]) for p in layer["pages"]]
            for layer in layers] == [[("chana", "fetched")],
                                     [("chanb", "fetched")]]
    with open(tmp_path / "store" / "c9" / "metadata.json",
              encoding="utf-8") as f:
        assert json.load(f)["status"] == "completed"


def test_orchestrator_process_crawls_with_the_ports_worker(tmp_path):
    """The same crawl with the port's own `CrawlWorker`: its pool of
    `SimTelegramClient`s over the port's `SimNetwork`, the port's
    `RemoteBus` into the orchestrator process; the process exits 0 once
    the crawl completes, every page fetched."""
    pytest.importorskip("grpc")
    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus
    from distributed_crawler_tpu_torch.clients import (
        ConnectionPool,
        SimNetwork,
        SimTelegramClient,
        TLMessage,
    )
    from distributed_crawler_tpu_torch.config.crawler import CrawlerConfig
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner
    from distributed_crawler_tpu_torch.state import (
        CompositeStateManager,
        StateConfig,
    )
    from distributed_crawler_tpu_torch.worker import CrawlWorker

    def text(t, **kw):
        return TLMessage(content={"@type": "messageText",
                                  "text": {"text": t, "entities": []}}, **kw)

    net = SimNetwork()
    net.add_channel("chana", messages=[
        text("hello t.me/chanb", date=1700000000, view_count=5),
    ], member_count=100)
    net.add_channel("chanb", messages=[
        text("plain message", date=1700000100, view_count=3),
    ], member_count=200)
    crawl_runner.shutdown_connection_pool()
    crawl_runner.init_connection_pool(ConnectionPool.for_testing(
        {"conn0": SimTelegramClient(net, conn_id="conn0")}))
    address = f"127.0.0.1:{free_port()}"
    proc, url = _orch_process(tmp_path, "--urls", "chana", "--bus-address",
                              address, "--max-depth", "2")
    remote = worker = None
    try:
        _wait_route(proc, url + "/status")
        remote = RemoteBus(address)
        worker = CrawlWorker(
            "w1", CrawlerConfig(crawl_id="c9", platform="telegram",
                                skip_media_download=True,
                                sampling_method="channel"),
            remote, CompositeStateManager(StateConfig(
                crawl_id="c9", crawl_execution_id="e1",
                storage_root=str(tmp_path / "wrk"))))
        worker.start(background=False)
        assert proc.wait(timeout=90) == 0, proc.communicate()[1][-2000:]
    finally:
        if worker is not None:
            worker.stop()
        if remote is not None:
            remote.close()
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        crawl_runner.shutdown_connection_pool()
    with open(tmp_path / "store" / "c9" / "state.json",
              encoding="utf-8") as f:
        layers = json.load(f)["layers"]
    assert [[(p["url"], p["status"]) for p in layer["pages"]]
            for layer in layers] == [[("chana", "fetched")],
                                     [("chanb", "fetched")]]
    with open(tmp_path / "store" / "c9" / "metadata.json",
              encoding="utf-8") as f:
        assert json.load(f)["status"] == "completed"
    posts = tmp_path / "wrk" / "c9" / "chana" / "posts" / "posts.jsonl"
    assert len(posts.read_text().splitlines()) == 1


# -- the crawl-worker process and the native client -----------------------------
CPU_MAIN = ("import sys; from distributed_crawler_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")


def _process(log, *argv, cpu=False):
    """``python -m distributed_crawler_tpu_torch`` (or, with ``cpu``, its
    `main` on the CPU) logging to ``log``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CRAWLER_INFERENCE_BUCKET_SIZES="16,32")
    head = ([sys.executable, "-c", CPU_MAIN] if cpu
            else [sys.executable, "-m", "distributed_crawler_tpu_torch"])
    with open(log, "w") as out:
        return subprocess.Popen(head + list(argv), cwd=ROOT, env=env,
                                stdout=out, stderr=subprocess.STDOUT)


def _ref_process(log, *argv):
    """The reference's ``python -m distributed_crawler_tpu.cli`` on the
    CPU, logging to ``log``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    with open(log, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "distributed_crawler_tpu.cli", *argv],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)


def _stored_posts(store, crawl_id, names):
    """``{channel: [post dicts]}`` of a crawl worker's store, each without
    its ``capture_time`` (the wall clock at the crawl)."""
    out = {}
    for name in names:
        path = store / crawl_id / name / "posts" / "posts.jsonl"
        out[name] = [{k: v for k, v in json.loads(ln).items()
                      if k != "capture_time"}
                     for ln in path.read_text().splitlines()]
    return out


def _seed_dbs(tmp_path, n, seed=0, channels=2, posts=3):
    """``n`` seed-DB tarballs of `chip_smoke.native_store`'s store at a
    tiny size (posts of 1-6 words); returns (paths, channel names)."""
    from chip_smoke import native_store, write_seed_dbs

    doc, names = native_store(np, seed, channels=channels, posts=posts,
                              spans=((1, 6),))
    return write_seed_dbs(str(tmp_path / "dbs"), doc, n), names


def _result_rows(store, crawl_id):
    rows = []
    for f in sorted((store / "inference" / crawl_id / "batches").glob(
            "*.jsonl")):
        rows += [json.loads(ln) for ln in f.read_text().splitlines()]
    return rows


def test_worker_process_crawls_seed_dbs_into_a_tpu_worker(tmp_path):
    """The counterpart of `tests/test_topology_e2e.py:68`, all of it the
    port's processes: ``--mode orchestrator`` hosting the broker (BFS,
    depth 1), ``--mode worker --infer`` with its pool from two seed-DB
    tarballs through the native client, and a CPU ``--mode tpu-worker``.
    The crawl completes, each channel's posts are stored once and each
    gets one result row; the worker's ``/status`` counts both items, and
    SIGTERM stops it with 130.  Beside it, the reference's orchestrator
    and ``--mode worker`` crawl the same tarballs: both stores hold the
    same posts, field by field."""
    pytest.importorskip("grpc")
    dbs, names = _seed_dbs(tmp_path, 2)
    address, ref_address = (f"127.0.0.1:{free_port()}" for _ in range(2))
    m_orch, m_wrk = free_port(), free_port()
    procs, ref = [], []
    try:
        ref.append(_ref_process(
            tmp_path / "ref_orch.log", "--mode", "orchestrator", "--urls",
            names[0], "--bus-address", ref_address, "--crawl-id", "topo1",
            "--storage-root", str(tmp_path / "ref_ostore"), "--max-depth",
            "1", "--skip-media"))
        ref.append(_ref_process(
            tmp_path / "ref_worker.log", "--mode", "worker", "--worker-id",
            "w1", "--bus-address", ref_address, "--crawl-id", "topo1",
            "--tdlib-database-urls", ",".join(dbs), "--storage-root",
            str(tmp_path / "ref_wstore"), "--skip-media"))
        procs.append(_process(
            tmp_path / "orch.log", "--mode", "orchestrator", "--urls",
            names[0], "--bus-address", address, "--crawl-id", "topo1",
            "--storage-root", str(tmp_path / "ostore"), "--max-depth", "1",
            "--skip-media", "--metrics-port", str(m_orch)))
        _wait_route(procs[0], f"http://127.0.0.1:{m_orch}/status")
        procs.append(_process(
            tmp_path / "tpu.log", "--mode", "tpu-worker", "--infer-model",
            "tiny", "--bus-address", address, "--storage-root",
            str(tmp_path / "tpustore"), cpu=True))
        procs.append(_process(
            tmp_path / "worker.log", "--mode", "worker", "--worker-id", "w1",
            "--bus-address", address, "--crawl-id", "topo1",
            "--tdlib-database-urls", ",".join(dbs), "--storage-root",
            str(tmp_path / "wstore"), "--skip-media", "--infer",
            "--metrics-port", str(m_wrk), "--telemetry-interval", "1"))
        assert procs[0].wait(timeout=120) == 0, \
            (tmp_path / "orch.log").read_text()[-3000:]
        stored = {}
        for name in names:
            path = (tmp_path / "wstore" / "topo1" / name / "posts" /
                    "posts.jsonl")
            stored[name] = [json.loads(ln)["post_uid"]
                            for ln in path.read_text().splitlines()]
        uids = [u for v in stored.values() for u in v]
        assert [len(v) for v in stored.values()] == [3, 3]
        assert len(set(uids)) == 6
        deadline = time.monotonic() + 60
        rows = []
        while time.monotonic() < deadline:
            rows = _result_rows(tmp_path / "tpustore", "topo1")
            if len(rows) >= 6:
                break
            time.sleep(0.5)
        assert sorted(r["post_uid"] for r in rows) == sorted(uids), \
            (tmp_path / "tpu.log").read_text()[-3000:]
        assert all(len(r["embedding"]) and "label" in r for r in rows)
        status = _wait_route(procs[2], f"http://127.0.0.1:{m_wrk}/status")
        assert (status["worker_id"], status["tasks_processed"],
                status["tasks_success"]) == ("w1", 2, 2)
        code, body = http_get(f"http://127.0.0.1:{m_wrk}/metrics")
        assert code == 200
        assert b'telegram_rate_limit_calls_total{api_call="SearchPublicChat"}' \
            in body
        procs[2].send_signal(signal.SIGTERM)
        assert procs[2].wait(timeout=60) == 130
        log = (tmp_path / "worker.log").read_text()
        built = os.path.join(ROOT, "distributed_crawler_tpu_torch", "_build",
                             "native", "libdct_client-")
        assert f"native client library loaded path={built}" in log
        assert ref[0].wait(timeout=120) == 0, \
            (tmp_path / "ref_orch.log").read_text()[-3000:]
    finally:
        for p in procs + ref:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    assert _stored_posts(tmp_path / "wstore", "topo1", names) == \
        _stored_posts(tmp_path / "ref_wstore", "topo1", names)
    with open(tmp_path / "ostore" / "topo1" / "state.json",
              encoding="utf-8") as f:
        layers = json.load(f)["layers"]
    assert [[(p["url"], p["status"]) for p in layer["pages"]]
            for layer in layers] == [[(names[0], "fetched")],
                                     [(names[1], "fetched")]]


def test_launch_random_walk_on_a_seed_db_pool_beside_a_validator(tmp_path,
                                                                  capsys):
    """``--mode launch --sampling random-walk --tandem-crawl`` in process,
    its pool from two seed-DB tarballs through the native client, beside a
    ``--mode launch --validate-only`` process on the same graph file and a
    t.me stand-in: the walk completes (exit 0, metadata ``completed``),
    every batch completes, each seed steps forward to one of its own
    channels, the missing name is marked invalid, t.me is asked once per
    name, no post is stored, and the validator exits 130 on SIGTERM."""
    from chip_smoke import TmeStandIn, write_seed_dbs
    from distributed_crawler_tpu_torch.clients import SimNetwork
    from distributed_crawler_tpu_torch.clients.native import (
        NativeTelegramClient,
    )
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner
    from distributed_crawler_tpu_torch.state import (
        CompositeStateManager,
        SqlConfig,
        StateConfig,
    )

    rng = np.random.default_rng(21)
    seeds = ["rwseeda", "rwseedb"]
    kids = {s: [f"{s}kid{i}" for i in range(2)] for s in seeds}
    ghost = "rwghostname"

    def msg(text, i):
        return {"date": 1700000000 + 60 * i,
                "view_count": int(rng.integers(1, 500)),
                "content": {"@type": "messageText",
                            "text": {"text": text, "entities": []}}}

    def words():
        return " ".join("".join(rng.choice(list("abcdefgh"), 5))
                        for _ in range(int(rng.integers(1, 6))))

    channels = []
    for s in seeds:
        links = " ".join(f"t.me/{n}" for n in kids[s] + [ghost])
        channels.append({"username": s, "title": s, "member_count": 1000,
                         "messages": [msg(f"{words()} {links}", i)
                                      for i in range(3)]})
        channels += [{"username": k, "title": k, "member_count": 1000,
                      "messages": [msg(words(), i) for i in range(3)]}
                     for k in kids[s]]
    doc = {"channels": channels}
    dbs = write_seed_dbs(str(tmp_path / "dbs"), doc, 2)
    net = SimNetwork()
    for c in channels:
        net.add_channel(c["username"])
    client = NativeTelegramClient(seed_json=json.dumps(doc))
    try:
        ids = {s: client.search_public_chat(s).id for s in seeds}
    finally:
        client.close()
    store = tmp_path / "store"
    pool_sm = CompositeStateManager(StateConfig(
        crawl_id="tw", crawl_execution_id="e0",
        storage_root=str(tmp_path / "pool"), sampling_method="random-walk",
        sql=SqlConfig(url=str(store / "graph.sqlite"))))
    for s in seeds:   # the deployment's seed pool
        pool_sm.upsert_seed_channel_chat_id(s, ids[s])
    pool_sm.close()
    stand_in = TmeStandIn(net)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, NO_PROXY="127.0.0.1,localhost",
               no_proxy="127.0.0.1,localhost")
    validator = subprocess.Popen(
        [sys.executable, "-m", "distributed_crawler_tpu_torch", "--mode",
         "launch", "--validate-only", "--crawl-id", "tw", "--storage-root",
         str(store), "--validator-base-url", stand_in.url,
         "--validator-request-rate", "60000",
         "--validator-request-jitter-ms", "0", "--walkback-rate", "0",
         "--log-level", "error"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        rc, _, err = run_main(tcli, [
            "--mode", "launch", "--sampling", "random-walk",
            "--tandem-crawl", "--urls", ",".join(seeds), "--crawl-id", "tw",
            "--storage-root", str(store), "--tdlib-database-urls",
            ",".join(dbs), "--walkback-rate", "0", "--max-crawl-duration",
            "90s", "--log-level", "error"], capsys)
        assert rc == 0, err
        assert crawl_runner._pool is None   # torn down with the mode
        # Read before the validator stops: its manager saves its own
        # metadata under the shared storage root when it closes.
        with open(store / "tw" / "metadata.json", encoding="utf-8") as f:
            assert json.load(f)["status"] == "completed"
        assert validator.poll() is None, \
            validator.communicate()[1].decode()[-2000:]
        validator.send_signal(signal.SIGTERM)
        assert validator.wait(timeout=60) == 130
    finally:
        if validator.poll() is None:
            validator.kill()
        validator.communicate()
        stand_in.close()
    import sqlite3

    con = sqlite3.connect(store / "graph.sqlite")
    try:
        q = lambda sql: con.execute(sql).fetchall()  # noqa: E731
        edges = q("SELECT destination_channel, source_channel, walkback, "
                  "skipped FROM edge_records")
        batches = {r[0] for r in q("SELECT status FROM "
                                   "pending_edge_batches")}
        invalid = dict(q("SELECT channel_username, reason FROM "
                         "invalid_channels"))
    finally:
        con.close()
    assert batches == {"completed"}
    forward = {e[1]: e[0] for e in edges if not e[2] and not e[3]}
    assert {s: forward.get(s) in kids[s] for s in seeds} == \
        dict.fromkeys(seeds, True)
    assert invalid.get(ghost) == "not_found"
    assert stand_in.requests and set(stand_in.requests.values()) == {1}
    assert ghost in stand_in.requests
    assert not list((store / "tw").glob("*/posts/posts.jsonl"))


@pytest.mark.parametrize("argv,part", [
    (["--mode", "worker", "--worker-id", "w1", "--media-bridge"], "part C"),
    (["--mode", "worker", "--worker-id", "w1", "--platform", "youtube"],
     "part C"),
    (["--mode", "worker", "--worker-id", "w1", "--dc-wire", "mtproto",
      "--dc-address", "127.0.0.1:9"], "part D"),
    (["--mode", "launch", "--sampling", "random-walk", "--urls", "a",
      "--media-bridge"], "part C")])
def test_crawling_mode_refuses_what_waits(tmp_path, capsys, argv, part):
    """The media bridge and the YouTube crawler wait for the crawl modes,
    the MTProto wire for the rest of part D: exit 2 before a bus, a
    manager or a pool is made."""
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner

    rc, _, err = run_main(tcli, argv + [
        "--storage-root", str(tmp_path / "s"), "--tdlib-database-urls",
        str(tmp_path / "db.tar.gz")], capsys)
    assert rc == 2
    assert f"ROADMAP Queue 1 {part}" in err
    assert not (tmp_path / "s").exists() and crawl_runner._pool is None


@pytest.mark.parametrize("argv", [
    ["--mode", "worker"],
    ["--mode", "launch", "--sampling", "random-walk"],
    ["--mode", "launch", "--sampling", "random-walk", "--urls", "a",
     "--seed-size", "3"],
    ["--mode", "launch", "--sampling", "random-walk", "--urls", "a",
     "--crawl-id", "x" * 33]])
def test_crawling_mode_config_errors_are_the_references(tmp_path, capsys,
                                                        argv):
    """A worker without ``--worker-id`` and the random walk's sampling
    matrix: exit 2 with the reference's message."""
    errs = {}
    for name, cli in (("port", tcli), ("ref", jcli)):
        rc, _, err = run_main(cli, argv + [
            "--storage-root", str(tmp_path / name)], capsys)
        assert rc == 2
        errs[name] = [ln for ln in err.splitlines()
                      if ln.startswith("error:")]
    assert errs["port"] == errs["ref"] and len(errs["port"]) == 1


def test_gen_code_writes_credentials_a_gateway_pool_reads(tmp_path, capsys):
    """``--mode gen-code --dc-address`` in both CLIs walks the ladder at a
    gateway and writes equal credentials (mode 0600); a ``--mode worker
    --dc-address --concurrency 2`` config's pool reads them back and
    dials two authenticated connections."""
    from distributed_crawler_tpu.clients.mock_dc import MockDcServer
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner

    env = {"TG_API_ID": "94575", "TG_API_HASH": "h",
           "TG_PHONE_NUMBER": "+15550004444", "TG_PHONE_CODE": "55555"}
    seed = json.dumps({"channels": [{"username": "wirechan",
                                     "title": "Wire", "messages": []}]})
    srv = MockDcServer(seed_json=seed, expected_code="55555").start()
    try:
        files = {}
        for name, cli in (("port", tcli), ("ref", jcli)):
            tdlib = tmp_path / name / ".tdlib"
            rc = cli.main(["--mode", "gen-code", "--dc-address",
                           srv.address, "--tdlib-dir", str(tdlib)], env=env)
            out, err = capsys.readouterr()
            assert rc == 0, err
            assert f"credentials saved to {tdlib}/credentials.json" in out
            path = tdlib / "credentials.json"
            assert oct(os.stat(path).st_mode & 0o777) == "0o600"
            files[name] = path.read_text()
        assert files["port"] == files["ref"]
        cfg, _ = resolve(tcli, ["--mode", "worker", "--dc-address",
                                srv.address, "--tdlib-dir",
                                str(tmp_path / "port" / ".tdlib"),
                                "--concurrency", "2"])
        crawl_runner.shutdown_connection_pool()
        try:
            assert crawl_runner.setup_pool_from_config(cfg) is True
            assert len(crawl_runner._pool._conns) == 2
            conn = crawl_runner.get_connection_from_pool(timeout_s=5)
            assert conn.client.search_public_chat("wirechan").title == \
                "Wire"
            crawl_runner.release_connection_to_pool(conn)
        finally:
            crawl_runner.shutdown_connection_pool()
        assert srv.auth_successes == 4
    finally:
        srv.close()

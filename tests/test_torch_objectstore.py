"""The port's object-store sink (`state/objectstore.py`, `state/s3store.py`,
`state/azurestore.py`) against the JAX package's, on the CPU.

- The cases of `tests/test_objectstore.py` on the port's classes: the
  uploader's retry that resumes at the failed part, the local client's
  multipart directories and key-escape refusal, the URL schemes, the
  provider's surface and its buffered append (one upload per flush; a
  failed upload keeps every accepted line).
- Objects the port's provider writes are the bytes the reference's
  writes, and each package's provider reads what the other wrote.
- `SigV4Signer` and `SharedKeySigner` give the reference's headers for the
  same requests at a fixed clock.
- The port's S3 and Azure clients against the emulators of
  `tests/test_s3store.py` and `tests/test_azurestore.py` (their classes,
  imported by name, so nothing there is collected twice).
- The port's `TPUWorker` and `ClusterWorker` with `ObjectStorageProvider`
  as their sink.

The part size, retries and backoff are the module constants (8 MiB, 4,
0.2 s), so the multipart cases move objects of a little over 16 MiB.
"""

import base64
import datetime
import json
import os
import re
import urllib.parse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distributed_crawler_tpu.state import azurestore as jazure  # noqa: E402
from distributed_crawler_tpu.state import objectstore as jobj  # noqa: E402
from distributed_crawler_tpu.state import s3store as js3  # noqa: E402
from distributed_crawler_tpu_torch.state import azurestore as tazure  # noqa: E402
from distributed_crawler_tpu_torch.state import s3store as ts3  # noqa: E402
from distributed_crawler_tpu_torch.state.objectstore import (  # noqa: E402
    PART_SIZE,
    InMemoryObjectClient,
    LocalFSObjectClient,
    ObjectStorageProvider,
    ObjectStoreUploader,
    TransientStoreError,
    make_object_client,
)
from tests.test_azurestore import (  # noqa: E402
    ACCOUNT,
    KEY_B64,
    AzureEmulator,
)
from tests.test_s3store import ACCESS, SECRET, S3Emulator  # noqa: E402

# Three parts: two whole, one short.
BIG = 2 * PART_SIZE + 1000


def _big(seed=0, n=BIG):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# -- the uploader -------------------------------------------------------------
def test_small_object_is_one_put():
    client = InMemoryObjectClient()
    ObjectStoreUploader(client).upload_bytes("k/small", b"x" * 10)
    assert client.objects["k/small"] == b"x" * 10
    assert [c[0] for c in client.calls] == ["put_object"]


def test_multipart_roundtrip():
    client = InMemoryObjectClient()
    data = _big()
    ObjectStoreUploader(client).upload_bytes("k/big", data)
    assert client.objects["k/big"] == data
    assert [c[1] for c in client.calls if c[0] == "upload_part"] == \
        ["k/big#0", "k/big#1", "k/big#2"]


def test_mid_file_failure_resumes_not_restarts():
    """Two failures of the first part: it is sent three times, every later
    part once."""
    client = InMemoryObjectClient()
    data = _big(1)
    client.fail("upload_part", 2)
    ObjectStoreUploader(client).upload_bytes("k/big", data)
    assert client.objects["k/big"] == data
    sent = [c[1] for c in client.calls if c[0] == "upload_part"]
    assert sent.count("k/big#0") == 3
    assert sent.count("k/big#1") == sent.count("k/big#2") == 1


def test_permanent_failure_aborts_multipart():
    client = InMemoryObjectClient()
    client.fail("upload_part", 99)
    with pytest.raises(TransientStoreError):
        ObjectStoreUploader(client).upload_bytes("k", _big(2))
    assert client._mp == {}  # aborted: no upload state left behind
    assert "k" not in client.objects
    assert [c[0] for c in client.calls].count("upload_part") == 4


# -- the local client -----------------------------------------------------------
def test_local_multipart_concat_and_list(tmp_path):
    client = LocalFSObjectClient(str(tmp_path / "store"))
    data = _big(3)
    ObjectStoreUploader(client).upload_bytes("a/b/blob.bin", data)
    assert client.get_object("a/b/blob.bin") == data
    assert client.head_object("a/b/blob.bin") == len(data)
    assert client.list_objects("a/") == ["a/b/blob.bin"]
    assert not [d for d in os.listdir(tmp_path / "store")
                if d.startswith(".mp-")]
    client.delete_object("a/b/blob.bin")
    assert client.get_object("a/b/blob.bin") is None


@pytest.mark.parametrize("key", ["../outside", "../store-evil/f"])
def test_key_escape_rejected(tmp_path, key):
    client = LocalFSObjectClient(str(tmp_path / "store"))
    with pytest.raises(ValueError, match="escapes"):
        client.put_object(key, b"x")
    assert not (tmp_path / "store-evil").exists()
    assert not (tmp_path / "outside").exists()


def test_make_object_client_schemes(tmp_path, monkeypatch):
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    monkeypatch.delenv("AZURE_STORAGE_KEY", raising=False)
    assert isinstance(make_object_client("memory://"), InMemoryObjectClient)
    for url in (f"file://{tmp_path}/s", f"file:{tmp_path}/r",
                str(tmp_path / "bare")):
        assert isinstance(make_object_client(url), LocalFSObjectClient)
    for url in ("s3://bucket/prefix?access_key=",
                "azure://acct/cont?endpoint=http://x", "gs://bucket/prefix",
                "azure://acct", "s3://"):
        with pytest.raises(ValueError) as mine:
            make_object_client(url)
        with pytest.raises(ValueError) as ref:
            jobj.make_object_client(url)
        assert str(mine.value) == str(ref.value)


# -- the provider -----------------------------------------------------------------
def test_provider_surface():
    p = ObjectStorageProvider(InMemoryObjectClient())
    p.save_json("m/meta.json", {"a": 1, "видео": [1.5]})
    assert p.load_json("m/meta.json") == {"a": 1, "видео": [1.5]}
    assert p.load_json("m/nope.json") is None
    p.put_text("m/t.txt", "hello\n")
    assert p.get_text("m/t.txt") == "hello\n"
    p.append_jsonl("m/rows.jsonl", '{"n": 1}')
    p.append_jsonl("m/rows.jsonl", '{"n": 2}\n')
    assert p.list_dir("m") == ["meta.json", "rows.jsonl", "t.txt"]
    assert p.get_text("m/rows.jsonl") == '{"n": 1}\n{"n": 2}\n'
    assert p.get_text("m/nope") is None
    p.append_jsonl("m/t.txt", "x")
    p.put_text("m/t.txt", "again")  # overwrites buffered appends too
    p.flush()
    assert p.get_text("m/t.txt") == "again"


def test_appends_batch_until_flush_threshold():
    """One read-modify-write per flush, not per line."""
    client = InMemoryObjectClient()
    p = ObjectStorageProvider(client)

    def puts():
        return [c for c in client.calls if c[0] == "put_object"]

    for i in range(100):
        p.append_jsonl("r/x.jsonl", f'{{"i": {i}}}')
    assert puts() == []
    assert p.list_dir("r") == ["x.jsonl"]  # buffered rows are listed
    assert len(p.get_text("r/x.jsonl").splitlines()) == 100
    assert len(puts()) == 1
    p.append_jsonl("r/x.jsonl", '{"i": 100}')
    p.flush()
    assert len(p.get_text("r/x.jsonl").splitlines()) == 101
    # Past the threshold a key uploads by itself.
    line = "y" * 1023
    for _ in range(256):
        p.append_jsonl("r/big.jsonl", line)
    assert client.objects["r/big.jsonl"] == (line + "\n").encode() * 256


def test_failed_upload_keeps_every_accepted_line():
    client = InMemoryObjectClient()
    p = ObjectStorageProvider(client)
    p.append_jsonl("f/rows.jsonl", "a")
    client.fail("put_object", 4)  # every attempt of one upload
    with pytest.raises(TransientStoreError):
        p.flush()
    assert "f/rows.jsonl" not in client.objects
    p.append_jsonl("f/rows.jsonl", "b")
    p.flush()
    assert client.objects["f/rows.jsonl"] == b"a\nb\n"


def _write_through(provider):
    provider.save_json("c/ckpt.json", {"step": 3, "k": [1.0, 2.5]})
    provider.put_text("c/batches/b1.jsonl", '{"post_uid": "media:x"}\n')
    for i in range(3):
        provider.append_jsonl("c/chan/posts/posts.jsonl",
                              json.dumps({"i": i, "t": "видео"},
                                         ensure_ascii=False))
    provider.flush()


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_both_packages_write_the_same_objects(tmp_path):
    _write_through(ObjectStorageProvider(
        LocalFSObjectClient(str(tmp_path / "port"))))
    _write_through(jobj.ObjectStorageProvider(
        jobj.LocalFSObjectClient(str(tmp_path / "ref"))))
    got = _tree(str(tmp_path / "port"))
    assert got == _tree(str(tmp_path / "ref"))
    assert sorted(got) == sorted(os.path.join(*k.split("/")) for k in (
        "c/ckpt.json", "c/batches/b1.jsonl", "c/chan/posts/posts.jsonl"))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_reads_what_the_other_wrote(tmp_path, writer):
    root = str(tmp_path / "store")
    mine = ObjectStorageProvider(LocalFSObjectClient(root))
    ref = jobj.ObjectStorageProvider(jobj.LocalFSObjectClient(root))
    w, r = (mine, ref) if writer == "port" else (ref, mine)
    _write_through(w)
    assert r.load_json("c/ckpt.json") == {"step": 3, "k": [1.0, 2.5]}
    assert r.get_text("c/batches/b1.jsonl") == '{"post_uid": "media:x"}\n'
    assert r.list_dir("c") == ["batches", "chan", "ckpt.json"]
    assert [json.loads(line)["i"] for line in r.get_text(
        "c/chan/posts/posts.jsonl").splitlines()] == [0, 1, 2]


# -- the signers ----------------------------------------------------------------
NOW = datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)
S3_REQUESTS = [
    ("GET", "crawl.s3.us-east-1.amazonaws.com", "/k.jsonl", [], "e3b0"),
    ("PUT", "127.0.0.1:9000", "/crawl/dir with space/post+plus=eq~t.jsonl",
     [], "ab" * 32),
    ("PUT", "127.0.0.1:9000", "/crawl/mp/big.bin",
     [("uploadId", "u/1+2"), ("partNumber", "3")], "cd" * 32),
    ("GET", "127.0.0.1:9000", "/crawl",
     [("prefix", "p/ä"), ("list-type", "2"), ("continuation-token", "x=y")],
     "e3b0"),
    ("POST", "h", "/crawl/mp", [("uploads", "")], "00"),
]


@pytest.mark.parametrize("req", range(len(S3_REQUESTS)))
@pytest.mark.parametrize("region", ["us-east-1", "eu-central-1"])
def test_sigv4_headers_are_the_references(req, region):
    method, host, path, query, payload = S3_REQUESTS[req]
    mine = ts3.SigV4Signer(ACCESS, SECRET, region).sign(
        method, host, path, query, payload, now=NOW)
    ref = js3.SigV4Signer(ACCESS, SECRET, region).sign(
        method, host, path, query, payload, now=NOW)
    assert mine == ref
    assert mine["x-amz-date"] == "20260304T050607Z"


AZ_REQUESTS = [
    ("PUT", "/crawls/a/b.jsonl", [], {"x-ms-blob-type": "BlockBlob"}, 11),
    ("GET", "/crawls/a/b.jsonl", [], {}, 0),
    ("GET", "/crawls", [("restype", "container"), ("comp", "list"),
                        ("prefix", "run1/p/"), ("marker", "m2")], {}, 0),
    ("PUT", "/crawls/mp.bin", [("comp", "block"), ("blockid", "dXAx==")],
     {}, 8),
    ("PUT", f"/{ACCOUNT}/crawls/p/a.jsonl", [("comp", "blocklist")],
     {"Content-Type": "application/xml"}, 120),
]


@pytest.mark.parametrize("req", range(len(AZ_REQUESTS)))
def test_shared_key_authorization_is_the_references(req):
    method, path, query, extra, length = AZ_REQUESTS[req]
    headers = {"x-ms-date": "Wed, 04 Mar 2026 05:06:07 GMT",
               "x-ms-version": tazure.API_VERSION, **extra}
    mine = tazure.SharedKeySigner(ACCOUNT, KEY_B64).sign(
        method, path, query, headers, length)
    ref = jazure.SharedKeySigner(ACCOUNT, KEY_B64).sign(
        method, path, query, headers, length)
    assert mine == ref and mine.startswith(f"SharedKey {ACCOUNT}:")
    assert tazure.API_VERSION == jazure.API_VERSION


def test_shared_key_refuses_a_key_that_is_not_base64():
    with pytest.raises(ValueError, match="not base64"):
        tazure.SharedKeySigner(ACCOUNT, "not-base64!")


# -- S3 against the emulator ------------------------------------------------------
@pytest.fixture
def s3():
    e = S3Emulator().start()
    yield e
    e.close()


def _s3_client(emu, prefix="", secret=SECRET):
    return ts3.S3ObjectClient(bucket="crawl", prefix=prefix,
                              endpoint=emu.endpoint, access_key=ACCESS,
                              secret_key=secret)


def test_s3_put_get_head_list_delete(s3):
    c = _s3_client(s3)
    c.put_object("a/b.jsonl", b"hello s3")
    assert c.get_object("a/b.jsonl") == b"hello s3"
    assert c.head_object("a/b.jsonl") == 8
    assert c.get_object("missing") is None and c.head_object("x") is None
    key = "dir with space/post+plus=eq~tilde.jsonl"
    c.put_object(key, b"data")
    assert c.get_object(key) == b"data"
    for i in range(8):  # the emulator pages by 3
        c.put_object(f"p/k{i}", b"v")
    assert c.list_objects("p/") == [f"p/k{i}" for i in range(8)]
    c.delete_object("a/b.jsonl")
    c.delete_object("a/b.jsonl")  # a 404 is fine
    assert c.get_object("a/b.jsonl") is None
    c.close()


def test_s3_prefix_and_errors(s3):
    c = _s3_client(s3, prefix="crawls/c1")
    c.put_object("combined/a.jsonl", b"x")
    assert "crawls/c1/combined/a.jsonl" in s3.objects
    assert c.list_objects("combined/") == ["combined/a.jsonl"]
    with pytest.raises(ValueError, match="403"):
        _s3_client(s3, secret="wrong-secret").put_object("k", b"x")
    s3.fail_next.append((r"PUT /crawl/crawls/c1/t5", 1))
    with pytest.raises(TransientStoreError):
        c.put_object("t5", b"x")
    dead = ts3.S3ObjectClient(bucket="b", endpoint="http://127.0.0.1:1",
                              access_key=ACCESS, secret_key=SECRET)
    with pytest.raises(TransientStoreError):
        dead.get_object("k")


def test_s3_multipart_resumes_at_the_failed_part(s3):
    c = _s3_client(s3)
    # partNumber=2 (0-based part 1) fails twice, then succeeds.
    s3.fail_next.append((r"PUT /crawl/mp/fault\.bin\?partNumber=2&", 2))
    data = _big(4)
    ObjectStoreUploader(c).upload_bytes("mp/fault.bin", data)
    assert s3.objects["mp/fault.bin"] == data
    by_part = {}
    for m, p in s3.request_log:
        if m == "PUT" and "partNumber=" in p and "fault.bin" in p:
            n = int(re.search(r"partNumber=(\d+)", p).group(1))
            by_part[n] = by_part.get(n, 0) + 1
    assert by_part == {1: 1, 2: 3, 3: 1}
    uid = c.create_multipart("mp/etag.bin")
    c.upload_part("mp/etag.bin", uid, 0, b"part0")
    with pytest.raises(ValueError, match="400"):
        c.complete_multipart("mp/etag.bin", uid, ['"bogus-etag"'])
    c.abort_multipart("mp/etag.bin", uid)


def test_s3_urls(s3, monkeypatch):
    url = (f"s3://crawl/pfx?endpoint={s3.endpoint}"
           f"&access_key={ACCESS}&secret_key={SECRET}")
    make_object_client(url).put_object("k.jsonl", b"via-url")
    assert s3.objects["pfx/k.jsonl"] == b"via-url"
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", ACCESS)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", SECRET)
    make_object_client(f"s3://crawl?endpoint={s3.endpoint}").put_object(
        "envkey", b"ok")
    assert s3.objects["envkey"] == b"ok"
    # The provider over S3, read back by the reference's.
    p = ObjectStorageProvider(make_object_client(
        f"s3://crawl/run?endpoint={s3.endpoint}"))
    p.append_jsonl("r/rows.jsonl", '{"n": 1}')
    p.flush()
    ref = jobj.ObjectStorageProvider(jobj.make_object_client(
        f"s3://crawl/run?endpoint={s3.endpoint}"))
    assert ref.get_text("r/rows.jsonl") == '{"n": 1}\n'


# -- Azure against the emulator ------------------------------------------------------
@pytest.fixture
def azure():
    e = AzureEmulator().start()
    yield e
    e.close()


def _az_client(emu, prefix="", key=KEY_B64, endpoint=None):
    return tazure.AzureBlobObjectClient(
        account=ACCOUNT, container="crawls", prefix=prefix,
        endpoint=endpoint or emu.endpoint, account_key=key)


def test_azure_put_get_head_list_delete(azure):
    c = _az_client(azure, prefix="run1")
    c.put_object("a/b.jsonl", b"hello azure")
    assert c.get_object("a/b.jsonl") == b"hello azure"
    assert c.head_object("a/b.jsonl") == 11
    assert c.get_object("missing") is None
    for i in range(8):
        c.put_object(f"p/k{i}", b"v")
    assert ("crawls", "run1/p/k0") in azure.blobs
    assert c.list_objects("p/") == [f"p/k{i}" for i in range(8)]
    c.delete_object("a/b.jsonl")
    assert c.get_object("a/b.jsonl") is None
    c.close()


def test_azure_errors(azure):
    wrong = base64.b64encode(b"wrong-key").decode()
    with pytest.raises(ValueError, match="403"):
        _az_client(azure, key=wrong).put_object("k", b"x")
    azure.fail_next.append((r"PUT /crawls/t5", 1))
    with pytest.raises(TransientStoreError):
        _az_client(azure).put_object("t5", b"x")
    dead = tazure.AzureBlobObjectClient(
        account=ACCOUNT, container="c", endpoint="http://127.0.0.1:1",
        account_key=KEY_B64)
    with pytest.raises(TransientStoreError):
        dead.get_object("k")


def test_azure_multipart_resumes_at_the_failed_block(azure):
    c = _az_client(azure)
    azure.fail_next.append((r"decoded=.*:000001", 2))
    data = _big(5)
    ObjectStoreUploader(c).upload_bytes("mp/fault.bin", data)
    assert azure.blobs[("crawls", "mp/fault.bin")] == data
    by_part = {}
    for m, p in azure.request_log:
        if m == "PUT" and "comp=block" in p and "blocklist" not in p \
                and "fault.bin" in p:
            bid = re.search(r"blockid=([^&]+)", p).group(1)
            part = base64.b64decode(
                urllib.parse.unquote(bid)).decode().split(":")[1]
            by_part[part] = by_part.get(part, 0) + 1
    assert by_part == {"000000": 1, "000001": 3, "000002": 1}
    uid = c.create_multipart("mp/bad.bin")
    c.upload_part("mp/bad.bin", uid, 0, b"part0")
    with pytest.raises(ValueError, match="400"):
        c.complete_multipart("mp/bad.bin", uid, ["Ym9ndXM="])


def test_azurite_style_endpoint():
    """The account rides the path and appears twice in the signed
    resource."""
    emu = AzureEmulator(account_in_path=True).start()
    try:
        c = _az_client(emu, prefix="p",
                       endpoint=f"{emu.endpoint}/{ACCOUNT}")
        c.put_object("a.jsonl", b"azurite-style")
        assert emu.blobs[("crawls", "p/a.jsonl")] == b"azurite-style"
        assert c.list_objects("") == ["a.jsonl"]
    finally:
        emu.close()


def test_azure_urls(azure, monkeypatch):
    url = (f"azure://{ACCOUNT}/crawls/pfx?endpoint={azure.endpoint}"
           f"&account_key={urllib.parse.quote(KEY_B64)}")
    make_object_client(url).put_object("k.jsonl", b"via-url")
    assert azure.blobs[("crawls", "pfx/k.jsonl")] == b"via-url"
    monkeypatch.setenv("AZURE_STORAGE_KEY", KEY_B64)
    make_object_client(
        f"azure://{ACCOUNT}/crawls?endpoint={azure.endpoint}").put_object(
        "envkey", b"ok")
    assert azure.blobs[("crawls", "envkey")] == b"ok"


# -- the workers' sink ----------------------------------------------------------------
def test_tpu_worker_writes_results_to_the_object_store():
    from distributed_crawler_tpu.inference.worker import iter_results
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_BATCHES,
        InMemoryBus,
        RecordBatch,
    )
    from distributed_crawler_tpu_torch.datamodel import Post
    from distributed_crawler_tpu_torch.inference import engine as teng
    from distributed_crawler_tpu_torch.inference.worker import (
        TPUWorker,
        TPUWorkerConfig,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    client = InMemoryObjectClient()
    provider = ObjectStorageProvider(client)
    registry = MetricsRegistry()
    engine = teng.InferenceEngine(
        teng.EngineConfig(model="tiny", n_labels=2, batch_size=4,
                          buckets=(16, 32)), registry=registry, device="cpu")
    bus = InMemoryBus(sync=True)
    worker = TPUWorker(bus, engine, provider=provider,
                       cfg=TPUWorkerConfig(heartbeat_s=60.0),
                       registry=registry)
    worker.start()
    try:
        batch = RecordBatch.from_posts(
            [Post(post_uid=f"p{i}", all_text=f"text {i}") for i in range(3)],
            crawl_id="c9")
        bus.publish(TOPIC_INFERENCE_BATCHES, batch.to_dict())
        assert worker.drain(10.0)
    finally:
        worker.stop()
        bus.close()
    key = f"inference/c9/batches/{batch.batch_id}.jsonl"
    assert key in client.objects
    rows = list(iter_results(provider, "c9"))
    assert [r["post_uid"] for r in rows] == ["p0", "p1", "p2"]
    assert all(len(r["embedding"]) == engine.ecfg.hidden for r in rows)


def test_cluster_worker_assigns_and_checkpoints_into_the_object_store():
    from distributed_crawler_tpu_torch.bus import InMemoryBus, RecordBatch
    from distributed_crawler_tpu_torch.cluster import (
        ClusterWorker,
        ClusterWorkerConfig,
        iter_assignments,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    rng = np.random.RandomState(0)
    batch = RecordBatch.from_dict({
        "batch_id": "b1", "crawl_id": "c1", "trace_id": "trace_os_1",
        "records": [{"post_uid": f"p{i}", "channel_name": "chanA",
                     "description": "t"} for i in range(6)],
        "results": [{"embedding": rng.randn(16).tolist(), "label": "x"}
                    for _ in range(6)]})
    provider = ObjectStorageProvider(InMemoryObjectClient())

    def worker():
        return ClusterWorker(
            InMemoryBus(sync=True), provider=provider,
            cfg=ClusterWorkerConfig(worker_id="cluster-1", k=4,
                                    buckets=(8, 32),
                                    checkpoint_every_batches=1),
            registry=MetricsRegistry(), device="cpu")

    w = worker()
    w._handle_payload(batch.to_dict(), ack=None)
    w.start()
    try:
        assert w.drain(timeout_s=10)
    finally:
        w.stop()
    rows = list(iter_assignments(provider, "c1"))
    assert sorted(r["post_uid"] for r in rows) == [f"p{i}" for i in range(6)]
    assert w.engine.vectors == 6
    # A new worker on the same store resumes from the checkpoint.
    resumed = worker()
    assert resumed.engine.vectors == 6
    assert torch.equal(resumed.engine.centroids, w.engine.centroids)

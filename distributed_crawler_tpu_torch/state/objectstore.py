"""The object-store results sink (``--object-store``).

The port's copy of the reference's `distributed_crawler_tpu/state/
objectstore.py`:

- `ObjectStoreClient`: the S3-shaped blob surface (put/get/head/list/
  delete, multipart create/upload/complete/abort).  `InMemoryObjectClient`
  (``memory://``, with fault injection), `LocalFSObjectClient`
  (``file://``), `state/s3store.S3ObjectClient` (``s3://``) and
  `state/azurestore.AzureBlobObjectClient` (``azure://``) implement it.
- `ObjectStoreUploader`: objects above `PART_SIZE` go up in parts, each
  retried with exponential backoff; a failed part is retried where it
  failed, and earlier parts are never sent again.
- `ObjectStorageProvider`: the workers' `StorageProvider` over a client,
  so a worker's results, transcripts and checkpoints land in the store.

Keys and bytes are the reference's, so either package reads what the
other wrote.  The reference's provider also has ``store_file``,
``exists`` and ``delete`` and its uploader ``upload_file``, for the
crawler's media and the chunker; the port's workers call none of them,
and they are not ported.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Protocol, Tuple, runtime_checkable

logger = logging.getLogger("dct.objectstore")

# The reference's defaults, which no caller of the port changes.
PART_SIZE = 8 * 1024 * 1024   # larger objects upload in parts of this size
MAX_RETRIES = 4               # attempts per part (and per whole object)
BACKOFF_S = 0.2               # first retry's wait; doubles each attempt
# Appended lines buffer per key up to this many bytes: an object store has
# no append, and a read-modify-write per line would move O(n^2) bytes.
APPEND_FLUSH_BYTES = 256 * 1024


@runtime_checkable
class ObjectStoreClient(Protocol):
    """S3-shaped blob surface; keys are forward-slash paths."""

    def put_object(self, key: str, data: bytes) -> None: ...

    def get_object(self, key: str) -> Optional[bytes]: ...

    def head_object(self, key: str) -> Optional[int]: ...

    def list_objects(self, prefix: str) -> List[str]: ...

    def delete_object(self, key: str) -> None: ...

    def create_multipart(self, key: str) -> str: ...

    def upload_part(self, key: str, upload_id: str, part_no: int,
                    data: bytes) -> str: ...

    def complete_multipart(self, key: str, upload_id: str,
                           etags: List[str]) -> None: ...

    def abort_multipart(self, key: str, upload_id: str) -> None: ...


class TransientStoreError(Exception):
    """A retryable failure (connection error, 5xx): the uploader retries."""


class KeepAliveHttpTransport:
    """The cloud clients' HTTP: one keep-alive connection per client,
    serialized by a lock (a TLS handshake per part would dominate a
    multipart upload).  A transport error drops the connection, so the
    uploader's retry gets a fresh one, and raises `TransientStoreError`."""

    def __init__(self, host: str, tls: bool, timeout_s: float,
                 scheme_name: str):
        self._host = host
        self._tls = tls
        self._timeout_s = timeout_s
        self._scheme_name = scheme_name
        self._lock = threading.Lock()
        self._conn = None

    def http_request(self, method: str, url: str, body: bytes,
                     headers: Dict[str, str]):
        """Returns ``(status, headers_dict, body_bytes)``."""
        import http.client

        with self._lock:
            if self._conn is None:
                conn_cls = (http.client.HTTPSConnection if self._tls
                            else http.client.HTTPConnection)
                self._conn = conn_cls(self._host, timeout=self._timeout_s)
            conn = self._conn
            try:
                conn.request(method, url, body=body or None,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, dict(resp.getheaders()), data
            except (OSError, http.client.HTTPException) as e:
                self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass
                raise TransientStoreError(
                    f"{self._scheme_name} {method} {url.split('?')[0]}: "
                    f"{e}") from e

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None

    def raise_for(self, status: int, method: str, what: str,
                  body: bytes) -> None:
        """5xx is transient; 3xx and 4xx are configuration errors (a
        redirect would break the signed host, and its body is not the
        object)."""
        if status >= 500:
            raise TransientStoreError(
                f"{self._scheme_name} {method} {what}: HTTP {status}")
        if status >= 300:
            raise ValueError(
                f"{self._scheme_name} {method} {what}: HTTP {status}: "
                f"{body[:300].decode('utf-8', 'replace')}")


class InMemoryObjectClient:
    """Objects in a dict (``memory://``).  ``fail(op, times)`` makes the
    next ``times`` calls of ``op`` raise `TransientStoreError`."""

    def __init__(self):
        self.objects: Dict[str, bytes] = {}
        self._mp: Dict[str, Dict[int, bytes]] = {}
        self._faults: Dict[str, int] = {}
        self.calls: List[Tuple[str, str]] = []
        self._lock = threading.RLock()

    def fail(self, op: str, times: int = 1) -> None:
        with self._lock:
            self._faults[op] = self._faults.get(op, 0) + times

    def _maybe_fail(self, op: str) -> None:
        with self._lock:
            if self._faults.get(op, 0) > 0:
                self._faults[op] -= 1
                raise TransientStoreError(f"injected {op} failure")

    def _call(self, op: str, what: str) -> None:
        with self._lock:
            self.calls.append((op, what))
        self._maybe_fail(op)

    def put_object(self, key: str, data: bytes) -> None:
        self._call("put_object", key)
        with self._lock:
            self.objects[key] = bytes(data)

    def get_object(self, key: str) -> Optional[bytes]:
        self._call("get_object", key)
        with self._lock:
            return self.objects.get(key)

    def head_object(self, key: str) -> Optional[int]:
        with self._lock:
            data = self.objects.get(key)
        return None if data is None else len(data)

    def list_objects(self, prefix: str) -> List[str]:
        self._maybe_fail("list_objects")
        with self._lock:
            return sorted(k for k in self.objects if k.startswith(prefix))

    def delete_object(self, key: str) -> None:
        self._maybe_fail("delete_object")
        with self._lock:
            self.objects.pop(key, None)

    def create_multipart(self, key: str) -> str:
        self._call("create_multipart", key)
        with self._lock:
            upload_id = f"mp-{len(self._mp)}-{key}"
            self._mp[upload_id] = {}
        return upload_id

    def upload_part(self, key: str, upload_id: str, part_no: int,
                    data: bytes) -> str:
        self._call("upload_part", f"{key}#{part_no}")
        with self._lock:
            self._mp[upload_id][part_no] = bytes(data)
        return f"etag-{part_no}"

    def complete_multipart(self, key: str, upload_id: str,
                           etags: List[str]) -> None:
        self._call("complete_multipart", key)
        with self._lock:
            parts = self._mp.pop(upload_id)
            self.objects[key] = b"".join(parts[i] for i in sorted(parts))

    def abort_multipart(self, key: str, upload_id: str) -> None:
        with self._lock:
            self._mp.pop(upload_id, None)


class LocalFSObjectClient:
    """Objects as files under ``root`` (``file://``).  A multipart upload
    stages its parts in a hidden ``.mp-<id>`` directory and concatenates
    them on complete, so a completed object is always whole; a key that
    resolves outside ``root`` is refused."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._counter = 0

    def _path(self, key: str) -> str:
        root = os.path.normpath(self.root)
        path = os.path.normpath(os.path.join(root, key))
        # commonpath, not startswith: '../store-evil' shares the string
        # prefix of root but is a sibling directory.
        if path != root and os.path.commonpath([root, path]) != root:
            raise ValueError(f"key escapes store root: {key}")
        return path

    @staticmethod
    def _replace(path: str, write) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)

    def put_object(self, key: str, data: bytes) -> None:
        self._replace(self._path(key), lambda f: f.write(data))

    def get_object(self, key: str) -> Optional[bytes]:
        path = self._path(key)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def head_object(self, key: str) -> Optional[int]:
        path = self._path(key)
        return os.path.getsize(path) if os.path.isfile(path) else None

    def list_objects(self, prefix: str) -> List[str]:
        keys = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [d for d in dirnames if not d.startswith(".mp-")]
            for name in filenames:
                if name.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    keys.append(key)
        return sorted(keys)

    def delete_object(self, key: str) -> None:
        path = self._path(key)
        if os.path.isfile(path):
            os.remove(path)

    def _mp_dir(self, upload_id: str) -> str:
        return os.path.join(self.root, f".mp-{upload_id}")

    def create_multipart(self, key: str) -> str:
        with self._lock:
            self._counter += 1
            upload_id = f"{self._counter}-{time.time_ns()}"
        os.makedirs(self._mp_dir(upload_id), exist_ok=True)
        return upload_id

    def upload_part(self, key: str, upload_id: str, part_no: int,
                    data: bytes) -> str:
        self._replace(os.path.join(self._mp_dir(upload_id),
                                   f"part_{part_no:06d}"),
                      lambda f: f.write(data))
        return f"etag-{part_no}"

    def complete_multipart(self, key: str, upload_id: str,
                           etags: List[str]) -> None:
        mp_dir = self._mp_dir(upload_id)
        parts = sorted(n for n in os.listdir(mp_dir)
                       if n.startswith("part_") and not n.endswith(".tmp"))

        def concat(out):
            for name in parts:
                with open(os.path.join(mp_dir, name), "rb") as f:
                    shutil.copyfileobj(f, out, 1 << 20)

        self._replace(self._path(key), concat)
        self.abort_multipart(key, upload_id)

    def abort_multipart(self, key: str, upload_id: str) -> None:
        shutil.rmtree(self._mp_dir(upload_id), ignore_errors=True)


class ObjectStoreUploader:
    """Uploads with retry per part over any `ObjectStoreClient`.

    An object of at most `PART_SIZE` bytes is one ``put_object``, retried
    whole; a larger one is a multipart upload whose parts each get
    `MAX_RETRIES` attempts, `BACKOFF_S` doubling between them, so a
    failure resumes at the part that failed.  A part that fails every
    attempt aborts the upload and raises its last error."""

    def __init__(self, client: ObjectStoreClient):
        self.client = client

    def _with_retry(self, op_name: str, fn):
        for attempt in range(MAX_RETRIES):
            try:
                return fn()
            except Exception as e:  # every failure of the store is retried
                logger.warning("%s failed (attempt %d/%d): %s", op_name,
                               attempt + 1, MAX_RETRIES, e)
                if attempt + 1 == MAX_RETRIES:
                    raise
                time.sleep(BACKOFF_S * (2 ** attempt))

    def upload_bytes(self, key: str, data: bytes) -> None:
        if len(data) <= PART_SIZE:
            self._with_retry(f"put {key}",
                             lambda: self.client.put_object(key, data))
            return
        upload_id = self._with_retry(
            f"create-multipart {key}",
            lambda: self.client.create_multipart(key))
        try:
            etags: List[str] = []
            for part_no, start in enumerate(range(0, len(data), PART_SIZE)):
                chunk = data[start:start + PART_SIZE]
                etags.append(self._with_retry(
                    f"part {part_no} of {key}",
                    lambda c=chunk, n=part_no:
                    self.client.upload_part(key, upload_id, n, c)))
            self._with_retry(
                f"complete {key}",
                lambda: self.client.complete_multipart(key, upload_id, etags))
        except Exception:
            try:
                self.client.abort_multipart(key, upload_id)
            except Exception as e:  # cleanup must not mask the failure
                logger.warning("abort of %s failed: %s", key, e)
            raise


class ObjectStorageProvider:
    """The workers' `StorageProvider` over an object store.

    ``append_jsonl`` buffers lines per key until `APPEND_FLUSH_BYTES`, then
    uploads the stored object with the buffer appended; an upload that
    fails puts the buffer back before it raises, so an accepted line is
    never dropped.  ``get_text`` and ``list_dir`` see buffered lines;
    ``flush`` (the workers call it at stop) uploads every buffer.  One
    writer per key is the contract: each worker owns its keys."""

    def __init__(self, client: ObjectStoreClient):
        self.client = client
        self.uploader = ObjectStoreUploader(client)
        self._lock = threading.Lock()
        self._append_buf: Dict[str, bytearray] = {}

    def save_json(self, rel_path: str, data: Any) -> None:
        self.uploader.upload_bytes(
            rel_path, json.dumps(data, ensure_ascii=False).encode("utf-8"))

    def load_json(self, rel_path: str) -> Optional[Any]:
        raw = self.client.get_object(rel_path)
        return None if raw is None else json.loads(raw.decode("utf-8"))

    def append_jsonl(self, rel_path: str, line: str) -> None:
        with self._lock:
            buf = self._append_buf.setdefault(rel_path, bytearray())
            buf += line.rstrip("\n").encode("utf-8") + b"\n"
            if len(buf) >= APPEND_FLUSH_BYTES:
                self._flush_key_locked(rel_path)

    def _flush_key_locked(self, rel_path: str) -> bytes:
        """Upload ``rel_path``'s buffer after the stored bytes; returns the
        merged object, so a reader needs no second GET.  On failure the
        buffer goes back in front of any lines appended meanwhile."""
        buf = self._append_buf.pop(rel_path, None)
        prior = self.client.get_object(rel_path) or b""
        if not buf:
            return prior
        merged = prior + bytes(buf)
        try:
            self.uploader.upload_bytes(rel_path, merged)
        except Exception:
            self._append_buf[rel_path] = buf + self._append_buf.get(
                rel_path, bytearray())
            raise
        return merged

    def flush(self) -> None:
        with self._lock:
            for key in list(self._append_buf):
                self._flush_key_locked(key)

    def put_text(self, rel_path: str, text: str) -> None:
        with self._lock:
            self._append_buf.pop(rel_path, None)  # overwrite semantics
        self.uploader.upload_bytes(rel_path, text.encode("utf-8"))

    def get_text(self, rel_path: str) -> Optional[str]:
        with self._lock:
            if self._append_buf.get(rel_path):
                return self._flush_key_locked(rel_path).decode("utf-8")
        raw = self.client.get_object(rel_path)
        return None if raw is None else raw.decode("utf-8")

    def list_dir(self, rel_path: str) -> List[str]:
        prefix = rel_path.rstrip("/") + "/"
        names = set()
        with self._lock:
            for key, buf in self._append_buf.items():
                if buf and key.startswith(prefix):
                    names.add(key[len(prefix):].split("/", 1)[0])
        for key in self.client.list_objects(prefix):
            names.add(key[len(prefix):].split("/", 1)[0])
        return sorted(names)


def make_object_client(url: str) -> ObjectStoreClient:
    """``memory://`` | ``file:///abs/path`` | ``file:relative/path`` |
    ``s3://bucket/prefix?endpoint=...`` | ``azure://account/container/
    prefix?endpoint=...`` | a bare path (a local directory).  Another
    scheme raises `ValueError`, as in the reference."""
    if url == "memory://":
        return InMemoryObjectClient()
    if url.startswith("file://"):
        return LocalFSObjectClient(url[len("file://"):] or "/")
    if url.startswith("file:"):
        return LocalFSObjectClient(url[len("file:"):])
    if url.startswith("s3://"):
        from .s3store import parse_s3_url

        return parse_s3_url(url)
    if url.startswith("azure://"):
        from .azurestore import parse_azure_url

        return parse_azure_url(url)
    if "://" in url:
        raise ValueError(
            f"no client for object-store scheme {url.split('://')[0]!r}; "
            f"implement ObjectStoreClient and wire it in make_object_client")
    return LocalFSObjectClient(url)

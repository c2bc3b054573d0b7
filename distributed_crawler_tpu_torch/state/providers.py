"""Storage providers: the results sink of the port's workers.

The port's copy of `LocalStorageProvider` and its protocol from the
reference's `distributed_crawler_tpu/state/providers.py`.  The three
workers write one idempotent JSONL file per batch through ``put_text``,
the cluster worker checkpoints through ``save_json``/``load_json``, the
transcript re-entry's post sink (`state/local.py`) appends through
``append_jsonl``, and the readers (`iter_results`, `iter_transcripts`,
`iter_assignments`) walk the tree with ``list_dir``/``get_text``.  Layouts
and bytes are the reference's, so either package can read what the other
wrote.  `state/objectstore.ObjectStorageProvider` is the other
implementation (``--object-store``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class StorageProvider(Protocol):
    """The byte/JSON storage surface the workers use."""

    def save_json(self, rel_path: str, data: Any) -> None: ...

    def load_json(self, rel_path: str) -> Optional[Any]: ...

    def append_jsonl(self, rel_path: str, line: str) -> None: ...

    def put_text(self, rel_path: str, text: str) -> None: ...

    def get_text(self, rel_path: str) -> Optional[str]: ...

    def list_dir(self, rel_path: str) -> List[str]: ...

    def flush(self) -> None:
        """Push any client-side write buffering to durable storage; a
        no-op for providers that write through (the object store buffers
        appends and relies on it at shutdown)."""
        ...


class LocalStorageProvider:
    """Filesystem provider rooted at ``base_path``."""

    def __init__(self, base_path: str):
        self.base_path = base_path
        os.makedirs(base_path, exist_ok=True)
        self._lock = threading.Lock()

    def flush(self) -> None:  # writes go straight to disk
        pass

    def _abs(self, rel_path: str) -> str:
        return os.path.join(self.base_path, rel_path)

    def _replace(self, rel_path: str, write) -> None:
        """Write to a temporary file, then rename: atomic on POSIX, so a
        rewrite of the same path is idempotent and a reader never sees
        half a file."""
        path = self._abs(rel_path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            write(f)
        os.replace(tmp, path)

    def save_json(self, rel_path: str, data: Any) -> None:
        self._replace(rel_path,
                      lambda f: json.dump(data, f, ensure_ascii=False))

    def load_json(self, rel_path: str) -> Optional[Any]:
        text = self.get_text(rel_path)
        return None if text is None else json.loads(text)

    def append_jsonl(self, rel_path: str, line: str) -> None:
        """Append one line (its trailing newlines replaced by one).  The
        lock serializes the file write itself: interleaved writers would
        corrupt the stream."""
        path = self._abs(rel_path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock:
            with open(path, "a", encoding="utf-8") as f:
                f.write(line.rstrip("\n") + "\n")

    def put_text(self, rel_path: str, text: str) -> None:
        """Atomic whole-file write: the basis of the workers' idempotent
        result writeback."""
        self._replace(rel_path, lambda f: f.write(text))

    def get_text(self, rel_path: str) -> Optional[str]:
        path = self._abs(rel_path)
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return f.read()

    def list_dir(self, rel_path: str) -> List[str]:
        path = self._abs(rel_path)
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))


class InMemoryStorageProvider:
    """A provider that keeps every write in memory and records each call:
    the reference's, and the load gate's writeback sink (its
    reconciliation reads the batch files back through ``list_dir`` /
    ``get_text``)."""

    def __init__(self):
        self.json_store: Dict[str, Any] = {}
        self.jsonl_store: Dict[str, List[str]] = {}
        self.flushes = 0
        self.text_store: Dict[str, str] = {}
        self.files: Dict[str, bytes] = {}
        self.calls: List[tuple] = []

    def flush(self) -> None:
        self.calls.append(("flush", ""))
        self.flushes += 1

    def save_json(self, rel_path: str, data: Any) -> None:
        self.calls.append(("save_json", rel_path))
        self.json_store[rel_path] = json.loads(json.dumps(data))

    def load_json(self, rel_path: str) -> Optional[Any]:
        self.calls.append(("load_json", rel_path))
        return self.json_store.get(rel_path)

    def append_jsonl(self, rel_path: str, line: str) -> None:
        self.calls.append(("append_jsonl", rel_path))
        if rel_path in self.text_store:
            # Appending to a put_text file: byte-append exactly as the
            # filesystem provider would (no line re-normalization of the
            # prior content).
            self.text_store[rel_path] += line.rstrip("\n") + "\n"
            return
        self.jsonl_store.setdefault(rel_path, []).append(line.rstrip("\n"))

    def put_text(self, rel_path: str, text: str) -> None:
        # Byte-exact round trip, matching LocalStorageProvider's atomic
        # whole-file write (no line normalization).
        self.calls.append(("put_text", rel_path))
        self.text_store[rel_path] = text
        self.jsonl_store.pop(rel_path, None)  # put_text overwrites appends

    def get_text(self, rel_path: str) -> Optional[str]:
        if rel_path in self.text_store:
            return self.text_store[rel_path]
        lines = self.jsonl_store.get(rel_path)
        if lines is None:
            return None
        return "\n".join(lines) + "\n"

    def store_file(self, rel_path: str, source_path: str,
                   delete_source: bool = True) -> str:
        self.calls.append(("store_file", rel_path, source_path))
        with open(source_path, "rb") as f:
            self.files[rel_path] = f.read()
        if delete_source:
            try:
                os.remove(source_path)
            except OSError:
                pass
        return rel_path

    def exists(self, rel_path: str) -> bool:
        return (rel_path in self.json_store or rel_path in self.jsonl_store
                or rel_path in self.text_store or rel_path in self.files)

    def list_dir(self, rel_path: str) -> List[str]:
        prefix = rel_path.rstrip("/") + "/"
        names = set()
        for key in (list(self.json_store) + list(self.jsonl_store)
                    + list(self.text_store) + list(self.files)):
            if key.startswith(prefix):
                names.add(key[len(prefix):].split("/", 1)[0])
        return sorted(names)

    def delete(self, rel_path: str) -> None:
        self.json_store.pop(rel_path, None)
        self.jsonl_store.pop(rel_path, None)
        self.text_store.pop(rel_path, None)
        self.files.pop(rel_path, None)

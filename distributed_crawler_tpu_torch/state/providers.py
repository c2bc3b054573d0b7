"""Storage providers: the results sink of the port's workers.

The port's copy of `LocalStorageProvider` and its protocol from the
reference's `distributed_crawler_tpu/state/providers.py`.  The three
workers write one idempotent JSONL file per batch through ``put_text``,
the cluster worker checkpoints through ``save_json``/``load_json``, and the
readers (`iter_results`, `iter_transcripts`, `iter_assignments`) walk the
tree with ``list_dir``/``get_text``.  Layouts are the reference's, so
either package can read what the other wrote.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class StorageProvider(Protocol):
    """The byte/JSON storage surface the workers use."""

    def save_json(self, rel_path: str, data: Any) -> None: ...

    def load_json(self, rel_path: str) -> Optional[Any]: ...

    def put_text(self, rel_path: str, text: str) -> None: ...

    def get_text(self, rel_path: str) -> Optional[str]: ...

    def list_dir(self, rel_path: str) -> List[str]: ...

    def flush(self) -> None:
        """Push any client-side write buffering to durable storage; a
        no-op for providers that write through."""
        ...


class LocalStorageProvider:
    """Filesystem provider rooted at ``base_path``."""

    def __init__(self, base_path: str):
        self.base_path = base_path
        os.makedirs(base_path, exist_ok=True)

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

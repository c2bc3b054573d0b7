"""State-manager configuration: the fields the port's page state reads.

The reference's `distributed_crawler_tpu/state/interface.py` configs,
cut to what `state/base.py`, `state/local.py` and `state/composite.py`
read.  There is no ``sql``: the port has no SQL graph store (ROADMAP
Queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class LocalConfig:
    """Local-filesystem backend: the root the crawl's files live under."""

    base_path: str = ""


@dataclass
class StateConfig:
    storage_root: str = ""
    crawl_id: str = ""
    crawl_execution_id: str = ""
    platform: str = "telegram"
    sampling_method: str = "channel"
    max_pages: int = 0  # 0 = unlimited
    local: Optional[LocalConfig] = None

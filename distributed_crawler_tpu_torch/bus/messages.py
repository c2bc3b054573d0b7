"""Bus constants the serving slice needs, copied from the reference's
`distributed_crawler_tpu/bus/messages.py`.  The topic strings are a wire
contract and must stay identical."""

from __future__ import annotations

import secrets
import string
from datetime import datetime, timezone
from typing import Any

TOPIC_INFERENCE_BATCHES = "tpu-inference-batches"
TOPIC_INFERENCE_RESULTS = "tpu-inference-results"

# Frames without a tenant label decode to this documented default.
DEFAULT_TENANT = "default"


def normalize_tenant(value: Any) -> str:
    """Fold falsy / non-string tenant values to ``DEFAULT_TENANT``."""
    if not isinstance(value, str) or not value.strip():
        return DEFAULT_TENANT
    return value.strip()


_ALPHANUM = string.ascii_letters + string.digits


def new_trace_id() -> str:
    """``trace_<UTC yyyymmddHHMMSS>_<8 alphanumerics>``."""
    stamp = datetime.now(timezone.utc).strftime("%Y%m%d%H%M%S")
    return "trace_" + stamp + "_" + "".join(
        secrets.choice(_ALPHANUM) for _ in range(8))

"""The Prometheus text-exposition parser.

A copy of the reference's `distributed_crawler_tpu/utils/exposition.py`:
the registry's self-sampler (`utils/timeseries.py`) turns every sample of
the process's own ``/metrics`` into time-series points each heartbeat, and
the port's tests and `chip_smoke.py` read ``/metrics`` with it.  Standard
library only, since it runs on every heartbeat.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List

# name{labels} value — histogram/summary suffixes parse like any sample.
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)\s*$")
# One k="v" pair inside a label block; values may carry escaped quotes.
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return (value.replace('\\"', '"').replace("\\n", "\n")
            .replace("\\\\", "\\"))


@dataclass
class Sample:
    """One parsed exposition sample."""

    name: str
    value: float
    labels: Dict[str, str] = field(default_factory=dict)
    labels_str: str = ""     # the raw "{k=\"v\",...}" block ("" when bare)
    line: str = ""           # the raw line (postmortem renders these)


def parse_exposition(text: str) -> List[Sample]:
    """Every sample in a Prometheus text exposition, in document order.

    Comment/HELP/TYPE lines and unparseable lines are skipped (a torn
    scrape must degrade to fewer samples, never raise)."""
    out: List[Sample] = []
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        m = _SAMPLE_RE.match(stripped)
        if m is None:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        labels_str = m.group(2) or ""
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labels_str)}
        out.append(Sample(name=m.group(1), value=value, labels=labels,
                          labels_str=labels_str, line=stripped))
    return out

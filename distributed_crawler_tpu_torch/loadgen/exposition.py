"""Re-export of the port's Prometheus exposition parser.

The implementation lives in `utils/exposition.py` (stdlib-only, so the
watchtower self-sampler can import it from worker heartbeat threads
without executing this package's __init__, which drags in the whole
gate).  The loadgen surface keeps the reference's name for it: the gate
is the parser's scraping-side consumer.
"""

from ..utils.exposition import (  # noqa: F401
    Sample,
    metric_samples,
    moving_samples,
    parse_exposition,
)

__all__ = ["Sample", "parse_exposition", "metric_samples",
           "moving_samples"]

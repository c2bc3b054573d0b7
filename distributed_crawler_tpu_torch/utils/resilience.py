"""Retry with backoff: the port's copy of the retry half of the reference's
`distributed_crawler_tpu/utils/resilience.py`.

- :class:`RetryPolicy` — declarative jittered exponential backoff with an
  optional retryable-error predicate.  An exception carrying a
  ``retry_after_s`` attribute (a server-directed hint, FLOOD_WAIT or
  HTTP 429) overrides the computed delay, capped by ``retry_after_cap_s``
  so one hostile hint cannot park a dispatch thread for minutes.
- :func:`retry_call` — the attempt loop the buses run their handlers
  through.  A ``stop`` event makes the waits between attempts
  interruptible (the gRPC bus passes its shutdown event); the reference's
  ``sleep`` hook is left out: no caller in the port replaces the wait.

Same defaults, the same cap and the same metric as the reference:
``resilience_retries_total{op}`` counts every retried attempt, in the
port's registry.  The circuit breaker and the composed ``Policy`` are not
ported: nothing in the port calls them yet.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .metrics import REGISTRY, MetricsRegistry

logger = logging.getLogger("dct.torch.resilience")


@dataclass(frozen=True)
class RetryPolicy:
    """Attempt ``n`` (0-based) waits ``base_delay_s * multiplier**n`` capped
    at ``max_delay_s``, widened by up to ``jitter`` (a fraction, so 0.1 =
    ±10%).  ``retryable`` filters which exceptions are worth another
    attempt (None = all).  A ``retry_after_s`` attribute on the exception
    overrides the computed delay, capped at ``retry_after_cap_s``."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    retry_after_cap_s: float = 30.0
    retryable: Optional[Callable[[BaseException], bool]] = None

    def should_retry(self, exc: BaseException) -> bool:
        return self.retryable is None or bool(self.retryable(exc))

    def delay_s(self, attempt: int, exc: Optional[BaseException] = None,
                rng: Callable[[], float] = random.random) -> float:
        """Wait before retrying after 0-based ``attempt`` failed with
        ``exc``.  Deterministic with ``jitter=0``."""
        hint = getattr(exc, "retry_after_s", None)
        if hint is not None:
            try:
                return min(float(hint), self.retry_after_cap_s)
            except (TypeError, ValueError):
                pass
        delay = min(self.base_delay_s * (self.multiplier ** attempt),
                    self.max_delay_s)
        if self.jitter > 0:
            delay *= 1.0 + self.jitter * (2.0 * rng() - 1.0)
        return max(0.0, delay)


def retry_call(fn: Callable[..., Any], *args: Any,
               retry: RetryPolicy,
               op: str = "op",
               stop: Optional[threading.Event] = None,
               registry: MetricsRegistry = REGISTRY,
               **kwargs: Any) -> Any:
    """Run ``fn(*args, **kwargs)`` under ``retry``; returns its result or
    raises the last exception once attempts are exhausted (or the error is
    classified non-retryable).  Waits between attempts with
    ``time.sleep``, or on ``stop``: a set event cuts the wait short, not
    the remaining attempts, so a closing bus still delivers."""
    wait = stop.wait if stop is not None else time.sleep
    retries = registry.counter(
        "resilience_retries_total",
        "Retried attempts per operation (utils/resilience.py)")
    attempts = max(1, retry.max_attempts)
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if attempt + 1 >= attempts or not retry.should_retry(e):
                raise
            retries.labels(op=op).inc()
            delay = retry.delay_s(attempt, e)
            logger.warning("%s failed (attempt %d/%d): %s; retrying in "
                           "%.3fs", op, attempt + 1, attempts, e, delay)
            if delay > 0:
                wait(delay)
    raise RuntimeError("unreachable")

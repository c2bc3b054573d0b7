"""Retry with backoff and circuit breakers: the port's copy of the
reference's `distributed_crawler_tpu/utils/resilience.py`.

- :class:`RetryPolicy` — declarative jittered exponential backoff with an
  optional retryable-error predicate.  An exception carrying a
  ``retry_after_s`` attribute (a server-directed hint, FLOOD_WAIT or
  HTTP 429) overrides the computed delay, capped by ``retry_after_cap_s``
  so one hostile hint cannot park a dispatch thread for minutes.
- :func:`retry_call` — the attempt loop the buses and the publisher
  outbox (`bus/outbox.py`) run through.  A ``stop`` event makes the waits
  between attempts interruptible (the gRPC bus passes its shutdown
  event); a ``breaker`` is consulted before and fed after every attempt.
  The reference's ``sleep`` hook is left out: no caller in the port
  replaces the wait.
- :class:`CircuitBreaker` — closed → open after ``failure_threshold``
  consecutive failures; open → half-open after ``recovery_timeout_s``;
  one half-open probe decides re-close or re-open.  Every
  transition sets ``resilience_circuit_state{target}`` (0 closed, 0.5
  half-open, 1 open), counts ``resilience_circuit_open_total{target}``
  on opening, and is flight-recorded (kind ``circuit``).

Same defaults, the same cap and the same metrics as the reference:
``resilience_retries_total{op}`` counts every retried attempt, in the
port's registry.  The composed ``Policy``/``with_policy`` is not ported:
the outbox and the partitioned bus call `retry_call` with a breaker, as
the reference's do, and nothing in the port needs a per-attempt timeout.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from . import flight
from .metrics import REGISTRY, MetricsRegistry

logger = logging.getLogger("dct.torch.resilience")

CIRCUIT_CLOSED = "closed"
CIRCUIT_OPEN = "open"
CIRCUIT_HALF_OPEN = "half_open"

_STATE_VALUE = {CIRCUIT_CLOSED: 0.0, CIRCUIT_HALF_OPEN: 0.5,
                CIRCUIT_OPEN: 1.0}


class CircuitOpenError(RuntimeError):
    """Raised instead of attempting an op whose breaker is open."""

    def __init__(self, target: str):
        super().__init__(f"circuit for {target!r} is open")
        self.target = target


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
               breaker: Optional["CircuitBreaker"] = None,
               **kwargs: Any) -> Any:
    """Run ``fn(*args, **kwargs)`` under ``retry``; returns its result or
    raises the last exception once attempts are exhausted (or the error is
    classified non-retryable).  Waits between attempts with
    ``time.sleep``, or on ``stop``: a set event cuts the wait short, not
    the remaining attempts, so a closing bus still delivers.

    ``breaker`` (if given) is consulted before and fed after every
    attempt.  A breaker that opens mid-retry re-raises the real
    underlying error; :class:`CircuitOpenError` surfaces only when the op
    was shed without a single attempt."""
    wait = stop.wait if stop is not None else time.sleep
    retries = registry.counter(
        "resilience_retries_total",
        "Retried attempts per operation (utils/resilience.py)")
    attempts = max(1, retry.max_attempts)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        if breaker is not None and not breaker.allow():
            if last is not None:
                raise last
            raise CircuitOpenError(breaker.target)
        try:
            result = fn(*args, **kwargs)
        except Exception as e:
            if breaker is not None:
                breaker.record_failure()
            last = e
            if attempt + 1 >= attempts or not retry.should_retry(e):
                raise
            retries.labels(op=op).inc()
            delay = retry.delay_s(attempt, e)
            logger.warning("%s failed (attempt %d/%d): %s; retrying in "
                           "%.3fs", op, attempt + 1, attempts, e, delay)
            if delay > 0:
                wait(delay)
            continue
        if breaker is not None:
            breaker.record_success()
        return result
    raise last if last is not None else RuntimeError("unreachable")


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probes.

    closed: ops flow; ``failure_threshold`` consecutive failures open it.
    open: ops are rejected (:meth:`allow` returns False) until
    ``recovery_timeout_s`` passes, then it turns half-open.
    half-open: one op is let through as the probe; its success closes the
    circuit, its failure re-opens it (and restarts the recovery clock)."""

    def __init__(self, target: str, failure_threshold: int = 5,
                 recovery_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry: MetricsRegistry = REGISTRY):
        self.target = target
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_timeout_s = recovery_timeout_s
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CIRCUIT_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._gauge = registry.gauge(
            "resilience_circuit_state",
            "Circuit state per target: 0 closed, 0.5 half-open, 1 open"
        ).labels(target=target)
        self._opens = registry.counter(
            "resilience_circuit_open_total",
            "Circuit open transitions per target").labels(target=target)
        self._gauge.set(0.0)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _transition_locked(self, new_state: str) -> None:
        if new_state == self._state:
            return
        old, self._state = self._state, new_state
        self._gauge.set(_STATE_VALUE[new_state])
        if new_state == CIRCUIT_OPEN:
            self._opens.inc()
        flight.record("circuit", target=self.target, frm=old, to=new_state,
                      failures=self._failures)
        log = logger.warning if new_state == CIRCUIT_OPEN else logger.info
        log("circuit %s: %s -> %s", self.target, old, new_state)

    def _maybe_half_open_locked(self) -> None:
        if self._state == CIRCUIT_OPEN and \
                self.clock() - self._opened_at >= self.recovery_timeout_s:
            self._probing = False
            self._transition_locked(CIRCUIT_HALF_OPEN)

    def allow(self) -> bool:
        """May an op proceed right now?  In half-open state the first True
        is the probe; the rest are False until it reports."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CIRCUIT_CLOSED:
                return True
            if self._state == CIRCUIT_HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._transition_locked(CIRCUIT_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == CIRCUIT_HALF_OPEN:
                # The probe failed: back to open, restart the clock.
                self._opened_at = self.clock()
                self._transition_locked(CIRCUIT_OPEN)
            elif self._state == CIRCUIT_CLOSED and \
                    self._failures >= self.failure_threshold:
                self._opened_at = self.clock()
                self._transition_locked(CIRCUIT_OPEN)

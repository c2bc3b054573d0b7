"""In-memory message bus with at-least-once delivery.

The counterpart of the reference's `distributed_crawler_tpu/bus/
inmemory.py`:

- every payload goes through a JSON round trip, as on a real transport —
  which is what catches a numpy scalar leaking into results;
- a payload that fails to decode is dropped (it will never parse);
- a handler that raises is retried up to ``max_redeliveries`` times
  through `utils/resilience.retry_call` (a fixed ``retry_delay_s`` wait,
  or the exception's ``retry_after_s`` hint capped at 2 s; each retry
  counts in ``resilience_retries_total``), then the message goes to the
  dead letters;
- delivery is inline on publish (``sync=True``) or on a dispatch thread.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import resilience, trace

logger = logging.getLogger("dct.torch.bus")

Handler = Callable[[Dict[str, Any]], None]


def serialize_payload(payload: Any) -> bytes:
    """bytes pass through; a message object is sent as its ``to_dict()``;
    the rest is UTF-8 JSON (the reference's rule, for every bus)."""
    if isinstance(payload, bytes):
        return payload
    if hasattr(payload, "to_dict"):
        payload = payload.to_dict()
    return json.dumps(payload, ensure_ascii=False).encode("utf-8")


class InMemoryBus:
    """Topic-based pubsub with retry-on-handler-error."""

    def __init__(self, max_redeliveries: int = 3, retry_delay_s: float = 0.0,
                 sync: bool = True):
        self.max_redeliveries = max_redeliveries
        self.retry_delay_s = retry_delay_s
        self.sync = sync
        # The reference's redelivery schedule: a fixed delay (multiplier
        # 1), ``retry_after_s`` hints honoured up to 2 s.
        self._retry = resilience.RetryPolicy(
            max_attempts=max_redeliveries + 1, base_delay_s=retry_delay_s,
            max_delay_s=max(retry_delay_s, 1.0), multiplier=1.0,
            jitter=0.0, retry_after_cap_s=2.0)
        self._handlers: Dict[str, List[Handler]] = {}
        self._lock = threading.RLock()
        self._queue: "queue.Queue[Tuple[str, bytes]]" = queue.Queue()
        self._dead_letters: List[Tuple[str, Dict[str, Any], str]] = []
        self._published_count: Dict[str, int] = {}
        self._delivered_count: Dict[str, int] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def subscribe(self, topic: str, handler: Handler) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)

    def start(self) -> None:
        """Start async dispatch (no-op in sync mode)."""
        if self.sync or self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="dct-torch-bus", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        # At-least-once: deliver anything still queued before shutting down.
        while True:
            try:
                topic, data = self._queue.get_nowait()
            except queue.Empty:
                break
            self._deliver(topic, data)

    def publish(self, topic: str, payload: Any) -> None:
        """Publish a dict (JSON-serialized) or raw bytes to a topic; a
        traced dict is stamped with the publisher's open span."""
        data = serialize_payload(trace.inject(payload))
        with self._lock:
            self._published_count[topic] = \
                self._published_count.get(topic, 0) + 1
        if self.sync:
            self._deliver(topic, data)
        else:
            self._queue.put((topic, data))

    def _dispatch_loop(self) -> None:
        while self._running:
            try:
                topic, data = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._deliver(topic, data)

    def _deliver(self, topic: str, data: bytes) -> None:
        try:
            payload = json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            logger.error("dropping undecodable message on %s: %s", topic, e)
            return
        with self._lock:
            handlers = list(self._handlers.get(topic, []))
        with trace.payload_span("bus.deliver", payload, topic=topic,
                                transport="inmemory"):
            for handler in handlers:
                try:
                    resilience.retry_call(handler, payload,
                                          retry=self._retry,
                                          op=f"bus.inmemory.{topic}")
                    delivered, last_err = True, ""
                except Exception as e:
                    delivered, last_err = False, str(e)
                with self._lock:
                    if delivered:
                        self._delivered_count[topic] = \
                            self._delivered_count.get(topic, 0) + 1
                    else:
                        self._dead_letters.append((topic, payload, last_err))

    @property
    def dead_letters(self) -> List[Tuple[str, Dict[str, Any], str]]:
        with self._lock:
            return list(self._dead_letters)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                "published": dict(self._published_count),
                "delivered": dict(self._delivered_count),
                "dead_lettered": {"total": len(self._dead_letters)},
            }

    def drain(self, timeout_s: float = 2.0) -> bool:
        """Wait for the async queue to empty."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._queue.empty():
                return True
            time.sleep(0.005)
        return self._queue.empty()

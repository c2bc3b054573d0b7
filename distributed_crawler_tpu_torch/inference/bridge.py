"""Stored posts become RecordBatches on the bus: the text path's front door.

The port's `InferenceBridge` (reference `distributed_crawler_tpu/inference/
bridge.py:32-126`).  It decorates a state manager: every `store_post`
still lands in the wrapped manager's sink first, and the post is then fed
to a `BatchAccumulator` whose full batches are published on
``tpu-inference-batches``.  A deadline thread ships a partial batch older
than ``deadline_s``.  A ``post_uid`` seen within the last `DEDUPE_WINDOW`
posts is stored again but not shipped again, so a redelivered transcript
or a re-crawled post is embedded once.  Everything else goes to the
wrapped manager through ``__getattr__``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict

from ..bus.codec import BatchAccumulator, RecordBatch
from ..bus.messages import TOPIC_INFERENCE_BATCHES
from ..datamodel.post import Post
from ..utils import trace

logger = logging.getLogger("dct.inference.bridge")

# The reference's defaults, which no caller of the port changes.
POLL_INTERVAL_S = 0.02     # how often the deadline thread looks
DEDUPE_WINDOW = 65536      # recently shipped post_uids remembered


class InferenceBridge:
    """State-manager decorator publishing record batches as posts arrive."""

    def __init__(self, sm, bus, crawl_id: str, batch_size: int,
                 deadline_s: float):
        self._sm = sm
        self._bus = bus
        self._acc = BatchAccumulator(batch_size, deadline_s,
                                     crawl_id=crawl_id)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.batches_published = 0
        self.posts_bridged = 0
        self.posts_deduped = 0
        self._seen_uids: "OrderedDict[str, None]" = OrderedDict()
        self._thread = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="dct-bridge-flush")
        self._thread.start()

    # -- the decorated write path -------------------------------------------
    def store_post(self, channel_id: str, post: Post) -> None:
        self._sm.store_post(channel_id, post)
        now = time.monotonic()
        with self._lock:
            uid = post.post_uid
            if uid:
                if uid in self._seen_uids:
                    self._seen_uids.move_to_end(uid)
                    self.posts_deduped += 1
                    return  # already shipped once
                self._seen_uids[uid] = None
                while len(self._seen_uids) > DEDUPE_WINDOW:
                    self._seen_uids.popitem(last=False)
            self.posts_bridged += 1
            batch = self._acc.add(post, now)
        if batch is not None:
            self._publish(batch)

    # -- lifecycle ------------------------------------------------------------
    def flush(self) -> None:
        """Ship whatever is accumulated."""
        with self._lock:
            batch = self._acc.flush()
        if batch is not None:
            self._publish(batch)

    def close(self) -> None:
        """Stop the deadline thread, ship the rest, close the manager."""
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.flush()
        self._sm.close()

    def _poll_loop(self) -> None:
        while not self._stop.wait(POLL_INTERVAL_S):
            with self._lock:
                batch = self._acc.poll(time.monotonic())
            if batch is not None:
                self._publish(batch)

    def _publish(self, batch: RecordBatch) -> None:
        """Publish under the batch trace's root span; a failure is logged,
        not raised (the posts are already in the crawl's sink)."""
        try:
            with trace.span("orchestrator.dispatch",
                            trace_id=batch.trace_id, batch=batch.batch_id,
                            records=len(batch), crawl_id=batch.crawl_id,
                            tenant=batch.tenant):
                self._bus.publish(TOPIC_INFERENCE_BATCHES, batch.to_dict())
        except Exception as e:
            logger.error("failed to publish record batch", extra={
                "batch_id": batch.batch_id, "records": len(batch),
                "error": str(e)})
            return
        with self._lock:
            self.batches_published += 1

    # -- everything else is the wrapped manager -------------------------------
    def __getattr__(self, name):
        return getattr(self._sm, name)

"""The transcript re-entry: transcripts back into the text path as posts.

The port's `TranscriptReentry` (reference `distributed_crawler_tpu/media/
bridge.py:200-243`).  It subscribes to ``tpu-transcripts`` and stores each
successful transcript through a manager, normally an
`inference.bridge.InferenceBridge`, as a synthetic text post whose
``post_uid`` is the deterministic ``media:<media_id>``: the post lands in
the crawl's ``posts.jsonl``, and the bridge ships it once to the text
worker, which embeds and classifies it like any crawled post.  Error and
empty transcripts are counted, not stored.

The reference's `MediaBridge` (the crawl's media writes into
`AudioBatchMessage`s) is not ported: only the reference's crawl modes build
it, and it waits with them (ROADMAP Queue 1 part C).  The port's channel
crawl already calls the hook it implements (``notify_media_stored``, in
`telegram/parsing.fetch_and_upload_media`) on a manager that has one.
"""

from __future__ import annotations

import logging
import os
import threading

from ..bus.messages import TOPIC_TRANSCRIPTS, TranscriptMessage
from ..datamodel.post import Post
from ..utils import trace

logger = logging.getLogger("dct.media.bridge")


class TranscriptReentry:
    """``tpu-transcripts`` -> synthetic text posts through ``sm``."""

    def __init__(self, sm, bus):
        self._sm = sm
        self._lock = threading.Lock()  # the counters, across bus threads
        self.posts_reentered = 0
        self.errors_skipped = 0
        bus.subscribe(TOPIC_TRANSCRIPTS, self.handle_transcript)

    def handle_transcript(self, payload: dict) -> None:
        try:
            msg = TranscriptMessage.from_dict(payload)
            msg.validate()
        except Exception as e:
            logger.warning("undecodable transcript payload dropped: %s", e)
            return
        if msg.error or not (msg.text or msg.tokens):
            with self._lock:
                self.errors_skipped += 1
            return
        text = msg.text or " ".join(str(t) for t in msg.tokens)
        channel = msg.channel_name or \
            (os.path.dirname(msg.path) or "transcripts")
        post = Post(
            post_uid=msg.post_uid or f"media:{msg.media_id}",
            channel_id=channel,
            channel_name=channel,
            platform_name="telegram",
            post_type=["audio_transcript"],
            description=text,
        )
        # The re-entry joins the transcript's trace (itself the audio
        # batch's), linking the media leg to the text leg's record batch.
        with trace.span("media.reentry", trace_id=msg.trace_id,
                        media_id=msg.media_id, post_uid=post.post_uid):
            self._sm.store_post(post.channel_id, post)
        with self._lock:
            self.posts_reentered += 1

"""Telegram message parsing and history fetching: the port's copy of the
reference's `distributed_crawler_tpu/telegram/`.  A message to a `Post`
across the content types, media fetch with dedup and a size cap,
channel-link extraction with its source, and paged history walks with
date windows and sampling.
"""

from .fetch import fetch_channel_messages_with_sampling
from .parsing import (
    SOURCE_MENTION,
    SOURCE_PLAINTEXT,
    SOURCE_TEXT_URL,
    SOURCE_URL,
    DiscoveredLink,
    build_telegram_link,
    extract_channel_links,
    extract_channel_links_with_source,
    fetch_and_upload_media,
    parse_message,
    utf16_slice,
)

__all__ = [
    "parse_message",
    "fetch_and_upload_media",
    "extract_channel_links",
    "extract_channel_links_with_source",
    "DiscoveredLink",
    "build_telegram_link",
    "utf16_slice",
    "SOURCE_MENTION",
    "SOURCE_TEXT_URL",
    "SOURCE_URL",
    "SOURCE_PLAINTEXT",
    "fetch_channel_messages_with_sampling",
]

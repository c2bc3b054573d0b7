"""Message -> Post parsing, link extraction and media: the port's copy of
the reference's `distributed_crawler_tpu/telegram/parsing.py`.

- `parse_message`: a message to the 75-field `Post` across the content
  types; the caller contains a failure per message;
- media: a 150 MB cap, dedup through the state manager's processed-media
  set, the stored file announced through the manager's
  ``notify_media_stored`` hook where it has one, the client's copy
  deleted after upload;
- UTF-16 entity offsets;
- channel-link extraction with its source (mention, text_url, url,
  plaintext);
- public t.me links: message id / 1048576.

Message content is the tagged-dict union of the client boundary
(`clients/telegram.TLMessage.content`).
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from ..config.crawler import CrawlerConfig
from ..clients.telegram import (
    TelegramClient,
    TLChat,
    TLMessage,
    TLSupergroup,
    TLSupergroupFullInfo,
)
from ..datamodel import ChannelData, Comment, EngagementData, MediaData, Post

logger = logging.getLogger("dct.telegram.parse")

MAX_MEDIA_BYTES = 150 * 1048576  # 150 MB cap

# Source types, most to least reliable.
SOURCE_MENTION = "mention"
SOURCE_TEXT_URL = "text_url"
SOURCE_URL = "url"
SOURCE_PLAINTEXT = "plaintext"

_TME_RE = re.compile(r"t\.me/([A-Za-z0-9_]{3,32})")
_AT_RE = re.compile(r"@([A-Za-z][A-Za-z0-9_]{3,31})")

# t.me paths that are features, not channels.
_RESERVED = {"joinchat", "addstickers", "addtheme", "addlist", "share", "proxy",
             "socks", "iv", "c", "s", "bg", "login", "invoice", "setlanguage",
             "confirmphone", "contact", "addemoji", "boost"}


@dataclass
class DiscoveredLink:
    """A channel username and how it was extracted."""

    name: str
    source_type: str


def utf16_slice(s: str, utf16_offset: int, utf16_length: int) -> str:
    """Slice a Python string by TDLib's UTF-16 code-unit offsets."""
    units = 0
    start = end = len(s)
    target_end = utf16_offset + utf16_length
    for i, ch in enumerate(s):
        if units >= utf16_offset and start == len(s):
            start = i
        if units >= target_end:
            end = i
            break
        units += 2 if ord(ch) > 0xFFFF else 1
    else:
        if units >= utf16_offset and start == len(s):
            start = len(s)
        end = len(s)
    return s[start:end]


def build_telegram_link(username: str, message_id: int) -> str:
    """Public post link; TDLib's internal id >> 20."""
    return f"https://t.me/{username}/{message_id // 1048576}"


def _clean_username(raw: str) -> Optional[str]:
    name = raw.strip().strip("/").lower()
    if name.startswith("@"):
        name = name[1:]
    if not name or name in _RESERVED:
        return None
    return name


def _extract_formatted_text(content: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The formatted-text node per content type."""
    ctype = content.get("@type", "")
    if ctype == "messageText":
        return content.get("text")
    if ctype in ("messagePhoto", "messageVideo", "messageDocument",
                 "messageAnimation", "messageAudio", "messageVoiceNote",
                 "messagePaidMedia"):
        return content.get("caption")
    return None


def _links_from_formatted_text(ft: Dict[str, Any],
                               source_map: Dict[str, str]) -> None:
    """Walk the entities most reliable first, then scan the plain text."""
    text = ft.get("text", "") or ""

    def add_if_new(name: Optional[str], source: str) -> None:
        if name and name not in source_map:
            source_map[name] = source

    # Reliability order among entity types: mention > text_url > url.  The
    # pass order (not in-message order) decides attribution, so a username
    # seen both as a bare URL and an @mention is credited to the mention.
    _RELIABILITY = ("textEntityTypeMention", "textEntityTypeTextUrl",
                    "textEntityTypeUrl")
    entities = ft.get("entities") or []
    for wanted in _RELIABILITY:
        for entity in entities:
            etype = (entity.get("type") or {}).get("@type", "")
            if etype != wanted:
                continue
            if etype == "textEntityTypeTextUrl":
                url = (entity.get("type") or {}).get("url", "")
                m = _TME_RE.search(url)
                if m:
                    add_if_new(_clean_username(m.group(1)), SOURCE_TEXT_URL)
            elif etype == "textEntityTypeMention":
                mention = utf16_slice(text, int(entity.get("offset", 0)),
                                      int(entity.get("length", 0)))
                add_if_new(_clean_username(mention), SOURCE_MENTION)
            else:  # textEntityTypeUrl
                url = utf16_slice(text, int(entity.get("offset", 0)),
                                  int(entity.get("length", 0)))
                m = _TME_RE.search(url)
                if m:
                    add_if_new(_clean_username(m.group(1)), SOURCE_URL)

    # Plain-text scan, least reliable.
    for m in _TME_RE.finditer(text):
        add_if_new(_clean_username(m.group(1)), SOURCE_PLAINTEXT)
    for m in _AT_RE.finditer(text):
        add_if_new(_clean_username(m.group(1)), SOURCE_PLAINTEXT)


def extract_channel_links_with_source(message: TLMessage) -> List[DiscoveredLink]:
    """All channel usernames a message references, with their source."""
    source_map: Dict[str, str] = {}
    ft = _extract_formatted_text(message.content)
    if ft:
        _links_from_formatted_text(ft, source_map)
    return [DiscoveredLink(name=n, source_type=s) for n, s in source_map.items()]


def extract_channel_links(message: TLMessage) -> List[str]:
    """The usernames of `extract_channel_links_with_source`."""
    return [l.name for l in extract_channel_links_with_source(message)]


def fetch_and_upload_media(client: TelegramClient, sm, crawl_id: str,
                           channel_name: str, remote_file_id: str,
                           post_link: str, cfg: CrawlerConfig) -> str:
    """Download a media file and hand it to the state manager.

    Returns the stored file name ("" when skipped).  Dedup through the media
    cache; size cap 150 MB; the client-side copy is deleted after upload.
    """
    if cfg.skip_media_download or not remote_file_id:
        return ""
    if sm.has_processed_media(remote_file_id):
        logger.debug("media already processed", extra={"media_id": remote_file_id})
        return ""
    try:
        handle = client.get_remote_file(remote_file_id)
        if handle.size > MAX_MEDIA_BYTES:
            logger.info("media exceeds size cap, skipping",
                        extra={"media_id": remote_file_id, "size": handle.size})
            sm.mark_media_as_processed(remote_file_id)
            return ""
        downloaded = client.download_file(handle.id)
        if not downloaded.local_path:
            return ""
        file_name = os.path.basename(downloaded.local_path)
        stored_path, stored_name = sm.store_file(channel_name,
                                                 downloaded.local_path, file_name)
        # Media -> ASR seam (the reference's `MediaBridge`, which the port
        # has not ported yet): a bridged manager publishes the stored ref
        # to the media topic so the ASR worker transcribes it; plain
        # managers do not implement the hook.
        # Notify BEFORE the cache mark: once marked, a re-crawl never
        # re-fetches this media, so a crash between the two would
        # otherwise lose the transcript forever — duplicate notifies
        # from a mark-less retry are absorbed by the bridge's dedupe
        # window.
        notify = getattr(sm, "notify_media_stored", None)
        if callable(notify):
            notify(media_id=remote_file_id, path=stored_path,
                   channel_name=channel_name)
        sm.mark_media_as_processed(remote_file_id)
        # Free the client's copy on disk.
        try:
            client.delete_file(downloaded.id)
        except Exception:
            pass
        return stored_name
    except Exception as e:
        logger.warning("media fetch failed", extra={
            "media_id": remote_file_id, "post_link": post_link, "error": str(e)})
        return ""


_CONTENT_TEXT_KEYS = {
    "messageText": ("text", "text"),
    "messagePhoto": ("caption", "text"),
    "messageVideo": ("caption", "text"),
    "messageDocument": ("caption", "text"),
    "messageAnimation": ("caption", "text"),
    "messageAudio": ("caption", "text"),
    "messageVoiceNote": ("caption", "text"),
    "messagePaidMedia": ("caption", "text"),
}


def _content_text(content: Dict[str, Any]) -> str:
    ctype = content.get("@type", "")
    keys = _CONTENT_TEXT_KEYS.get(ctype)
    if keys:
        node = content.get(keys[0]) or {}
        return node.get(keys[1], "") or ""
    if ctype == "messagePoll":
        poll = content.get("poll") or {}
        q = (poll.get("question") or {})
        question = q.get("text", "") if isinstance(q, dict) else str(q)
        options = []
        for opt in poll.get("options") or []:
            t = opt.get("text")
            options.append(t.get("text", "") if isinstance(t, dict) else str(t))
        return "\n".join([question] + options)
    if ctype == "messageAnimatedEmoji":
        return content.get("emoji", "") or ""
    if ctype == "messageSticker":
        return (content.get("sticker") or {}).get("emoji", "") or ""
    if ctype in ("messageGiveaway", "messageGiveawayWinners",
                 "messageGiveawayCompleted"):
        return content.get("description", "") or ""
    return ""


def _media_remote_id(content: Dict[str, Any]) -> str:
    """Remote file ID of the primary media object, if any."""
    ctype = content.get("@type", "")
    for key in ("video", "photo", "animation", "document", "audio",
                "voice_note", "video_note", "sticker"):
        node = content.get(key)
        if isinstance(node, dict):
            rid = node.get("remote_id", "")
            if rid:
                return rid
    if ctype == "messagePhoto":
        sizes = (content.get("photo") or {}).get("sizes") or []
        if sizes:
            return sizes[-1].get("remote_id", "")
    return ""


def _post_type(content: Dict[str, Any]) -> List[str]:
    ctype = content.get("@type", "messageText")
    mapping = {
        "messageText": "text", "messagePhoto": "image", "messageVideo": "video",
        "messageAnimation": "video", "messageVideoNote": "video",
        "messageAudio": "audio", "messageVoiceNote": "audio",
        "messageDocument": "document", "messageSticker": "sticker",
        "messagePoll": "poll", "messageAnimatedEmoji": "text",
        "messageGiveaway": "giveaway", "messageGiveawayWinners": "giveaway",
        "messageGiveawayCompleted": "giveaway", "messagePaidMedia": "paid_media",
    }
    return [mapping.get(ctype, "other")]


def parse_message(crawl_id: str, message: TLMessage, chat: TLChat,
                  supergroup: Optional[TLSupergroup],
                  supergroup_info: Optional[TLSupergroupFullInfo],
                  message_count: int, total_views: int, channel_username: str,
                  client: TelegramClient, sm, cfg: CrawlerConfig) -> Post:
    """Convert one message into the canonical Post.

    Raises on malformed content; the caller contains it, so one bad
    message never kills a channel.
    """
    content = message.content or {}
    text = _content_text(content)
    post_link = build_telegram_link(channel_username, message.id)
    published = datetime.fromtimestamp(message.date, tz=timezone.utc) \
        if message.date else None

    # Media (respecting cap/dedup/skip config).
    document_name = ""
    remote_id = _media_remote_id(content)
    if remote_id:
        document_name = fetch_and_upload_media(
            client, sm, crawl_id, channel_username, remote_id, post_link, cfg)

    # Comments: only when the post has replies.
    comments: List[Comment] = []
    if message.reply_count > 0 and cfg.max_comments != 0:
        try:
            thread = client.get_message_thread_history(
                message.chat_id, message.id,
                limit=cfg.max_comments if cfg.max_comments > 0 else 100)
            for cm in thread.messages:
                comments.append(Comment(
                    text=_content_text(cm.content or {}),
                    reactions=dict(cm.reactions or {}),
                    view_count=cm.view_count,
                    reply_count=cm.reply_count,
                    handle=cm.sender_username,
                ))
        except Exception as e:
            logger.debug("comment fetch failed", extra={
                "post_link": post_link, "error": str(e)})

    outlinks = extract_channel_links(message)
    description = (supergroup_info.description if supergroup_info else "") or ""
    member_count = supergroup_info.member_count if supergroup_info else (
        supergroup.member_count if supergroup else 0)

    engagement = message.view_count + message.forward_count + message.reply_count
    post = Post(
        post_link=post_link,
        channel_id=str(chat.id),
        post_uid=f"{chat.id}_{message.id}",
        url=post_link,
        published_at=published,
        created_at=published,
        engagement=engagement,
        view_count=message.view_count,
        share_count=message.forward_count,
        comment_count=message.reply_count,
        crawl_label=cfg.crawl_label,
        channel_name=chat.title,
        channel_data=ChannelData(
            channel_id=str(chat.id),
            channel_name=chat.title,
            channel_description=description,
            channel_engagement_data=EngagementData(
                follower_count=member_count,
                post_count=message_count,
                views_count=total_views,
            ),
            channel_url_external=f"https://t.me/{channel_username}",
            channel_url=f"https://t.me/{channel_username}",
        ),
        platform_name="telegram",
        description=text,
        post_type=_post_type(content),
        media_data=MediaData(document_name=document_name),
        shares_count=message.forward_count,
        comments_count=message.reply_count,
        views_count=message.view_count,
        comments=comments,
        reactions=dict(message.reactions or {}),
        outlinks=outlinks,
        capture_time=datetime.now(timezone.utc),
        handle=channel_username,
    )
    return post

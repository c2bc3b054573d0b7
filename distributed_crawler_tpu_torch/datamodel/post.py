"""The post record: the unit the crawl writes and the text path embeds.

The port's copy of the reference's `distributed_crawler_tpu/datamodel/
post.py` (`Post`, the nested records it serializes, and the
`NullLogEvent` the null-field validation emits).  Field names,
order and the JSON bytes of `Post.to_json` are the reference's (a post
written by either package is byte-equal), so a crawl's ``posts.jsonl``
and the records of a `RecordBatch` read the same in both packages.
Datetimes are timezone-aware UTC; unset is ``None`` and serializes as
Go's zero time.  The time helpers live here, and `bus/codec.py` imports
them.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

# Go's time.Time zero value, used on the wire for "unset".
ZERO_TIME_STR = "0001-01-01T00:00:00Z"


def format_time(dt: Optional[datetime]) -> str:
    """RFC3339/UTC; None -> Go zero time."""
    if dt is None:
        return ZERO_TIME_STR
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


def parse_time(value: Any) -> Optional[datetime]:
    """Parse an RFC3339 string (or pass a datetime through); zero -> None."""
    if value is None or isinstance(value, datetime):
        return value
    s = str(value)
    if not s or s == ZERO_TIME_STR:
        return None
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        dt = datetime.fromisoformat(s)
    except ValueError:
        # More than 6 fractional digits: truncate to microseconds.
        m = re.match(r"^(.*?\.)(\d+)([+-]\d{2}:\d{2})$", s)
        if not m:
            return None
        dt = datetime.fromisoformat(m.group(1) + m.group(2)[:6] + m.group(3))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


def text_for_inference(record: Dict[str, Any]) -> str:
    """The text a post (its fields, or its dict) contributes to
    embed+classify, best-field-first."""
    for key in ("all_text", "searchable_text", "description"):
        t = record.get(key) or ""
        if t:
            return t
    return record.get("transcript_text") or record.get("image_text") or ""


@dataclass
class EngagementData:
    """Channel audience engagement metrics."""

    follower_count: int = 0
    following_count: int = 0
    like_count: int = 0
    post_count: int = 0
    views_count: int = 0
    comment_count: int = 0
    share_count: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "follower_count": self.follower_count,
            "following_count": self.following_count,
            "like_count": self.like_count,
            "post_count": self.post_count,
            "views_count": self.views_count,
            "comment_count": self.comment_count,
            "share_count": self.share_count,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngagementData":
        return cls(
            follower_count=int(d.get("follower_count") or 0),
            following_count=int(d.get("following_count") or 0),
            like_count=int(d.get("like_count") or 0),
            post_count=int(d.get("post_count") or 0),
            views_count=int(d.get("views_count") or 0),
            comment_count=int(d.get("comment_count") or 0),
            share_count=int(d.get("share_count") or 0),
        )


@dataclass
class ChannelData:
    """Channel identity + engagement."""

    channel_id: str = ""
    channel_name: str = ""
    channel_description: str = ""
    channel_profile_image: str = ""
    channel_engagement_data: EngagementData = field(default_factory=EngagementData)
    channel_url_external: str = ""
    channel_url: str = ""
    country_code: str = ""
    published_at: Optional[datetime] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "channel_id": self.channel_id,
            "channel_name": self.channel_name,
            "channel_description": self.channel_description,
            "channel_profile_image": self.channel_profile_image,
            "channel_engagement_data": self.channel_engagement_data.to_dict(),
            "channel_url_external": self.channel_url_external,
            "channel_url": self.channel_url,
            "country_code": self.country_code,
            "published_at": format_time(self.published_at),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChannelData":
        return cls(
            channel_id=d.get("channel_id", "") or "",
            channel_name=d.get("channel_name", "") or "",
            channel_description=d.get("channel_description", "") or "",
            channel_profile_image=d.get("channel_profile_image", "") or "",
            channel_engagement_data=EngagementData.from_dict(
                d.get("channel_engagement_data") or {}
            ),
            channel_url_external=d.get("channel_url_external", "") or "",
            channel_url=d.get("channel_url", "") or "",
            country_code=d.get("country_code", "") or "",
            published_at=parse_time(d.get("published_at")),
        )


@dataclass
class Comment:
    """A single comment on a post."""

    text: str = ""
    reactions: Dict[str, int] = field(default_factory=dict)
    view_count: int = 0
    reply_count: int = 0
    handle: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "text": self.text,
            "reactions": self.reactions,
            "view_count": self.view_count,
            "reply_count": self.reply_count,
            "handle": self.handle,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Comment":
        return cls(
            text=d.get("text", "") or "",
            reactions=dict(d.get("reactions") or {}),
            view_count=int(d.get("view_count") or 0),
            reply_count=int(d.get("reply_count") or 0),
            handle=d.get("handle", "") or "",
        )


@dataclass
class OCRData:
    """Text extracted from images."""

    ocr_text: str = ""
    thumb_url: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"ocr_text": self.ocr_text, "thumb_url": self.thumb_url}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OCRData":
        return cls(ocr_text=d.get("ocr_text", "") or "", thumb_url=d.get("thumb_url", "") or "")


@dataclass
class PerformanceScores:
    """Post performance metrics."""

    likes: Optional[int] = None
    shares: Optional[int] = None
    comments: Optional[int] = None
    views: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "likes": self.likes,
            "shares": self.shares,
            "comments": self.comments,
            "views": self.views,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PerformanceScores":
        return cls(
            likes=d.get("likes"),
            shares=d.get("shares"),
            comments=d.get("comments"),
            views=float(d.get("views") or 0.0),
        )


@dataclass
class InnerLink:
    """Internal-link placeholder."""

    def to_dict(self) -> Dict[str, Any]:
        return {}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InnerLink":
        return cls()


@dataclass
class MediaData:
    """Media file info attached to a post."""

    document_name: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"document_name": self.document_name}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MediaData":
        return cls(document_name=d.get("document_name", "") or "")


@dataclass
class NullLogEvent:
    """A structured record of a null or empty field."""

    platform: str = ""
    data_type: str = ""
    field_name: str = ""
    strategy_used: str = ""
    is_platform_limit: bool = False
    message: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "platform": self.platform,
            "data_type": self.data_type,
            "field_name": self.field_name,
            "strategy_used": self.strategy_used,
            "is_platform_limit": self.is_platform_limit,
            "message": self.message,
        }


@dataclass
class Post:
    """The 75-field post record.  Crawlers produce it; the text worker
    embeds and classifies `text_for_inference` of each."""

    post_link: str = ""
    channel_id: str = ""
    post_uid: str = ""
    url: str = ""
    published_at: Optional[datetime] = None
    created_at: Optional[datetime] = None
    language_code: str = ""
    engagement: int = 0
    view_count: int = 0
    like_count: int = 0
    share_count: int = 0
    comment_count: int = 0
    crawl_label: str = ""
    list_ids: List[Any] = field(default_factory=list)
    channel_name: str = ""
    search_terms: List[Any] = field(default_factory=list)
    search_term_ids: List[Any] = field(default_factory=list)
    project_ids: List[Any] = field(default_factory=list)
    exercise_ids: List[Any] = field(default_factory=list)
    label_data: List[Any] = field(default_factory=list)
    labels_metadata: List[Any] = field(default_factory=list)
    project_labeled_post_ids: List[Any] = field(default_factory=list)
    labeler_ids: List[Any] = field(default_factory=list)
    all_labels: List[Any] = field(default_factory=list)
    label_ids: List[Any] = field(default_factory=list)
    is_ad: bool = False
    transcript_text: str = ""
    image_text: str = ""
    video_length: Optional[int] = None
    is_verified: Optional[bool] = None
    channel_data: ChannelData = field(default_factory=ChannelData)
    platform_name: str = ""
    shared_id: Optional[str] = None
    quoted_id: Optional[str] = None
    replied_id: Optional[str] = None
    ai_label: Optional[str] = None
    root_post_id: Optional[str] = None
    engagement_steps_count: int = 0
    ocr_data: List[OCRData] = field(default_factory=list)
    performance_scores: PerformanceScores = field(default_factory=PerformanceScores)
    has_embed_media: Optional[bool] = None
    description: str = ""
    repost_channel_data: Optional[str] = None
    post_type: List[str] = field(default_factory=list)
    inner_link: InnerLink = field(default_factory=InnerLink)
    post_title: Optional[str] = None
    media_data: MediaData = field(default_factory=MediaData)
    is_reply: Optional[bool] = None
    ad_fields: Optional[str] = None
    likes_count: int = 0
    shares_count: int = 0
    comments_count: int = 0
    views_count: int = 0
    searchable_text: str = ""
    all_text: str = ""
    contrast_agent_project_ids: List[Any] = field(default_factory=list)
    agent_ids: List[Any] = field(default_factory=list)
    segment_ids: List[Any] = field(default_factory=list)
    thumb_url: str = ""
    media_url: str = ""
    comments: List[Comment] = field(default_factory=list)
    reactions: Dict[str, int] = field(default_factory=dict)
    outlinks: List[str] = field(default_factory=list)
    capture_time: Optional[datetime] = None
    handle: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "post_link": self.post_link,
            "channel_id": self.channel_id,
            "post_uid": self.post_uid,
            "url": self.url,
            "published_at": format_time(self.published_at),
            "created_at": format_time(self.created_at),
            "language_code": self.language_code,
            "engagement": self.engagement,
            "view_count": self.view_count,
            "like_count": self.like_count,
            "share_count": self.share_count,
            "comment_count": self.comment_count,
            "crawl_label": self.crawl_label,
            "list_ids": self.list_ids,
            "channel_name": self.channel_name,
            "search_terms": self.search_terms,
            "search_term_ids": self.search_term_ids,
            "project_ids": self.project_ids,
            "exercise_ids": self.exercise_ids,
            "label_data": self.label_data,
            "labels_metadata": self.labels_metadata,
            "project_labeled_post_ids": self.project_labeled_post_ids,
            "labeler_ids": self.labeler_ids,
            "all_labels": self.all_labels,
            "label_ids": self.label_ids,
            "is_ad": self.is_ad,
            "transcript_text": self.transcript_text,
            "image_text": self.image_text,
            "video_length": self.video_length,
            "is_verified": self.is_verified,
            "channel_data": self.channel_data.to_dict(),
            "platform_name": self.platform_name,
            "shared_id": self.shared_id,
            "quoted_id": self.quoted_id,
            "replied_id": self.replied_id,
            "ai_label": self.ai_label,
            "root_post_id": self.root_post_id,
            "engagement_steps_count": self.engagement_steps_count,
            "ocr_data": [o.to_dict() for o in self.ocr_data],
            "performance_scores": self.performance_scores.to_dict(),
            "has_embed_media": self.has_embed_media,
            "description": self.description,
            "repost_channel_data": self.repost_channel_data,
            "post_type": self.post_type,
            "inner_link": self.inner_link.to_dict(),
            "post_title": self.post_title,
            "media_data": self.media_data.to_dict(),
            "is_reply": self.is_reply,
            "ad_fields": self.ad_fields,
            "likes_count": self.likes_count,
            "shares_count": self.shares_count,
            "comments_count": self.comments_count,
            "views_count": self.views_count,
            "searchable_text": self.searchable_text,
            "all_text": self.all_text,
            "contrast_agent_project_ids": self.contrast_agent_project_ids,
            "agent_ids": self.agent_ids,
            "segment_ids": self.segment_ids,
            "thumb_url": self.thumb_url,
            "media_url": self.media_url,
            "comments": [c.to_dict() for c in self.comments],
            "reactions": self.reactions,
            "outlinks": self.outlinks,
            "capture_time": format_time(self.capture_time),
            "handle": self.handle,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Post":
        return cls(
            post_link=d.get("post_link", "") or "",
            channel_id=d.get("channel_id", "") or "",
            post_uid=d.get("post_uid", "") or "",
            url=d.get("url", "") or "",
            published_at=parse_time(d.get("published_at")),
            created_at=parse_time(d.get("created_at")),
            language_code=d.get("language_code", "") or "",
            engagement=int(d.get("engagement") or 0),
            view_count=int(d.get("view_count") or 0),
            like_count=int(d.get("like_count") or 0),
            share_count=int(d.get("share_count") or 0),
            comment_count=int(d.get("comment_count") or 0),
            crawl_label=d.get("crawl_label", "") or "",
            list_ids=list(d.get("list_ids") or []),
            channel_name=d.get("channel_name", "") or "",
            search_terms=list(d.get("search_terms") or []),
            search_term_ids=list(d.get("search_term_ids") or []),
            project_ids=list(d.get("project_ids") or []),
            exercise_ids=list(d.get("exercise_ids") or []),
            label_data=list(d.get("label_data") or []),
            labels_metadata=list(d.get("labels_metadata") or []),
            project_labeled_post_ids=list(d.get("project_labeled_post_ids") or []),
            labeler_ids=list(d.get("labeler_ids") or []),
            all_labels=list(d.get("all_labels") or []),
            label_ids=list(d.get("label_ids") or []),
            is_ad=bool(d.get("is_ad") or False),
            transcript_text=d.get("transcript_text", "") or "",
            image_text=d.get("image_text", "") or "",
            video_length=d.get("video_length"),
            is_verified=d.get("is_verified"),
            channel_data=ChannelData.from_dict(d.get("channel_data") or {}),
            platform_name=d.get("platform_name", "") or "",
            shared_id=d.get("shared_id"),
            quoted_id=d.get("quoted_id"),
            replied_id=d.get("replied_id"),
            ai_label=d.get("ai_label"),
            root_post_id=d.get("root_post_id"),
            engagement_steps_count=int(d.get("engagement_steps_count") or 0),
            ocr_data=[OCRData.from_dict(o) for o in (d.get("ocr_data") or [])],
            performance_scores=PerformanceScores.from_dict(d.get("performance_scores") or {}),
            has_embed_media=d.get("has_embed_media"),
            description=d.get("description", "") or "",
            repost_channel_data=d.get("repost_channel_data"),
            post_type=list(d.get("post_type") or []),
            inner_link=InnerLink.from_dict(d.get("inner_link") or {}),
            post_title=d.get("post_title"),
            media_data=MediaData.from_dict(d.get("media_data") or {}),
            is_reply=d.get("is_reply"),
            ad_fields=d.get("ad_fields"),
            likes_count=int(d.get("likes_count") or 0),
            shares_count=int(d.get("shares_count") or 0),
            comments_count=int(d.get("comments_count") or 0),
            views_count=int(d.get("views_count") or 0),
            searchable_text=d.get("searchable_text", "") or "",
            all_text=d.get("all_text", "") or "",
            contrast_agent_project_ids=list(d.get("contrast_agent_project_ids") or []),
            agent_ids=list(d.get("agent_ids") or []),
            segment_ids=list(d.get("segment_ids") or []),
            thumb_url=d.get("thumb_url", "") or "",
            media_url=d.get("media_url", "") or "",
            comments=[Comment.from_dict(c) for c in (d.get("comments") or [])],
            reactions=dict(d.get("reactions") or {}),
            outlinks=list(d.get("outlinks") or []),
            capture_time=parse_time(d.get("capture_time")),
            handle=d.get("handle", "") or "",
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), ensure_ascii=False, separators=(",", ":"))

    def text_for_inference(self) -> str:
        """The text embed+classify consumes, best-field-first."""
        return text_for_inference(vars(self))

"""Null and empty-field validation of crawl data, per platform: the
port's copy of the reference's `distributed_crawler_tpu/datamodel/
validation.py`.

Four behaviours (critical, log, unavailable, optional), a default rule
table per platform keyed by the JSON field paths (``channel_data.
channel_id``), a user JSON config merged over the defaults, and a walk
over the dataclasses that emits `NullLogEvent`s.  The channel crawl runs
every post and every channel's data through `NullValidator`.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
from dataclasses import dataclass, field as dc_field
from datetime import datetime
from typing import Any, Dict, List, Optional

from .post import ChannelData, NullLogEvent, Post

logger = logging.getLogger("dct.null_validation")


class Behavior(str, enum.Enum):
    """How to handle a null or empty field."""

    CRITICAL = "critical"  # invalidates the record
    LOG = "log"  # warn
    UNAVAILABLE = "unavailable"  # field not available on this platform
    OPTIONAL = "optional"  # event only, no console output


@dataclass
class FieldRule:
    behavior: Behavior
    message: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FieldRule":
        return cls(behavior=Behavior(d["behavior"]), message=d.get("message", ""))


@dataclass
class ValidationConfig:
    platform: str
    rules: Dict[str, FieldRule]


@dataclass
class ValidationResult:
    """A validation outcome."""

    valid: bool = True
    errors: List[str] = dc_field(default_factory=list)
    warnings: List[str] = dc_field(default_factory=list)
    unavailable_used: List[str] = dc_field(default_factory=list)
    null_log_events: List[NullLogEvent] = dc_field(default_factory=list)


def _rules(crit=(), log=(), unavail=(), opt=()) -> Dict[str, FieldRule]:
    out: Dict[str, FieldRule] = {}
    for paths, behavior in ((crit, Behavior.CRITICAL), (log, Behavior.LOG),
                            (unavail, Behavior.UNAVAILABLE), (opt, Behavior.OPTIONAL)):
        for p in paths:
            leaf = p.rsplit(".", 1)[-1]
            if behavior is Behavior.CRITICAL:
                msg = f"{leaf} is required"
            elif behavior is Behavior.UNAVAILABLE:
                msg = f"{leaf} not available"
            else:
                msg = f"{leaf} is empty"
            out[p] = FieldRule(behavior, msg)
    return out


# Shared across both platforms (label-pipeline fields the crawler never fills).
_ALWAYS_UNAVAILABLE = (
    "list_ids", "search_terms", "search_term_ids", "project_ids", "exercise_ids",
    "label_data", "labels_metadata", "project_labeled_post_ids", "labeler_ids",
    "all_labels", "label_ids", "shared_id", "quoted_id", "replied_id", "ai_label",
    "root_post_id", "engagement_steps_count", "performance_scores.shares",
    "repost_channel_data", "inner_link", "is_reply", "ad_fields",
    "contrast_agent_project_ids", "agent_ids", "segment_ids",
)

_CRITICAL_CORE = (
    "channel_data.channel_id", "channel_data.channel_name", "channel_data.channel_url",
    "post_link", "channel_id", "post_uid", "url", "published_at", "platform_name",
)


def default_configs() -> Dict[str, ValidationConfig]:
    """The default rule table of each platform."""
    youtube = _rules(
        crit=_CRITICAL_CORE,
        log=(
            "channel_data.channel_description", "channel_data.channel_profile_image",
            "channel_data.channel_engagement_data.follower_count",
            "channel_data.channel_engagement_data.post_count",
            "channel_data.channel_engagement_data.views_count",
            "channel_data.channel_url_external", "channel_data.published_at",
            "created_at", "language_code", "engagement", "view_count", "like_count",
            "comment_count", "crawl_label", "channel_name", "video_length",
            "ocr_data", "performance_scores.likes", "performance_scores.comments",
            "performance_scores.views", "has_embed_media", "description", "post_type",
            "post_title", "media_data.document_name", "likes_count", "comments_count",
            "views_count", "searchable_text", "all_text", "thumb_url", "media_url",
            "reactions", "outlinks", "capture_time", "handle",
        ),
        unavail=_ALWAYS_UNAVAILABLE + (
            "channel_data.channel_engagement_data.following_count",
            "channel_data.channel_engagement_data.like_count",
            "channel_data.channel_engagement_data.comment_count",
            "channel_data.channel_engagement_data.share_count",
            "share_count", "is_ad", "transcript_text", "image_text", "is_verified",
            "shares_count", "comments",
        ),
        opt=("channel_data.country_code",),
    )
    telegram = _rules(
        crit=_CRITICAL_CORE,
        log=(
            "channel_data.channel_description", "channel_data.channel_profile_image",
            "channel_data.channel_engagement_data.follower_count",
            "channel_data.channel_engagement_data.post_count",
            "channel_data.channel_engagement_data.views_count",
            "channel_data.channel_url_external",
            "created_at", "engagement", "view_count", "share_count", "comment_count",
            "crawl_label", "channel_name", "is_ad", "description", "post_type",
            "shares_count", "comments_count", "views_count", "thumb_url", "media_url",
            "comments", "reactions", "outlinks", "capture_time", "handle",
        ),
        unavail=_ALWAYS_UNAVAILABLE + (
            "channel_data.channel_engagement_data.following_count",
            "channel_data.channel_engagement_data.like_count",
            "channel_data.channel_engagement_data.comment_count",
            "channel_data.channel_engagement_data.share_count",
            "channel_data.country_code", "channel_data.published_at",
            "language_code", "like_count", "transcript_text", "image_text",
            "video_length", "is_verified", "ocr_data", "performance_scores.likes",
            "performance_scores.comments", "performance_scores.views",
            "has_embed_media", "post_title", "media_data.document_name",
            "likes_count", "searchable_text", "all_text",
        ),
    )
    return {
        "youtube": ValidationConfig(platform="youtube", rules=youtube),
        "telegram": ValidationConfig(platform="telegram", rules=telegram),
    }


def merge_configs(platform: str, user_rules: Optional[Dict[str, FieldRule]]) -> ValidationConfig:
    """User rules override the defaults."""
    defaults = default_configs()
    if platform not in defaults:
        raise ValueError(f"no default config for platform: {platform}")
    merged = dict(defaults[platform].rules)
    if user_rules:
        merged.update(user_rules)
    return ValidationConfig(platform=platform, rules=merged)


def load_config_from_json(json_data: str, platform: str) -> ValidationConfig:
    """Load a partial user config from JSON and merge it."""
    raw = json.loads(json_data)
    user_rules = {
        path: FieldRule.from_dict(rule) for path, rule in (raw.get("rules") or {}).items()
    }
    return merge_configs(platform, user_rules)


def _is_empty(value: Any) -> bool:
    """The zero-value test of the reference."""
    if value is None:
        return True
    if isinstance(value, str):
        return value == ""
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value == 0
    if isinstance(value, (list, dict, tuple, set)):
        return len(value) == 0
    return False


class NullValidator:
    """Walks a Post/ChannelData and applies the rule table to empty fields."""

    def __init__(self, platform: str, user_rules: Optional[Dict[str, FieldRule]] = None,
                 config: Optional[ValidationConfig] = None):
        self.config = config or merge_configs(platform, user_rules)

    @classmethod
    def from_json(cls, json_data: str, platform: str) -> "NullValidator":
        return cls(platform, config=load_config_from_json(json_data, platform))

    def validate_post(self, post: Post) -> ValidationResult:
        result = ValidationResult()
        self._walk("", "post", post, result)
        self._log_result(result, "post", post.post_link)
        return result

    def validate_channel_data(self, data: ChannelData) -> ValidationResult:
        result = ValidationResult()
        self._walk("channel_data", "channel", data, result)
        self._log_result(result, "channel", data.channel_id)
        return result

    def _walk(self, prefix: str, data_type: str, obj: Any, result: ValidationResult) -> None:
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            path = f"{prefix}.{f.name}" if prefix else f.name
            if dataclasses.is_dataclass(value) and not isinstance(value, datetime):
                # InnerLink has no fields: treat an empty nested struct as a leaf.
                if dataclasses.fields(value):
                    self._walk(path, data_type, value, result)
                else:
                    self._handle_empty(path, data_type, result)
                continue
            if _is_empty(value):
                self._handle_empty(path, data_type, result)

    def _handle_empty(self, path: str, data_type: str, result: ValidationResult) -> None:
        rule = self.config.rules.get(path)
        if rule is None:
            return  # no rule -> optional
        result.null_log_events.append(NullLogEvent(
            platform=self.config.platform,
            data_type=data_type,
            field_name=path,
            strategy_used=rule.behavior.value,
            is_platform_limit=rule.behavior is Behavior.UNAVAILABLE,
            message=rule.message,
        ))
        if rule.behavior is Behavior.CRITICAL:
            result.valid = False
            result.errors.append(path)
        elif rule.behavior is Behavior.LOG:
            result.warnings.append(path)
        elif rule.behavior is Behavior.UNAVAILABLE:
            result.unavailable_used.append(path)

    def _log_result(self, result: ValidationResult, data_type: str, ident: str) -> None:
        if result.valid:
            logger.debug("valid %s data", data_type, extra={"id": ident,
                         "log_tag": "null_validation"})
        else:
            logger.error("invalid %s data: missing %s", data_type, result.errors,
                         extra={"id": ident, "log_tag": "null_validation"})

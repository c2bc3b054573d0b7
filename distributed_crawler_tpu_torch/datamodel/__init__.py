"""The post record the crawl writes and the text path embeds, and the
null-field validation the channel crawl runs on it."""

from .post import (
    ChannelData,
    Comment,
    EngagementData,
    MediaData,
    NullLogEvent,
    Post,
)
from .validation import (
    Behavior,
    FieldRule,
    NullValidator,
    ValidationConfig,
    ValidationResult,
    default_configs,
    load_config_from_json,
    merge_configs,
)

__all__ = [
    "Post", "Comment", "ChannelData", "EngagementData", "MediaData",
    "NullLogEvent", "Behavior", "FieldRule", "ValidationConfig",
    "ValidationResult", "NullValidator", "default_configs",
    "merge_configs", "load_config_from_json",
]

"""Configuration of the port's device modes: the precedence chain (flags >
``CRAWLER_*`` env > YAML file > defaults) and the inference and media
settings, copied from the reference's `config/`."""

from .crawler import (
    CrawlerConfig,
    InferenceConfig,
    MediaConfig,
    TelegramRateLimitConfig,
    generate_crawl_id,
)
from .precedence import ENV_PREFIX, ConfigResolver, env_key

__all__ = [
    "ConfigResolver", "CrawlerConfig", "ENV_PREFIX", "InferenceConfig",
    "MediaConfig", "TelegramRateLimitConfig", "env_key",
    "generate_crawl_id",
]

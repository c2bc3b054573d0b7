"""The post record the crawl writes and the text path embeds."""

from .post import Post

__all__ = ["Post"]

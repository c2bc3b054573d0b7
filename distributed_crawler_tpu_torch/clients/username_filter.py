"""Username plausibility pre-filter: the port's copy of the reference's
`distributed_crawler_tpu/clients/username_filter.py`.

Telegram's documented username rules (5-32 characters, ASCII letters,
digits and underscore, an ASCII letter first, no trailing underscore)
plus the reference's heuristics for known false positives (bot suffixes,
path-like strings).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class UsernameFilterResult:
    valid: bool
    reason: str = ""  # empty if valid


def _is_valid_char(ch: str) -> bool:
    return ch.isascii() and (ch.isalnum() or ch == "_")


def filter_username(username: str) -> UsernameFilterResult:
    if len(username) < 5:
        return UsernameFilterResult(False, "too_short")
    if len(username) > 32:
        return UsernameFilterResult(False, "too_long")
    first = username[0]
    if not (first.isascii() and first.isalpha()):
        return UsernameFilterResult(False, "invalid_start_char")
    if username.endswith("_"):
        return UsernameFilterResult(False, "ends_with_underscore")
    if not all(_is_valid_char(c) for c in username):
        return UsernameFilterResult(False, "invalid_char")
    if any(c in username for c in "/\\~."):
        return UsernameFilterResult(False, "looks_like_path")
    lower = username.lower()
    if lower.endswith("_bot") or lower.endswith("bot"):
        # Bots are never supergroups.
        return UsernameFilterResult(False, "bot_suffix")
    return UsernameFilterResult(True)

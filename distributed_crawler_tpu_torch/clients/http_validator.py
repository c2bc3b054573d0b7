"""Account-free Telegram channel validation by reading https://t.me/<user>:
the port's copy of the reference's `distributed_crawler_tpu/clients/
http_validator.py`.

- the page's classification from its ``<title>`` and robots meta
  (`parse_channel_html`);
- the error taxonomy: a transient failure retries the edge later, a
  block pauses validation (`ValidationHTTPError`, `TRANSIENT`,
  `BLOCKED`);
- a pool of Chromium user agents;
- a token bucket with jitter between requests (`ValidatorRateLimiter`).

The ``transport`` is any callable ``(url, headers) -> (status, body)``:
`urllib_transport` (the standard library's, the default) or, through
`make_transport`, ``"chrome"``, the native client's Chrome-shaped TLS.
That one needs `clients/native.py`, which waits for ROADMAP Queue 1 part
D: `chrome_transport` and ``make_transport("chrome")`` raise naming it.
"""

from __future__ import annotations

import logging
import random
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from .rate_limiter import Clock, SystemClock, TokenBucket

logger = logging.getLogger("dct.clients.validator")

# Chromium only: mixing engines would not match the TLS fingerprint.
BROWSER_USER_AGENTS = [
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 (KHTML, like Gecko) Chrome/124.0.0.0 Safari/537.36",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 10_15_7) AppleWebKit/537.36 (KHTML, like Gecko) Chrome/124.0.0.0 Safari/537.36",
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 (KHTML, like Gecko) Chrome/124.0.0.0 Safari/537.36",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 (KHTML, like Gecko) Chrome/124.0.0.0 Safari/537.36 Edg/124.0.0.0",
]

MAX_READ_BYTES = 64 * 1024  # the signals live in <head>

# Error kinds.
TRANSIENT = "transient"  # retry the edge later
BLOCKED = "blocked"  # an IP-level or soft block: pause validation


class ValidationHTTPError(Exception):
    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


@dataclass
class ChannelValidationResult:
    status: str = ""  # valid | not_channel | invalid
    reason: str = ""  # "" | not_supergroup | not_found


Transport = Callable[[str, dict], Tuple[int, bytes]]


def urllib_transport(url: str, headers: dict) -> Tuple[int, bytes]:
    """The standard library's transport (no fingerprint shaping)."""
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read(MAX_READ_BYTES)
    except urllib.error.HTTPError as e:
        return e.code, e.read(MAX_READ_BYTES) if e.fp else b""


def _native_missing() -> NotImplementedError:
    return NotImplementedError(
        "the chrome validator transport needs the native Telegram client's "
        "TLS stack (clients/native.py), which the port has not ported yet "
        "(ROADMAP Queue 1 part D); use validator_transport 'urllib'")


def chrome_transport(url: str, headers: dict, **kw) -> Tuple[int, bytes]:
    """The native Chrome-shaped TLS transport: waits for part D."""
    raise _native_missing()


def make_transport(kind: str = "urllib", **kw) -> Transport:
    """The validator's transport by name: ``urllib`` (the default) or
    ``chrome``, which raises here, at construction, rather than failing
    every request as a transient error."""
    if kind in ("", "urllib"):
        return urllib_transport
    if kind == "chrome":
        raise _native_missing()
    raise ValueError(f"unknown validator transport {kind!r}; "
                     f"expected 'urllib' or 'chrome'")


def _extract_title(html: str) -> str:
    """The first <title>'s content."""
    lower = html.lower()
    start = lower.find("<title>")
    if start == -1:
        return ""
    start += len("<title>")
    end = lower.find("</title>", start)
    if end == -1:
        return ""
    return html[start:end].strip()


def _has_robots_noindex(html: str) -> bool:
    """Whether the robots meta tag itself says noindex."""
    lower = html.lower()
    idx = lower.find('name="robots"')
    if idx == -1:
        return False
    tag_start = lower.rfind("<", 0, idx)
    tag_end = lower.find(">", idx)
    if tag_start == -1 or tag_end == -1:
        return False
    return "noindex" in lower[tag_start:tag_end + 1]


def parse_channel_html(html: str) -> ChannelValidationResult:
    """Classify a t.me page by its title:

    - "Telegram: View @" -> a valid channel or supergroup;
    - "Telegram: Contact @" with robots noindex -> the username is not
      occupied (invalid, not_found); without -> a user, bot or basic
      group (not_channel, not_supergroup);
    - "Telegram Messenger" (a reserved path's redirect) -> invalid,
      not_found.

    Raises ValueError on any other title (the caller's soft block)."""
    title = _extract_title(html)
    if "Telegram: View @" in title:
        return ChannelValidationResult(status="valid")
    if "Telegram: Contact @" in title:
        if _has_robots_noindex(html):
            return ChannelValidationResult(status="invalid",
                                           reason="not_found")
        return ChannelValidationResult(status="not_channel",
                                       reason="not_supergroup")
    if title == "Telegram Messenger":
        return ChannelValidationResult(status="invalid", reason="not_found")
    raise ValueError(f"unrecognised title pattern: {title!r}")


def validate_channel_http(username: str,
                          transport: Transport = urllib_transport,
                          rng: Optional[random.Random] = None,
                          base_url: str = "https://t.me"
                          ) -> ChannelValidationResult:
    """Fetch ``{base_url}/<username>`` and classify it; ``base_url`` may
    name a mirror or a forward proxy (config ``validator_base_url``)."""
    rng = rng or random
    url = f"{base_url.rstrip('/')}/{username}"
    headers = {
        "User-Agent": rng.choice(BROWSER_USER_AGENTS),
        "Accept": "text/html,application/xhtml+xml,application/xml;q=0.9,"
                  "image/webp,*/*;q=0.8",
        "Accept-Language": "en-US,en;q=0.9",
        "Upgrade-Insecure-Requests": "1",
        "Sec-Fetch-Dest": "document",
        "Sec-Fetch-Mode": "navigate",
        "Sec-Fetch-Site": "none",
    }
    try:
        status_code, body = transport(url, headers)
    except Exception as e:
        raise ValidationHTTPError(
            TRANSIENT, f"HTTP request failed for {username}: {e}") from e

    if status_code != 200:
        # 5xx is transient; 403, 429 and any other 4xx a block.
        kind = TRANSIENT if status_code >= 500 else BLOCKED
        raise ValidationHTTPError(
            kind, f"unexpected status {status_code} for {username}")

    html = body[:MAX_READ_BYTES].decode("utf-8", errors="replace")
    try:
        return parse_channel_html(html)
    except ValueError as e:
        # An unrecognised 200 is a soft block, not a definitive invalid.
        logger.warning("unrecognised HTML response",
                       extra={"channel": username})
        raise ValidationHTTPError(
            BLOCKED, f"failed to parse response for {username}: {e}") from e


class ValidatorRateLimiter:
    """A token bucket plus jitter between validator requests."""

    def __init__(self, requests_per_minute: float = 6.0, jitter_ms: int = 200,
                 clock: Optional[Clock] = None,
                 rng: Optional[random.Random] = None):
        self.clock = clock or SystemClock()
        self._bucket = TokenBucket(requests_per_minute, self.clock)
        self.jitter_ms = jitter_ms
        self._rng = rng or random.Random()

    def wait(self) -> float:
        waited = self._bucket.wait()
        jitter = (self._rng.randint(0, self.jitter_ms) / 1000.0
                  if self.jitter_ms > 0 else 0.0)
        self.clock.sleep(jitter)
        return waited + jitter

"""Time and duration parsing for the CLI's date flags.

The port's copy of the reference's `distributed_crawler_tpu/utils/
timeparse.py`, with the same results and error messages:

- `parse_time_ago`: "30d", "6h", "2w", "1m", "1y" -> a cutoff datetime
  (``--time-ago``);
- `parse_date_between`: "YYYY-MM-DD,YYYY-MM-DD" -> (min, max)
  (``--date-between``);
- `parse_duration`: Go-style duration strings ("2h45m", "90s", "500ms")
  -> seconds (``--max-crawl-duration``).
"""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone
from typing import Optional, Tuple

_UNITS_MSG = "must be a number followed by a unit (h,d,w,m,y)"


def _add_months(dt: datetime, months: int) -> datetime:
    """Calendar-aware month arithmetic (Go time.AddDate semantics, normalized)."""
    month_index = dt.month - 1 + months
    year = dt.year + month_index // 12
    month = month_index % 12 + 1
    # Go normalizes overflow days (Jan 31 - 1 month -> Dec 31; Mar 31 -1m -> "Mar 3"),
    # we clamp instead: the cutoff is a filter boundary, not a calendar identity.
    day = min(dt.day, [31, 29 if year % 4 == 0 and (year % 100 != 0 or year % 400 == 0) else 28,
                       31, 30, 31, 30, 31, 31, 30, 31, 30, 31][month - 1])
    return dt.replace(year=year, month=month, day=day)


def parse_time_ago(time_ago: str, now: Optional[datetime] = None) -> Optional[datetime]:
    """Parse "<N><unit>" into a cutoff datetime (`main.go:91-142`).

    Empty string -> None (no cutoff).
    """
    if not time_ago:
        return None
    unit = time_ago[-1]
    value_str = time_ago[:-1]
    m = re.match(r"^\s*(\d+)", value_str)
    if not m:
        raise ValueError(f"invalid time-ago format, {_UNITS_MSG}: {time_ago!r}")
    value = int(m.group(1))
    now = now or datetime.now(timezone.utc)
    if unit == "h":
        return now - timedelta(hours=value)
    if unit == "d":
        return now - timedelta(days=value)
    if unit == "w":
        return now - timedelta(weeks=value)
    if unit == "m":
        return _add_months(now, -value)
    if unit == "y":
        return _add_months(now, -12 * value)
    raise ValueError(
        f"invalid time unit '{unit}', must be h (hours), d (days), w (weeks), "
        "m (months), or y (years)"
    )


def parse_date_between(spec: str) -> Tuple[datetime, datetime]:
    """Parse "YYYY-MM-DD,YYYY-MM-DD" into (min, max) (`main.go:432-471`)."""
    dates = spec.split(",")
    if len(dates) != 2:
        raise ValueError("invalid date-between format, must be 'YYYY-MM-DD,YYYY-MM-DD'")
    try:
        min_date = datetime.strptime(dates[0].strip(), "%Y-%m-%d").replace(tzinfo=timezone.utc)
    except ValueError as e:
        raise ValueError(f"invalid min date in date-between format, must be YYYY-MM-DD: {e}")
    try:
        max_date = datetime.strptime(dates[1].strip(), "%Y-%m-%d").replace(tzinfo=timezone.utc)
    except ValueError as e:
        raise ValueError(f"invalid max date in date-between format, must be YYYY-MM-DD: {e}")
    if min_date > max_date:
        raise ValueError("min date must be before max date in date-between")
    return min_date, max_date


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|h|m|s)")


def parse_duration(spec: str) -> float:
    """Go-style duration string ("2h45m", "90s", "500ms") -> seconds."""
    if not spec:
        return 0.0
    matches = _DURATION_RE.findall(spec)
    if not matches or "".join(f"{n}{u}" for n, u in matches) != spec.replace(" ", ""):
        raise ValueError(f"invalid duration: {spec!r}")
    mult = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001}
    return sum(float(n) * mult[u] for n, u in matches)

"""Arrow's three readings of a date-time string, reproduced.

The JAX package leans on Arrow in three places where a string becomes a
timestamp, with different rules; the port reproduces each:

- `parse_timestamp_s`: the JSON reader's type inference (the stats
  index): `YYYY-MM-DD`, optionally `(T| )HH[:MM[:SS]]` and a zone (`Z`,
  `+HH`, `+HHMM`, `+HH:MM`, applied), no fraction of a second; a valid
  calendar date and time. Epoch seconds, or None (Arrow keeps a string).
- `string_to_us`: a cast of a string literal to `timestamp[us]` (a
  predicate literal against timestamp stats, an IN value against a
  timestamp column): the same date-time with up to six digits of
  fraction and no zone. Epoch microseconds, or None (Arrow refuses).
- `json_to_us`: the JSON reader's conversion to an explicit
  `timestamp[us]` field (a checkpoint's `stats_parsed`): the inference's
  date-time with up to six digits of fraction after the seconds, before
  the zone. Epoch microseconds, or None (Arrow fails the parse).
"""

from __future__ import annotations

import re
from typing import Optional

_TS_RE = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})"
    r"(?:[T ](\d{2})(?::(\d{2})(?::(\d{2}))?)?"
    r"(Z|[+-]\d{2}(?::?\d{2})?)?)?")
_CAST_RE = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})"
    r"(?:[T ](\d{2})(?::(\d{2})(?::(\d{2})(?:\.(\d{1,6}))?)?)?)?")
_JSON_RE = re.compile(
    r"(\d{4}-\d{2}-\d{2}(?:[T ]\d{2}(?::\d{2}(?::\d{2})?)?)?)"
    r"(?:\.(\d{1,6}))?(Z|[+-]\d{2}(?::?\d{2})?)?")
_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_from_civil(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def parse_timestamp_s(s: str) -> Optional[int]:
    """Epoch seconds of `s` as Arrow's JSON reader infers a timestamp[s],
    or None when Arrow would keep it a string."""
    m = _TS_RE.fullmatch(s)
    if m is None:
        return None
    y, mo, d = int(m[1]), int(m[2]), int(m[3])
    if not 1 <= mo <= 12:
        return None
    leap = y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)
    if not 1 <= d <= _DAYS_IN_MONTH[mo - 1] + (mo == 2 and leap):
        return None
    hh = int(m[4] or 0)
    mm = int(m[5] or 0)
    ss = int(m[6] or 0)
    if hh > 23 or mm > 59 or ss > 59:
        return None
    off = 0
    z = m[7]
    if z and z != "Z":
        oh = int(z[1:3])
        om = int(z[-2:]) if len(z) > 3 else 0
        if oh > 23 or om > 59:
            return None
        off = (oh * 3600 + om * 60) * (1 if z[0] == "+" else -1)
    return (_days_from_civil(y, mo, d) * 86400 + hh * 3600 + mm * 60 + ss
            - off)


def string_to_us(s: str) -> Optional[int]:
    """A string literal cast to timestamp[us] as Arrow casts it: an ISO
    date or zone-less date-time, with up to six digits of fraction; None
    where Arrow refuses (a zone suffix among them)."""
    m = _CAST_RE.fullmatch(s)
    if m is None:
        return None
    frac = m[7]
    secs = parse_timestamp_s(s if frac is None
                             else s[:-len(frac) - 1])
    if secs is None:
        return None
    return secs * 1_000_000 + (0 if frac is None
                               else int((frac + "00000")[:6]))


def json_to_us(s: str) -> Optional[int]:
    """Epoch microseconds of `s` as Arrow's JSON reader converts it to an
    explicit timestamp[us] field, or None where the parse fails."""
    m = _JSON_RE.fullmatch(s)
    if m is None or (m[2] is not None and m[1].count(":") != 2):
        return None  # a fraction only after the seconds
    secs = parse_timestamp_s(m[1] + (m[3] or ""))
    if secs is None:
        return None
    return secs * 1_000_000 + (0 if m[2] is None
                               else int((m[2] + "00000")[:6]))

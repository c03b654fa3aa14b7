"""flb_strptime equivalent — BSD-style strptime subset.

The port's own copy of ``fluentbit_tpu/parsers/strptime.py``, whole
(tests/test_torch_parsers.py holds the two equal).

Reference: src/flb_strptime.c (a BSD strptime clone) and
flb_parser_time_lookup (src/flb_parser.c): the parser's time format is
split at ``%L`` (fractional seconds), each side parsed by strptime, the
digit run at the split parsed as subseconds; a format without a year gets
the current year prepended (old syslog records); without an explicit
timezone (%z) the parser's fixed ``time_offset`` applies (default UTC).

This is a from-scratch implementation of the same directive set over
Python strings; it returns the number of characters consumed so callers
can continue parsing (the %L split requires exactly that).
"""

from __future__ import annotations

import calendar
import time as _time
from dataclasses import dataclass
from typing import Optional, Tuple

_MONTHS = ["january", "february", "march", "april", "may", "june", "july",
           "august", "september", "october", "november", "december"]
_DAYS = ["sunday", "monday", "tuesday", "wednesday", "thursday", "friday",
         "saturday"]


@dataclass
class Tm:
    """Broken-down time being filled in (struct flb_tm)."""

    year: int = 1970
    mon: int = 1
    mday: int = 1
    hour: int = 0
    min: int = 0
    sec: int = 0
    yday: Optional[int] = None
    gmtoff: Optional[int] = None  # seconds east of UTC; None = not parsed
    epoch: Optional[float] = None  # %s short-circuit
    _pm: bool = False
    _hour12: Optional[int] = None
    _century: Optional[int] = None  # %C
    _yy: Optional[int] = None       # %y (composed with %C in finish)

    def finish(self) -> None:
        if self._hour12 is not None:
            h = self._hour12 % 12
            self.hour = h + 12 if self._pm else h
        if self._century is not None:
            yy = self._yy if self._yy is not None else self.year % 100
            self.year = self._century * 100 + yy
        elif self._yy is not None:
            self.year = 2000 + self._yy if self._yy < 69 else 1900 + self._yy

    def to_epoch(self, default_offset: int = 0) -> float:
        """Seconds since epoch; unparsed timezone → default_offset."""
        if self.epoch is not None:
            return self.epoch
        self.finish()
        if self.yday is not None and self.mon == 1 and self.mday == 1:
            base = calendar.timegm((self.year, 1, 1, self.hour, self.min,
                                    self.sec, 0, 1, 0))
            ts = base + (self.yday - 1) * 86400
        else:
            ts = calendar.timegm((self.year, self.mon, self.mday, self.hour,
                                  self.min, self.sec, 0, 1, 0))
        off = self.gmtoff if self.gmtoff is not None else default_offset
        return ts - off


def _digits(s: str, i: int, max_len: int) -> Tuple[Optional[int], int]:
    j = i
    while j < len(s) and j - i < max_len and s[j].isdigit():
        j += 1
    if j == i:
        return None, i
    return int(s[i:j]), j


def _name(s: str, i: int, names) -> Tuple[Optional[int], int]:
    low = s[i : i + 12].lower()
    for idx, n in enumerate(names):
        if low.startswith(n[:3]):
            # full name wins if present
            if low.startswith(n):
                return idx, i + len(n)
            return idx, i + 3
    return None, i


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i].isspace():
        i += 1
    return i


def flb_strptime(s: str, fmt: str, tm: Tm) -> Optional[int]:
    """Parse ``s`` by ``fmt`` into ``tm``; returns chars consumed or None
    on mismatch (the C version returns the advanced pointer)."""
    i = 0
    f = 0
    n = len(s)
    nf = len(fmt)
    while f < nf:
        c = fmt[f]
        if c.isspace():
            # whitespace in format: skip any run of whitespace in input
            i = _skip_ws(s, i)
            f += 1
            continue
        if c != "%":
            if i >= n or s[i] != c:
                return None
            i += 1
            f += 1
            continue
        f += 1
        if f >= nf:
            return None
        d = fmt[f]
        f += 1
        if d == "%":
            if i >= n or s[i] != "%":
                return None
            i += 1
        elif d in ("n", "t"):
            i = _skip_ws(s, i)
        elif d in ("a", "A"):
            idx, i2 = _name(s, i, _DAYS)
            if idx is None:
                return None
            i = i2
        elif d in ("b", "B", "h"):
            idx, i2 = _name(s, i, _MONTHS)
            if idx is None:
                return None
            tm.mon = idx + 1
            i = i2
        elif d in ("d", "e"):
            if d == "e":
                i = _skip_ws(s, i)
            v, i = _digits(s, i, 2)
            if v is None or not (1 <= v <= 31):
                return None
            tm.mday = v
        elif d == "m":
            v, i = _digits(s, i, 2)
            if v is None or not (1 <= v <= 12):
                return None
            tm.mon = v
        elif d in ("H", "k"):
            if d == "k":
                i = _skip_ws(s, i)
            v, i = _digits(s, i, 2)
            if v is None or v > 23:
                return None
            tm.hour = v
        elif d in ("I", "l"):
            if d == "l":
                i = _skip_ws(s, i)
            v, i = _digits(s, i, 2)
            if v is None or not (1 <= v <= 12):
                return None
            tm._hour12 = v
        elif d == "M":
            v, i = _digits(s, i, 2)
            if v is None or v > 59:
                return None
            tm.min = v
        elif d == "S":
            v, i = _digits(s, i, 2)
            if v is None or v > 61:
                return None
            tm.sec = v
        elif d == "j":
            v, i = _digits(s, i, 3)
            if v is None or not (1 <= v <= 366):
                return None
            tm.yday = v
        elif d == "Y":
            v, i = _digits(s, i, 4)
            if v is None:
                return None
            tm.year = v
        elif d == "y":
            v, i = _digits(s, i, 2)
            if v is None:
                return None
            tm._yy = v  # century composed in finish() (%C%y support)
        elif d == "C":
            v, i = _digits(s, i, 2)
            if v is None:
                return None
            tm._century = v
        elif d == "s":
            v, i = _digits(s, i, 20)
            if v is None:
                return None
            tm.epoch = float(v)
        elif d == "p":
            low = s[i : i + 2].lower()
            if low == "am":
                tm._pm = False
            elif low == "pm":
                tm._pm = True
            else:
                return None
            i += 2
        elif d == "T":
            r = flb_strptime(s[i:], "%H:%M:%S", tm)
            if r is None:
                return None
            i += r
        elif d == "R":
            r = flb_strptime(s[i:], "%H:%M", tm)
            if r is None:
                return None
            i += r
        elif d == "D" or d == "x":
            r = flb_strptime(s[i:], "%m/%d/%y", tm)
            if r is None:
                return None
            i += r
        elif d == "z":
            if i < n and s[i] in "Zz":
                tm.gmtoff = 0
                i += 1
            elif i < n and s[i] in "+-":
                sign = -1 if s[i] == "-" else 1
                i += 1
                h, i = _digits(s, i, 2)
                if h is None:
                    return None
                if i < n and s[i] == ":":
                    i += 1
                m, i2 = _digits(s, i, 2)
                if m is None:
                    m = 0
                else:
                    i = i2
                tm.gmtoff = sign * (h * 3600 + m * 60)
            else:
                return None
        elif d == "Z":
            up = s[i : i + 3].upper()
            if up.startswith("UTC") or up.startswith("GMT"):
                tm.gmtoff = 0
                i += 3
            elif i < n and s[i] in "Zz":
                tm.gmtoff = 0
                i += 1
            else:
                j = i
                while j < n and s[j].isalpha():
                    j += 1
                if j == i:
                    return None
                i = j  # unknown zone name: consumed, offset unknown
        elif d in ("u", "w"):
            v, i = _digits(s, i, 1)
            if v is None:
                return None
        elif d in ("U", "W"):
            v, i = _digits(s, i, 2)
            if v is None:
                return None
        else:
            return None
    return i


def parse_subseconds(s: str, i: int) -> Tuple[Optional[float], int]:
    """The %L fragment: a dot/comma-optional digit run → fractional secs
    (reference parse_subseconds, src/flb_parser.c:1869)."""
    if i < len(s) and s[i] in ".,":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return None, i
    frac = int(s[i:j]) / (10.0 ** (j - i))
    return frac, j


def time_lookup(
    value: str,
    time_fmt: str,
    time_offset: int = 0,
    now: Optional[float] = None,
) -> Optional[float]:
    """flb_parser_time_lookup equivalent: parse ``value`` by ``time_fmt``
    (split at %L), returning epoch seconds (float, frac included) or None.

    A format without %Y/%y/%s gets the current UTC year prepended (the
    reference's old-syslog accommodation).
    """
    fmt = time_fmt
    s = value
    with_year = any(x in fmt for x in ("%Y", "%y", "%s", "%D", "%x", "%C"))
    if not with_year:
        t = _time.gmtime(now if now is not None else _time.time())
        s = f"{t.tm_year} {s}"
        fmt = "%Y " + fmt
    frac = 0.0
    tm = Tm()
    if "%L" in fmt:
        pre, post = fmt.split("%L", 1)
        consumed = flb_strptime(s, pre, tm)
        if consumed is None:
            return None
        fv, pos = parse_subseconds(s, consumed)
        if fv is None:
            return None
        frac = fv
        if post:
            rest = flb_strptime(s[pos:], post, tm)
            if rest is None:
                return None
    else:
        if flb_strptime(s, fmt, tm) is None:
            return None
    return tm.to_epoch(default_offset=time_offset) + frac


def parse_tzone_offset(s: str) -> Optional[int]:
    """'+0200' / '-05:30' / 'Z' → seconds east of UTC
    (flb_parser_tzone_offset, src/flb_parser.c)."""
    tm = Tm()
    if flb_strptime(s.strip(), "%z", tm) is None:
        return None
    return tm.gmtoff

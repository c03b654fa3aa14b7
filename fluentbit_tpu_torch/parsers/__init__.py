"""Parsers subsystem — named parsers: regex / json / logfmt / ltsv.

The port's own copy of ``fluentbit_tpu/parsers/__init__.py``, whole
(tests/test_torch_parsers.py holds the two equal). Reference:
src/flb_parser.c (registry + flb_parser_do dispatch, :1784-1800),
flb_parser_regex.c, flb_parser_json.c, flb_parser_logfmt.c,
flb_parser_ltsv.c, time handling via src/flb_strptime.c (see
.strptime). Parsers are created programmatically
(``FLBContext.parser``, the [PARSER] section's properties), looked up by
name, and applied by filter_parser and in_tail.

``Parser.do(text)`` returns ``(fields_dict, timestamp_or_None)`` on
success or ``None`` on parse failure — the (out_buf, out_time) contract
of flb_parser_do.

Device note: for regex parsers whose pattern is DFA-expressible,
filter_parser runs the match decision on the engine's device
(fluentbit_tpu_torch.ops.grep, K3 on CUDA) as a prefilter; capture
extraction runs on the host for matching records (match-then-extract).
"""

from __future__ import annotations

import json as _json
import logging
from typing import Any, Dict, Optional, Tuple

from ..core.config import parse_bool
from ..regex import FlbRegex
from .strptime import parse_tzone_offset, time_lookup

_log = logging.getLogger("flb.parser")

__all__ = ["Parser", "ParserError", "create_parser", "TYPE_CASTERS"]


class ParserError(ValueError):
    pass


def _cast_int(v: str):
    try:
        return int(float(v)) if "." in v else int(v, 10)
    except ValueError:
        return v


def _cast_float(v: str):
    try:
        return float(v)
    except ValueError:
        return v


def _cast_bool(v: str):
    s = v.strip().lower()
    if s in ("true", "on", "yes", "1"):
        return True
    if s in ("false", "off", "no", "0"):
        return False
    return v


def _cast_hex(v: str):
    try:
        return int(v, 16)
    except ValueError:
        return v


#: Types option casters (flb_parser_types_str_to_type; casting applied by
#: the regex/logfmt/ltsv parsers, never by json)
TYPE_CASTERS = {
    "integer": _cast_int,
    "float": _cast_float,
    "bool": _cast_bool,
    "hex": _cast_hex,
    "string": lambda v: v,
}


def parse_types_spec(spec: str) -> Dict[str, Any]:
    """'code:integer size:integer flag:bool' → {key: caster}."""
    out = {}
    for part in str(spec).split():
        if ":" not in part:
            raise ParserError(f"invalid Types entry {part!r}")
        key, tname = part.split(":", 1)
        caster = TYPE_CASTERS.get(tname.lower())
        if caster is None:
            raise ParserError(f"unknown type {tname!r} in Types")
        out[key] = caster
    return out


class Parser:
    """A named parser (struct flb_parser)."""

    def __init__(
        self,
        name: str,
        fmt: str,
        regex: Optional[str] = None,
        time_key: Optional[str] = None,
        time_format: Optional[str] = None,
        time_keep: bool = False,
        time_offset: Optional[str] = None,
        time_strict: bool = True,
        types: Optional[str] = None,
        skip_empty_values: bool = True,
    ):
        self.name = name
        self.fmt = fmt.lower()
        if self.fmt not in ("regex", "json", "logfmt", "ltsv"):
            raise ParserError(f"unknown parser format {fmt!r}")
        self.time_key = time_key or "time"
        self.time_format = time_format
        self.time_keep = time_keep
        self.time_strict = time_strict
        self.skip_empty_values = skip_empty_values
        self.time_offset = 0
        if time_offset:
            off = parse_tzone_offset(str(time_offset))
            if off is None:
                raise ParserError(f"invalid Time_Offset {time_offset!r}")
            self.time_offset = off
        self.types = parse_types_spec(types) if types else {}
        self.regex: Optional[FlbRegex] = None
        if self.fmt == "regex":
            if not regex:
                raise ParserError("regex parser requires a Regex")
            self.regex = FlbRegex(regex)

    # -- the flb_parser_do contract --

    def do(self, text: str) -> Optional[Tuple[Dict[str, Any], Optional[float]]]:
        if self.fmt == "regex":
            fields = self._do_regex(text)
        elif self.fmt == "json":
            fields = self._do_json(text)
        elif self.fmt == "logfmt":
            fields = self._do_logfmt(text)
        else:
            fields = self._do_ltsv(text)
        if fields is None:
            return None
        ts = self._extract_time(fields)
        return fields, ts

    def _extract_time(self, fields: Dict[str, Any]) -> Optional[float]:
        """Parse + (usually) pop the time field.

        Reference cb_results (src/flb_parser_regex.c:65-95): on lookup
        FAILURE the time field is dropped and the record still parses
        with no time override; on success it is dropped unless
        time_keep.
        """
        if not self.time_format or self.time_key not in fields:
            return None
        raw = fields[self.time_key]
        if not isinstance(raw, str):
            return None
        ts = time_lookup(raw, self.time_format, self.time_offset)
        if ts is None:
            # strict vs non-strict differ only in log level: either way
            # the field is dropped and the record parses with no time
            # override (src/flb_parser.c flb_parser_time_lookup +
            # flb_parser_regex.c cb_results)
            _log.log(
                30 if self.time_strict else 10,
                "[parser:%s] invalid time format %s for '%s'",
                self.name, self.time_format, raw,
            )
            fields.pop(self.time_key, None)
            return None
        if not self.time_keep:
            fields.pop(self.time_key, None)
        return ts

    def _apply_types(self, fields: Dict[str, Any]) -> Dict[str, Any]:
        if self.types:
            for k, caster in self.types.items():
                v = fields.get(k)
                if isinstance(v, str):
                    fields[k] = caster(v)
        return fields

    def _do_regex(self, text: str) -> Optional[Dict[str, Any]]:
        got = self.regex.parse_record(text)
        if got is None:
            return None
        fields: Dict[str, Any] = {}
        for k, v in got.items():
            if v == "" and self.skip_empty_values:
                continue
            fields[k] = v
        if not fields:
            return None  # zero extracted fields = parse failure
        return self._apply_types(fields)

    def _do_json(self, text: str) -> Optional[Dict[str, Any]]:
        try:
            obj = _json.loads(text)
        except Exception:
            return None
        if not isinstance(obj, dict):
            return None  # flb_parser_json_do requires a map
        return obj

    def _do_logfmt(self, text: str) -> Optional[Dict[str, Any]]:
        """logfmt: ident[=value] pairs, values bare or double-quoted
        (reference flb_parser_logfmt.c scanner semantics)."""
        fields: Dict[str, Any] = {}
        i = 0
        n = len(text)
        while i < n:
            while i < n and text[i] in " \t":
                i += 1
            if i >= n:
                break
            # key: up to '=' or whitespace
            k0 = i
            while i < n and text[i] not in "= \t":
                i += 1
            key = text[k0:i]
            value = ""
            if i < n and text[i] == "=":
                i += 1
                if i < n and text[i] == '"':
                    i += 1
                    buf = []
                    while i < n and text[i] != '"':
                        if text[i] == "\\" and i + 1 < n:
                            esc = text[i + 1]
                            buf.append(
                                {"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc)
                            )
                            i += 2
                        else:
                            buf.append(text[i])
                            i += 1
                    i += 1  # closing quote
                    value = "".join(buf)
                else:
                    v0 = i
                    while i < n and text[i] not in " \t":
                        i += 1
                    value = text[v0:i]
            if key:
                fields[key] = value
        if not fields:
            return None
        return self._apply_types(fields)

    def _do_ltsv(self, text: str) -> Optional[Dict[str, Any]]:
        """LTSV: tab-separated label:value fields
        (reference flb_parser_ltsv.c)."""
        fields: Dict[str, Any] = {}
        for part in text.rstrip("\r\n").split("\t"):
            if not part:
                continue
            if ":" not in part:
                continue
            label, value = part.split(":", 1)
            fields[label] = value
        if not fields:
            return None
        return self._apply_types(fields)


def create_parser(name: str, **props) -> Parser:
    """Create from [PARSER]-section style properties (case-insensitive
    keys: Format, Regex, Time_Key, Time_Format, Time_Keep, Time_Offset,
    Types, Skip_Empty_Values)."""
    low = {k.lower(): v for k, v in props.items()}
    return Parser(
        name=name,
        fmt=low.get("format", "regex"),
        regex=low.get("regex"),
        time_key=low.get("time_key"),
        time_format=low.get("time_format"),
        time_keep=parse_bool(low["time_keep"]) if "time_keep" in low else False,
        time_offset=low.get("time_offset"),
        time_strict=parse_bool(low["time_strict"]) if "time_strict" in low else True,
        types=low.get("types"),
        skip_empty_values=parse_bool(low["skip_empty_values"])
        if "skip_empty_values" in low
        else True,
    )

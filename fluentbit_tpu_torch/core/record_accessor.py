"""Record accessor — the ``$key['nested'][0]`` path language.

The port's own copy of ``fluentbit_tpu/core/record_accessor.py``, trimmed
to field lookup (templates and updates wait for rewrite_tag's slice).

Reference: src/flb_record_accessor.c + flex/bison grammar
src/record_accessor/ra.l, ra.y. Paths address fields inside a record's body
and support nested maps and array indexing.

Grammar supported here:
  $key                    top-level key
  $key['a']['b']          nested map access (single or double quotes)
  $key.a.b                dotted shorthand (ra.y KEY '.' KEY)
  $key[0]                 array index
"""

from __future__ import annotations

import re
from typing import Any, List

_PATH_TOKEN = re.compile(
    r"""\[(?:'(?P<sq>[^']*)'|"(?P<dq>[^"]*)"|(?P<idx>-?\d+))\]|\.(?P<dot>[A-Za-z0-9_\-]+)"""
)
_HEAD = re.compile(r"^\$(?P<head>[A-Za-z0-9_\-]+)")


class RecordAccessor:
    """Compiled accessor for a single ``$...`` path."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        if not pattern.startswith("$"):
            # bare key name — grep's "Regex key val" form allows `key`
            self.head = pattern
            self.parts: List[Any] = []
            return
        m = _HEAD.match(pattern)
        if not m:
            raise ValueError(f"invalid record accessor {pattern!r}")
        self.head = m.group("head")
        self.parts = []
        for tok in _PATH_TOKEN.finditer(pattern, m.end()):
            if tok.group("sq") is not None:
                self.parts.append(tok.group("sq"))
            elif tok.group("dq") is not None:
                self.parts.append(tok.group("dq"))
            elif tok.group("idx") is not None:
                self.parts.append(int(tok.group("idx")))
            else:
                self.parts.append(tok.group("dot"))

    def get(self, record: dict, default: Any = None) -> Any:
        """Fetch the addressed value from a body map (flb_ra_get_value_object)."""
        cur: Any = record
        key: Any = self.head
        for part in [self.head] + self.parts:
            if isinstance(cur, dict):
                if part in cur:
                    cur = cur[part]
                elif isinstance(part, int) and str(part) in cur:
                    cur = cur[str(part)]
                else:
                    return default
            elif isinstance(cur, list) and isinstance(part, int):
                if -len(cur) <= part < len(cur):
                    cur = cur[part]
                else:
                    return default
            else:
                return default
        return cur

    def exists(self, record: dict) -> bool:
        sentinel = object()
        return self.get(record, sentinel) is not sentinel

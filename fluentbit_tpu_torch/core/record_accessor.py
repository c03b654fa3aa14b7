"""Record accessor — the ``$key['nested'][0]`` path language.

The port's own copy of ``fluentbit_tpu/core/record_accessor.py``, trimmed
to field lookup and rewrite_tag's tag ``Template`` (updates and deletes
wait for the slices that need them).

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
from typing import Any, List, Optional, Tuple

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


# In templates only the bracket trail form is taken ($k['a'][0]); dotted
# shorthand would be ambiguous with literal '.' separators in tag templates.
_TEMPLATE_VAR = re.compile(
    r"""\$(?P<num>\d)|\$(?P<name>[A-Za-z_][A-Za-z0-9_\-]*)(?P<trail>(?:\[(?:'[^']*'|"[^"]*"|-?\d+)\])*)"""
)


class Template:
    """Template string with embedded accessors — rewrite_tag's new-tag
    composer (flb_ra_translate, reference src/flb_record_accessor.c).

    Variables: $TAG, $TAG[n], $0..$9 (regex captures), $field paths.
    """

    def __init__(self, text: str):
        self.text = text
        self._parts: List[Tuple[str, Any]] = []  # (kind, payload)
        pos = 0
        for m in _TEMPLATE_VAR.finditer(text):
            if m.start() > pos:
                self._parts.append(("lit", text[pos : m.start()]))
            if m.group("num") is not None:
                self._parts.append(("cap", int(m.group("num"))))
            else:
                name = m.group("name")
                trail = m.group("trail") or ""
                if name == "TAG":
                    if trail and re.fullmatch(r"\[\d+\]", trail):
                        self._parts.append(("tagpart", int(trail[1:-1])))
                    else:
                        self._parts.append(("tag", None))
                else:
                    self._parts.append(("ra", RecordAccessor("$" + name + trail)))
            pos = m.end()
        if pos < len(text):
            self._parts.append(("lit", text[pos:]))

    @property
    def static_for_tag(self) -> bool:
        """True when the rendering depends on the tag alone (no record
        fields, no regex captures): rewrite_tag's batch hook renders such
        a template once per rule and chunk."""
        return all(k in ("lit", "tag", "tagpart") for k, _ in self._parts)

    def render(
        self,
        record: Optional[dict] = None,
        tag: str = "",
        captures: Optional[Tuple[str, ...]] = None,
    ) -> str:
        out: List[str] = []
        tag_parts = tag.split(".")
        for kind, payload in self._parts:
            if kind == "lit":
                out.append(payload)
            elif kind == "tag":
                out.append(tag)
            elif kind == "tagpart":
                out.append(tag_parts[payload] if payload < len(tag_parts) else "")
            elif kind == "cap":
                if captures and payload < len(captures) and captures[payload] is not None:
                    out.append(str(captures[payload]))
            else:  # ra
                val = payload.get(record or {})
                if val is not None:
                    out.append(val if isinstance(val, str) else _stringify(val))
        return "".join(out)


def _stringify(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)

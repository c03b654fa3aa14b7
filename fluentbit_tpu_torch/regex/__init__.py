"""Regex engine — Onigmo-equivalent matching (the port's own copy of
``fluentbit_tpu/regex``; tests/test_torch_regex.py holds the two equal).

Two execution tiers, same semantics (ONIG_SYNTAX_RUBY, UTF-8 bytes):

- ``compile_dfa`` → table-driven scan DFA for device execution
  (fluentbit_tpu_torch.ops.grep) and the CPU reference matcher.
- ``FlbRegex`` → the user-facing wrapper (flb_regex_create/match
  equivalent, src/flb_regex.c): DFA when possible, Python ``re`` for
  patterns with backrefs/lookaround (translated to Ruby semantics), and
  the capture tuple rewrite_tag's tag templates read
  (``search_captures``), and the named captures a regex parser turns
  into a record (``parse_record``).
"""

from __future__ import annotations

import re as _pyre
from typing import Dict, Optional

from .parser import (ALL_BYTES, _POSIX_CLASSES, ParsedRegex,
                     UnsupportedRegex, parse)
from .dfa import DFA, compile_dfa

__all__ = ["FlbRegex", "DFA", "compile_dfa", "parse", "UnsupportedRegex",
           "ParsedRegex", "to_python_regex"]


def _class_content(mask: int) -> str:
    """Render a 256-bit byte mask as Python character-class content."""
    out = []
    b = 0
    while b < 256:
        if mask >> b & 1:
            start = b
            while b < 256 and mask >> b & 1:
                b += 1
            end = b - 1
            # a run reaching 0xFF means "any non-ASCII byte"; in decoded
            # text that is any astral/BMP char (incl. surrogateescape)
            hi = "\\U0010ffff" if end == 0xFF else "\\x%02x" % end
            if start == end:
                out.append("\\x%02x" % start)
            else:
                out.append("\\x%02x-%s" % (start, hi))
        else:
            b += 1
    return "".join(out)


def _posix_content(name: str) -> str:
    neg = name.startswith("^")
    mask = _POSIX_CLASSES.get(name[1:] if neg else name)
    if mask is None:
        raise UnsupportedRegex(f"unknown POSIX class [:{name}:]")
    return _class_content(ALL_BYTES & ~mask if neg else mask)


def to_python_regex(pattern: str) -> str:
    """Translate Ruby-syntax pattern to Python re syntax.

    - ``(?<name>`` → ``(?P<name>``   (keep lookbehind ``(?<=`` / ``(?<!``)
    - ``\\Z`` (Ruby: end-or-before-final-newline) → ``(?=\\n?\\Z)``
    - ``\\z`` → ``\\Z``
    - ``\\h``/``\\H`` (hex digit) → character classes
    - ``\\e`` (escape char, Ruby-only) → ``\\x1b``
    - POSIX classes ``[[:alpha:]]`` → expanded ranges
    """
    out = []
    i = 0
    n = len(pattern)
    in_class = False
    class_start = -1  # position just after '[' (or '[^')
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if in_class:
                # inside a class: \h expands to its ranges; anchors are
                # not special in classes
                if nxt == "h":
                    out.append("0-9a-fA-F")
                elif nxt == "H":
                    # non-hex-digit as explicit ranges (valid inside a class,
                    # unlike a nested [^...])
                    out.append("\\x00-\\x2f\\x3a-\\x40\\x47-\\x60\\x67-\\uffff")
                elif nxt == "e":
                    out.append("\\x1b")
                else:
                    out.append(c + nxt)
            elif nxt == "z":
                out.append(r"\Z")
            elif nxt == "Z":
                out.append(r"(?=\n?\Z)")
            elif nxt == "h":
                out.append("[0-9a-fA-F]")
            elif nxt == "H":
                out.append("[^0-9a-fA-F]")
            elif nxt == "e":
                out.append("\\x1b")
            else:
                out.append(c + nxt)
            i += 2
            continue
        if in_class:
            if c == "[" and pattern.startswith("[:", i):
                j = pattern.find(":]", i + 2)
                # a name spanning ']' means the '[:' was literal class
                # content, not a POSIX class (e.g. "[a[:b]")
                if j > 0 and "]" not in pattern[i + 2 : j]:
                    out.append(_posix_content(pattern[i + 2 : j]))
                    i = j + 2
                    continue
            if c == "]" and i > class_start:
                in_class = False
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class = True
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            class_start = i  # a ']' at this exact position is literal
            continue
        if pattern.startswith("(?<", i) and not (
            pattern.startswith("(?<=", i) or pattern.startswith("(?<!", i)
        ):
            out.append("(?P<")
            i += 3
            continue
        if pattern.startswith("(?'", i):
            j = pattern.index("'", i + 3)
            out.append("(?P<" + pattern[i + 3 : j] + ">")
            i = j + 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


class FlbRegex:
    """flb_regex equivalent: compile once, match/parse many.

    Ruby ^/$ are line anchors → the Python fallback compiles with
    re.MULTILINE (exactly the ONIG_OPTION_NONE default of
    src/flb_regex.c:146).
    """

    def __init__(self, pattern: str, ignorecase: bool = False):
        self.pattern = pattern
        self.ignorecase = ignorecase
        self.dfa: Optional[DFA] = None
        self.parsed: Optional[ParsedRegex] = None
        try:
            self.parsed = parse(pattern, ignorecase=ignorecase)
            self.dfa = compile_dfa(self.parsed)
        except UnsupportedRegex:
            pass
        # the Python fallback is compiled lazily: a DFA-capable pattern may
        # use Ruby-valid constructs Python rejects, and must still work
        self._py_cached = None
        if self.dfa is None:
            self._py()  # no engine can run it → raise at construction

    def _py(self):
        if self._py_cached is None:
            flags = _pyre.MULTILINE
            if self.ignorecase:
                flags |= _pyre.IGNORECASE
            self._py_cached = _pyre.compile(to_python_regex(self.pattern), flags)
        return self._py_cached

    @property
    def dfa_capable(self) -> bool:
        return self.dfa is not None

    def match(self, text) -> bool:
        """Search semantics (flb_regex_match): True if found anywhere."""
        if isinstance(text, str):
            data = text.encode("utf-8")
        else:
            data = bytes(text)
        if self.dfa is not None:
            return self.dfa.match_bytes(data)
        return self._py().search(data.decode("utf-8", "surrogateescape")) is not None

    def search_captures(self, text):
        """Search returning the capture tuple ``($0, $1, ...)`` — group 0
        is the whole match (flb_ra_regex_match's flb_regex_search result,
        consumed by rewrite_tag tag templates). None when no match.

        Ruby capture numbering: when a pattern contains named groups,
        unnamed groups do not capture — $1.. are the named groups in
        order of appearance (ONIG_SYNTAX_RUBY behavior).
        """
        if isinstance(text, bytes):
            text = text.decode("utf-8", "surrogateescape")
        py = self._py()
        m = py.search(text)
        if m is None:
            return None
        if py.groupindex:
            ordered = sorted(py.groupindex.items(), key=lambda kv: kv[1])
            return (m.group(0),) + tuple(m.group(i) for _, i in ordered)
        return (m.group(0),) + m.groups()

    def parse_record(self, text) -> Optional[Dict[str, str]]:
        """Named-capture extraction (flb_regex_parse with callback per
        named group). Returns None when the pattern does not match."""
        if isinstance(text, bytes):
            text = text.decode("utf-8", "surrogateescape")
        m = self._py().search(text)
        if m is None:
            return None
        return {k: v for k, v in m.groupdict().items() if v is not None}

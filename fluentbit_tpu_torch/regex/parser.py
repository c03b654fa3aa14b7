"""Regex parser — Onigmo/Ruby-syntax subset → AST.

The port's own copy of ``fluentbit_tpu/regex/parser.py``.

The reference compiles patterns with ONIG_SYNTAX_RUBY + ONIG_ENCODING_UTF8
(src/flb_regex.c:143-146). Ruby semantics implemented here:

- ``^``/``$`` are LINE anchors (match at string start/end and after/before
  a newline), ``\\A``/``\\z``/``\\Z`` are string anchors.
- ``.`` matches any byte except ``\\n`` (multiline option makes it match all).
- char classes, ranges, negation, escapes (\\d \\w \\s \\h and negations),
  quantifiers ``* + ? {m} {m,} {m,n}`` with lazy/possessive variants
  (language-equivalent for boolean matching), groups ``(...)``,
  ``(?:...)``, named ``(?<name>...)``/``(?'name')``, alternation.

Matching is byte-level over UTF-8: multi-byte literals expand to byte
sequences; negated classes cover bytes 0x80-0xFF so ``[^ ]`` correctly
consumes each byte of multi-byte characters. Counted quantifiers over
``.`` count bytes, not characters, for non-ASCII input (documented
divergence; the DFA-ineligible checker flags patterns where it matters).

Unsupported constructs (backreferences, lookaround, recursion,
\\p{...} unicode properties) raise UnsupportedRegex — callers fall back
to a CPU regex engine, mirroring how the north star keeps a CPU fallback
path for non-vectorizable patterns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

ALL_BYTES = (1 << 256) - 1
NEWLINE_MASK = 1 << 10  # '\n'
DOT_MASK = ALL_BYTES & ~NEWLINE_MASK


class UnsupportedRegex(Exception):
    """Pattern uses a construct the DFA compiler cannot express."""


# -- AST --

@dataclass
class Lit:
    """One byte drawn from a 256-bit mask."""
    mask: int


@dataclass
class Seq:
    items: List["Node"]


@dataclass
class Alt:
    items: List["Node"]


@dataclass
class Rep:
    node: "Node"
    min: int
    max: Optional[int]  # None = unbounded
    lazy: bool = False


@dataclass
class Group:
    node: "Node"
    index: int  # 0 = non-capturing
    name: Optional[str] = None


@dataclass
class Anchor:
    # 'bol' ^, 'eol' $, 'bos' \A, 'eos' \z, 'eos_nl' \Z, 'wordb' \b (unsupported)
    kind: str


Node = Union[Lit, Seq, Alt, Rep, Group, Anchor]


def _mask_of(chars: str) -> int:
    m = 0
    for c in chars:
        m |= 1 << ord(c)
    return m


_D = _mask_of("0123456789")
_W = _D | _mask_of("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_S = _mask_of(" \t\n\r\f\v")
_H = _D | _mask_of("abcdefABCDEF")

_CLASS_ESCAPES = {
    "d": _D, "D": ALL_BYTES & ~_D,
    "w": _W, "W": ALL_BYTES & ~_W,
    "s": _S, "S": ALL_BYTES & ~_S,
    "h": _H, "H": ALL_BYTES & ~_H,
}

_CHAR_ESCAPES = {
    "t": 9, "n": 10, "r": 13, "f": 12, "v": 11, "a": 7, "e": 27, "0": 0,
}


def _range_mask(lo: int, hi: int) -> int:
    return ((1 << (hi + 1)) - 1) & ~((1 << lo) - 1)


#: POSIX bracket classes ``[:name:]`` (ASCII ranges — consistent with the
#: ASCII interpretation this engine uses for \\w/\\d/\\s; Onigmo syntax).
_POSIX_CLASSES = {
    "alnum": _D | _mask_of("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"),
    "alpha": _mask_of("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"),
    "ascii": _range_mask(0x00, 0x7F),
    "blank": _mask_of(" \t"),
    "cntrl": _range_mask(0x00, 0x1F) | (1 << 0x7F),
    "digit": _D,
    "graph": _range_mask(0x21, 0x7E),
    "lower": _mask_of("abcdefghijklmnopqrstuvwxyz"),
    "print": _range_mask(0x20, 0x7E),
    "punct": _range_mask(0x21, 0x2F) | _range_mask(0x3A, 0x40)
             | _range_mask(0x5B, 0x60) | _range_mask(0x7B, 0x7E),
    "space": _S,
    "upper": _mask_of("ABCDEFGHIJKLMNOPQRSTUVWXYZ"),
    "word": _W,
    "xdigit": _H,
}


class _Parser:
    def __init__(self, pattern: str, ignorecase: bool = False,
                 dot_all: bool = False):
        # operate on the UTF-8 byte encoding of the pattern so multi-byte
        # literals become byte sequences naturally
        self.pat = pattern
        self.pos = 0
        self.n = len(pattern)
        self.group_count = 0
        self.ignorecase = ignorecase
        self.dot_all = dot_all

    # -- cursor helpers --

    def peek(self) -> Optional[str]:
        return self.pat[self.pos] if self.pos < self.n else None

    def next(self) -> str:
        c = self.pat[self.pos]
        self.pos += 1
        return c

    def eat(self, c: str) -> bool:
        if self.peek() == c:
            self.pos += 1
            return True
        return False

    def error(self, msg: str) -> Exception:
        return ValueError(f"regex parse error at {self.pos}: {msg} in {self.pat!r}")

    # -- grammar --

    def parse(self) -> Node:
        node = self.parse_alt()
        if self.pos != self.n:
            raise self.error(f"unexpected {self.peek()!r}")
        return node

    def parse_alt(self) -> Node:
        branches = [self.parse_seq()]
        while self.eat("|"):
            branches.append(self.parse_seq())
        if len(branches) == 1:
            return branches[0]
        return Alt(branches)

    def parse_seq(self) -> Node:
        items: List[Node] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            items.append(self.parse_quant())
        if len(items) == 1:
            return items[0]
        return Seq(items)

    def parse_quant(self) -> Node:
        atom = self.parse_atom()
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                atom = Rep(atom, 0, None, self._lazy())
            elif c == "+":
                self.next()
                atom = Rep(atom, 1, None, self._lazy())
            elif c == "?":
                self.next()
                atom = Rep(atom, 0, 1, self._lazy())
            elif c == "{":
                save = self.pos
                rep = self._try_braces(atom)
                if rep is None:
                    self.pos = save
                    break
                atom = rep
            else:
                break
        return atom

    def _lazy(self) -> bool:
        if self.peek() == "?":
            self.next()
            return True
        if self.peek() == "+":  # possessive — same language
            self.next()
        return False

    def _try_braces(self, atom: Node) -> Optional[Rep]:
        assert self.next() == "{"
        start = self.pos
        digits1 = ""
        while self.peek() and self.peek().isdigit():
            digits1 += self.next()
        lo: Optional[int] = int(digits1) if digits1 else None
        hi: Optional[int] = lo
        if self.eat(","):
            digits2 = ""
            while self.peek() and self.peek().isdigit():
                digits2 += self.next()
            hi = int(digits2) if digits2 else None
            if lo is None:
                lo = 0
        if not self.eat("}") or lo is None:
            return None  # literal '{'
        if hi is not None and (hi > 256 or lo > 256):
            raise UnsupportedRegex(f"counted repetition too large: {{{lo},{hi}}}")
        if hi is not None and hi < lo:
            raise self.error(f"bad repetition {{{lo},{hi}}}")
        return Rep(atom, lo, hi, self._lazy())

    def parse_atom(self) -> Node:
        c = self.next()
        if c == "(":
            return self.parse_group()
        if c == "[":
            return Lit(self._maybe_fold(self.parse_class()))
        if c == ".":
            return Lit(ALL_BYTES if self.dot_all else DOT_MASK)
        if c == "^":
            return Anchor("bol")
        if c == "$":
            return Anchor("eol")
        if c == "\\":
            return self.parse_escape()
        if c in "*+?":
            raise self.error(f"nothing to repeat {c!r}")
        return self._literal_char(c)

    def _literal_char(self, c: str) -> Node:
        data = c.encode("utf-8")
        if len(data) == 1:
            return Lit(self._maybe_fold(1 << data[0]))
        return Seq([Lit(1 << b) for b in data])

    def _maybe_fold(self, mask: int) -> int:
        if not self.ignorecase:
            return mask
        folded = mask
        for lo_c, up_c in zip(range(97, 123), range(65, 91)):
            if mask >> lo_c & 1:
                folded |= 1 << up_c
            if mask >> up_c & 1:
                folded |= 1 << lo_c
        return folded

    def parse_group(self) -> Node:
        name: Optional[str] = None
        capture = True
        if self.eat("?"):
            c = self.peek()
            if c == ":":
                self.next()
                capture = False
            elif c == "<":
                self.next()
                nxt = self.peek()
                if nxt in ("=", "!"):
                    raise UnsupportedRegex("lookbehind is not DFA-expressible")
                name = self._parse_name(">")
            elif c == "'":
                self.next()
                name = self._parse_name("'")
            elif c == "P":
                self.next()
                if not self.eat("<"):
                    raise self.error("expected (?P<name>")
                name = self._parse_name(">")
            elif c in ("=", "!"):
                raise UnsupportedRegex("lookahead is not DFA-expressible")
            elif c == "#":
                # comment group
                while self.peek() not in (None, ")"):
                    self.next()
                if not self.eat(")"):
                    raise self.error("unterminated comment group")
                return Seq([])
            else:
                raise UnsupportedRegex(f"unsupported group (?{c}")
        node = self.parse_alt()
        if not self.eat(")"):
            raise self.error("unterminated group")
        if capture:
            self.group_count += 1
            return Group(node, self.group_count, name)
        return Group(node, 0, None)

    def _parse_name(self, term: str) -> str:
        name = ""
        while self.peek() not in (None, term):
            name += self.next()
        if not self.eat(term):
            raise self.error("unterminated group name")
        return name

    def parse_escape(self) -> Node:
        c = self.peek()
        if c is None:
            raise self.error("trailing backslash")
        self.next()
        if c in _CLASS_ESCAPES:
            return Lit(_CLASS_ESCAPES[c])
        if c in _CHAR_ESCAPES:
            return Lit(1 << _CHAR_ESCAPES[c])
        if c == "x":
            return Lit(self._maybe_fold(1 << self._hex2()))
        if c == "A":
            return Anchor("bos")
        if c == "z":
            return Anchor("eos")
        if c == "Z":
            return Anchor("eos_nl")
        if c in ("b", "B"):
            raise UnsupportedRegex("word boundary \\b is not supported")
        if c in ("p", "P"):
            raise UnsupportedRegex("unicode property \\p{...} is not supported")
        if c == "G" or c == "K":
            raise UnsupportedRegex(f"\\{c} is not supported")
        if c.isdigit():
            raise UnsupportedRegex("backreferences are not DFA-expressible")
        if c == "k":
            raise UnsupportedRegex("named backreferences are not DFA-expressible")
        # escaped literal (punctuation, or any other char)
        return self._literal_char(c)

    def _hex2(self) -> int:
        h = ""
        while len(h) < 2 and self.peek() and self.peek() in "0123456789abcdefABCDEF":
            h += self.next()
        if not h:
            raise self.error("bad \\x escape")
        return int(h, 16)

    def parse_class(self) -> int:
        negate = self.eat("^")
        mask = 0
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.error("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            # POSIX bracket class [:name:] / [:^name:] (Onigmo syntax)
            if c == "[" and self.pos + 1 < self.n and self.pat[self.pos + 1] == ":":
                mask |= self._parse_posix_class()
                continue
            self.next()
            if c == "\\":
                e = self.next()
                if e in _CLASS_ESCAPES:
                    mask |= _CLASS_ESCAPES[e]
                    continue
                if e in _CHAR_ESCAPES:
                    lo_b = _CHAR_ESCAPES[e]
                elif e == "x":
                    lo_b = self._hex2()
                elif e in ("p", "P"):
                    raise UnsupportedRegex("\\p in class is not supported")
                else:
                    data = e.encode("utf-8")
                    if len(data) > 1:
                        raise UnsupportedRegex("non-ASCII literal in character class")
                    lo_b = data[0]
            else:
                data = c.encode("utf-8")
                if len(data) > 1:
                    raise UnsupportedRegex("non-ASCII literal in character class")
                lo_b = data[0]
            # range?
            if self.peek() == "-" and self.pos + 1 < self.n and self.pat[self.pos + 1] != "]":
                self.next()  # '-'
                hc = self.next()
                if hc == "\\":
                    he = self.next()
                    if he in _CHAR_ESCAPES:
                        hi_b = _CHAR_ESCAPES[he]
                    elif he == "x":
                        hi_b = self._hex2()
                    else:
                        data = he.encode("utf-8")
                        if len(data) > 1:
                            raise UnsupportedRegex("non-ASCII range bound")
                        hi_b = data[0]
                else:
                    data = hc.encode("utf-8")
                    if len(data) > 1:
                        raise UnsupportedRegex("non-ASCII range bound")
                    hi_b = data[0]
                if hi_b < lo_b:
                    raise self.error(f"bad range {lo_b}-{hi_b}")
                for b in range(lo_b, hi_b + 1):
                    mask |= 1 << b
            else:
                mask |= 1 << lo_b
        if negate:
            mask = ALL_BYTES & ~mask
        return mask

    def _parse_posix_class(self) -> int:
        """``[:name:]`` / ``[:^name:]`` inside a class; cursor at ``[``."""
        save = self.pos
        self.next()  # '['
        self.next()  # ':'
        neg = self.eat("^")
        name = ""
        while self.peek() is not None and self.peek() not in (":", "]"):
            name += self.next()
        if self.peek() == ":" and self.pos + 1 < self.n and self.pat[self.pos + 1] == "]":
            self.next()
            self.next()
            m = _POSIX_CLASSES.get(name)
            if m is None:
                raise UnsupportedRegex(f"unknown POSIX class [:{name}:]")
            return ALL_BYTES & ~m if neg else m
        # not actually a POSIX class (e.g. "[a[:b]"): rewind, treat '[' literal
        self.pos = save
        self.next()
        return 1 << ord("[")


@dataclass
class ParsedRegex:
    root: Node
    n_groups: int
    group_names: dict  # index -> name
    pattern: str


def parse(pattern: str, ignorecase: bool = False, dot_all: bool = False) -> ParsedRegex:
    p = _Parser(pattern, ignorecase=ignorecase, dot_all=dot_all)
    root = p.parse()
    names: dict = {}

    def walk(n: Node) -> None:
        if isinstance(n, Group):
            if n.name and n.index:
                names[n.index] = n.name
            walk(n.node)
        elif isinstance(n, (Seq, Alt)):
            for it in n.items:
                walk(it)
        elif isinstance(n, Rep):
            walk(n.node)

    walk(root)
    return ParsedRegex(root, p.group_count, names, pattern)

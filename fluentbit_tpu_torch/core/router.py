"""Tag → output routing (the port's own copy of ``fluentbit_tpu/core/router.py``).

Reference: src/flb_router.c:140 (flb_router_match) — Match patterns support
'*' wildcards (each '*' matches any run of characters, so 'kube.*' matches
'kube.var.log'); Match_Regex uses a full regex instead. Routes are computed
per chunk.
"""

from __future__ import annotations

import re
from typing import Optional


def tag_match(pattern: str, tag: str) -> bool:
    """Wildcard tag match (flb_router_match equivalent).

    '*' matches any sequence of characters (including '.'), '**' degenerates
    to the same. Comparison is exact otherwise (case sensitive, like the
    reference's strncmp-based loop).
    """
    # fast paths
    if pattern == "*" or pattern == "**":
        return True
    if "*" not in pattern:
        return pattern == tag
    rx = _pattern_cache.get(pattern)
    if rx is None:
        parts = [re.escape(p) for p in pattern.split("*")]
        rx = re.compile("^" + ".*".join(parts) + "$", re.S)
        _pattern_cache[pattern] = rx
    return rx.match(tag) is not None


_pattern_cache: dict = {}


class Route:
    """A match rule binding an instance to tags."""

    def __init__(self, match: Optional[str] = None, match_regex: Optional[str] = None):
        self.match = match
        self.match_regex = re.compile(match_regex) if match_regex else None

    def matches(self, tag: str) -> bool:
        if self.match_regex is not None:
            return self.match_regex.search(tag) is not None
        if self.match is not None:
            return tag_match(self.match, tag)
        return False

"""Conditions — field/op/value rules for conditional routing.

The port's own copy of ``fluentbit_tpu/core/conditions.py``: an output's
``route_condition`` keys become the rules of one AND condition, which
the engine evaluates on each record at ingest (``Engine._append_split``).
The YAML form that processors read (``from_config``) waits for them.

Reference: src/flb_conditionals.c (struct flb_condition: a rule list
with AND/OR combination; ops eq/neq/gt/lt/gte/lte/regex/not_regex/
in/not_in, record-accessor fields) consumed by the condition-based
router (src/flb_router_condition.c).

A rule on a field the record lacks is false, whatever its op (so
``not_regex`` and ``neq`` too), except ``not_exists``. ``regex`` is true
only on a string value the pattern finds (search semantics); a value of
any other type makes ``not_regex`` true.
"""

from __future__ import annotations

from typing import Any, List

from ..regex import FlbRegex
from .record_accessor import RecordAccessor

OPS = ("eq", "neq", "gt", "lt", "gte", "lte", "regex", "not_regex",
       "in", "not_in", "exists", "not_exists")

_MISSING = object()


class Rule:
    __slots__ = ("ra", "op", "value", "_rx")

    def __init__(self, field: str, op: str, value: Any = None):
        op = op.lower()
        if op not in OPS:
            raise ValueError(f"condition: unknown op {op!r}")
        self.ra = RecordAccessor(field if field.startswith("$")
                                 else "$" + field)
        self.op = op
        self.value = value
        self._rx = FlbRegex(str(value)) if op in ("regex", "not_regex") \
            else None

    def eval(self, body: dict) -> bool:
        v = self.ra.get(body, _MISSING)
        op = self.op
        if op == "exists":
            return v is not _MISSING
        if op == "not_exists":
            return v is _MISSING
        if v is _MISSING:
            return False
        if op == "eq":
            return v == self.value
        if op == "neq":
            return v != self.value
        if op in ("gt", "lt", "gte", "lte"):
            try:
                if op == "gt":
                    return v > self.value
                if op == "lt":
                    return v < self.value
                if op == "gte":
                    return v >= self.value
                return v <= self.value
            except TypeError:
                return False
        if op in ("regex", "not_regex"):
            ok = isinstance(v, str) and self._rx.match(v)
            return ok if op == "regex" else not ok
        members = self.value if isinstance(self.value, (list, tuple)) \
            else [self.value]
        return (v in members) if op == "in" else (v not in members)


class Condition:
    """flb_condition: AND/OR over a rule list."""

    def __init__(self, rules: List[Rule], op: str = "and"):
        op = (op or "and").lower()
        if op not in ("and", "or"):
            raise ValueError(f"condition: unknown combinator {op!r}")
        self.rules = rules
        self.op = op

    def eval(self, body: dict) -> bool:
        if not isinstance(body, dict):
            return False
        if self.op == "and":
            return all(r.eval(body) for r in self.rules)
        return any(r.eval(body) for r in self.rules)

    @classmethod
    def from_route_conditions(cls, values: List[Any]) -> "Condition":
        """An output's ``route_condition`` values (``field op [value]``,
        split on the first two runs of whitespace), ANDed. The value of
        an ordering op becomes an int or a float where it parses as
        one; eq and neq compare the string as written."""
        rules = []
        for c in values:
            parts = c.split(None, 2) if isinstance(c, str) else list(c)
            if len(parts) < 2:
                raise ValueError(
                    f"route_condition needs 'field op [value]': {c!r}")
            field, op = parts[0], parts[1]
            value: Any = parts[2] if len(parts) > 2 else None
            if isinstance(value, str) and op.lower() in (
                    "gt", "lt", "gte", "lte"):
                try:
                    value = int(value)
                except ValueError:
                    try:
                        value = float(value)
                    except ValueError:
                        pass
            rules.append(Rule(field, op, value))
        return cls(rules, "and")

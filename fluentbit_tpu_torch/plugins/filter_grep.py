"""filter_grep — keep/exclude records by regex on a record-accessor field.

The port's counterpart of ``fluentbit_tpu/plugins/filter_grep.py`` on the
decoded path. Reference: plugins/filter_grep/grep.c. Rules are
``Regex <field> <pattern>`` (keep) and ``Exclude <field> <pattern>``
pairs. Three evaluation modes (logical_op): legacy (first rule decides:
Regex-miss ⇒ EXCLUDE, Exclude-hit ⇒ EXCLUDE, Regex-hit ⇒ KEEP,
fallthrough ⇒ KEEP, grep.c:167-194), AND, OR (grep.c:250-284 — the
verdict uses the type of the *last examined* rule).

Execution: when every rule pattern compiles to a DFA, an append of at
least ``tpu_batch_records`` records stages its field values into one
``[R, B, L]`` batch and the engine's device runs the DFA program
(``ops.grep``: the CUDA kernel on a GPU, its plain torch version on the
CPU). Values longer than ``tpu_max_record_len`` and smaller appends take
the per-record regex, with identical semantics. There is no host
fallback for a device failure: it raises.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.config import ConfigMapEntry
from ..core.plugin import FilterPlugin, FilterResult, registry
from ..core.record_accessor import RecordAccessor
from ..ops.batch import assemble, bucket_size, staging
from ..regex import FlbRegex

LEGACY, AND, OR = "legacy", "AND", "OR"


def _to_text(v) -> Optional[str]:
    """Only string values are regex-matchable — the reference's
    flb_ra_key_regex_match returns no-match for every non-STR msgpack
    type (src/flb_ra_key.c:418)."""
    if isinstance(v, str):
        return v
    return None


class Rule:
    __slots__ = ("is_exclude", "ra", "pattern", "regex")

    def __init__(self, is_exclude: bool, field: str, pattern: str):
        self.is_exclude = is_exclude
        self.ra = RecordAccessor(field)
        self.pattern = pattern
        # Ruby-semantics engine; .dfa is the device-executable table when
        # the pattern is DFA-expressible
        self.regex = FlbRegex(pattern)

    @property
    def dfa(self):
        return self.regex.dfa

    def match(self, body: dict) -> bool:
        val = _to_text(self.ra.get(body))
        if val is None:
            return False
        return self.regex.match(val)


def legacy_keep(rules, body: dict) -> bool:
    """First-rule-decides verdict (grep.c:167-194): Exclude-hit ⇒ drop,
    Regex-miss ⇒ drop, Regex-hit ⇒ keep, fallthrough ⇒ keep."""
    for rule in rules:
        if rule.match(body):
            return rule.is_exclude is False
        if not rule.is_exclude:
            return False
    return True


def legacy_keep_mask(rules, mask: np.ndarray) -> np.ndarray:
    """Vectorized ``legacy_keep`` over a per-rule match matrix
    ``mask[R, B]`` → ``keep[B]``."""
    B = mask.shape[1]
    keep = np.ones(B, dtype=bool)
    undecided = np.ones(B, dtype=bool)
    for r, rule in enumerate(rules):
        m = mask[r]
        if rule.is_exclude:
            keep &= ~(undecided & m)  # Exclude-hit → drop
            undecided &= ~m
        else:
            # a Regex rule decides every still-undecided record
            keep = np.where(undecided, m, keep)
            break
    return keep


def parse_grep_rules(properties) -> List[Rule]:
    """Build the ordered rule list from regex/exclude properties
    (property order matters for legacy semantics)."""
    rules: List[Rule] = []
    for key, value in properties.items():
        lk = key.lower()
        if lk in ("regex", "exclude"):
            parts = value.split(None, 1) if isinstance(value, str) else list(value)
            if len(parts) != 2:
                raise ValueError(f"grep: invalid rule {value!r}")
            rules.append(Rule(lk == "exclude", parts[0], parts[1]))
    return rules


@registry.register
class GrepFilter(FilterPlugin):
    name = "grep"
    description = "keep/exclude records matching regex patterns"
    config_map = [
        ConfigMapEntry("regex", "slist", multiple=True, slist_max_split=1,
                       desc="keep rule: <field> <pattern>"),
        ConfigMapEntry("exclude", "slist", multiple=True, slist_max_split=1,
                       desc="exclude rule: <field> <pattern>"),
        ConfigMapEntry("logical_op", "str", default="legacy"),
        ConfigMapEntry("tpu_batch_records", "int", default=32,
                       desc="min records per append to use the device path"),
        ConfigMapEntry("tpu_max_record_len", "int", default=512,
                       desc="field byte length staged on device; longer "
                            "values resolve with the per-record regex"),
    ]

    def init(self, instance, engine) -> None:
        from ..ops.grep import program_for

        self.rules = parse_grep_rules(instance.properties)
        op = (self.logical_op or "legacy").lower()
        self.op = AND if op == "and" else OR if op == "or" else LEGACY
        if self.op != LEGACY and self.rules:
            kinds = {r.is_exclude for r in self.rules}
            if len(kinds) > 1:
                raise ValueError("grep: AND/OR mode cannot mix Regex and Exclude rules")
        self.device = engine.device
        #: host seconds of each device match (staging to verdict), the
        #: most recent appends only
        self.match_seconds: collections.deque = collections.deque(maxlen=4096)
        self._program = None
        if self.rules and all(r.dfa is not None for r in self.rules):
            self._program = program_for(
                tuple(r.pattern for r in self.rules), self.tpu_max_record_len,
                self.device)

    # -- verdicts (bit-exact vs grep.c) --

    def keep_record(self, body: dict) -> bool:
        if not self.rules:
            return True
        if self.op == LEGACY:
            return legacy_keep(self.rules, body)
        # AND/OR: compute 'found' with short-circuit, verdict by last rule's type
        found = False
        rule = self.rules[0]
        for rule in self.rules:
            found = rule.match(body)
            if self.op == OR and found:
                break
            if self.op == AND and not found:
                break
        if not rule.is_exclude:
            return found
        return not found

    def keep_mask(self, mask: np.ndarray) -> np.ndarray:
        """mask[R, B] per-rule match matrix → keep[B], same semantics as
        keep_record (grep.c verdict logic applied as vector ops)."""
        if self.op == LEGACY:
            return legacy_keep_mask(self.rules, mask)
        found = mask.any(axis=0) if self.op == OR else mask.all(axis=0)
        # AND/OR rules are all the same kind (enforced in init)
        return ~found if self.rules[0].is_exclude else found

    def _match_matrix_device(self, events: list) -> np.ndarray:
        """Stage field values into one [R, Bp, L] host batch (pinned for
        a CUDA device), run the DFA program on the device, resolve
        overflow rows with the regex. Returns mask[R, B] bool."""
        t0 = time.perf_counter()
        B = len(events)
        R = len(self.rules)
        L = self.tpu_max_record_len
        Bp = bucket_size(B, max_len=L)
        batch = staging((R, Bp, L), torch.uint8, self.device)
        lengths = staging((R, Bp), torch.int32, self.device)
        batch_np, lengths_np = batch.numpy(), lengths.numpy()
        # rules addressing the same field share one extraction + staging
        by_path: dict = {}
        for r, rule in enumerate(self.rules):
            by_path.setdefault(rule.ra.pattern, (rule.ra, []))[1].append(r)
        values: List[Optional[List[Optional[bytes]]]] = [None] * R
        overflow: List[List[int]] = [[] for _ in range(R)]
        for ra, idxs in by_path.values():
            vals: List[Optional[bytes]] = []
            for ev in events:
                v = _to_text(ra.get(ev.body))
                vals.append(v.encode("utf-8") if v is not None else None)
            r0 = idxs[0]
            staged = assemble(vals, L, Bp, out=(batch_np[r0], lengths_np[r0]))
            for r in idxs:
                if r != r0:
                    batch_np[r] = batch_np[r0]
                    lengths_np[r] = lengths_np[r0]
                values[r] = vals
                overflow[r] = staged.overflow
        mask = np.array(self._program.match(batch, lengths)[:, :B])
        for r, rule in enumerate(self.rules):
            for i in overflow[r]:
                mask[r, i] = rule.regex.match(values[r][i])
        self.match_seconds.append(time.perf_counter() - t0)
        return mask

    def filter(self, events: list, tag: str, engine) -> tuple:
        if (
            self._program is not None
            and len(events) >= self.tpu_batch_records
        ):
            keep = self.keep_mask(self._match_matrix_device(events))
            kept = [ev for ev, k in zip(events, keep) if k]
        else:
            kept = [ev for ev in events if self.keep_record(ev.body)]
        if len(kept) == len(events):
            return (FilterResult.NOTOUCH, events)
        return (FilterResult.MODIFIED, kept)

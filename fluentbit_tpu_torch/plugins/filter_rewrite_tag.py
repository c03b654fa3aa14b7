"""filter_rewrite_tag — re-tag records by regex rule and re-emit.

The port's counterpart of ``fluentbit_tpu/plugins/filter_rewrite_tag.py``.
Reference: plugins/filter_rewrite_tag/rewrite_tag.c.
Rules are ``Rule <$key> <regex> <new_tag_template> <keep>``; the FIRST
matching rule wins (process_record, :356-385); the new tag is composed by
the record-accessor template with access to regex captures ($0..$9),
$TAG, $TAG[n] and record fields (:393); the record is re-emitted under
the new tag through a per-instance hidden ``emitter`` input (:407,
created with alias ``emitter_for_<name>``, :245-260) and re-enters the
whole pipeline; the original is kept or dropped per the rule's keep flag
(:375). Records that re-enter from this filter's own emitter pass
untouched.

The raw path (``process_batch``, ``stateful_batch``; the reference's
filter_rewrite_tag.py:251-385): when every rule's key is a top-level
field and its regex compiles to a DFA, the engine hands the filter the
append's msgpack bytes. The host DFA twin (``native.grep_match``) gives
each record's rule verdicts in one walk of the chunk, on any device, as
in the reference; the first matching rule wins. A chunk from the
filter's own emitter passes untouched. Rules whose template reads the
tag alone render once per chunk; the others decode only their records'
spans and take the per-record rule walk for the captures. Groups are
emitted in first-seen order, each one emitter append of the records'
byte spans (``native.compact``), and the records a rule does not keep
are cut from the chunk the same way. An error of a new tag's chain
keeps that group's originals, as the reference degrades it, unless it
is a RuntimeError (a device, launch or build error), which fails the
append.

The decoded path: when every rule regex compiles to a DFA, an append of
at least ``tpu_batch_records`` records stages the rules' field values
into one ``[R, B, L]`` batch and the engine's device runs the DFA
program (``ops.grep``: on CUDA the hand-written kernels — for short
literal rules such as config 3's, three per-k child programs through
the assoc kernel K4 — on the CPU their plain torch versions). Values
longer than ``tpu_max_record_len`` and smaller appends take the
per-record regex, with identical semantics. For each matched record the
winning rule's regex gives the captures on the host, as in the
reference. There is no host fallback for a device failure: it raises.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..codec.events import decode_events, reencode_event
from ..core.config import ConfigMapEntry, parse_bool
from ..core.plugin import FilterPlugin, FilterResult, registry
from ..core.record_accessor import RecordAccessor, Template
from ..ops.batch import assemble, bucket_size, staging
from ..ops.device import DEVICE_ERRORS
from ..ops.grep import program_for
from ..regex import FlbRegex

log = logging.getLogger("flb")


def _to_text(v) -> Optional[str]:
    """String values only — flb_ra_key_regex_match returns no-match for
    non-STR msgpack types (src/flb_ra_key.c:418)."""
    if isinstance(v, str):
        return v
    return None


class RewriteRule:
    __slots__ = ("ra", "regex", "template", "keep")

    def __init__(self, key: str, pattern: str, new_tag: str, keep):
        self.ra = RecordAccessor(key)
        self.regex = FlbRegex(pattern)
        self.template = Template(new_tag)
        self.keep = parse_bool(keep)


@registry.register
class RewriteTagFilter(FilterPlugin):
    name = "rewrite_tag"
    description = "re-tag records by regex and re-emit through the pipeline"
    # the batch hook emits: a decline after it must not re-run it
    stateful_batch = True
    config_map = [
        ConfigMapEntry("rule", "slist", multiple=True, slist_max_split=3,
                       desc="<$key> <regex> <new_tag> <keep>"),
        ConfigMapEntry("emitter_name", "str"),
        ConfigMapEntry("emitter_storage.type", "str", default="memory",
                       desc="the hidden emitter's storage.type"),
        ConfigMapEntry("emitter_mem_buf_limit", "str", default="10M",
                       desc="the hidden emitter's mem_buf_limit: over it "
                            "a group is refused and its originals kept"),
        ConfigMapEntry("tpu.enable", "bool", default=True),
        ConfigMapEntry("tpu_batch_records", "int", default=64),
        ConfigMapEntry("tpu_max_record_len", "int", default=512),
    ]

    def init(self, instance, engine) -> None:
        if not self.rule:
            raise ValueError("rewrite_tag requires at least one Rule")
        self.rules: List[RewriteRule] = []
        for parts in self.rule:
            if len(parts) != 4:
                raise ValueError(f"rewrite_tag: invalid rule {parts!r}")
            self.rules.append(RewriteRule(*parts))
        name = self.emitter_name or f"emitter_for_{instance.display_name}"
        # the emitter's buffer limit and storage (reference :93-100): over
        # the limit its append returns -1 and the group's originals stay
        self.emitter = engine.hidden_input(
            "emitter", alias=name, mem_buf_limit=self.emitter_mem_buf_limit,
            **{"storage.type": self.emitter_storage_type}).plugin
        self._m_emit = engine.m_filter_emit
        self.device = engine.device
        #: host seconds of each device-path append: (staging, launch +
        #: readback, overflow rows' regex, captures + render + emit), the
        #: most recent appends only
        self.step_seconds: collections.deque = collections.deque(maxlen=4096)
        self._program = None
        if self.tpu_enable and all(r.regex.dfa is not None
                                   for r in self.rules):
            self._program = program_for(
                tuple(r.regex.pattern for r in self.rules),
                self.tpu_max_record_len, self.device)
        # the raw path's tables: every rule on a top-level key, with a DFA
        self._batch_tables = None
        self._batch_static = [r.template.static_for_tag for r in self.rules]
        if all(r.regex.dfa is not None and not r.ra.parts
               for r in self.rules):
            self._batch_tables = native.GrepTables(
                [(r.ra.head.encode("utf-8"), r.regex.dfa)
                 for r in self.rules])

    # -- matching --

    def _values_matrix(self, events: list) -> List[List[Optional[str]]]:
        """Each rule's field value per record (None: missing or not a
        string); rules addressing the same field share one list."""
        by_path: dict = {}
        vals: List[List[Optional[str]]] = []
        for rule in self.rules:
            row = by_path.get(rule.ra.pattern)
            if row is None:
                ra = rule.ra
                row = by_path[ra.pattern] = [
                    _to_text(ra.get(ev.body)) if isinstance(ev.body, dict)
                    else None
                    for ev in events
                ]
            vals.append(row)
        return vals

    def _stage(self, values):
        """One pinned [R, Bp, L] host batch of the field values (rules
        sharing a field share one assembly) → (batch, lengths, each
        rule's overflow rows)."""
        R = len(self.rules)
        L = self.tpu_max_record_len
        Bp = bucket_size(len(values[0]), max_len=L)
        batch = staging((R, Bp, L), torch.uint8, self.device)
        lengths = staging((R, Bp), torch.int32, self.device)
        batch_np, lengths_np = batch.numpy(), lengths.numpy()
        first: dict = {}  # id(values row) -> (rule row, its overflow)
        overflow: List[List[int]] = []
        for r in range(R):
            got = first.get(id(values[r]))
            if got is None:
                staged = assemble(
                    [v.encode("utf-8") if v is not None else None
                     for v in values[r]],
                    L, Bp, out=(batch_np[r], lengths_np[r]))
                got = first[id(values[r])] = (r, staged.overflow)
            else:
                batch_np[r] = batch_np[got[0]]
                lengths_np[r] = lengths_np[got[0]]
            overflow.append(got[1])
        return batch, lengths, overflow

    def _device_match_matrix(self, staged, n: int) -> np.ndarray:
        """mask[R, n]: rule r's regex matches record b's field value, by
        the DFA program on the device over ``_stage``'s batch (overflow
        rows read False until ``_overflow_regex``)."""
        batch, lengths, _ = staged
        return np.array(self._program.match(batch, lengths)[:, :n])

    def _overflow_regex(self, mask: np.ndarray, values, overflow) -> None:
        """Values longer than tpu_max_record_len: the per-record regex."""
        for r, rows in enumerate(overflow):
            rx = self.rules[r].regex
            for i in rows:
                mask[r, i] = rx.match(values[r][i])

    def _first_match_cpu(self, body):
        """Per-record rule scan, break on first match (process_record)."""
        if not isinstance(body, dict):
            return None, None
        for rule in self.rules:
            v = _to_text(rule.ra.get(body))
            if v is None:
                continue
            caps = rule.regex.search_captures(v)
            if caps is not None:
                return rule, caps
        return None, None

    # -- the raw path (engine process_batch hook) --

    def can_process_batch(self) -> bool:
        return self._batch_tables is not None

    def process_batch(self, chunk):
        # the own-emitter guard at chunk granularity: re-emitted records
        # pass untouched
        if chunk.src is self.emitter.instance:
            n = chunk.n
            if n is None:
                n = native.count_records(chunk.data)
                if n is None:
                    return None
            return (n, chunk.data, n)
        tag = chunk.tag
        data = chunk.as_bytes()
        got = native.grep_match(data, self._batch_tables, n_hint=chunk.n)
        if got is None:
            return None
        mask, offsets, n = got
        if n == 0:
            return (0, data, 0)
        any_match = mask.any(axis=0)
        if not any_match.any():
            return (n, data, n)
        # first matching rule per record (process_record's break)
        first = np.where(any_match, mask.argmax(axis=0), -1)
        # new tag -> [members, members not kept, first member]: groups
        # emit in first-seen order, as the decoded path's pending dict
        groups: dict = {}

        def group(new_tag, b):
            ent = groups.get(new_tag)
            if ent is None:
                ent = groups[new_tag] = [np.zeros(n, dtype=bool),
                                         np.zeros(n, dtype=bool), b]
            ent[2] = min(ent[2], b)
            return ent

        need_record: List[int] = []
        for r, rule in enumerate(self.rules):
            idx = np.nonzero(first == r)[0]
            if len(idx) == 0:
                continue
            if not self._batch_static[r]:
                need_record.extend(idx.tolist())
                continue
            new_tag = rule.template.render(tag=tag)
            if not new_tag:
                continue  # a failed translation keeps the record
            ent = group(new_tag, int(idx[0]))
            ent[0][idx] = True
            if not rule.keep:
                ent[1][idx] = True
        # rules that need captures or record fields: decode just those
        # records' spans and walk the rules the mask admits
        for b in need_record:
            ev = decode_events(data[offsets[b]: offsets[b + 1]])[0]
            rule = captures = None
            for r, rl in enumerate(self.rules):
                if not mask[r, b]:
                    continue
                v = _to_text(rl.ra.get(ev.body)) \
                    if isinstance(ev.body, dict) else None
                if v is None:
                    continue
                captures = rl.regex.search_captures(v)
                if captures is not None:
                    rule = rl
                    break
            if rule is None:
                continue
            new_tag = rule.template.render(record=ev.body, tag=tag,
                                           captures=captures)
            if not new_tag:
                continue
            ent = group(new_tag, b)
            ent[0][b] = True
            if not rule.keep:
                ent[1][b] = True
        keep = np.ones(n, dtype=bool)
        emitted = 0
        for new_tag, (members, drop, _first) in sorted(
                groups.items(), key=lambda kv: kv[1][2]):
            count = int(members.sum())
            payload = native.compact(data, offsets, members)
            if not self._emit_group(new_tag, payload, count):
                continue
            emitted += count
            keep &= ~drop
        if emitted:
            self._m_emit.inc(emitted, (self.instance.display_name,))
        n_keep = int(keep.sum())
        if n_keep == n:
            return (n, data, n)
        if n_keep == 0:
            return (0, b"", n)
        return (n_keep, native.compact(data, offsets, keep), n)

    def _emit_group(self, new_tag: str, payload: bytes, count: int) -> bool:
        """One new tag's records into the emitter; they re-enter the
        pipeline under the new tag. False when the emitter refused them
        (-1: its buffer is over ``emitter_mem_buf_limit``) or that tag's
        chain raised: the originals of this group are kept, as the
        reference keeps them (:353-368, :444-448). A device error
        raises."""
        try:
            rc = self.emitter.add_record(new_tag, payload, count)
        except DEVICE_ERRORS:
            raise
        except Exception:
            log.exception("rewrite_tag emitter append failed for tag %r; "
                          "originals kept", new_tag)
            return False
        return rc >= 0

    def filter(self, events: list, tag: str, engine) -> tuple:
        # records re-entering from our OWN emitter are never re-matched
        # (the i_ins == ctx->ins_emitter check, rewrite_tag.c): without
        # it a rule whose rewritten record still matches recurses
        if engine._ingest_src is self.emitter.instance:
            return (FilterResult.NOTOUCH, events)
        use_device = (self._program is not None
                      and len(events) >= self.tpu_batch_records)
        if use_device:
            t0 = time.perf_counter()
            values = self._values_matrix(events)
            staged = self._stage(values)
            t1 = time.perf_counter()
            mask = self._device_match_matrix(staged, len(events))
            t2 = time.perf_counter()
            self._overflow_regex(mask, values, staged[2])
            t3 = time.perf_counter()
            hits = mask.T.tolist()
        keep = [True] * len(events)
        # one emitter append per rendered tag, in first-seen order
        pending: dict = {}  # new_tag → [(index, raw)]
        for b, ev in enumerate(events):
            if use_device:
                rule = captures = None
                for r, hit in enumerate(hits[b]):
                    if hit:
                        captures = self.rules[r].regex.search_captures(
                            values[r][b])
                        if captures is not None:
                            rule = self.rules[r]
                            break
            else:
                rule, captures = self._first_match_cpu(ev.body)
            if rule is None:
                continue
            # an empty rendering is a failed translation: keep the record
            new_tag = rule.template.render(record=ev.body, tag=tag,
                                           captures=captures)
            if not new_tag:
                continue
            raw = ev.raw if ev.raw is not None else reencode_event(ev)
            pending.setdefault(new_tag, []).append((b, raw))
            if not rule.keep:
                keep[b] = False
        emitted = 0
        for new_tag, items in pending.items():
            if not self._emit_group(new_tag,
                                    b"".join(raw for _, raw in items),
                                    len(items)):
                for b, _ in items:
                    keep[b] = True
                continue
            emitted += len(items)
        if emitted:
            self._m_emit.inc(emitted, (self.instance.display_name,))
        if use_device:
            self.step_seconds.append((t1 - t0, t2 - t1, t3 - t2,
                                      time.perf_counter() - t3))
        if all(keep):
            return (FilterResult.NOTOUCH, events)
        kept = [ev for b, ev in enumerate(events) if keep[b]]
        return (FilterResult.MODIFIED, kept)

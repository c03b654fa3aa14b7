"""filter_parser — apply a named parser to a record field.

The port's counterpart of ``fluentbit_tpu/plugins/filter_parser.py``.
Reference: plugins/filter_parser/filter_parser.c. For
each record, look up ``key_name`` (or a record-accessor path when it
starts with ``$``, :122-126), run the configured parsers in order on its
string value (:268-303); on first success the parsed map replaces the
body, ``reserve_data`` appends the other original fields (:237),
``preserve_key`` keeps the parsed source key (:238-240); a parsed
non-zero time overrides the record timestamp; on failure the record
passes through untouched. With an RA path, the reference keeps ALL
original fields under reserve_data (the matched kv is not identified in
that branch) — mirrored here.

Divergence note (the reference package's, kept): the reference appends
reserved originals after the parsed fields in the msgpack map, allowing
duplicate keys (first wins on record-accessor lookups). Python dicts
cannot hold duplicates, so on key collision the parsed value wins — the
same value a reference RA lookup would return.

Device prefilter: with a single DFA-expressible regex parser, an append
of at least ``tpu_batch_records`` records stages the field values into
one pinned ``[1, B, L]`` batch and the engine's device runs the match
decision (``ops.grep``: on CUDA the hand-written kernel — K3, the scan,
for a program of more than 64 states such as apache2 — on the CPU its
plain torch version). Capture extraction runs on the host only for the
records the mask admits; values longer than ``tpu_max_record_len`` take
the regex. There is no host fallback for a device failure: it raises.
``step_seconds`` holds, per device append, (values + staging, launch +
readback, the overflow rows' regex, parse + apply).

The raw path (``process_batch``, ``thread_safe_raw``; the reference's
filter_parser.py:125-190 and :244-324) has two modes (``_batch_mode``).
"regex": with a single regex parser that compiles to a DFA and a plain
``key_name``, the host DFA twin (``native.grep_match``) gives the match
mask in one walk of the chunk, on any device, as in the reference; the
chunk then decodes and only the records the mask admits run the regex
with captures (a ``bin`` value never stages, and always parses). If the
walk and the decode count different records, the hook declines. "json":
with a single json parser on a plain ``key_name``, no ``time_format``,
no ``reserve_data`` and no ``preserve_key``, the event codec extension's
``parser_json_batch`` transcodes the whole chunk (the bytes ``json.loads``
→ ``pack_event`` would give a record); its ``FallbackError`` (a record
outside the set it reproduces exactly) declines, and the decoded path
runs the chunk.

``tpu_approx`` / ``tpu_approx_states`` are accepted; a value other than
the default raises ValueError (the approximate DFA reduction is not
ported).
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional

import numpy as np
import torch

from .. import failpoints as _fp
from .. import native
from ..codec import _native_codec
from ..codec.events import LogEvent, decode_events, reencode_event
from ..core.config import ConfigMapEntry
from ..core.plugin import FilterPlugin, FilterResult, registry
from ..core.record_accessor import RecordAccessor
from ..ops.batch import assemble, bucket_size, staging


def _to_str(v) -> Optional[str]:
    if isinstance(v, str):
        return v
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return None  # msgpackobj2char: only string/bin values are parseable


@registry.register
class ParserFilter(FilterPlugin):
    name = "parser"
    description = "parse a field with a named parser"
    # the batch hook keeps no state across appends: chains of these run
    # under the input's own lock
    thread_safe_raw = True
    config_map = [
        ConfigMapEntry("key_name", "str", desc="field to parse"),
        ConfigMapEntry("parser", "str", multiple=True,
                       desc="parser name (may repeat; tried in order)"),
        ConfigMapEntry("reserve_data", "bool", default=False,
                       desc="keep the other original fields"),
        ConfigMapEntry("preserve_key", "bool", default=False,
                       desc="keep the parsed source key"),
        ConfigMapEntry("tpu.enable", "bool", default=True,
                       desc="device match prefilter when the parser allows"),
        ConfigMapEntry("tpu_batch_records", "int", default=64),
        ConfigMapEntry("tpu_max_record_len", "int", default=512),
        ConfigMapEntry("tpu_approx", "bool", default=False,
                       desc="not ported: only the default is accepted"),
        ConfigMapEntry("tpu_approx_states", "int", default=64,
                       desc="not ported: only the default is accepted"),
    ]

    def init(self, instance, engine) -> None:
        from ..ops.grep import program_for

        if not self.key_name:
            raise ValueError("parser filter requires Key_Name")
        if not self.parser:
            raise ValueError("parser filter requires at least one Parser")
        if self.tpu_approx or self.tpu_approx_states != 64:
            raise ValueError("parser: tpu_approx / tpu_approx_states are "
                             "not supported by this port yet")
        self.parsers = []
        for pname in self.parser:
            p = engine.parsers.get(pname)
            if p is None:
                raise ValueError(f"parser filter: unknown parser {pname!r}")
            self.parsers.append(p)
        self.ra: Optional[RecordAccessor] = None
        if self.key_name.startswith("$"):
            self.ra = RecordAccessor(self.key_name)
        self.device = engine.device
        #: host seconds per device append: (values + staging, launch +
        #: readback, overflow regex, parse + apply), the most recent only
        self.step_seconds: collections.deque = collections.deque(maxlen=4096)
        # device prefilter: single regex parser with a compiled DFA
        self._prefilter = None
        if (
            self.tpu_enable
            and len(self.parsers) == 1
            and self.parsers[0].fmt == "regex"
            and self.parsers[0].regex.dfa is not None
        ):
            self._prefilter = program_for(
                (self.parsers[0].regex.pattern,), self.tpu_max_record_len,
                self.device)
        # the raw path: "json" transcodes the chunk in the codec
        # extension, "regex" masks with the host DFA twin; one parser on
        # a plain key either way
        self._batch_mode = None
        self._batch_key = self.key_name.encode("utf-8")
        self._batch_tables = None
        p0 = self.parsers[0]
        if self.ra is None and len(self.parsers) == 1:
            if (p0.fmt == "json" and p0.time_format is None
                    and not self.reserve_data and not self.preserve_key):
                self._batch_mode = "json"
            elif p0.fmt == "regex" and p0.regex.dfa is not None:
                self._batch_tables = native.GrepTables(
                    [(self._batch_key, p0.regex.dfa)])
                self._batch_mode = "regex"

    # -- per-record semantics --

    def _get_value(self, body: dict) -> Optional[str]:
        if self.ra is not None:
            return _to_str(self.ra.get(body))
        v = body.get(self.key_name) if isinstance(body, dict) else None
        return _to_str(v)

    def _apply(self, ev: LogEvent, value: str) -> Optional[LogEvent]:
        """Try the parsers in order; build the replacement event."""
        for p in self.parsers:
            got = p.do(value)
            if got is None:
                continue
            fields, ts = got
            body = dict(fields)
            if self.reserve_data:
                for k, v in ev.body.items():
                    if (
                        self.ra is None
                        and k == self.key_name
                        and not self.preserve_key
                    ):
                        continue
                    body.setdefault(k, v)
            elif self.preserve_key and self.ra is None:
                body.setdefault(self.key_name, ev.body.get(self.key_name))
            new_ts = ev.timestamp if (ts is None or ts == 0) else ts
            return LogEvent(
                timestamp=new_ts, body=body, metadata=ev.metadata, raw=None
            )
        return None

    def _device_match_mask(self, values: List[Optional[str]]):
        """Vectorized match prefilter: the staged values through the
        device program, overflow rows through the regex. Returns the
        mask and the ``perf_counter`` stamps after staging, readback and
        the overflow regex."""
        vals = [v.encode("utf-8") if isinstance(v, str) else None
                for v in values]
        L = self.tpu_max_record_len
        Bp = bucket_size(len(vals), max_len=L)
        batch = staging((1, Bp, L), torch.uint8, self.device)
        lengths = staging((1, Bp), torch.int32, self.device)
        staged = assemble(vals, L, Bp,
                          out=(batch.numpy()[0], lengths.numpy()[0]))
        t_staged = time.perf_counter()
        mask = np.array(self._prefilter.match(batch, lengths)[0, :len(vals)])
        t_read = time.perf_counter()
        rx = self.parsers[0].regex
        for i in staged.overflow:
            mask[i] = rx.match(vals[i])
        return mask, (t_staged, t_read, time.perf_counter())

    # -- the raw path (engine process_batch hook) --

    def can_process_batch(self) -> bool:
        return self._batch_mode is not None

    def process_batch(self, chunk):
        if self._batch_mode == "json":
            return self._process_batch_json(chunk)
        return self._process_batch_regex(chunk)

    def _process_batch_json(self, chunk):
        """The whole chunk's JSON fields transcoded in the extension,
        byte-equal to ``json.loads`` → ``pack_event`` a record. Its
        ``FallbackError`` (a legacy or non-canonical record, a ``bin``
        value, an integer past 64 bits, a lone surrogate, invalid UTF-8
        in the text) declines: the decoded path gives that chunk's
        defined result. The failpoint site ``codec.fallback`` forces the
        decline (reference :260-267)."""
        if _fp.ACTIVE:
            try:
                _fp.fire("codec.fallback")
            except _fp.FailpointError:
                return None
        mod = _native_codec.load()
        data = chunk.as_bytes()
        try:
            out, n, parsed = mod.parser_json_batch(data, self._batch_key)
        except mod.FallbackError:
            return None
        if parsed == 0:
            return (n, data, n)  # nothing parsed: the bytes as they came
        return (n, out, n)

    def _process_batch_regex(self, chunk):
        data = chunk.as_bytes()
        got = native.grep_match(data, self._batch_tables, n_hint=chunk.n)
        if got is None:
            return None
        mask, _offsets, n = got
        row = mask[0]
        events = decode_events(data)
        if len(events) != n:
            return None  # the walk and the decode disagree: decline
        out = bytearray()
        modified = False
        for i, ev in enumerate(events):
            v = None
            body = ev.body
            if isinstance(body, dict):
                raw_v = body.get(self.key_name)
                if isinstance(raw_v, bytes):
                    # a bin value never stages; it decodes and parses
                    v = raw_v.decode("utf-8", "replace")
                elif isinstance(raw_v, str) and row[i]:
                    v = raw_v
            new_ev = self._apply(ev, v) if v is not None else None
            if new_ev is None:
                out += ev.raw if ev.raw is not None else reencode_event(ev)
            else:
                out += reencode_event(new_ev)
                modified = True
        if not modified:
            return (n, data, n)
        return (n, bytes(out), n)

    def filter(self, events: list, tag: str, engine) -> tuple:
        t0 = time.perf_counter()
        values = [
            self._get_value(ev.body) if isinstance(ev.body, dict) else None
            for ev in events
        ]
        mask = stamps = None
        if (self._prefilter is not None
                and len(events) >= self.tpu_batch_records):
            mask, stamps = self._device_match_mask(values)
        out: List[LogEvent] = []
        modified = False
        for i, ev in enumerate(events):
            v = values[i]
            if v is None or (mask is not None and not mask[i]):
                out.append(ev)
                continue
            new_ev = self._apply(ev, v)
            if new_ev is None:
                out.append(ev)
            else:
                out.append(new_ev)
                modified = True
        if stamps is not None:
            t_staged, t_read, t_regex = stamps
            self.step_seconds.append((t_staged - t0, t_read - t_staged,
                                      t_regex - t_read,
                                      time.perf_counter() - t_regex))
        if not modified:
            return (FilterResult.NOTOUCH, events)
        return (FilterResult.MODIFIED, out)

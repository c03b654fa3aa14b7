"""filter_grep — keep/exclude records by regex on a record-accessor field.

The port's counterpart of ``fluentbit_tpu/plugins/filter_grep.py``.
Reference: plugins/filter_grep/grep.c. Rules are
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

The raw chunk path (``can_filter_raw`` / ``filter_raw``, the engine's
first choice when every filter of a tag can take it) matches straight
off the append's msgpack bytes: the host codec (``fluentbit_tpu_torch.
native``) stages each rule's top-level field into the batch, segments of
``FBTPU_SEGMENT_RECORDS`` records (4096) are double-buffered (staging of
segment N+1 overlaps the kernel of segment N), overflow rows are decoded
and re-checked on the host, and the survivors are copied as byte spans,
with no decode and no re-encode. Over a mesh (``FBTPU_MESH``) each
segment launches through the sharded dispatch (K5, ``ops.grep``).

The raw path is ``thread_safe_raw`` (the reference's
filter_grep.py:187-190): its rules and program are fixed after
``init``, it stages into buffers of its own per call, its totals go to
per-thread shards (``ShardedTimings``) and the launch counters take a
lock, so the engine runs it for several inputs at once under each
input's own lock.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..codec.events import decode_events
from ..core.config import ConfigMapEntry
from ..core.plugin import FilterPlugin, FilterResult, registry
from ..core.record_accessor import RecordAccessor
from ..ops.batch import assemble, bucket_size, len_bucket, staging
from ..regex import FlbRegex

LEGACY, AND, OR = "legacy", "AND", "OR"


class _RawDecline(Exception):
    """A segment's staging cannot serve this chunk: unwind the pipeline
    and decline to the decoded path."""


class ShardedTimings:
    """The raw path's totals in per-thread shards (the reference's
    ``ShardedTimings``, filter_grep.py:44-95): an add goes to the calling
    thread's own dict, with no lock, and a read sums the shards. The
    mapping interface stays: ``timings["extract_s"]`` reads the sum, and
    an item write is the reset, storing the value into every shard (so
    it means something for 0 only)."""

    _KEYS = ("extract_s", "kernel_s", "overflow_s", "compact_s", "records")

    def __init__(self) -> None:
        self._tls = threading.local()
        self._shards: list = []
        self._reg_lock = threading.Lock()  # shard registration (cold)

    def _shard(self) -> dict:
        d = getattr(self._tls, "d", None)
        if d is None:
            d = dict.fromkeys(self._KEYS, 0)
            with self._reg_lock:
                self._shards.append(d)
            self._tls.d = d
        return d

    def add(self, key: str, value) -> None:
        self._shard()[key] += value

    def __iter__(self):
        return iter(self._KEYS)

    def __contains__(self, key) -> bool:
        return key in self._KEYS

    def __getitem__(self, key):
        with self._reg_lock:
            shards = list(self._shards)
        return sum(d[key] for d in shards)

    def __setitem__(self, key, value) -> None:
        with self._reg_lock:
            shards = list(self._shards)
        for d in shards:
            d[key] = value


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
    # the raw path keeps no state across appends beyond its sharded
    # totals and the locked launch counters: inputs run it in parallel
    thread_safe_raw = True
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
        #: (staging, launch + readback, overflow regex) host seconds of
        #: each device match on the decoded path, the most recent appends
        #: only
        self.match_seconds: collections.deque = collections.deque(maxlen=4096)
        #: the raw path's totals, summed over the threads that appended:
        #: host seconds of field staging (``extract_s``), of launches and
        #: readbacks beyond the staging (``kernel_s``), of the overflow
        #: rows' decode and regex (``overflow_s``) and of survivor
        #: compaction (``compact_s``), and the records it matched
        self.raw_timings = ShardedTimings()
        #: (extract, kernel, overflow, compact) seconds of each raw
        #: append, the most recent appends only (a deque's append is
        #: atomic)
        self.raw_step_seconds: collections.deque = collections.deque(
            maxlen=4096)
        #: (records, segments) of each raw append, the most recent only:
        #: one kernel launch a segment and rule group
        self.raw_appends: collections.deque = collections.deque(maxlen=4096)
        self._mesh = self._mesh_resolved = None
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
        t1 = time.perf_counter()
        mask = np.array(self._program.match(batch, lengths)[:, :B])
        t2 = time.perf_counter()
        for r, rule in enumerate(self.rules):
            for i in overflow[r]:
                mask[r, i] = rule.regex.match(values[r][i])
        t3 = time.perf_counter()
        self.match_seconds.append((t1 - t0, t2 - t1, t3 - t2))
        return mask

    # -- the raw chunk path (no decode) --

    def _grep_mesh(self):
        """The mesh the raw path shards across, or None, resolved once
        from ``FBTPU_MESH``: "off"/"0" never builds one; "on"/"1"/"force"
        builds one over the visible CUDA devices; "auto" (the default)
        does so only when the engine's device is CUDA. ``build_mesh``
        returns None below two devices, so one card never shards."""
        if self._mesh_resolved is None:
            from ..ops.mesh import build_mesh

            mode = os.environ.get("FBTPU_MESH", "auto").lower()
            if self._program is None or mode in ("0", "off"):
                self._mesh = None
            elif mode in ("1", "on", "force"):
                self._mesh = build_mesh()
            else:
                self._mesh = (build_mesh() if self.device.type == "cuda"
                              else None)
            self._mesh_resolved = True
        return self._mesh

    def can_filter_raw(self) -> bool:
        """True when matching can run straight off chunk bytes: every
        rule compiles to a DFA and addresses a top-level key (a nested
        accessor declines), and the host codec is built (it raises if it
        cannot be)."""
        from .. import native

        return (self._program is not None and bool(self.rules)
                and all(not r.ra.parts for r in self.rules)
                and native.available())

    def filter_raw(self, data, tag: str, engine, n_records=None):
        """Raw chunk bytes → device verdicts → survivors as byte spans.
        Returns ``(n_kept, new_data, n_records)``, or None to decline
        (fewer than ``tpu_batch_records`` records, or a buffer the codec
        cannot stage): the engine then runs the decoded path. Kept
        records are byte-identical (grep.c:286-392). A failed build,
        launch or readback raises."""
        from .. import native

        if n_records is not None and n_records < self.tpu_batch_records:
            return None
        tm = self.raw_timings
        steps = [0.0, 0.0, 0.0, 0]
        got = self._device_match_raw(data, n_records, mesh=self._grep_mesh(),
                                     steps=steps)
        if got is None:
            return None
        mask, offsets, n = got
        tm.add("records", n)
        keep = self.keep_mask(mask)
        n_keep = int(keep.sum())
        compact_s = 0.0
        if n_keep == n:
            out = data
        elif n_keep == 0:
            out = b""
        else:
            t0 = time.perf_counter()
            out = native.compact(data, offsets[: n + 1], keep)
            compact_s = time.perf_counter() - t0
            if out is None:
                raise RuntimeError("grep: compact found a record span "
                                   "outside the chunk")
            tm.add("compact_s", compact_s)
        self.raw_step_seconds.append((*steps[:3], compact_s))
        self.raw_appends.append((n, steps[3]))
        return (n_keep, out, n)

    def _device_match_raw(self, data, n_records, mesh=None, steps=None):
        """Device matching straight off chunk bytes, double-buffered.

        The chunk's records split into segments of
        ``FBTPU_SEGMENT_RECORDS`` (4096); the host codec stages segment
        N+1's fields while segment N's kernel runs
        (``core.chunk_batch.double_buffered``: the launch returns a
        device tensor, its readback runs one segment behind). Each
        segment stages into pinned buffers of its own, rows left
        unzeroed and lengths at -1 for pad rows.

        Without ``mesh`` a segment stages at the row width of its longest
        value (``len_bucket``) and launches ``dispatch``; with one, it
        stages at ``tpu_max_record_len`` with the rows a multiple of the
        shard count and launches ``dispatch_mesh(..., with_counts=
        False)``. Overflow rows (-2) are decoded and re-checked with the
        regex on the host. Returns ``(mask bool [R, n], offsets[n+1],
        n)``, or None to decline; adds the call's extract, kernel and
        overflow seconds to ``raw_timings`` and writes them, and the
        number of segments, into ``steps`` (a list of four) when
        given."""
        from .. import native
        from ..core.chunk_batch import double_buffered, segment_bounds

        if not isinstance(data, bytes):
            data = bytes(data)
        # a full segment is a bucket_size rung exactly: zero pad rows
        seg = int(os.environ.get("FBTPU_SEGMENT_RECORDS", "4096"))
        n = n_records
        offsets = None
        if n is None or n > seg:
            # segments (or an unknown count) need the boundaries first; a
            # one-segment chunk takes them from its staging walk
            offsets = native.scan_offsets(data)
            if offsets is None:
                return None
            n = len(offsets) - 1
        if n < self.tpu_batch_records:
            return None
        by_key: dict = {}
        for r, rule in enumerate(self.rules):
            by_key.setdefault(rule.ra.head.encode("utf-8"), []).append(r)
        R = len(self.rules)
        Lmax = self.tpu_max_record_len
        bounds = segment_bounds(n, seg)
        multi = len(bounds) > 1
        n_dev = mesh.size if mesh is not None else 1
        offs_box = [offsets]
        extract_s = [0.0]
        lens_parts: list = []
        cnts: list = []

        def stage_key(span, key, rows, lens, cnt):
            want_offs = offs_box[0] is None
            offs = np.empty(cnt + 1, dtype=np.int64) if want_offs else None
            count = native.stage_field_into(span, key, rows, lens,
                                            n_hint=cnt, offsets_out=offs)
            if count != cnt:
                raise _RawDecline
            if want_offs:
                offs_box[0] = offs

        def stages():
            for s, e in bounds:
                t0 = time.perf_counter()
                cnt = e - s
                span = (data if offs_box[0] is None
                        else data[offs_box[0][s]: offs_box[0][e]])
                if mesh is not None:
                    # one width for every segment, rows a multiple of the
                    # shards; staged straight into the transfer matrix
                    Bp = bucket_size(seg if multi else cnt, max_len=Lmax,
                                     multiple_of=n_dev)
                    batch = staging((R, Bp, Lmax), torch.uint8, self.device,
                                    fill=None)
                    lengths = staging((R, Bp), torch.int32, self.device,
                                      fill=-1)
                    b_np, l_np = batch.numpy(), lengths.numpy()
                    for key, idxs in by_key.items():
                        r0 = idxs[0]
                        stage_key(span, key, b_np[r0], l_np[r0], cnt)
                        for r in idxs[1:]:
                            b_np[r, :cnt] = b_np[r0, :cnt]
                            l_np[r, :cnt] = l_np[r0, :cnt]
                else:
                    staged = {}
                    longest = 1
                    for key in by_key:
                        wide = np.empty((cnt, Lmax), dtype=np.uint8)
                        wlen = np.full((cnt,), -1, dtype=np.int32)
                        stage_key(span, key, wide, wlen, cnt)
                        staged[key] = (wide, wlen)
                        longest = max(longest, int(wlen.max()) if cnt else 0)
                    # the walk is sequential in L: stage at the longest
                    # value's bucket
                    width = len_bucket(longest, Lmax)
                    Bp = bucket_size(seg if multi else cnt, max_len=width)
                    batch = staging((R, Bp, width), torch.uint8, self.device,
                                    fill=None)
                    lengths = staging((R, Bp), torch.int32, self.device,
                                      fill=-1)
                    b_np, l_np = batch.numpy(), lengths.numpy()
                    for key, idxs in by_key.items():
                        wide, wlen = staged[key]
                        for r in idxs:
                            b_np[r, :cnt] = wide[:, :width]
                            l_np[r, :cnt] = wlen
                extract_s[0] += time.perf_counter() - t0
                yield batch, lengths, cnt

        def dispatch(item):
            batch, lengths, cnt = item
            lens_parts.append(lengths.numpy()[:, :cnt])
            cnts.append(cnt)
            if mesh is not None:
                return self._program.dispatch_mesh(
                    mesh, batch, lengths, with_counts=False)[0]
            return self._program.dispatch(batch, lengths)

        t_all = time.perf_counter()
        try:
            masks = double_buffered(stages(), dispatch)
        except _RawDecline:
            return None
        wall = time.perf_counter() - t_all
        kernel_s = max(wall - extract_s[0], 0.0)
        tm = self.raw_timings
        tm.add("extract_s", extract_s[0])
        tm.add("kernel_s", kernel_s)
        offsets = offs_box[0]
        mask = np.concatenate([m[:, :c] for m, c in zip(masks, cnts)], axis=1)
        lengths = np.concatenate(lens_parts, axis=1)
        # overflow rows (-2): decode just those records on the host
        t0 = time.perf_counter()
        for b_idx in np.unique(np.nonzero(lengths == -2)[1]):
            span = data[offsets[b_idx]: offsets[b_idx + 1]]
            body = decode_events(span)[0].body
            for r, rule in enumerate(self.rules):
                if lengths[r, b_idx] == -2:
                    mask[r, b_idx] = rule.match(body)
        overflow_s = time.perf_counter() - t0
        tm.add("overflow_s", overflow_s)
        if steps is not None:
            steps[:] = (extract_s[0], kernel_s, overflow_s, len(bounds))
        return mask, offsets, n

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

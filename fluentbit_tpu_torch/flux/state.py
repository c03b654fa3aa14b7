"""Per-tenant flux state — the port of ``fluentbit_tpu/flux/state.py``.

One :class:`FluxState` is the analytics state behind one configured
``filter_flux`` instance. Per group key (the ``group_by`` labels) it
keeps:

- **HLL cardinality** per distinct column: int32 registers on the
  state's device;
- **count-min top-k** over one state-wide count-min table on the device,
  keyed by composite ``group␟value`` bytes, with a bounded per-group
  candidate set on the host;
- **window aggregates** — count/sum/min/max/avg per numeric column over
  tumbling or hopping windows (processing time) or event-time tumbling
  windows. Counts are integers from the device; float sums, mins and
  maxs accumulate on the host in IEEE doubles, in record order, for
  exactness (``_seq_sum``), as in the reference.

Each absorb with at most ``_FUSED_MAX_GROUPS`` groups is one
``kernels.fused_absorb``: the K10 kernel on a CUDA state, its plain
version on a CPU state. A state built with ``spec.mesh`` keeps
``kernels.flux_mesh()`` in ``_mesh`` (None below two CUDA devices; a
caller may set a hand-built ``ops.mesh.Mesh`` whose first device is the
state's), and while it is set the absorb is ``kernels.sharded_fused_absorb``
instead: K10 per shard, then the merges. Either runs on freshly
assembled register stacks and a copy of the table, and the state
commits them only after the launch has returned (snapshot in, commit on
finish): a launch that raises leaves the state as it was. Above the cap, counts come from
``host_segment_counts``, each distinct field is one
``ops.sketch.hll_update_groups_rows`` (K6's grouped form: every group's own
registers in one launch), and the composites one ``CountMin.update``
(K7).
Every route gives the same state bit for bit, and the same state as the
reference package; snapshots (plain Python and numpy) carry across
between the two packages both ways.

Left out of this port: the ``flux.snapshot`` failpoint and the device
fault lane.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import pickle
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import failpoints as _fp
from ..ops.batch import assemble
from ..ops.device import DeviceLike, resolve, to_device
from ..ops import sketch
from ..ops.sketch import CountMin, HyperLogLog, estimate_registers
from . import kernels

__all__ = ["WindowSpec", "FluxSpec", "FluxState", "SNAPSHOT_VERSION"]

log = logging.getLogger("flb.flux")

SNAPSHOT_VERSION = 1

#: composite separator for top-k keys: group fields join with \x1e,
#: group|value with \x1f (both outside normal label alphabets)
_FIELD_SEP = b"\x1e"
_VALUE_SEP = b"\x1f"

#: cap on distinct group keys tracked for top-k candidates (LRU-ish;
#: the CMS itself is fixed-size — only the nomination sets need a bound)
_MAX_CANDIDATE_GROUPS = 4096


class WindowSpec:
    """Window shape: ``None`` kind = unwindowed running state."""

    __slots__ = ("kind", "size", "advance")

    def __init__(self, kind: Optional[str] = None, size: float = 0.0,
                 advance: Optional[float] = None):
        if kind not in (None, "tumbling", "hopping"):
            raise ValueError(f"unknown window kind {kind!r}")
        if kind is not None and size <= 0:
            raise ValueError("window size must be positive")
        self.kind = kind
        self.size = float(size)
        self.advance = float(advance) if advance else self.size

    @classmethod
    def parse(cls, text: Optional[str]) -> "WindowSpec":
        """``"tumbling 60"`` | ``"hopping 60 10"`` | ``"none"``/empty."""
        if not text or str(text).strip().lower() in ("none", "off"):
            return cls(None)
        parts = str(text).split()
        kind = parts[0].lower()
        size = float(parts[1]) if len(parts) > 1 else 0.0
        advance = float(parts[2]) if len(parts) > 2 else None
        return cls(kind, size, advance)

    @property
    def n_panes(self) -> int:
        if self.kind != "hopping":
            return 1
        return max(1, int(round(self.size / self.advance)))


class FluxSpec:
    """Immutable shape of one flux state."""

    __slots__ = ("name", "group_by", "distinct", "numeric", "topk_field",
                 "topk", "window", "hll_p", "cms_depth", "cms_width",
                 "max_len", "event_time", "mesh")

    def __init__(self, name: str,
                 group_by: Sequence[str] = (),
                 distinct: Sequence[str] = (),
                 numeric: Sequence[str] = (),
                 topk_field: Optional[str] = None,
                 topk: int = 10,
                 window: Optional[WindowSpec] = None,
                 hll_p: int = 12,
                 cms_depth: int = 4,
                 cms_width: int = 16384,
                 max_len: int = 256,
                 event_time: bool = False,
                 mesh: bool = False):
        self.name = name
        self.group_by = tuple(group_by)
        self.distinct = tuple(distinct)
        self.numeric = tuple(numeric)
        self.topk_field = topk_field
        self.topk = int(topk)
        self.window = window or WindowSpec(None)
        self.hll_p = int(hll_p)
        self.cms_depth = int(cms_depth)
        self.cms_width = int(cms_width)
        self.max_len = int(max_len)
        self.event_time = bool(event_time)
        self.mesh = bool(mesh)
        if self.event_time and self.window.kind != "tumbling":
            # fail at config time: event-time assignment divides by the
            # window size
            raise ValueError(
                "event-time windows require a tumbling window "
                "(hopping panes are processing-time; see FLUX.md)")

    def shape(self) -> dict:
        """Structural identity for snapshot compatibility checks: the
        sketch geometry and ``max_len`` included (a changed geometry would
        misplace every register and counter)."""
        return {
            "group_by": self.group_by,
            "distinct": self.distinct,
            "numeric": self.numeric,
            "topk_field": self.topk_field,
            "event_time": self.event_time,
            "window": (self.window.kind, self.window.size,
                       self.window.advance),
            "hll_p": self.hll_p,
            "cms_depth": self.cms_depth,
            "cms_width": self.cms_width,
            "max_len": self.max_len,
        }

    @property
    def string_fields(self) -> Tuple[str, ...]:
        """Columns staged as string bytes, in staging order."""
        out: List[str] = list(self.group_by)
        for f in self.distinct:
            if f not in out:
                out.append(f)
        if self.topk_field and self.topk_field not in out:
            out.append(self.topk_field)
        return tuple(out)


class _ColStat:
    """Per-(group, numeric column) running aggregate."""

    __slots__ = ("has", "sum", "min", "max", "min_int", "max_int")

    def __init__(self):
        self.has = False
        self.sum = 0.0
        self.min = 0.0
        self.max = 0.0
        # representative int-ness: the ORIGINAL min/max value's type
        self.min_int = False
        self.max_int = False

    def merge(self, other: "_ColStat") -> None:
        if not other.has:
            return
        if not self.has:
            self.has = True
            self.sum = 0.0 + other.sum
            self.min, self.min_int = other.min, other.min_int
            self.max, self.max_int = other.max, other.max_int
            return
        self.sum = self.sum + other.sum
        if other.min < self.min:
            self.min, self.min_int = other.min, other.min_int
        if other.max > self.max:
            self.max, self.max_int = other.max, other.max_int

    def min_value(self):
        if not self.has:
            return None
        return int(self.min) if self.min_int else self.min

    def max_value(self):
        if not self.has:
            return None
        return int(self.max) if self.max_int else self.max


class _FluxGroup:
    """One group key's accumulators inside one window pane; its HLL
    registers live on ``device``."""

    __slots__ = ("count", "cols", "hlls")

    def __init__(self, spec: FluxSpec, device: torch.device):
        self.count = 0
        self.cols: Dict[str, _ColStat] = {f: _ColStat()
                                          for f in spec.numeric}
        self.hlls: Dict[str, HyperLogLog] = {
            f: HyperLogLog(p=spec.hll_p, device=device)
            for f in spec.distinct
        }

    def merge(self, other: "_FluxGroup") -> None:
        self.count += other.count
        for f, st in other.cols.items():
            self.cols[f].merge(st)
        for f, h in other.hlls.items():
            self.hlls[f].merge_registers(h.registers)


def _seq_sum(start: float, values: np.ndarray) -> float:
    """``((start + v0) + v1) + ...`` with C-double sequential adds —
    np.bincount accumulates its weights in input order."""
    w = np.concatenate([np.asarray([start], dtype=np.float64),
                        values.astype(np.float64, copy=False)])
    return float(np.bincount(np.zeros(w.size, dtype=np.intp),
                             weights=w, minlength=1)[0])


def _host_registers(groups: Sequence[_FluxGroup], field: str) -> np.ndarray:
    """Every group's registers of ``field`` as one host array
    ``[len(groups), 2^p]`` (one device→host copy)."""
    return torch.stack([g.hlls[field].registers
                        for g in groups]).cpu().numpy()


class FluxState:
    """Mutable analytics state (see module docstring). All mutation
    happens under the engine's ingest lock, so no locking lives here.
    ``device`` is where registers and table live: ``None`` means
    ``cuda`` and raises without a card."""

    #: fused-absorb group ceiling: the [G, 2^p] register stack scales with
    #: the group count, so a batch with more groups takes the unfused
    #: route (the reference's host branch)
    _FUSED_MAX_GROUPS = 512

    def __init__(self, spec: FluxSpec, now=None, device: DeviceLike = None):
        self.spec = spec
        self.device = resolve(device)
        self._now = now or time.time
        self._mesh = kernels.flux_mesh() if spec.mesh else None
        # processing-time pane machinery
        self._groups: Dict[tuple, _FluxGroup] = {}
        self._panes: List[Dict[tuple, _FluxGroup]] = []
        self._window_start = self._now()
        # event-time machinery (tumbling only)
        self._event_windows: Dict[int, Dict[tuple, _FluxGroup]] = {}
        self._watermark: Optional[float] = None
        self._pending_closed: List[Tuple[float,
                                         List[Tuple[tuple, _FluxGroup]]]] = []
        # state-lifetime top-k: one CMS + bounded per-group candidates
        self.cms: Optional[CountMin] = None
        self._candidates: Dict[tuple, Dict[bytes, None]] = {}
        if spec.topk_field:
            self.cms = CountMin(depth=spec.cms_depth, width=spec.cms_width,
                                device=self.device)
        # counters (exported as fluentbit_flux_*)
        self.records_total = 0
        self.late_records_total = 0
        self.window_emits_total = 0
        self.batches_total = 0
        #: host seconds of each absorb's steps (columns, grouping,
        #: composites, stage, launch, commit, numeric), recent absorbs only
        self.step_seconds: collections.deque = collections.deque(maxlen=4096)
        self._steps: Dict[str, float] = {}

    def _new_group(self) -> _FluxGroup:
        return _FluxGroup(self.spec, self.device)

    def _step(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self._steps[name] = self._steps.get(name, 0.0) + (t1 - t0)
        return t1

    # ------------------------------------------------------------ absorb

    def absorb_batch(self, n: int,
                     strcols: Dict[str, Tuple[np.ndarray, np.ndarray]],
                     numcols: Dict[str, Tuple[np.ndarray, np.ndarray]],
                     ) -> int:
        """Absorb one staged chunk (processing-time mode).

        strcols  : field → (batch u8 [n, L], lengths i32 [n]); lengths
                   < 0 = missing/non-string/oversize
        numcols  : field → (values f64 [n], kinds u8 [n]); kind 0 =
                   missing/non-numeric, 1 = integer, 2 = float
        """
        if self.spec.event_time:
            raise RuntimeError("event-time state has no batched path")
        if n > 0:
            self._steps = {}
            self._absorb_rows(self._groups, n, strcols, numcols)
            self.step_seconds.append(self._steps)
            self.records_total += n
        self.batches_total += 1
        return max(n, 0)

    def absorb_events(self, events: list) -> int:
        """Per-record entry: converts decoded events to the column layout
        of :meth:`absorb_batch` and runs the same math. EVERY record
        counts; a non-map body counts with all columns missing."""
        n = len(events)
        if n == 0:
            return 0
        self._steps = {}
        t0 = time.perf_counter()
        bodies = [ev.body if isinstance(ev.body, dict) else {}
                  for ev in events]
        strcols = {
            f: self._str_column(bodies, f)
            for f in self.spec.string_fields
        }
        numcols = {
            f: self._num_column(bodies, f) for f in self.spec.numeric
        }
        self._step("columns", t0)
        if self.spec.event_time:
            ts = np.asarray([ev.ts_float for ev in events],
                            dtype=np.float64)
            absorbed = self._absorb_event_time(ts, strcols, numcols)
        else:
            self._absorb_rows(self._groups, n, strcols, numcols)
            absorbed = n
        self.batches_total += 1
        self.records_total += absorbed
        self.step_seconds.append(self._steps)
        return absorbed

    def _str_column(self, bodies: List[dict], field: str):
        vals: List[Optional[bytes]] = []
        for b in bodies:
            v = b.get(field)
            if isinstance(v, str):
                vb = v.encode("utf-8")
                # oversize → missing
                vals.append(vb if len(vb) <= self.spec.max_len else None)
            else:
                vals.append(None)
        batch = assemble(vals, self.spec.max_len)
        ln = batch.lengths.copy()
        ln[ln == -2] = -1  # collapse oversize into plain missing
        return batch.batch, ln

    def _num_column(self, bodies: List[dict], field: str):
        vals = np.zeros((len(bodies),), dtype=np.float64)
        kinds = np.zeros((len(bodies),), dtype=np.uint8)
        for i, b in enumerate(bodies):
            v = b.get(field)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            vals[i] = float(v)
            kinds[i] = 1 if isinstance(v, int) else 2
        return vals, kinds

    # -- grouping ------------------------------------------------------

    def _group_rows(self, n_rows: int, strcols
                    ) -> Tuple[np.ndarray, List[tuple]]:
        """Segment ids (first-seen order) + group key tuples."""
        gb = self.spec.group_by
        if not gb:
            return np.zeros((n_rows,), dtype=np.int64), [()]
        mats = []
        for f in gb:
            b, ln = strcols[f]
            L = b.shape[1]
            ln2 = np.where(ln < 0, np.int32(-1), ln)
            bz = np.ascontiguousarray(b, dtype=np.uint8).copy()
            # zero pad bytes so the void view compares by value; the
            # length column disambiguates embedded-NUL prefixes
            mask = np.arange(L)[None, :] >= np.clip(ln2, 0, None)[:, None]
            bz[mask] = 0
            mats.append(bz)
            mats.append(ln2.astype("<i4").view(np.uint8).reshape(-1, 4))
        keyed = np.ascontiguousarray(np.concatenate(mats, axis=1))
        void = keyed.view(f"V{keyed.shape[1]}").reshape(-1)
        _, first_idx, inv = np.unique(void, return_index=True,
                                      return_inverse=True)
        order = np.argsort(first_idx, kind="stable")
        remap = np.empty(order.size, dtype=np.int64)
        remap[order] = np.arange(order.size)
        seg = remap[np.asarray(inv).reshape(-1)]
        keys: List[tuple] = []
        for j in order:
            row = int(first_idx[j])
            key = []
            for f in gb:
                b, ln = strcols[f]
                lni = int(ln[row])
                key.append(b[row, :lni].tobytes() if lni >= 0 else None)
            keys.append(tuple(key))
        return seg, keys

    # -- the shared core ----------------------------------------------

    def _absorb_rows(self, pane: Dict[tuple, _FluxGroup], n_rows: int,
                     strcols, numcols) -> None:
        t0 = time.perf_counter()
        seg, keys = self._group_rows(n_rows, strcols)
        n_groups = len(keys)
        single = n_groups == 1
        order = bounds = None
        if not single:
            # one stable sort: each group's rows in ascending order (the
            # sequential-sum exactness needs it)
            order = np.argsort(seg, kind="stable")
            bounds = np.searchsorted(seg[order],
                                     np.arange(n_groups + 1))

        def gslice(gid, b, ln):
            if single:
                return b, ln
            gidx = order[bounds[gid]:bounds[gid + 1]]
            return b[gidx], ln[gidx]

        # new groups join the pane only when the absorb commits
        groups = [pane.get(key) or self._new_group() for key in keys]
        t0 = self._step("grouping", t0)
        # top-k composites: built per group (prefix + value) in group
        # order, absorbed below as ONE concatenated batch
        comp = comp_len = None
        nominate = []
        if self.spec.topk_field:
            tb, tl = strcols[self.spec.topk_field]
            parts = []
            for gid, key in enumerate(keys):
                gb, gl = gslice(gid, tb, tl)
                built = self._topk_composites(key, gb, gl)
                if built is None:
                    continue
                nominate.append((key,) + built)
                parts.append(built[:2])
            if parts:
                comp = np.concatenate([c for c, _ in parts])
                comp_len = np.concatenate([cl for _, cl in parts])
        t0 = self._step("composites", t0)
        if n_groups <= self._FUSED_MAX_GROUPS:
            # ONE launch for the whole absorb: counts, every group's
            # registers and the count-min table
            counts = self._fused_absorb(groups, seg, strcols, comp,
                                        comp_len)
        else:
            # above the cap (the reference's host branch): host counts,
            # ONE grouped K6 per distinct field over the column as staged,
            # straight into each group's own registers, and one K7
            ones = np.ones((seg.shape[0],), dtype=np.int32)
            counts = kernels.host_segment_counts(seg, ones, n_groups)
            dev = self.device
            seg_t = to_device(seg.astype(np.int32), torch.int32, dev)
            for f in self.spec.distinct:
                b, ln = strcols[f]
                sketch.hll_update_groups_rows(
                    [g.hlls[f].registers for g in groups],
                    to_device(b, torch.uint8, dev),
                    to_device(ln, torch.int32, dev), seg_t, self.spec.hll_p)
            if comp is not None:
                self.cms.update(comp, comp_len)
            t0 = self._step("launch", t0)
        for key, g in zip(keys, groups):
            if key not in pane:
                pane[key] = g
        for key, c, cl, plen in nominate:
            self._topk_nominate(key, c, cl, plen)
        t0 = time.perf_counter()
        for gid, g in enumerate(groups):
            g.count += int(counts[gid])
            for f in self.spec.numeric:
                vals, kinds = numcols[f]
                if not single:
                    gidx = order[bounds[gid]:bounds[gid + 1]]
                    vals, kinds = vals[gidx], kinds[gidx]
                self._update_col(g.cols[f], vals, kinds)
        self._step("numeric", t0)

    def _fused_absorb(self, groups: List[_FluxGroup], seg: np.ndarray,
                      strcols, comp, comp_len) -> np.ndarray:
        """One ``kernels.fused_absorb`` (``sharded_fused_absorb`` over
        ``_mesh`` when it is set) over freshly assembled state: each
        field's register stack ``[G, 2^p]`` is stacked from the groups'
        registers and the table is cloned; the launch updates those, and
        they are committed only after the counts came back (which waits
        for the launch). A raise leaves the state as it was."""
        spec = self.spec
        dev = self.device
        t0 = time.perf_counter()
        B = seg.shape[0]
        seg_t = to_device(seg.astype(np.int32), torch.int32, dev)
        valid_t = torch.ones((B,), dtype=torch.int32, device=dev)
        fields, stacks = [], []
        for f in spec.distinct:
            b, ln = strcols[f]
            fields.append((to_device(b, torch.uint8, dev),
                           to_device(ln, torch.int32, dev)))
            stacks.append(torch.stack([g.hlls[f].registers
                                       for g in groups]))
        table = comp_t = comp_len_t = None
        if comp is not None:
            table = self.cms.table.clone()
            comp_t = to_device(comp, torch.uint8, dev)
            comp_len_t = to_device(comp_len, torch.int32, dev)
        t0 = self._step("stage", t0)
        if self._mesh is not None:
            counts_t = kernels.sharded_fused_absorb(
                self._mesh, seg_t, valid_t, fields, stacks, comp_t,
                comp_len_t, table, hll_p=spec.hll_p, n_seg=len(groups))
        else:
            counts_t = kernels.fused_absorb(seg_t, valid_t, fields, stacks,
                                            comp_t, comp_len_t, table,
                                            hll_p=spec.hll_p,
                                            n_seg=len(groups))
        t0 = self._step("launch", t0)
        counts = counts_t.cpu().numpy()
        # commit: copy each stack row back into its group's own registers
        # (a row view would pin the whole stack for as long as the group
        # lives)
        for f, stack in zip(spec.distinct, stacks):
            torch._foreach_copy_([g.hlls[f].registers for g in groups],
                                 list(stack.unbind(0)))
        if table is not None:
            self.cms.table = table
        self._step("commit", t0)
        return counts

    @staticmethod
    def _update_col(st: _ColStat, vals: np.ndarray,
                    kinds: np.ndarray) -> None:
        valid = kinds > 0
        if not valid.any():
            return
        vv = vals[valid]
        kk = kinds[valid]
        if np.isnan(vv).any():
            # NaN ordering is path-dependent under vectorized min/max;
            # run the exact per-value semantics instead (rare)
            for v, k in zip(vv.tolist(), kk.tolist()):
                is_int = k == 1
                if not st.has:
                    st.has = True
                    st.sum = 0.0 + v
                    st.min, st.min_int = v, is_int
                    st.max, st.max_int = v, is_int
                    continue
                st.sum = st.sum + v
                if v < st.min:
                    st.min, st.min_int = v, is_int
                if v > st.max:
                    st.max, st.max_int = v, is_int
            return
        start = st.sum if st.has else 0.0
        new_sum = _seq_sum(start, vv)
        gmin = float(vv.min())
        gmax = float(vv.max())
        min_int = bool(kk[int(np.argmax(vv == gmin))] == 1)
        max_int = bool(kk[int(np.argmax(vv == gmax))] == 1)
        if not st.has:
            st.has = True
            st.min, st.min_int = gmin, min_int
            st.max, st.max_int = gmax, max_int
        else:
            if gmin < st.min:
                st.min, st.min_int = gmin, min_int
            if gmax > st.max:
                st.max, st.max_int = gmax, max_int
        st.sum = new_sum

    def _topk_composites(self, key: tuple, batch: np.ndarray,
                         lengths: np.ndarray):
        """One group's top-k composite rows (``prefix + value``) —
        ``(comp, comp_len, plen)`` over the group's VALID rows, or None
        when the group contributes nothing."""
        prefix = self._group_prefix(key)
        W = self.spec.max_len
        valid = np.nonzero(lengths >= 0)[0]
        if valid.size == 0:
            return None
        plen = len(prefix)
        if plen > W:
            # the group prefix alone exceeds the composite width: this
            # group has no top-k
            return None
        comp = np.zeros((valid.size, W), dtype=np.uint8)
        comp_len = np.full((valid.size,), -1, dtype=np.int32)
        if plen:
            comp[:, :plen] = np.frombuffer(prefix, dtype=np.uint8)
        vl = lengths[valid]
        fits = plen + vl <= W
        span = min(W - plen, batch.shape[1])
        comp[:, plen:plen + span] = batch[valid, :span]
        # oversize composites are excluded (comp_len -1)
        comp_len[fits] = (plen + vl[fits]).astype(np.int32)
        pad = np.arange(W)[None, :] >= np.clip(comp_len, 0, None)[:, None]
        comp[pad] = 0
        return comp, comp_len, plen

    def _topk_nominate(self, key: tuple, comp: np.ndarray,
                       comp_len: np.ndarray, plen: int) -> None:
        """Candidate set: a BOUNDED stride sample of this chunk's values
        (the CMS holds the counts; candidates only nominate keys)."""
        cand = self._candidates.pop(key, None)
        if cand is None:
            cand = {}
        # re-insert at the END: the candidate-group map is bounded LRU-ish
        self._candidates[key] = cand
        if len(self._candidates) > _MAX_CANDIDATE_GROUPS:
            for stale in list(self._candidates)[
                    : len(self._candidates) - _MAX_CANDIDATE_GROUPS]:
                del self._candidates[stale]
        ok = np.nonzero(comp_len >= 0)[0]
        limit = max(64, 8 * self.spec.topk)
        if ok.size > limit:
            ok = ok[:: max(1, int(ok.size) // limit)][:limit]
        lens = comp_len[ok].tolist()
        for i, clen in zip(ok.tolist(), lens):
            vb = comp[i, plen:clen].tobytes()
            cand.pop(vb, None)
            cand[vb] = None
        if len(cand) > limit:
            for k in list(cand)[: len(cand) - limit]:
                del cand[k]

    def _group_prefix(self, key: tuple) -> bytes:
        if not key:
            return b""
        return _FIELD_SEP.join(
            b"\x00" if part is None else part for part in key
        ) + _VALUE_SEP

    # -- event-time ----------------------------------------------------

    def _absorb_event_time(self, ts: np.ndarray, strcols,
                           numcols) -> int:
        size = self.spec.window.size
        wid = np.floor(ts / size).astype(np.int64)
        wm = self._watermark
        absorbed = 0
        min_open = None
        if wm is not None:
            min_open = int(math.floor(wm / size))
        uniq, first_idx = np.unique(wid, return_index=True)
        for j in np.argsort(first_idx, kind="stable"):
            w = int(uniq[j])
            rows = np.nonzero(wid == w)[0]
            if min_open is not None and w < min_open:
                self.late_records_total += int(rows.size)
                continue
            pane = self._event_windows.get(w)
            if pane is None:
                pane = self._event_windows[w] = {}
            sc = {f: (b[rows], ln[rows]) for f, (b, ln) in strcols.items()}
            nc = {f: (v[rows], k[rows]) for f, (v, k) in numcols.items()}
            self._absorb_rows(pane, int(rows.size), sc, nc)
            absorbed += int(rows.size)
        new_wm = float(ts.max())
        if wm is None or new_wm > wm:
            self._watermark = new_wm
        self._close_event_windows()
        return absorbed

    def _close_event_windows(self) -> None:
        if self._watermark is None:
            return
        size = self.spec.window.size
        done = int(math.floor(self._watermark / size))
        for w in sorted(k for k in self._event_windows if k < done):
            pane = self._event_windows.pop(w)
            if pane:
                self._pending_closed.append(
                    ((w + 1) * size, list(pane.items())))
                self.window_emits_total += 1

    # ------------------------------------------------------------ window

    def tick(self, now: Optional[float] = None
             ) -> List[Tuple[tuple, _FluxGroup]]:
        """Close expired windows; returns the closed window's groups in
        first-seen order (empty list = nothing to emit)."""
        w = self.spec.window
        if self.spec.event_time:
            out: List[Tuple[tuple, _FluxGroup]] = []
            for _, items in self._pending_closed:
                out.extend(items)
            self._pending_closed = []
            return out
        if w.kind is None:
            return []
        now = self._now() if now is None else now
        if w.kind == "tumbling":
            if now - self._window_start < w.size:
                return []
            self._window_start += w.size * (
                (now - self._window_start) // w.size)
            closed = list(self._groups.items())
            self._groups = {}
            if closed:
                self.window_emits_total += 1
            return closed
        # hopping
        if now - self._window_start < w.advance:
            return []
        self._window_start += w.advance * (
            (now - self._window_start) // w.advance)
        self._panes.append(self._groups)
        self._groups = {}
        self._panes = self._panes[-w.n_panes:]
        merged: Dict[tuple, _FluxGroup] = {}
        for pane in self._panes:
            for key, g in pane.items():
                m = merged.get(key)
                if m is None:
                    m = merged[key] = self._new_group()
                m.merge(g)
        out = list(merged.items())
        if out:
            self.window_emits_total += 1
        return out

    def drain(self) -> List[Tuple[tuple, _FluxGroup]]:
        """Shutdown: whatever the open window(s) accumulated."""
        if self.spec.event_time:
            for w in sorted(self._event_windows):
                pane = self._event_windows.pop(w)
                if pane:
                    self._pending_closed.append(
                        ((w + 1) * self.spec.window.size,
                         list(pane.items())))
            return self.tick()
        if self.spec.window.kind is None:
            return list(self._groups.items())
        for pane in self._panes:
            for key, g in pane.items():
                cur = self._groups.get(key)
                if cur is None:
                    self._groups[key] = g
                else:
                    cur.merge(g)
        self._panes = []
        closed = list(self._groups.items())
        self._groups = {}
        return closed

    def live_groups(self) -> List[Tuple[tuple, _FluxGroup]]:
        """The OPEN pane's groups (read by the metrics exporter)."""
        if self.spec.event_time:
            merged: Dict[tuple, _FluxGroup] = {}
            for w in sorted(self._event_windows):
                for key, g in self._event_windows[w].items():
                    m = merged.get(key)
                    if m is None:
                        m = merged[key] = self._new_group()
                    m.merge(g)
            return list(merged.items())
        return list(self._groups.items())

    # ------------------------------------------------------------- reads

    def host_table(self) -> Optional[np.ndarray]:
        """The count-min table on the host (one device→host copy), for
        reading many groups' top-k with :meth:`topk`."""
        return None if self.cms is None else self.cms.table.cpu().numpy()

    def estimates(self, items: Sequence[Tuple[tuple, _FluxGroup]]
                  ) -> List[Dict[str, float]]:
        """Each group's HLL estimates by distinct field, from one
        device→host copy per field for all of ``items``."""
        out: List[Dict[str, float]] = [{} for _ in items]
        if not items:
            return out
        for f in self.spec.distinct:
            regs = _host_registers([g for _, g in items], f)
            for est, row in zip(out, regs):
                est[f] = estimate_registers(row)
        return out

    def topk(self, key: tuple, table: Optional[np.ndarray] = None
             ) -> List[Tuple[int, bytes]]:
        """Current hottest values for one group: (estimate, value),
        highest first — CMS point queries over the candidate set, from
        ``table`` (a :meth:`host_table` copy) or one table copy."""
        if self.cms is None:
            return []
        cand = list(self._candidates.get(key, ()))
        if not cand:
            return []
        prefix = self._group_prefix(key)
        ests = self.cms.query_many([prefix + v for v in cand], table)
        top = sorted(zip(ests, cand),
                     key=lambda t: (-t[0], t[1]))[: self.spec.topk]
        return [(int(e), v) for e, v in top]

    # ------------------------------------------------------ snapshot/restore

    def snapshot(self) -> dict:
        """Read-only structural snapshot in plain Python and numpy — the
        reference package's format, so either package restores the
        other's."""

        def enc_pane(pane):
            items = list(pane.items())
            regs = {f: _host_registers([g for _, g in items], f)
                    for f in self.spec.distinct} if items else {}
            out = []
            for i, (key, g) in enumerate(items):
                out.append({
                    "key": key,
                    "count": g.count,
                    "cols": {
                        f: (st.has, st.sum, st.min, st.max,
                            st.min_int, st.max_int)
                        for f, st in g.cols.items()
                    },
                    "hlls": {f: regs[f][i].copy() for f in g.hlls},
                })
            return out

        return {
            "version": SNAPSHOT_VERSION,
            "name": self.spec.name,
            "shape": self.spec.shape(),
            "window_start": self._window_start,
            "groups": enc_pane(self._groups),
            "panes": [enc_pane(p) for p in self._panes],
            "event_windows": {
                w: enc_pane(p) for w, p in self._event_windows.items()
            },
            "watermark": self._watermark,
            "cms": self.host_table().copy() if self.cms is not None
            else None,
            "candidates": {k: list(v) for k, v in
                           self._candidates.items()},
            "counters": (self.records_total, self.late_records_total,
                         self.window_emits_total, self.batches_total),
        }

    def restore(self, snap: dict) -> None:
        """Restore a snapshot of either package (same version, name and
        spec shape); registers and table move to the state's device.
        Everything is decoded before the state changes, so a bad
        snapshot raises and leaves the state as it was."""
        if snap.get("version") != SNAPSHOT_VERSION:
            raise ValueError(
                f"flux snapshot version {snap.get('version')!r} "
                f"unsupported (want {SNAPSHOT_VERSION})")
        if snap.get("name") != self.spec.name:
            raise ValueError(
                f"flux snapshot belongs to state "
                f"{snap.get('name')!r}, not {self.spec.name!r}")
        if snap.get("shape") != self.spec.shape():
            raise ValueError(
                f"flux snapshot shape {snap.get('shape')!r} does not "
                f"match this state's spec {self.spec.shape()!r}")
        m = 1 << self.spec.hll_p

        def dec_pane(items):
            pane: Dict[tuple, _FluxGroup] = {}
            for it in items:
                g = self._new_group()
                g.count = it["count"]
                for f, (has, s, mn, mx, mni, mxi) in it["cols"].items():
                    if f in g.cols:
                        st = g.cols[f]
                        st.has, st.sum = has, s
                        st.min, st.max = mn, mx
                        st.min_int, st.max_int = mni, mxi
                for f, regs in it["hlls"].items():
                    if f in g.hlls:
                        arr = np.asarray(regs).astype(np.int32)
                        if arr.shape != (m,):
                            raise ValueError(
                                f"flux snapshot HLL register shape "
                                f"{arr.shape} != ({m},)")
                        g.hlls[f].registers = torch.from_numpy(arr).to(
                            self.device)
                pane[it["key"]] = g
            return pane

        groups = dec_pane(snap["groups"])
        panes = [dec_pane(p) for p in snap["panes"]]
        event_windows = {
            w: dec_pane(p) for w, p in snap["event_windows"].items()
        }
        cms_table = None
        if self.cms is not None and snap.get("cms") is not None:
            arr = np.asarray(snap["cms"]).astype(np.int32)
            want = (self.cms.depth, self.cms.width)
            if arr.shape != want:
                raise ValueError(
                    f"flux snapshot CMS table shape {arr.shape} "
                    f"!= {want}")
            cms_table = torch.from_numpy(arr).to(self.device)
        candidates = {
            k: {v: None for v in vs}
            for k, vs in snap.get("candidates", {}).items()
        }
        (records, late, emits, batches) = snap["counters"]
        self._groups = groups
        self._panes = panes
        self._event_windows = event_windows
        self._watermark = snap["watermark"]
        self._window_start = snap["window_start"]
        if cms_table is not None:
            self.cms.table = cms_table
        self._candidates = candidates
        self.records_total = records
        self.late_records_total = late
        self.window_emits_total = emits
        self.batches_total = batches

    def persist(self, path: str) -> None:
        """Atomic snapshot write: tmp + fsync + rename (old-or-new, never
        torn)."""
        self.write_snapshot(self.snapshot(), path)

    @staticmethod
    def write_snapshot(snap: dict, path: str) -> None:
        """Write an already-built snapshot dict (see :meth:`persist`);
        callers holding the ingest lock build the snapshot under it and
        write outside it."""
        payload = pickle.dumps(snap, protocol=4)
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".flux-snap-", dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            if _fp.ACTIVE:
                # written and synced, not yet renamed: a crash leaves the
                # old snapshot whole
                _fp.fire("flux.snapshot")
            os.replace(tmp, path)
        finally:
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass  # best-effort tmp cleanup; the snapshot landed

    def load(self, path: str) -> bool:
        """Restore from a persisted snapshot (one this program or the
        reference package wrote: unpickling runs code, so only trusted
        paths); False = no or unusable file (fresh state)."""
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except OSError:
            return False
        try:
            snap = pickle.loads(payload)
        except Exception:
            log.warning("flux snapshot %s undecodable; starting fresh",
                        path, exc_info=True)
            return False
        try:
            self.restore(snap)
        except (KeyError, ValueError, TypeError):
            log.warning("flux snapshot %s unusable; starting fresh", path)
            return False
        return True

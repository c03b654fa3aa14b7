"""filter_flux — per-tenant streaming analytics inside the filter pass.

The port of ``fluentbit_tpu/flux/plugin.py`` on the decoded path: one
configured instance keeps one :class:`~fluentbit_tpu_torch.flux.state.FluxState`
(per-group HLL cardinality, count-min top-k and window aggregates) on the
engine's device and absorbs each append's decoded events in one batched
commit; records pass through untouched. Closed windows re-enter the
pipeline as rows through a hidden emitter under ``tag``, and the
``fluentbit_flux_*`` families land in the engine's metrics registry.

The window timer rides the hidden emitter's interval collector
(``tick_interval_sec``); it closes expired windows, emits their rows,
refreshes the gauges and writes interval snapshots (``snapshot_path``).
``mesh`` builds the state with ``spec.mesh``: its absorbs shard over the
visible CUDA devices (``kernels.flux_mesh``, None below two devices, so
one card keeps the single-device route).

SQL mode: ``flux.query.attach_flux`` makes a hidden instance through
``Engine.hidden_filter`` with ``_preset_state`` (the query's state) and
``_sql_mode`` set. Such an instance has no emitter or tick of its own:
the SP task reads and drains its windows, and the filter skips the SP
emitter's rows as well as its own.

The raw path (``process_batch``, ``stateful_batch``; the reference's
flux/plugin.py:241-311): the engine hands the filter the append's msgpack
bytes; the host codec stages the string columns (``stage_field_into``)
and the numeric ones (``stage_field_f64``) straight from them, and one
``FluxState.absorb_batch`` commits the chunk (on CUDA the fused absorb
K10, or above 512 groups the grouped K6 and the count-min K7). Rows from
the filter's own emitter, and in SQL mode from the stream processor's,
pass untouched. Event-time states keep the decoded path.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import List, Optional

import numpy as np

from .. import native
from ..codec.events import encode_event, now_event_time
from ..core.config import ConfigMapEntry
from ..core.plugin import FilterPlugin, FilterResult, registry
from ..ops.device import DEVICE_ERRORS
from .exporter import FluxExporter
from .state import FluxSpec, FluxState, WindowSpec

log = logging.getLogger("flb.flux")


@registry.register
class FluxFilter(FilterPlugin):
    name = "flux"
    description = "device-resident streaming analytics (sketches + windows)"
    # the batch hook absorbs: a decline after it must not re-run it
    stateful_batch = True
    config_map = [
        ConfigMapEntry("group_by", "str", multiple=True,
                       desc="tenant/group label fields (string-typed)"),
        ConfigMapEntry("distinct_field", "str", multiple=True,
                       desc="HLL cardinality columns"),
        ConfigMapEntry("aggregate_field", "str", multiple=True,
                       desc="numeric count/sum/min/max/avg columns"),
        ConfigMapEntry("topk_field", "str",
                       desc="count-min hot-key column"),
        ConfigMapEntry("topk", "int", default=10),
        ConfigMapEntry("window", "str",
                       desc="'tumbling N' | 'hopping N M' | 'none'"),
        ConfigMapEntry("window_time", "str", default="processing",
                       desc="processing|event (event: tumbling only)"),
        ConfigMapEntry("tag", "str",
                       desc="emit closed-window rows under this tag"),
        ConfigMapEntry("emitter_name", "str"),
        ConfigMapEntry("emitter_mem_buf_limit", "str", default="10M",
                       desc="the hidden emitter's mem_buf_limit: over it "
                            "a window's rows are refused"),
        ConfigMapEntry("sketch_precision", "int", default=12),
        ConfigMapEntry("sketch_depth", "int", default=4),
        ConfigMapEntry("sketch_width", "int", default=16384),
        ConfigMapEntry("max_field_len", "int", default=256),
        ConfigMapEntry("mesh", "bool", default=False,
                       desc="shard the absorb across the visible CUDA "
                            "devices (below two: the single-device "
                            "route)"),
        ConfigMapEntry("snapshot_path", "str"),
        ConfigMapEntry("snapshot_interval_sec", "int", default=0),
        ConfigMapEntry("export_interval_sec", "str", default="1"),
        ConfigMapEntry("tick_interval_sec", "str", default="0.5"),
    ]

    #: SQL mode: the query's state, built by ``flux.query.attach_flux``
    _preset_state: Optional[FluxState] = None
    _sql_mode: bool = False

    def init(self, instance, engine) -> None:
        self._engine = engine
        self._emitter = None
        self._emitter_ins = None
        self._last_snapshot = 0.0
        #: host seconds of each exporter refresh that ran (recent ones)
        self.refresh_seconds: collections.deque = collections.deque(
            maxlen=4096)
        if self._preset_state is not None:
            self.state = self._preset_state
            self.exporter = FluxExporter(engine.metrics, self.state,
                                         min_interval=1.0)
            return
        self.state = FluxState(FluxSpec(
            name=instance.display_name,
            group_by=self.group_by or (),
            distinct=self.distinct_field or (),
            numeric=self.aggregate_field or (),
            topk_field=self.topk_field,
            topk=self.topk,
            window=WindowSpec.parse(self.window),
            hll_p=self.sketch_precision,
            cms_depth=self.sketch_depth,
            cms_width=self.sketch_width,
            max_len=self.max_field_len,
            event_time=(self.window_time or "").lower() == "event",
            mesh=self.mesh,
        ), device=engine.device)
        if self.snapshot_path:
            self.state.load(self.snapshot_path)
        self.exporter = FluxExporter(
            engine.metrics, self.state,
            min_interval=float(self.export_interval_sec or 0))
        spec = self.state.spec
        if (self.tag or spec.window.kind is not None or spec.event_time
                or (self.snapshot_path
                    and (self.snapshot_interval_sec or 0) > 0)):
            # the tick collector drives window close, gauge refresh AND
            # interval snapshots
            ename = self.emitter_name or \
                f"emitter_for_{instance.display_name}"
            ins = engine.hidden_input(
                "emitter", alias=ename,
                mem_buf_limit=self.emitter_mem_buf_limit)
            self._emitter = ins.plugin
            self._emitter_ins = ins
            ins.plugin.collect_interval = float(
                self.tick_interval_sec or 0.5)
            ins.plugin.collect = self._on_tick

    # ------------------------------------------------------------- ticks

    def _on_tick(self, engine) -> None:
        """Window timer: close expired windows, emit rows, refresh gauges,
        persist the snapshot. The snapshot dict is built under the ingest
        lock but written outside it."""
        with engine._ingest_lock:
            snap = self._tick_locked()
        if snap is not None:
            try:
                self.state.write_snapshot(snap, self.snapshot_path)
                self._last_snapshot = time.time()
            except OSError:
                log.warning("flux snapshot persist failed; state stays "
                            "in memory", exc_info=True)

    def _tick_locked(self):
        """→ snapshot dict to write after the lock is released, or
        None."""
        closed = self.state.tick()
        if closed and self.tag and self._emitter is not None:
            self._emit_rows(closed, "window")
        self._refresh(force=bool(closed))
        if not self.snapshot_path:
            return None
        due = (self.snapshot_interval_sec or 0) > 0 and \
            time.time() - self._last_snapshot >= self.snapshot_interval_sec
        if not closed and not due:
            return None
        return self.state.snapshot()

    def _emit_rows(self, closed, what: str) -> None:
        rows = self._render_rows(closed)
        buf = bytearray()
        for r in rows:
            buf += encode_event(r, now_event_time())
        try:
            self._emitter.add_record(self.tag, bytes(buf), len(rows))
        except DEVICE_ERRORS:
            raise
        except Exception:
            log.exception("flux %s emit failed; rows dropped "
                          "(state already rolled over)", what)

    def _render_rows(self, closed) -> List[dict]:
        """One row per closed group; the registers come to the host with
        one copy per distinct field and the table with one copy."""
        spec = self.state.spec
        estimates = self.state.estimates(closed)
        table = self.state.host_table() if spec.topk_field else None
        rows: List[dict] = []
        for (key, g), est in zip(closed, estimates):
            row: dict = {"flux": spec.name}
            for fname, part in zip(spec.group_by, key):
                row[fname] = None if part is None \
                    else part.decode("utf-8", "replace")
            row["count"] = g.count
            for f in spec.numeric:
                st = g.cols[f]
                row[f + "_sum"] = st.sum if st.has else 0.0
                row[f + "_min"] = st.min_value()
                row[f + "_max"] = st.max_value()
                row[f + "_avg"] = (st.sum / g.count) if g.count else 0.0
            for f in spec.distinct:
                row[f + "_distinct"] = int(round(est[f]))
            if spec.topk_field:
                row["topk"] = [
                    {"value": v.decode("utf-8", "replace"),
                     "estimate": e}
                    for e, v in self.state.topk(key, table)
                ]
            rows.append(row)
        return rows

    def _skip_sources(self) -> list:
        out = []
        sp = getattr(self._engine, "sp", None)
        if self._sql_mode and sp is not None \
                and sp.emitter_instance is not None:
            out.append(sp.emitter_instance)
        if self._emitter_ins is not None:
            out.append(self._emitter_ins)
        return out

    # ------------------------------------------------------- raw path

    def can_process_batch(self) -> bool:
        # the reference's _batch_ok (flux/plugin.py:130-137): the port's
        # codec always has the stagers, and raises if it cannot be built
        return not self.state.spec.event_time

    def process_batch(self, chunk):
        data = chunk.as_bytes()
        n = chunk.n
        if chunk.src is not None and any(chunk.src is s for s in
                                         self._skip_sources()):
            if n is None:
                n = native.count_records(data)
                if n is None:
                    return None
            return (n, data, n)
        spec = self.state.spec
        if n is None and (spec.string_fields or not spec.numeric):
            n = native.count_records(data)
            if n is None:
                return None
        strcols = {}
        for f in spec.string_fields:
            # caller-owned column buffers: every column stays live
            b = np.empty((n, spec.max_len), dtype=np.uint8)
            ln = np.full((n,), -1, dtype=np.int32)
            if native.stage_field_into(data, f.encode("utf-8"), b, ln,
                                       n_hint=n) != n:
                return None
            strcols[f] = (b, ln)
        numcols = {}
        for f in spec.numeric:
            got = native.stage_field_f64(data, f.encode("utf-8"), n_hint=n)
            if got is None or (n is not None and got[2] != n):
                return None
            n = got[2]
            numcols[f] = got[:2]
        # the one commit: nothing below declines (a raise past it would
        # be a decline, and the decoded tail would absorb the chunk again)
        self.state.absorb_batch(n, strcols, numcols)
        self._refresh_or_defer()
        return (n, data, n)

    # ------------------------------------------------------------- filter

    def filter(self, events: list, tag: str, engine) -> tuple:
        src = getattr(engine, "_ingest_src", None) \
            if engine is not None else None
        if src is not None and any(src is s for s in
                                   self._skip_sources()):
            # the rows this filter emitted itself
            return (FilterResult.NOTOUCH, events)
        self.state.absorb_events(events)
        self._refresh_or_defer()
        return (FilterResult.NOTOUCH, events)

    def _refresh_or_defer(self) -> None:
        """The metrics refresh after an absorb: a host error is logged
        and the export deferred to the next refresh (reference
        :307-308, :322-323); a device error in the registers' readback
        raises."""
        try:
            self._refresh(force=False)
        except DEVICE_ERRORS:
            raise
        except Exception:
            log.exception("flux metrics refresh failed; export deferred")

    def _refresh(self, force: bool) -> None:
        t0 = time.perf_counter()
        if self.exporter.refresh(force=force):
            self.refresh_seconds.append(time.perf_counter() - t0)

    def exit(self) -> None:
        # configured mode emits what the open window holds; in SQL mode
        # the SP task drains it
        if self._preset_state is None and self.tag \
                and self._emitter is not None:
            closed = self.state.drain()
            if closed:
                self._emit_rows(closed, "drain")
        if self.snapshot_path:
            try:
                self.state.persist(self.snapshot_path)
            except OSError:
                log.warning("flux exit snapshot failed", exc_info=True)

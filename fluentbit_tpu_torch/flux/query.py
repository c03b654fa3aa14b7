"""Sketch-eligibility for stream-processor SQL — compile a query onto
flux state. The port of ``fluentbit_tpu/flux/query.py``.

A query is **sketch-eligible** when its aggregation can be maintained
incrementally by the flux plane at ingest rate (FLUX.md has the full
rule table):

- ``CREATE STREAM ... AS SELECT`` over ``TAG:'pattern'`` (snapshots and
  stream-to-stream sources stay on the exact path),
- a ``WINDOW TUMBLING/HOPPING`` clause with aggregates,
- no ``WHERE`` (predicate pushdown to the DFA plane is future work),
- aggregate functions within {COUNT, COUNT(DISTINCT k), SUM, MIN, MAX,
  AVG} — ``TIMESERIES_FORECAST`` needs the raw series,
- not opted out per query via ``WITH (flux='off')``.

Eligible queries get a :class:`FluxBinding`: a hidden ``flux`` filter
instance on the query's tag route updates state on the engine's device
inside the filter pass (one fused absorb per append: K10, or K10 per
shard and the merges when ``FBTPU_FLUX_MESH`` shards the state), and the
SPTask becomes a reader — its window tick renders rows straight from
flux state in the exact shape ``SPTask._rows_of`` would have produced.
Exact aggregates (COUNT/SUM/MIN/MAX/AVG) are bit-identical to the
Python evaluation path; COUNT(DISTINCT) returns the HLL estimate within
the documented error bound. An ineligible query keeps the exact path:
that is its semantics, not a fallback. ``attach_flux`` raises what
building the state or the filter raised, and ``Engine.sp_task`` passes
it on.
"""

from __future__ import annotations

import logging
import os
from typing import List

from .state import FluxSpec, FluxState, WindowSpec

log = logging.getLogger("flb.flux")

__all__ = ["FluxBinding", "eligible", "attach_flux"]

#: aggregate functions the flux plane can maintain incrementally
_FLUX_FUNCS = {"count", "count_distinct", "sum", "min", "max", "avg"}


def eligible(query) -> bool:
    """Pure shape check (no side effects) — see module docstring."""
    if query.kind != "stream" or query.source_type != "tag":
        return False
    if query.where is not None or query.window is None:
        return False
    if not query.has_aggregates:
        return False
    if str(query.props.get("flux", "")).lower() in ("off", "false", "0"):
        return False
    for k in query.keys:
        if k.func is None:
            continue
        if k.func not in _FLUX_FUNCS:
            return False
        if k.func in ("sum", "min", "max", "avg", "count_distinct"):
            if k.name is None:
                return False
            if "." in k.name:
                # dotted names resolve through NESTED maps on the exact
                # path (_get_key splits on '.'); the flux stagers only
                # see literal top-level keys — silently-wrong results,
                # so nested accessors stay on the exact path
                # (ROADMAP item 3 follow-up)
                return False
    if any("." in g for g in query.group_by):
        return False
    return True


def _build_spec(query, mesh: bool) -> FluxSpec:
    distinct: List[str] = []
    numeric: List[str] = []
    for k in query.keys:
        if k.func == "count_distinct" and k.name not in distinct:
            distinct.append(k.name)
        elif k.func in ("sum", "min", "max", "avg") \
                and k.name not in numeric:
            numeric.append(k.name)
    kind, size, advance = query.window
    p = int(query.props.get("flux_precision", 12) or 12)
    return FluxSpec(
        name=query.stream_name or "sp",
        group_by=query.group_by,
        distinct=distinct,
        numeric=numeric,
        window=WindowSpec(kind, size, advance),
        hll_p=p,
        max_len=int(query.props.get("flux_max_len", 256) or 256),
        mesh=mesh,
    )


class FluxBinding:
    """One flux-backed SPTask's read side: renders window rows from
    flux state in the exact ``SPTask._rows_of`` shape."""

    def __init__(self, query, state: FluxState):
        self.query = query
        self.state = state

    def _rows(self, closed) -> List[dict]:
        """One row per closed group; the registers come to the host with
        one copy per distinct field for all groups."""
        q = self.query
        rows: List[dict] = []
        for (key, g), est in zip(closed, self.state.estimates(closed)):
            row: dict = {}
            for gname, part in zip(q.group_by, key):
                row[gname] = None if part is None \
                    else part.decode("utf-8", "replace")
            for k in q.keys:
                if k.func:
                    row[k.out_name] = self._agg_result(g, est, k)
                elif k.name is not None:
                    row.setdefault(k.out_name, None)
            rows.append(row)
        return rows

    @staticmethod
    def _agg_result(g, est, k):
        if k.func == "count":
            return g.count
        if k.func == "count_distinct":
            return int(round(est[k.name]))
        st = g.cols[k.name]
        if k.func == "sum":
            return st.sum if st.has else 0.0
        if k.func == "avg":
            return ((st.sum if st.has else 0.0) / g.count
                    if g.count else 0.0)
        if k.func == "min":
            return st.min_value()
        if k.func == "max":
            return st.max_value()
        return None

    def rows_on_tick(self, now: float) -> List[dict]:
        return self._rows(self.state.tick(now))

    def rows_on_drain(self) -> List[dict]:
        return self._rows(self.state.drain())


def sql_mesh_enabled() -> bool:
    """SQL-backed states are built with ``spec.mesh`` when
    ``FBTPU_FLUX_MESH`` is 1/on/true (explicit, as in the reference);
    the state then shards over ``flux_mesh()``, which is None below two
    CUDA devices."""
    return os.environ.get("FBTPU_FLUX_MESH", "") in ("1", "on", "true")


def attach_flux(engine, task) -> bool:
    """Bind a sketch-eligible SPTask to flux state: build the state on
    the engine's device, install the hidden flux filter on the query's
    tag route, and flip the task into reader mode. False = not eligible
    (exact path); anything that fails raises."""
    query = task.query
    if not eligible(query):
        return False
    # the window clock is the task's (tests and the smoke inject both
    # through the same callable)
    state = FluxState(_build_spec(query, mesh=sql_mesh_enabled()),
                      now=task._now, device=engine.device)
    state._window_start = task._window_start
    engine.hidden_filter(
        "flux", state, match=query.source,
        alias=f"flux_sql_{query.stream_name or 'sp'}")
    task.flux = FluxBinding(query, state)
    log.info(
        "stream task %s resolved against flux state (%s); GROUP BY and "
        "COUNT(DISTINCT) fields must be strings at run time (other values "
        "land in the null group; WITH (flux='off') pins the exact path)",
        query.stream_name or query.source,
        "mesh" if state.spec.mesh else "single")
    return True

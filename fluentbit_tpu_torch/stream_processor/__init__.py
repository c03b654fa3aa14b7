"""Stream processor — inline SQL over the log stream.

The port's own copy of ``fluentbit_tpu/stream_processor`` (it imports
nothing of the reference package). Reference: src/stream_processor/
(flb_sp.c task runtime, sql.y grammar :37-65 CREATE STREAM, :108-160
select/keys, :253-276 windows, flb_sp_window.c tumbling/hopping,
flb_sp_groupby.c, flb_sp_aggregate_func.c AVG/SUM/COUNT/MIN/MAX +
TIMESERIES_FORECAST, flb_sp_snapshot.c). Invoked synchronously
post-filter at ingest (flb_sp_do, src/flb_input_chunk.c:3155); results
re-enter the pipeline through a hidden emitter (the
in_stream_processor pattern).

A hand-written recursive-descent parser and evaluator over the same
grammar subset (no flex/bison):

    CREATE STREAM name [WITH (tag='x')] AS
      SELECT *|keys|AGG(key)[ AS alias] FROM STREAM:name|TAG:'pattern'
      [WHERE cond] [WINDOW TUMBLING (N SECOND)
                   |WINDOW HOPPING (N SECOND, ADVANCE BY M SECOND)]
      [GROUP BY keys];

plus ``CREATE SNAPSHOT`` / ``FLUSH SNAPSHOT``. Aggregates: AVG, SUM,
COUNT, COUNT(DISTINCT k), MIN, MAX, TIMESERIES_FORECAST(key, N).
Conditions: comparisons, AND/OR/NOT, parentheses, IS [NOT] NULL,
@record.time() and @record.contains(key).

This is the exact path: host Python over decoded events, IEEE doubles
accumulated in record order. A sketch-eligible query instead reads
flux state (``flux.query.attach_flux`` sets ``SPTask.flux``), which the
hidden flux filter updates on the device. Nothing here catches an
error: a task that raises fails the append that ran it.
"""

from __future__ import annotations

import logging
import re
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..codec.events import decode_events, encode_event, now_event_time
from ..core.router import Route

log = logging.getLogger("flb.sp")

# ----------------------------------------------------------------- lexer

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>-?\d+(?:\.\d+)?)
      | '(?P<str>(?:[^'\\]|\\.)*)'
      | (?P<id>[A-Za-z_@][A-Za-z0-9_.\-]*)
      | (?P<op><=|>=|!=|<>|[(),;*=<>:])
    )""",
    re.VERBOSE,
)

KEYWORDS = {
    "create", "stream", "snapshot", "flush", "with", "as", "select",
    "from", "where", "window", "tumbling", "hopping", "advance", "by",
    "second", "minute", "hour", "group", "and", "or", "not", "is",
    "null", "tag", "limit", "distinct",
}

AGG_FUNCS = ("avg", "sum", "count", "min", "max", "timeseries_forecast")


class SQLError(ValueError):
    pass


def _tokenize(text: str) -> List[Tuple[str, Any]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip():
                raise SQLError(f"bad SQL near {text[pos:pos+20]!r}")
            break
        pos = m.end()
        if m.group("num") is not None:
            v = float(m.group("num"))
            out.append(("num", int(v) if v.is_integer() else v))
        elif m.group("str") is not None:
            out.append(("str", re.sub(r"\\(.)", r"\1", m.group("str"))))
        elif m.group("id") is not None:
            word = m.group("id")
            out.append(("kw", word.lower()) if word.lower() in KEYWORDS
                       else ("id", word))
        else:
            out.append(("op", m.group("op")))
    return out


# ------------------------------------------------------------------- AST

@dataclass
class SelectKey:
    name: Optional[str]          # None = *
    func: Optional[str] = None   # aggregate function
    alias: Optional[str] = None
    forecast_secs: int = 0       # TIMESERIES_FORECAST horizon

    @property
    def out_name(self) -> str:
        if self.alias:
            return self.alias
        if self.func == "count_distinct":
            return f"COUNT(DISTINCT {self.name})"
        if self.func:
            return f"{self.func.upper()}({self.name or '*'})"
        return self.name or "*"


@dataclass
class Query:
    stream_name: Optional[str]
    props: Dict[str, str]
    keys: List[SelectKey]
    source_type: str             # 'stream' | 'tag'
    source: str
    where: Optional[object]
    window: Optional[Tuple[str, float, float]]  # (kind, size_s, advance_s)
    group_by: List[str]
    # 'stream' | 'snapshot' | 'flush_snapshot' (FLB_SP_CREATE_STREAM /
    # CREATE_SNAPSHOT / FLUSH_SNAPSHOT command types, sql.y:108-146)
    kind: str = "stream"
    limit: int = 0               # CREATE SNAPSHOT ... LIMIT n

    @property
    def has_aggregates(self) -> bool:
        return any(k.func for k in self.keys)


class _Parser:
    def __init__(self, tokens: List[Tuple[str, Any]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind, value=None):
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise SQLError(f"expected {value or kind}, got {v!r}")
        return v

    def accept(self, kind, value=None) -> bool:
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.i += 1
            return True
        return False

    # CREATE STREAM name [WITH (...)] AS SELECT ... | SELECT ...
    def _parse_with(self, props: Dict[str, str]) -> None:
        if self.accept("kw", "with"):
            self.expect("op", "(")
            while True:
                k = self.next()[1]
                self.expect("op", "=")
                props[str(k)] = self.next()[1]
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")

    def parse(self) -> Query:
        name = None
        kind = "stream"
        props: Dict[str, str] = {}
        if self.accept("kw", "create"):
            if self.accept("kw", "snapshot"):
                # CREATE SNAPSHOT name [WITH(seconds=N)] AS SELECT *
                # FROM source [LIMIT n]  (sql.y:122-132)
                kind = "snapshot"
            else:
                self.expect("kw", "stream")
            name = self.expect("id")
            self._parse_with(props)
            self.expect("kw", "as")
        elif self.accept("kw", "flush"):
            # FLUSH SNAPSHOT name AS SELECT * FROM source WHERE cond
            # (sql.y:134-146)
            self.expect("kw", "snapshot")
            kind = "flush_snapshot"
            name = self.expect("id")
            self._parse_with(props)
            self.expect("kw", "as")
        q = self.parse_select()
        q.stream_name = name
        q.props = props
        q.kind = kind
        if kind == "snapshot" and q.limit == 0 and \
                not str(props.get("seconds", "")).strip():
            raise SQLError(
                f"snapshot {name!r}: size is not defined "
                "(use LIMIT n and/or WITH(seconds=N))")
        if kind != "snapshot" and q.limit:
            raise SQLError("LIMIT is only valid on CREATE SNAPSHOT")
        self.accept("op", ";")
        return q

    def parse_select(self) -> Query:
        self.expect("kw", "select")
        keys = [self.parse_select_key()]
        while self.accept("op", ","):
            keys.append(self.parse_select_key())
        self.expect("kw", "from")
        kind, v = self.next()
        low = str(v).lower()
        if low == "stream":
            source_type = "stream"
            self.expect("op", ":")
            source = str(self.expect("id"))
        elif low == "tag":
            source_type = "tag"
            self.expect("op", ":")
            source = str(self.next()[1])
        else:
            raise SQLError(
                f"expected STREAM:name or TAG:'pattern', got {v!r}"
            )
        where = None
        if self.accept("kw", "where"):
            where = self.parse_or()
        window = None
        if self.accept("kw", "window"):
            window = self.parse_window()
        group_by: List[str] = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self.expect("id"))
            while self.accept("op", ","):
                group_by.append(self.expect("id"))
        limit = 0
        if self.accept("kw", "limit"):
            k, v = self.next()
            if k != "num":
                raise SQLError(f"LIMIT needs a number, got {v!r}")
            limit = int(v)
        return Query(None, {}, keys, source_type, source, where, window,
                     group_by, limit=limit)

    def parse_select_key(self) -> SelectKey:
        k, v = self.next()
        if k == "op" and v == "*":
            return SelectKey(None)
        if k != "id":
            raise SQLError(f"bad select key {v!r}")
        name = str(v)
        if name.lower() in AGG_FUNCS and self.accept("op", "("):
            func = name.lower()
            if self.accept("op", "*"):
                arg = None
            elif func == "count" and self.accept("kw", "distinct"):
                # COUNT(DISTINCT key) — the cardinality aggregate the
                # flux plane answers with an HLL (exact evaluation
                # keeps a per-group value set)
                func = "count_distinct"
                arg = self.expect("id")
            else:
                arg = self.expect("id")
            horizon = 0
            if self.accept("op", ","):
                horizon = int(self.next()[1])
            self.expect("op", ")")
            alias = self.expect("id") if self.accept("kw", "as") else None
            return SelectKey(arg, func, alias, horizon)
        alias = self.expect("id") if self.accept("kw", "as") else None
        return SelectKey(name, None, alias)

    def parse_window(self) -> Tuple[str, float, float]:
        k, v = self.next()
        kind = str(v).lower()
        if kind not in ("tumbling", "hopping"):
            raise SQLError(f"unknown window kind {v!r}")
        self.expect("op", "(")
        size = float(self.next()[1]) * self._unit()
        advance = size
        if kind == "hopping":
            self.expect("op", ",")
            self.expect("kw", "advance")
            self.expect("kw", "by")
            advance = float(self.next()[1]) * self._unit()
        self.expect("op", ")")
        return (kind, size, advance)

    def _unit(self) -> float:
        k, v = self.next()
        unit = {"second": 1.0, "minute": 60.0, "hour": 3600.0}.get(v)
        if unit is None:
            raise SQLError(f"unknown time unit {v!r} "
                           f"(SECOND/MINUTE/HOUR)")
        return unit

    # -- conditions --

    def parse_or(self):
        left = self.parse_and()
        while self.accept("kw", "or"):
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept("kw", "and"):
            left = ("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept("kw", "not"):
            return ("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        if self.accept("op", "("):
            inner = self.parse_or()
            self.expect("op", ")")
            return inner
        left = self.parse_value()
        k, v = self.peek()
        if k == "op" and v in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            right = self.parse_value()
            return ("cmp", v, left, right)
        if k == "kw" and v == "is":
            self.next()
            negate = self.accept("kw", "not")
            self.expect("kw", "null")
            node = ("isnull", left)
            return ("not", node) if negate else node
        return ("truthy", left)

    def parse_value(self):
        k, v = self.next()
        if k == "num" or k == "str":
            return ("lit", v)
        if k == "kw" and v == "null":
            return ("lit", None)
        if k == "id":
            name = str(v)
            if name.startswith("@record."):
                fn = name[len("@record."):]
                self.expect("op", "(")
                arg = None
                if not self.accept("op", ")"):
                    arg = self.next()[1]
                    self.expect("op", ")")
                return ("recfn", fn, arg)
            if name.lower() in ("true", "false"):
                return ("lit", name.lower() == "true")
            return ("key", name)
        raise SQLError(f"bad value {v!r}")


def parse_sql(text: str) -> Query:
    return _Parser(_tokenize(text)).parse()


# -------------------------------------------------------------- evaluate

def _get_key(body: dict, name: str):
    if name in body:
        return body[name]
    cur = body
    for part in name.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def eval_cond(node, body: dict, ts: float) -> bool:
    kind = node[0]
    if kind == "or":
        return eval_cond(node[1], body, ts) or eval_cond(node[2], body, ts)
    if kind == "and":
        return eval_cond(node[1], body, ts) and eval_cond(node[2], body, ts)
    if kind == "not":
        return not eval_cond(node[1], body, ts)
    if kind == "isnull":
        return eval_value(node[1], body, ts) is None
    if kind == "truthy":
        return bool(eval_value(node[1], body, ts))
    if kind == "cmp":
        _, op, ln, rn = node
        lv = eval_value(ln, body, ts)
        rv = eval_value(rn, body, ts)
        if op in ("=",):
            return lv == rv
        if op in ("!=", "<>"):
            return lv != rv
        try:
            if op == "<":
                return lv < rv
            if op == "<=":
                return lv <= rv
            if op == ">":
                return lv > rv
            if op == ">=":
                return lv >= rv
        except TypeError:
            return False
    return False


def eval_value(node, body: dict, ts: float):
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "key":
        return _get_key(body, node[1])
    if kind == "recfn":
        fn, arg = node[1], node[2]
        if fn == "time":
            return ts
        if fn == "contains":
            return arg in body if isinstance(body, dict) else False
        raise SQLError(f"unknown @record function {fn!r}")
    return None


# ------------------------------------------------------------ aggregation

class _Agg:
    """Accumulator for one group (flb_sp_aggregate_func.c semantics)."""

    __slots__ = ("count", "sums", "mins", "maxs", "series", "distincts")

    def __init__(self):
        self.count = 0
        self.sums: Dict[str, float] = {}
        self.mins: Dict[str, Any] = {}
        self.maxs: Dict[str, Any] = {}
        self.series: Dict[str, List[Tuple[float, float]]] = {}
        # COUNT(DISTINCT key): exact per-group value sets — the
        # reference semantics the flux HLL approximates
        self.distincts: Dict[str, set] = {}

    def merge(self, other: "_Agg") -> None:
        """Union of two accumulators (hopping-window pane merge)."""
        self.count += other.count
        for n, v in other.sums.items():
            self.sums[n] = self.sums.get(n, 0.0) + v
        for n, v in other.mins.items():
            if n not in self.mins or v < self.mins[n]:
                self.mins[n] = v
        for n, v in other.maxs.items():
            if n not in self.maxs or v > self.maxs[n]:
                self.maxs[n] = v
        for n, s in other.series.items():
            self.series.setdefault(n, []).extend(s)
        for n, s in other.distincts.items():
            self.distincts.setdefault(n, set()).update(s)

    def add(self, body: dict, ts: float, keys: List[SelectKey]) -> None:
        self.count += 1
        seen = set()  # several aggregates may reference the same field
        for k in keys:
            if not k.func or k.name is None:
                continue
            n = k.name
            v = _get_key(body, n)
            if k.func == "count_distinct":
                if v is not None:
                    try:
                        self.distincts.setdefault(n, set()).add(v)
                    except TypeError:
                        pass  # unhashable (list/dict) values don't count
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if n not in seen:
                seen.add(n)
                self.sums[n] = self.sums.get(n, 0.0) + v
                if n not in self.mins or v < self.mins[n]:
                    self.mins[n] = v
                if n not in self.maxs or v > self.maxs[n]:
                    self.maxs[n] = v
            if k.func == "timeseries_forecast":
                self.series.setdefault(n, []).append((ts, float(v)))

    def result(self, key: SelectKey):
        n = key.name
        if key.func == "count":
            return self.count
        if key.func == "count_distinct":
            return len(self.distincts.get(n, ()))
        if key.func == "sum":
            return self.sums.get(n, 0.0)
        if key.func == "avg":
            return self.sums.get(n, 0.0) / self.count if self.count else 0.0
        if key.func == "min":
            return self.mins.get(n)
        if key.func == "max":
            return self.maxs.get(n)
        if key.func == "timeseries_forecast":
            return self._forecast(self.series.get(n, []),
                                  key.forecast_secs)
        return None

    @staticmethod
    def _forecast(series: List[Tuple[float, float]], horizon: float):
        """Simple linear regression forecast (the reference's
        TIMESERIES_FORECAST is least-squares over the window)."""
        n = len(series)
        if n < 2:
            return series[-1][1] if series else None
        t0 = series[0][0]
        xs = [t - t0 for t, _ in series]
        ys = [v for _, v in series]
        mx = sum(xs) / n
        my = sum(ys) / n
        denom = sum((x - mx) ** 2 for x in xs)
        slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
                 if denom else 0.0)
        intercept = my - slope * mx
        x_pred = xs[-1] + horizon
        return intercept + slope * x_pred


def project(body: dict, keys: List[SelectKey]) -> dict:
    """SELECT projection of one record."""
    out: Dict[str, Any] = {}
    for k in keys:
        if k.name is None and not k.func:
            out.update(body)
        else:
            out[k.out_name] = _get_key(body, k.name)
    return out


class SPTask:
    """One registered query (struct flb_sp_task)."""

    def __init__(self, sql: str, emit, now=None):
        self.query = parse_sql(sql)
        self.sql = sql
        self.emit = emit  # emit(tag, list_of_bodies)
        q = self.query
        self.out_tag = q.props.get("tag") or q.stream_name or "sp.results"
        self._route = (Route(match=q.source) if q.source_type == "tag"
                       else None)
        self._groups: Dict[tuple, _Agg] = {}
        # hopping windows: closed panes, newest last (size/advance many)
        self._panes: List[Dict[tuple, _Agg]] = []
        self._window_start = (now or time.time)()
        self._now = now or time.time
        # CREATE SNAPSHOT ring: (ts, body) bounded by LIMIT records
        # and/or WITH(seconds=N) age (flb_sp_snapshot.c pages)
        self._snap: List[tuple] = []
        self._snap_seconds = float(q.props.get("seconds", 0) or 0)
        # FLUSH SNAPSHOT looks its CREATE twin up through this hook
        # (flb_sp_snapshot_flush walks sp->tasks the same way)
        self.find_snapshot = lambda name: None
        # sketch-eligible queries resolve against flux state instead of
        # the per-event evaluation below (flux.query.attach_flux flips
        # this to a FluxBinding): the hidden flux filter absorbs the
        # records inside the filter pass, this task just reads windows
        self.flux = None

    def matches(self, tag: str, stream_name: Optional[str] = None) -> bool:
        if self.query.source_type == "tag":
            return self._route.matches(tag)
        return stream_name == self.query.source

    # -- ingest-side processing --

    # -- snapshots (flb_sp_snapshot.c) --

    def snapshot_update(self, ts: float, body: dict) -> None:
        self._snap.append((ts, body))
        if self.query.limit:
            del self._snap[:max(0, len(self._snap) - self.query.limit)]
        if self._snap_seconds > 0:
            cutoff = self._now() - self._snap_seconds
            i = 0
            while i < len(self._snap) and self._snap[i][0] < cutoff:
                i += 1
            if i:
                del self._snap[:i]

    def snapshot_take(self) -> List[tuple]:
        taken, self._snap = self._snap, []
        return taken

    def process(self, events: list, tag: str) -> None:
        q = self.query
        if self.flux is not None:
            # flux-backed: state was already updated inside the filter
            # chain (batched or per-record twin) — aggregating here
            # again would double-count
            return
        if q.kind == "snapshot":
            # WHERE and the SELECT projection apply to what gets
            # buffered, same as any other query kind
            for ev in events:
                if not isinstance(ev.body, dict):
                    continue
                if q.where is not None and \
                        not eval_cond(q.where, ev.body, ev.ts_float):
                    continue
                self.snapshot_update(ev.ts_float, self._project(ev.body))
            return
        if q.kind == "flush_snapshot":
            fire = any(
                isinstance(ev.body, dict)
                and (q.where is None
                     or eval_cond(q.where, ev.body, ev.ts_float))
                for ev in events)
            if not fire:
                return
            snap_task = self.find_snapshot(q.stream_name)
            if snap_task is None:
                return
            taken = snap_task.snapshot_take()
            if taken:
                # emit preserves the buffered records' own timestamps
                self.emit(self.out_tag, taken)
            return
        immediate: List[dict] = []
        for ev in events:
            body = ev.body
            if not isinstance(body, dict):
                continue
            ts = ev.ts_float
            if q.where is not None and not eval_cond(q.where, body, ts):
                continue
            if q.has_aggregates:
                gkey = tuple(_get_key(body, g) for g in q.group_by)
                agg = self._groups.get(gkey)
                if agg is None:
                    agg = self._groups[gkey] = _Agg()
                agg.add(body, ts, q.keys)
            else:
                immediate.append(self._project(body))
        if immediate:
            self.emit(self.out_tag, immediate)
        if q.has_aggregates and q.window is None:
            # no window: aggregates emit per processed chunk then reset
            self._emit_aggregates()

    def _project(self, body: dict) -> dict:
        return project(body, self.query.keys)

    def _rows_of(self, groups: Dict[tuple, _Agg]) -> List[dict]:
        q = self.query
        results = []
        for gkey, agg in groups.items():
            row: Dict[str, Any] = {}
            for gname, gval in zip(q.group_by, gkey):
                row[gname] = gval
            for k in q.keys:
                if k.func:
                    row[k.out_name] = agg.result(k)
                elif k.name is not None:
                    row.setdefault(k.out_name, None)
            results.append(row)
        return results

    def _emit_aggregates(self) -> None:
        results = self._rows_of(self._groups)
        self._groups.clear()
        if results:
            self.emit(self.out_tag, results)

    # -- window timer --

    def tick(self) -> None:
        """Close expired windows (flb_sp_window semantics). Tumbling:
        emit+reset every ``size``. Hopping: every ``advance`` the live
        pane closes and the emission aggregates the union of the last
        ``size/advance`` panes (a true sliding window over panes)."""
        q = self.query
        if self.flux is not None:
            rows = self.flux.rows_on_tick(self._now())
            if rows:
                self.emit(self.out_tag, rows)
            return
        if q.window is None or not q.has_aggregates:
            return
        kind, size, advance = q.window
        now = self._now()
        if kind == "tumbling":
            if now - self._window_start >= size:
                # advance by whole periods so tick latency never drifts
                # the window boundaries
                self._window_start += size * ((now - self._window_start)
                                              // size)
                self._emit_aggregates()
            return
        if now - self._window_start < advance:
            return
        self._window_start += advance * ((now - self._window_start)
                                         // advance)
        self._panes.append(self._groups)
        self._groups = {}
        n_panes = max(1, int(round(size / advance)))
        self._panes = self._panes[-n_panes:]
        merged: Dict[tuple, _Agg] = {}
        for pane in self._panes:
            for gkey, agg in pane.items():
                if gkey in merged:
                    merged[gkey].merge(agg)
                else:
                    m = _Agg()
                    m.merge(agg)
                    merged[gkey] = m
        results = self._rows_of(merged)
        if results:
            self.emit(self.out_tag, results)

    def drain(self) -> None:
        """Shutdown: emit whatever the open window accumulated."""
        if self.flux is not None:
            rows = self.flux.rows_on_drain()
            if rows:
                self.emit(self.out_tag, rows)
            return
        if self.query.window is not None and self.query.has_aggregates:
            for pane in self._panes:
                for gkey, agg in pane.items():
                    if gkey in self._groups:
                        self._groups[gkey].merge(agg)
                    else:
                        self._groups[gkey] = agg
            self._panes = []
            self._emit_aggregates()


class StreamProcessor:
    """flb_sp: the set of tasks + chunk hook + result re-ingestion."""

    def __init__(self, engine):
        self.engine = engine
        self.tasks: List[SPTask] = []
        # both set by Engine.sp_task (single place that also wires the
        # window-tick collector)
        self._emitter = None
        self.emitter_instance = None
        # the rows emitted between ``hold`` and ``release`` (None:
        # append them at once)
        self._held: Optional[list] = None

    def create_task(self, sql: str) -> SPTask:
        task = SPTask(sql, lambda tag, bodies: self._emit(task, tag, bodies))
        task.find_snapshot = self._find_snapshot
        self.tasks.append(task)
        return task

    def _find_snapshot(self, name: str):
        for t in self.tasks:
            if t.query.kind == "snapshot" and t.query.stream_name == name:
                return t
        return None

    def _emit(self, src_task: SPTask, tag: str, bodies: List[dict]) -> None:
        buf = bytearray()
        for b in bodies:
            if isinstance(b, tuple):  # snapshot flush: (orig_ts, body)
                ts, body = b
            else:
                ts, body = now_event_time(), b
            buf += encode_event(body, ts)
        data = bytes(buf)
        if self._emitter is None:
            raise RuntimeError(
                "stream processor emitter not wired — create tasks via "
                "Engine.sp_task"
            )
        if self._held is not None:
            self._held.append((tag, data, len(bodies)))
        else:
            self._emitter.add_record(tag, data, len(bodies))
        # stream-to-stream chaining: FROM STREAM:<name> consumes the
        # named stream's RESULTS (flb_sp_stream.c). Depth-bounded so a
        # cycle of streams (a←b, b←a) terminates instead of recursing
        name = src_task.query.stream_name
        if name:
            self._chain_depth = getattr(self, "_chain_depth", 0) + 1
            try:
                if self._chain_depth > 16:
                    log.warning(
                        "stream chain depth exceeded — cycle between "
                        "CREATE STREAM tasks? dropping further chaining"
                    )
                    return
                chained = decode_events(data)
                for t2 in self.tasks:
                    if t2 is not src_task and t2.matches(tag, name):
                        t2.process(chained, tag)
            finally:
                self._chain_depth -= 1

    def do(self, events: list, tag: str,
           stream_name: Optional[str] = None) -> None:
        """flb_sp_do — run every matching task over the filtered events
        (called at ingest, post-filter)."""
        for task in self.tasks:
            if task.matches(tag, stream_name):
                task.process(events, tag)

    def hold(self) -> None:
        """Hold the rows the tasks emit until ``release``: the engine
        wraps ``do`` (host Python only) in its handler of task errors,
        and the rows' re-entry through the filter chain, which may
        launch a kernel, stays outside it."""
        self._held = []

    def release(self) -> None:
        """Append the held rows in emit order (those emitted before a
        task raised included) and emit at once again."""
        held, self._held = self._held or [], None
        for tag, data, n in held:
            self._emitter.add_record(tag, data, n)

    def tick(self) -> None:
        for task in self.tasks:
            task.tick()

    def drain(self) -> None:
        """Shutdown: flush open windows so counted records are not lost."""
        for task in self.tasks:
            task.drain()

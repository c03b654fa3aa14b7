"""The port's stream processor against the reference's.

``fluentbit_tpu_torch.stream_processor`` is an exact host path, so the
port's ``parse_sql`` must give the reference's ``Query`` field for field
and raise ``SQLError`` with the same message on the same bad inputs, and
its ``SPTask`` / ``StreamProcessor`` must emit the same rows on the same
events (made from a numpy seed, encoded once, decoded by each package):
keys in order, values equal with their Python types (floats bit for bit,
NaN as NaN). Covered: projection and WHERE, per-chunk aggregates,
tumbling and hopping windows with GROUP BY over every aggregate
(TIMESERIES_FORECAST and COUNT(DISTINCT) included), CREATE SNAPSHOT /
FLUSH SNAPSHOT, a stream chain and drain. Then the engine: an exact task
on config 1's tag behind the grep filter sees every kept record and
forces the decoded path; without it the append goes raw again.
"""

import dataclasses
import json
import math
import struct

import numpy as np
import pytest

from fluentbit_tpu import stream_processor as jsp
from fluentbit_tpu.codec.events import encode_event as jencode
from fluentbit_tpu.codec.events import decode_events as jdecode
import fluentbit_tpu_torch as flb
from fluentbit_tpu_torch import stream_processor as tsp
from fluentbit_tpu_torch.codec.events import decode_events as tdecode
from fluentbit_tpu_torch.ops.device import DeviceError


def bodies(seed, n):
    """Records from a numpy seed: hosts and levels as labels, ints,
    floats, +-inf, NaN, booleans, strings, lists and missing values."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = {"host": ["a", "b", "c", None][int(rng.integers(4))],
                "level": ["info", "error", "debug"][int(rng.integers(3))],
                "user": f"u{int(rng.integers(12))}", "n": i}
        if body["host"] is None:
            del body["host"]
        r = rng.random()
        if r < 0.4:
            body["size"] = int(rng.integers(-10**9, 10**9))
        elif r < 0.75:
            body["size"] = float(rng.normal() * 1e3)
        elif r < 0.8:
            body["size"] = [float("inf"), -float("inf"), float("nan"), True,
                            "12", [1]][int(rng.integers(6))]
        if rng.random() < 0.3:
            body["nested"] = {"code": int(rng.integers(3))}
        out.append(body)
    return out


def encode(rows, ts0=1000.0):
    return b"".join(jencode(b, ts0 + 0.25 * i) for i, b in enumerate(rows))


def fbits(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v) if not math.isnan(v) else "nan")
    if isinstance(v, dict):
        return ("d", [(k, fbits(x)) for k, x in v.items()])
    if isinstance(v, list):
        return ("l", [fbits(x) for x in v])
    if isinstance(v, tuple):
        return ("t", [fbits(x) for x in v])
    return (type(v).__name__, v)


class Twin:
    """A reference task and a port task on one clock, fed the same
    bytes; ``check`` holds their emitted rows equal."""

    def __init__(self, sql):
        self.clock = [1000.0]
        self.got = {"ref": [], "port": []}
        now = lambda: self.clock[0]  # noqa: E731
        self.ref = jsp.SPTask(sql, lambda tag, rows: self.got["ref"].append(
            (tag, rows)), now=now)
        self.port = tsp.SPTask(sql, lambda tag, rows: self.got["port"].append(
            (tag, rows)), now=now)

    def process(self, buf, tag="app.log"):
        self.ref.process(jdecode(buf), tag)
        self.port.process(tdecode(buf), tag)
        self.check()

    def tick(self, at):
        self.clock[0] = at
        self.ref.tick()
        self.port.tick()
        self.check()

    def drain(self):
        self.ref.drain()
        self.port.drain()
        self.check()

    def check(self):
        assert fbits(self.got["port"]) == fbits(self.got["ref"])


QUERIES = [
    "SELECT * FROM TAG:'app.*' WHERE size > 0 AND NOT level = 'debug';",
    "SELECT host, size AS s, nested.code FROM TAG:'app.*' "
    "WHERE host IS NOT NULL OR @record.contains(nested);",
    "SELECT n FROM TAG:'app.*' WHERE @record.time() >= 1010 "
    "AND (size <= 100 OR size = 'x');",
    "CREATE STREAM agg WITH (tag='agg') AS SELECT COUNT(*) AS c, "
    "AVG(size), SUM(size), MIN(size), MAX(size), COUNT(DISTINCT user) "
    "FROM TAG:'app.*';",
    "SELECT host, COUNT(*), AVG(size) AS a, SUM(size), MIN(size), "
    "MAX(size), TIMESERIES_FORECAST(size, 30) AS f, "
    "COUNT(DISTINCT user) AS u FROM TAG:'app.*' "
    "WINDOW TUMBLING (1 MINUTE) GROUP BY host;",
    "SELECT host, level, COUNT(*), SUM(size), MAX(n) FROM TAG:'app.*' "
    "WHERE level != 'debug' WINDOW HOPPING (60 SECOND, ADVANCE BY 20 "
    "SECOND) GROUP BY host, level;",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_task_rows_equal_reference(sql):
    """Three appends with window ticks between them, then drain."""
    twin = Twin(sql)
    assert dataclasses.asdict(twin.port.query) == \
        dataclasses.asdict(twin.ref.query)
    for step, seed in enumerate((1, 2, 3)):
        twin.process(encode(bodies(seed, 80), 1000.0 + 20 * step))
        twin.tick(1000.0 + 21 * (step + 1))
    twin.tick(1070.0)
    twin.drain()
    assert twin.got["ref"]


def test_timeseries_forecast_equals_reference():
    twin = Twin("SELECT TIMESERIES_FORECAST(v, 5) AS f, "
                "TIMESERIES_FORECAST(w, 2) FROM TAG:'*';")
    rows = [{"v": float(i) * 1.5, "w": i * i} for i in range(10)]
    twin.process(encode(rows))
    twin.process(encode(rows[:1]))                     # one point
    # v = 6 per second along 0.25 s steps: 13.5 at 2.25 s, 43.5 at 7.25 s
    assert twin.got["port"][0][1][0]["f"] == pytest.approx(43.5)


SQLS = [
    "CREATE STREAM errors WITH (tag='app.errors', x=3) AS SELECT code, "
    "msg AS message FROM TAG:'app.*' WHERE level = 'error' AND code >= 500;",
    "CREATE STREAM s AS SELECT COUNT(*), AVG(size) AS a FROM STREAM:base "
    "WINDOW TUMBLING (5 SECOND) GROUP BY host;",
    "SELECT COUNT(*) FROM TAG:'x' WINDOW HOPPING (10 SECOND, ADVANCE BY 2 "
    "SECOND);",
    "SELECT COUNT(DISTINCT user) FROM TAG:'x';",
    "CREATE SNAPSHOT s WITH(seconds=5) AS SELECT * FROM TAG:'x' LIMIT 4;",
    "FLUSH SNAPSHOT s AS SELECT * FROM TAG:'x' WHERE a = 1;",
    "SELECT a FROM TAG:'x' WHERE b IS NULL AND c <> 'it''s' OR d < -1.5;",
    "SELECT * FROM TAG:'x' WHERE true;",
]

BAD_SQLS = [
    "SELECT FROM TAG:'x';",
    "SELECT * FROM NOWHERE:'x';",
    "CREATE SNAPSHOT s AS SELECT * FROM TAG:'x';",
    "CREATE STREAM s AS SELECT * FROM TAG:'x' LIMIT 5;",
    "SELECT * FROM TAG:'x' WINDOW SLIDING (5 SECOND);",
    "SELECT * FROM TAG:'x' WINDOW TUMBLING (5 DAY);",
    "SELECT * FROM TAG:'x' LIMIT y;",
    "SELECT * FROM TAG:'x' WHERE a = ;",
    "SELECT * FROM TAG:'x' WHERE a = 1 ~",
    "CREATE TABLE t AS SELECT * FROM TAG:'x';",
]


@pytest.mark.parametrize("sql", SQLS)
def test_parse_equals_reference(sql):
    assert dataclasses.asdict(tsp.parse_sql(sql)) == \
        dataclasses.asdict(jsp.parse_sql(sql))


@pytest.mark.parametrize("sql", BAD_SQLS)
def test_sql_errors_equal_reference(sql):
    with pytest.raises(jsp.SQLError) as want:
        jsp.parse_sql(sql)
    with pytest.raises(tsp.SQLError) as got:
        tsp.parse_sql(sql)
    assert str(got.value) == str(want.value)


class Capture:
    """The SP's hidden emitter, recording what it is handed."""

    def __init__(self, decode):
        self.decode = decode
        self.rows = []

    def add_record(self, tag, data, n):
        evs = self.decode(data)
        assert len(evs) == n
        self.rows.append((tag, [ev.body for ev in evs]))


def processors():
    out = []
    for mod, decode in ((jsp, jdecode), (tsp, tdecode)):
        sp = mod.StreamProcessor(engine=None)
        sp._emitter = Capture(decode)
        out.append(sp)
    return out


def test_snapshots_and_stream_chain_equal_reference():
    """CREATE SNAPSHOT (LIMIT 3) + FLUSH SNAPSHOT on an error record, and
    a stream that reads another stream's results, through each
    package's StreamProcessor: the emitted rows (and the snapshot's own
    timestamps) are equal."""
    sqls = ["CREATE SNAPSHOT recent AS SELECT n, level FROM TAG:'logs' "
            "LIMIT 3;",
            "FLUSH SNAPSHOT recent AS SELECT * FROM TAG:'logs' "
            "WHERE level = 'error';",
            "CREATE STREAM big WITH (tag='big.out') AS SELECT n, size FROM "
            "TAG:'logs' WHERE size > 0;",
            "CREATE STREAM bigger WITH (tag='bigger.out') AS SELECT n FROM "
            "STREAM:big WHERE size > 500;"]
    sps = processors()
    for sp in sps:
        for sql in sqls:
            sp.create_task(sql)
    for seed in (4, 5, 6):
        buf = encode(bodies(seed, 30))
        sps[0].do(jdecode(buf), "logs")
        sps[1].do(tdecode(buf), "logs")
    for sp in sps:
        sp.tick()
        sp.drain()
    want, got = sps[0]._emitter.rows, sps[1]._emitter.rows
    assert fbits(got) == fbits(want)
    assert {tag for tag, _ in want} == {"recent", "big.out", "bigger.out"}


# ---------------------------------------------------------------------------
# the engine: the raw gate's stream-processor term
# ---------------------------------------------------------------------------


def apache(i):
    return (f'10.0.0.{i % 256} - u{i} [10/Oct/2000:13:55:36 -0700] '
            f'"GET /p/{i} HTTP/1.1" {200 + i % 3} {i}')


def test_exact_task_forces_the_decoded_path():
    """Config 1 (lib → grep → lib) with an exact task on its tag: every
    record grep keeps reaches the task and the append is decoded; once
    the task is gone, the same append takes the raw path again."""
    APACHE2 = (
        r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
        r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
        r'(?<code>[^ ]*) (?<size>[^ ]*)'
        r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$')
    ctx = flb.create(device="cpu", flush="50ms", grace="1")
    ctx.input("lib", tag="bench.apache")
    ctx.filter("grep", match="bench.*", regex="log " + APACHE2)
    out = {}
    ctx.output("lib", match="*", callback=lambda d, tag: out.setdefault(
        tag, []).extend(ev.body for ev in tdecode(d)))
    task = ctx.sp_task("CREATE STREAM c WITH (tag='sp.count') AS SELECT "
                       "COUNT(*) AS n, MAX(i) FROM TAG:'bench.*' "
                       "WHERE i >= 0;")
    assert task.flux is None                           # WHERE: exact
    ctx.start()
    engine = ctx.engine
    grep = engine.filters[0].plugin
    ins = engine.inputs[0]
    recs = [{"log": apache(i) if i % 5 else "junk", "i": i}
            for i in range(200)]
    data = b"".join(jencode(r, 1.0) for r in recs)
    try:
        assert engine.input_log_append(ins, "bench.apache", data) == 160
        assert grep.raw_timings["records"] == 0        # decoded
        engine.sp.tasks.remove(task)
        assert engine.input_log_append(ins, "bench.apache", data) == 160
        assert grep.raw_timings["records"] == 200      # raw again
        ctx.flush_now()
    finally:
        ctx.stop()
    assert out["sp.count"] == [{"n": 160, "MAX(i)": 199}]
    assert len(out["bench.apache"]) == 320


def test_sp_error_fails_the_append(caplog):
    """A task that raises no longer fails the append (the name is kept
    from when it did): the error is logged as "stream processor failed"
    and the append's records reach the output, as in the reference."""
    ctx = flb.create(device="cpu", flush="50ms", grace="1")
    ctx.input("lib", tag="t")
    got = []
    ctx.output("lib", match="t", callback=lambda d, tag: got.extend(
        ev.body for ev in tdecode(d)))
    task = ctx.sp_task("SELECT * FROM TAG:'t';")

    def boom(events, tag):
        raise RuntimeError("task failed")

    task.process = boom
    ctx.start()
    try:
        with caplog.at_level("ERROR", logger="flb.engine"):
            assert ctx.push(0, json.dumps([{"a": 1}, {"a": 2}])) == 2
        ctx.flush_now()
    finally:
        ctx.stop()
    assert got == [{"a": 1}, {"a": 2}]
    failed = [r for r in caplog.records
              if r.getMessage() == "stream processor failed"]
    assert failed and "task failed" in failed[0].exc_text


def test_sp_rows_reentry_error_still_raises():
    """The rows a task emits re-enter the filter chain outside the
    handler of task errors: a filter that raises a device error on them
    (as a failed kernel launch does) still fails the append; a host
    error there is logged by the filter chain's policy."""
    ctx = flb.create(device="cpu", flush="50ms", grace="1")
    ctx.input("lib", tag="t")
    ctx.filter("grep", match="sp.out", regex="a x")
    ctx.sp_task("CREATE STREAM s WITH (tag='sp.out') AS SELECT a FROM "
                "TAG:'t';")
    grep = ctx.engine.filters[0]

    def boom(events, tag, engine):
        raise DeviceError("launch failed")

    ctx.start()
    grep.plugin.filter = boom
    try:
        with pytest.raises(DeviceError, match="launch failed"):
            ctx.push(0, json.dumps({"a": 1}))
        assert ctx.engine.sp._held is None
        assert ctx.engine.m_device_failures.get(("grep",)) == 1
    finally:
        ctx.stop()


def _group_by_run(create, decode, key_value, **kw):
    """One push of a non-hashable ``tag_k`` and a string one through an
    exact GROUP BY task; returns (push's count, output rows by tag, the
    logged errors)."""
    import logging

    ctx = create(flush="50ms", grace="1", **kw)
    in_ffd = ctx.input("lib", tag="app.x")
    got = {}
    ctx.output("lib", match="*", callback=lambda d, tag: got.setdefault(
        tag, []).extend(ev.body for ev in decode(d)))
    ctx.sp_task("SELECT tag_k, COUNT(*) FROM TAG:'app.*' GROUP BY tag_k;")
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Grab(logging.ERROR)
    logging.getLogger("flb.engine").addHandler(handler)
    ctx.start()
    try:
        n = ctx.push(in_ffd, json.dumps([
            [1700000000, {"tag_k": key_value, "m": 1}],
            [1700000001, {"tag_k": "a", "m": 2}]]))
        ctx.flush_now()
    finally:
        ctx.stop()
        logging.getLogger("flb.engine").removeHandler(handler)
    errors = [(r.getMessage(), r.exc_info[0].__name__) for r in records]
    return n, got, errors


@pytest.mark.parametrize("key_value", [[1, 2], {"x": 1}],
                         ids=["list", "map"])
def test_unhashable_group_key_keeps_the_append_in_both(key_value):
    """The exact task raises ``TypeError`` on a list- or map-valued
    GROUP BY key in both packages; both engines log it and keep the
    append's records, which reach the lib output unchanged."""
    import fluentbit_tpu as ref

    want = _group_by_run(ref.create, jdecode, key_value)
    port = _group_by_run(flb.create, tdecode, key_value, device="cpu")
    assert port == want
    n, got, errors = port
    assert n == 2
    assert got == {"app.x": [{"tag_k": key_value, "m": 1},
                             {"tag_k": "a", "m": 2}]}
    assert errors == [("stream processor failed", "TypeError")]


def test_window_task_after_start_ticks_and_drains():
    """sp_task after start(): its window collector is scheduled; an open
    window is drained and flushed at stop."""
    import time

    ctx = flb.create(device="cpu", flush="50ms", grace="1")
    in_ffd = ctx.input("lib", tag="t")
    got = {}
    ctx.output("lib", match="*", callback=lambda d, tag: got.setdefault(
        tag, []).extend(ev.body for ev in tdecode(d)))
    ctx.start()
    try:
        ctx.sp_task("CREATE STREAM w WITH (tag='w.out') AS SELECT COUNT(*) "
                    "AS n FROM TAG:'t' WINDOW TUMBLING (1 SECOND);")
        ctx.sp_task("CREATE STREAM long WITH (tag='long.out') AS SELECT "
                    "COUNT(*) AS n FROM TAG:'t' WINDOW TUMBLING (60 SECOND);")
        ctx.push(in_ffd, json.dumps({"a": 1}))
        ctx.push(in_ffd, json.dumps({"a": 2}))
        deadline = time.time() + 6
        while time.time() < deadline and "w.out" not in got:
            time.sleep(0.05)
    finally:
        ctx.stop()
    assert sum(r["n"] for r in got.get("w.out", [])) == 2
    assert got["long.out"] == [{"n": 2}]

"""Flux's SQL mode in the port against the reference's, and its exact path.

``Engine.sp_task`` with a sketch-eligible query binds the task to flux
state kept by a hidden ``flux`` filter (``flux.query.attach_flux``) on
the engine's device, here the CPU (the kernels' plain versions).
``eligible`` must give the reference's verdict on FLUX.md's table; the
flux-backed rows must equal the reference's flux-backed rows exactly
(COUNT(DISTINCT) included: both estimate from equal registers) and the
port's exact path (``allow_flux=False``) exactly but for COUNT(DISTINCT),
which lies within max(3, 10%) of the exact distinct count
(tests/test_flux_sql.py's bound); under ``FBTPU_FLUX_MESH=1`` with a
hand-built ``Mesh((cpu,) * 8)`` the rows equal the unsharded run's. An
``attach_flux`` that raises makes ``sp_task`` raise.
"""

import math
import random

import pytest
import torch

from fluentbit_tpu.codec.events import encode_event
from fluentbit_tpu.core.engine import Engine as JEngine
from fluentbit_tpu.flux.query import eligible as jeligible
from fluentbit_tpu.stream_processor import parse_sql as jparse
from fluentbit_tpu_torch.core.engine import Engine as TEngine
from fluentbit_tpu.flux import query as jquery
from fluentbit_tpu_torch.flux import query as tquery
from fluentbit_tpu_torch.ops.device import DeviceError
from fluentbit_tpu_torch.ops.mesh import Mesh
from fluentbit_tpu_torch.stream_processor import parse_sql as tparse

import fluentbit_tpu_torch.plugins  # noqa: F401  (registers the plugins)

SQL = ("CREATE STREAM s WITH (tag='out') AS "
       "SELECT tenant, COUNT(*), COUNT(DISTINCT user) AS uniq, "
       "SUM(size) AS sz, MIN(size), MAX(size), AVG(size) "
       "FROM TAG:'app.*' WINDOW TUMBLING (60 SECOND) GROUP BY tenant;")
HOPPING = ("CREATE STREAM h AS SELECT tenant, COUNT(*), SUM(size) AS sz, "
           "COUNT(DISTINCT user) AS uniq FROM TAG:'app.*' "
           "WINDOW HOPPING (60 SECOND, ADVANCE BY 20 SECOND) "
           "GROUP BY tenant;")

#: FLUX.md's eligibility table, row by row (tests/test_flux_sql.py)
ELIGIBILITY = [
    (SQL, True),
    ("CREATE STREAM s AS SELECT COUNT(*) FROM TAG:'a' GROUP BY t;", False),
    ("CREATE STREAM s AS SELECT COUNT(*) FROM TAG:'a' "
     "WHERE x = 1 WINDOW TUMBLING (5 SECOND);", False),
    ("CREATE STREAM s AS SELECT TIMESERIES_FORECAST(v, 10) "
     "FROM TAG:'a' WINDOW TUMBLING (5 SECOND);", False),
    ("CREATE STREAM s AS SELECT COUNT(*) FROM STREAM:base "
     "WINDOW TUMBLING (5 SECOND);", False),
    ("CREATE STREAM s WITH (flux='off') AS SELECT COUNT(*) "
     "FROM TAG:'a' WINDOW TUMBLING (5 SECOND);", False),
    ("CREATE STREAM s AS SELECT a, b FROM TAG:'a' "
     "WINDOW TUMBLING (5 SECOND);", False),
    ("CREATE STREAM s AS SELECT COUNT(*) FROM TAG:'a' "
     "WINDOW HOPPING (10 SECOND, ADVANCE BY 2 SECOND);", True),
    ("CREATE STREAM s AS SELECT AVG(http.status) FROM TAG:'a' "
     "WINDOW TUMBLING (5 SECOND);", False),
    ("CREATE STREAM s AS SELECT COUNT(*) FROM TAG:'a' "
     "WINDOW TUMBLING (5 SECOND) GROUP BY k8s.pod;", False),
    ("CREATE SNAPSHOT s AS SELECT * FROM TAG:'a' LIMIT 3;", False),
    ("CREATE STREAM s WITH (flux='false') AS SELECT COUNT(DISTINCT u) "
     "FROM TAG:'a' WINDOW TUMBLING (5 SECOND);", False),
    ("SELECT SUM(*) FROM TAG:'a' WINDOW TUMBLING (5 SECOND);", False),
]


@pytest.mark.parametrize("sql,want", ELIGIBILITY)
def test_eligibility_equals_reference(sql, want):
    assert tquery.eligible(tparse(sql)) is jeligible(jparse(sql)) is want


def corpus(rng, n):
    """tests/test_flux_sql.py's records: three tenants and a missing one,
    60 users, big ints, floats, +-inf, -0.0, booleans, None, strings and
    lists."""
    buf = bytearray()
    for i in range(n):
        body = {}
        if rng.random() > 0.05:
            body["tenant"] = rng.choice(["acme", "globex", "init"])
        if rng.random() > 0.05:
            body["user"] = f"u{rng.randrange(60)}"
        r = rng.random()
        if r < 0.3:
            body["size"] = rng.randrange(-10**12, 10**12)
        elif r < 0.6:
            body["size"] = rng.uniform(-1e6, 1e6)
        elif r < 0.7:
            body["size"] = rng.choice(
                [float("inf"), -float("inf"), 0.0, -0.0, True, None,
                 "123", [1]])
        buf += encode_event(body, 1000.0 + i)
    return bytes(buf)


def engine(kind, sql, allow_flux=True, mesh=None):
    """A reference or port engine with one task, a lib/dummy input and
    the task's window clock at 1000 s; the task's rows are captured."""
    t = [1000.0]
    e = JEngine() if kind == "ref" else TEngine(device=torch.device("cpu"))
    task = e.sp_task(sql, allow_flux=allow_flux)
    task._now = lambda: t[0]
    task._window_start = 1000.0
    if task.flux is not None:
        st = task.flux.state
        st._now = task._now
        st._window_start = 1000.0
        if mesh is not None:
            st._mesh = mesh
    out = []
    task.emit = lambda tag, rows: out.append((tag, rows))
    ins = e.input("dummy" if kind == "ref" else "lib")
    for x in e.inputs + e.filters:
        if not getattr(x, "_initialized", False):
            x.configure()
            x.plugin.init(x, e)
    return e, ins, task, out, t


def run(kind, sql, seed, allow_flux=True, mesh=None, steps=4, step_s=61):
    e, ins, task, out, clock = engine(kind, sql, allow_flux, mesh)
    rng = random.Random(seed)
    for step in range(steps):
        e.input_log_append(ins, "app.x", corpus(rng, 250))
        clock[0] = 1000.0 + step_s * (step + 1)
        task.tick()
    task.drain()
    return task, out


def same_value(a, b) -> bool:
    """Equal with the same type; NaN equals NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def assert_rows(got, want, uniq_bound=False):
    assert len(got) == len(want) > 0
    for (tag1, rows1), (tag2, rows2) in zip(got, want):
        assert tag1 == tag2 and len(rows1) == len(rows2)
        for r1, r2 in zip(rows1, rows2):
            assert list(r1) == list(r2)
            for k in r2:
                if uniq_bound and k == "uniq":
                    assert abs(r1[k] - r2[k]) <= max(3.0, 0.10 * r2[k])
                else:
                    assert same_value(r1[k], r2[k]), (k, r1[k], r2[k])


@pytest.mark.parametrize("sql,seed", [(SQL, 11), (SQL, 12), (HOPPING, 13)])
def test_flux_rows_equal_reference_and_exact_path(sql, seed):
    task, got = run("port", sql, seed, step_s=61 if sql is SQL else 21)
    assert task.flux is not None
    _, want = run("ref", sql, seed, step_s=61 if sql is SQL else 21)
    assert_rows(got, want)
    exact_task, exact = run("port", sql, seed, allow_flux=False,
                            step_s=61 if sql is SQL else 21)
    assert exact_task.flux is None
    assert_rows(got, exact, uniq_bound=True)


def test_flux_rows_on_a_mesh_equal_unsharded(monkeypatch):
    """FBTPU_FLUX_MESH=1 builds the state with spec.mesh (None on a host
    without two CUDA devices); over a hand-built 8-shard CPU mesh every
    row equals the unsharded run's, and the absorbs went through the
    mesh half."""
    monkeypatch.setenv("FBTPU_FLUX_MESH", "1")
    calls = []
    from fluentbit_tpu_torch.flux import kernels

    sharded = kernels.sharded_fused_absorb
    monkeypatch.setattr(kernels, "sharded_fused_absorb",
                        lambda *a, **kw: calls.append(1) or sharded(*a, **kw))
    task, got = run("port", SQL, 21,
                    mesh=Mesh((torch.device("cpu"),) * 8, "flux"))
    assert task.flux.state.spec.mesh and len(calls) == 4
    monkeypatch.delenv("FBTPU_FLUX_MESH")
    task, want = run("port", SQL, 21)
    assert not task.flux.state.spec.mesh and task.flux.state._mesh is None
    assert_rows(got, want)


def test_hidden_filter_stays_last_and_skips_the_sp_emitter():
    e, ins, task, out, clock = engine("port", SQL)
    hidden = [f for f in e.filters if f.plugin.name == "flux"]
    assert len(hidden) == 1 and hidden[0].route.matches("app.x")
    assert not hidden[0].route.matches("db.y")
    g = e.filter("grep", match="app.*", exclude="user ^drop")
    g.configure()
    g.plugin.init(g, e)
    assert [f.plugin.name for f in e.filters] == ["grep", "flux"]
    raw = b"".join(encode_event(
        {"tenant": "a", "user": ("drop" if i % 2 else "keep"), "size": 1},
        1000.0) for i in range(20))
    e.input_log_append(ins, "app.x", raw)
    # the SP's own emitter re-enters the chain: flux does not absorb it
    e.input_log_append(e.sp.emitter_instance, "app.y", raw)
    clock[0] = 1061.0
    task.tick()
    assert out[0][1][0]["COUNT(*)"] == 10


def test_sp_task_raises_when_attach_flux_raises(monkeypatch, caplog):
    """A host error in ``attach_flux`` no longer raises (the name is kept
    from when it did): it is logged and the query stays on the exact
    path, as in the reference. A device error still raises, counted
    under lane flux, and leaves no task."""
    def boom(*args, **kwargs):
        raise RuntimeError("attach failed")

    monkeypatch.setattr(tquery, "FluxState", boom)
    monkeypatch.setattr(jquery, "FluxState", boom)
    tasks = []
    for e in (TEngine(device=torch.device("cpu")), JEngine()):
        with caplog.at_level("ERROR", logger="flb.engine"):
            task = e.sp_task(SQL)
        assert e.sp.tasks == [task] and task.flux is None
        tasks.append(task)
    assert [r.getMessage().split(";")[0] for r in caplog.records] == [
        "flux attach failed"] * 2

    def device_boom(*args, **kwargs):
        raise DeviceError("flux absorb failed: CUDA error 700", lane="flux")

    monkeypatch.setattr(tquery, "FluxState", device_boom)
    e = TEngine(device=torch.device("cpu"))
    with pytest.raises(DeviceError, match="CUDA error 700"):
        e.sp_task(SQL)
    assert e.sp.tasks == []
    assert e.m_device_failures.get(("flux",)) == 1
    # an ineligible query never reaches it
    task = e.sp_task(SQL.replace("WITH (tag='out')",
                                 "WITH (tag='out', flux='off')"))
    assert task.flux is None

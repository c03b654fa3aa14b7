"""The port's failpoint plane and device error class against the
reference.

- The DSL: ``parse_spec`` gives the reference's terms for the same spec
  and refuses the same bad ones; for the same seed a site's schedule
  (which hits fire, and what they do) is the reference's, and the env
  loader, the snapshot and the listeners agree.
- Every site the port threads fires in a pipeline of each package, with
  the same appends: the deliveries, the output families and
  ``fluentbit_failpoint_triggered_total`` are equal (the forward sites
  over an edge and an aggregator of each package, their acks, resends
  and absorbed chunks equal). A hung output (``output.flush.<name>``
  with ``hang``) leaves its sibling route whole and recovers through
  its breaker's probe in both.
- ``device.dispatch`` on the plain route: the append raises
  ``DeviceError`` on the raw path (grep's K3 route) and the decoded path
  (its device match), counted once in
  ``fluentbit_device_launch_failures_total{lane="grep"}``, and the next
  append's records equal the reference's. An unarmed plane adds no work.
- An AST check over ``core/engine.py``, ``core/output_thread.py``,
  ``flux/plugin.py`` and the filter plugins: every broad ``except``
  (``Exception``, ``RuntimeError``, ``BaseException``) re-raises device
  errors first, but for the sites listed in ``NO_LAUNCH``, which reach
  no launch.
"""

import ast
import asyncio
import json
import pathlib
import time

import pytest
import torch

import fluentbit_tpu as ref
import fluentbit_tpu_torch as flb
from fluentbit_tpu import failpoints as rfp
from fluentbit_tpu.codec.events import decode_events as ref_decode
from fluentbit_tpu.codec.events import encode_event as ref_encode
from fluentbit_tpu.core.engine import Engine as RefEngine
from fluentbit_tpu.core.tls import open_connection as ref_open
from fluentbit_tpu_torch import failpoints as tfp
from fluentbit_tpu_torch.codec.events import decode_events, encode_event
from fluentbit_tpu_torch.codec.msgpack import Unpacker
from fluentbit_tpu_torch.core.engine import Engine
from fluentbit_tpu_torch.core.tls import open_connection as port_open
from fluentbit_tpu_torch.ops.device import DEVICE_ERRORS, DeviceError
from fluentbit_tpu_torch.plugins.filter_grep import GrepFilter
from test_torch_forward_output import (SHARED_KEY, Aggregator, expected_bytes,
                                       make_chunks, run_edge)

PLANES = {"ref": rfp, "port": tfp}
CREATE = {"ref": ref.create,
          "port": lambda **kw: flb.create(device="cpu", **kw)}
DECODE = {"ref": ref_decode, "port": decode_events}
PKG_ROOT = pathlib.Path(flb.__file__).resolve().parent


@pytest.fixture(autouse=True)
def _clean_planes():
    for fp in PLANES.values():
        fp.reset()
    yield
    for fp in PLANES.values():
        fp.reset()


def wait_for(cond, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.01)
    raise TimeoutError("condition not met")


# ----------------------------------------------------------------- the DSL

SPECS = ["off", "return", "return(reset)", "2*off->1*return(boom)",
         "25%return(x)", "12.5%3*delay(5)", "hang", "hang(5000)",
         "partial(6)", "panic", "1*crash", "50%off->delay(0)->return"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equals_reference(spec):
    def terms(fp):
        return [(t.pct, t.limit, t.action, t.arg, t.fired)
                for t in fp.parse_spec(spec)]

    assert terms(tfp) == terms(rfp)


@pytest.mark.parametrize("bad", ["", "explode", "return(x", "12%%off",
                                 "x*off", "delay(abc)", "partial(1.5)"])
def test_bad_specs_rejected_by_both(bad):
    for fp in PLANES.values():
        with pytest.raises(ValueError):
            fp.parse_spec(bad)


def hits(fp, name, n):
    """What each of ``n`` hits of ``name`` does: None, the directive, or
    the exception's type name."""
    out = []
    for _ in range(n):
        try:
            out.append(fp.fire(name))
        except (OSError, RuntimeError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("seed", ["0", "1234", "99"])
def test_schedule_for_a_seed_equals_reference(monkeypatch, seed):
    monkeypatch.setenv(rfp.SEED_VAR, seed)
    spec = ("30%2*return(a)->40%3*partial(9)->3*off->50%4*delay(0)"
            "->25%panic")
    got = {}
    for pkg, fp in PLANES.items():
        fp.enable("t.sched", spec)
        got[pkg] = (hits(fp, "t.sched", 80), fp.snapshot())
    assert got["port"] == got["ref"]
    assert {"FailpointError", "RuntimeError", ("partial", 9), None} <= set(
        got["port"][0])


def test_actions_equal_reference():
    for fp in PLANES.values():
        fp.enable("t.x", "2*off->1*return(boom)")
        fp.enable("t.p", "partial(6)")
        fp.enable("t.k", "panic")
        fp.enable("t.d", "delay(1)")
    got = {pkg: (hits(fp, "t.x", 4), hits(fp, "t.p", 2), hits(fp, "t.k", 1),
                 hits(fp, "t.d", 1), fp.snapshot(), fp.ACTIVE)
           for pkg, fp in PLANES.items()}
    assert got["port"] == got["ref"]
    assert got["port"][0] == [None, None, "FailpointError", None]
    assert issubclass(tfp.FailpointError, OSError)

    async def run(fp):
        fp.enable("t.a", "1*hang(1)->return")
        first = await fp.fire_async("t.a")
        with pytest.raises(fp.FailpointError):
            await fp.fire_async("t.a")
        return first

    assert [asyncio.run(run(fp)) for fp in PLANES.values()] == [None, None]
    for fp in PLANES.values():
        fp.reset()
        assert not fp.ACTIVE and fp.snapshot() == {}


def test_env_loading_and_listeners_equal_reference():
    env = ("output.flush=1*return; upstream.connect=25%return(reset);; "
           "bad; codec.fallback=nope")
    got = {}
    for pkg, fp in PLANES.items():
        seen = []

        def cb(name, action, seen=seen):
            seen.append((name, action))

        n = fp.load_env(env)
        fp.add_listener(cb)
        try:
            fp.enable("t.l", "1*off->delay(0)")
            fp.fire("t.l")  # off: not a trigger
            fp.fire("t.l")
        finally:
            fp.remove_listener(cb)
        got[pkg] = (n, fp.snapshot(), seen)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 2 and got["port"][2] == [("t.l", "delay")]


def test_port_sites_are_reference_sites():
    assert set(tfp.SITES) <= set(rfp.SITES)
    assert "device.dispatch" in tfp.SITES


# ------------------------------------------------- sites in a pipeline


def small_backoff(base, cap, attempt, rng=None):
    return 0.02


@pytest.fixture
def fast_retries(monkeypatch):
    from fluentbit_tpu.core import engine as ref_engine
    from fluentbit_tpu_torch.core import engine as port_engine

    for mod in (ref_engine, port_engine):
        monkeypatch.setattr(mod, "backoff_full_jitter", small_backoff)


#: the output families compared, by the engine attribute that holds each
OUT_FAMILIES = {"proc_records_total": "m_out_proc_records",
                "errors_total": "m_out_errors",
                "retries_total": "m_out_retries",
                "dropped_records_total": "m_out_dropped"}

#: site → (spec, output, output keys, service keys)
ENGINE_SITES = {
    "engine.flush_dispatch": ("1*return", "lib", {}, {}),
    "engine.retry_schedule": ("return", "retry", {}, {}),
    "output.flush": ("1*return(reset)", "lib", {}, {}),
    "output.flush.lib.0": ("1*hang(2000)", "lib",
                           {"flush_timeout": "0.2s"}, {}),
    "output.worker_flush": ("1*return(worker)", "lib", {"workers": "1"},
                            {}),
}


def run_site(pkg, site, spec, output, props, service):
    """lib input → ``output`` on ``pkg`` with ``site`` armed: two pushes
    of three records, a flush cycle after each; returns the records
    delivered, the output families, the trigger count and whether the
    task map emptied."""
    fp = PLANES[pkg]
    got = []
    ctx = CREATE[pkg](flush="50ms", grace="1", **service)
    ffd = ctx.input("lib", tag="t")
    if output == "lib":
        props = {**props, "callback": lambda d, t: got.extend(
            ev.body["seq"] for ev in DECODE[pkg](d))}
    ctx.output(output, match="t", retry_limit="2", **props)
    fp.enable(site, spec)
    ctx.start()
    e = ctx.engine
    try:
        for k in range(2):
            ctx.push(ffd, json.dumps([{"seq": 3 * k + i} for i in range(3)]))
            ctx.flush_now()
        wait_for(lambda: not e._task_map and not e._backlog
                 and not e._pending_retries)
    finally:
        ctx.stop()
    name = e.outputs[0].display_name
    fams = {f: getattr(e, attr).get((name,))
            for f, attr in OUT_FAMILIES.items()}
    return (sorted(got), fams, e.m_failpoint_triggered.get((site,)),
            fp.snapshot()[site]["triggered"])


@pytest.mark.parametrize("site", sorted(ENGINE_SITES))
def test_engine_site_fires_and_counts_equal(fast_retries, site):
    spec, output, props, service = ENGINE_SITES[site]
    got = {pkg: run_site(pkg, site, spec, output, props, service)
           for pkg in PLANES}
    assert got["port"] == got["ref"]
    assert got["port"][2] >= 1


def test_upstream_connect_fires_equal():
    got = {}
    for pkg, opener in (("ref", ref_open), ("port", port_open)):
        PLANES[pkg].enable("upstream.connect", "return(refused)")
        with pytest.raises(OSError, match="refused"):
            asyncio.run(opener(None, "127.0.0.1", 1))
        got[pkg] = PLANES[pkg].snapshot()
    assert got["port"] == got["ref"]


def test_codec_fallback_declines_bit_exact():
    """The json hook forced to decline: the records are the hook's, the
    decline and the trigger are counted, in both."""
    buf = b"".join(encode_event({"log": json.dumps({"k": i, "s": "x" * i})},
                                1700000000.0 + i) for i in range(64))

    def run(engine, fp, arm):
        engine.parser("p0", format="json")
        f = engine.filter("parser")
        f.set("key_name", "log")
        f.set("parser", "p0")
        ins = engine.input("dummy")
        for x in engine.inputs + engine.filters:
            x.configure()
            x.plugin.init(x, engine)
        if arm:
            fp.enable("codec.fallback", "return")
        engine.input_log_append(ins, "t", buf)
        out = b"".join(c.get_bytes() for c in ins.pool.drain())
        fp.reset()
        return out, engine.m_filter_batch_decline.get(("parser.0",))

    clean = run(Engine(device=torch.device("cpu")), tfp, False)
    forced = run(Engine(device=torch.device("cpu")), tfp, True)
    ref_forced = run(RefEngine(), rfp, True)
    assert forced[0] == clean[0] == ref_forced[0]
    assert forced[1] == ref_forced[1] == 1 and clean[1] == 0


FORWARD_SITES = {
    # site → its spec
    "forward.handshake": "1*return(auth)",
    "forward.conn_reset": "1*return(rst)",
    "forward.partial_write": "1*partial(10)",
    "forward.dup_delivery": "1*return(dup)",
    "forward.ack_drop": "1*return(lost)",
}


@pytest.mark.parametrize("site", sorted(FORWARD_SITES))
def test_forward_site_fires_and_counts_equal(site):
    """Edge → aggregator of one package with ``site`` armed: every record
    arrives once, and the edge's acks, losses and resends, the
    aggregator's absorbed chunks and dedup hits, and the trigger counts
    are the reference's."""
    chunks = make_chunks(23, n_chunks=1)
    want = expected_bytes(chunks)
    n_want = sum(len(list(Unpacker(v))) for v in want.values())
    got = {}
    for pkg, fp in PLANES.items():
        fp.enable(site, FORWARD_SITES[site])
        a = Aggregator(pkg, shared_key=SHARED_KEY)
        try:
            out = run_edge(pkg, dict(host="127.0.0.1", port=str(a.port),
                                     require_ack_response="on",
                                     ack_timeout="0.5",
                                     shared_key=SHARED_KEY,
                                     self_hostname="edge-1"),
                           chunks, until=lambda: a.count >= n_want)
        finally:
            records = a.stop()
        h, ah = out.health_block(), a.plugin.health_block()
        got[pkg] = (records == want, h["acks_waited"], h["acks_lost"],
                    h["resends"], ah["absorbed"], ah["dedup_hits"],
                    fp.snapshot()[site]["triggered"],
                    out._engine.m_failpoint_triggered.get((site,))
                    + a.ctx.engine.m_failpoint_triggered.get((site,)))
        fp.reset()
    assert got["port"] == got["ref"]
    assert got["port"][0] and got["port"][6] == 1


def test_hung_output_isolated_and_recovered_by_probe(fast_retries):
    """One output's flushes hang (``output.flush.sick``): the sibling
    route gets every record in order, the sick route's breaker opens
    (at least 2 timeouts: the timer decides how many), and once the
    site is disarmed the probe closes it and every record arrives at
    least once, in both."""
    def run(pkg):
        healthy, sick = [], []
        decode = DECODE[pkg]
        ctx = CREATE[pkg](flush="50ms", grace="1", **{
            "guard.breaker_failures": "2",
            "guard.breaker_cooldown": "0.3"})
        ffd = ctx.input("lib", tag="t")
        ctx.output("lib", match="t", alias="healthy",
                   callback=lambda d, t: healthy.extend(
                       ev.body["seq"] for ev in decode(d)))
        ctx.output("lib", match="t", alias="sick", flush_timeout="0.2s",
                   retry_limit="no_limits",
                   callback=lambda d, t: sick.extend(
                       ev.body["seq"] for ev in decode(d)))
        PLANES[pkg].enable("output.flush.sick", "hang(30000)")
        n = 6
        ctx.start()
        try:
            for seq in range(n):
                ctx.push(ffd, json.dumps({"seq": seq}))
                time.sleep(0.06)
            wait_for(lambda: len(healthy) == n, 4)
            g = ctx.engine.guard
            wait_for(lambda: g.breaker("sick").state_name() == "open", 4)
            timeouts = g.m_timeouts.get(("sick",))
            before = list(sick)
            PLANES[pkg].reset()
            wait_for(lambda: set(sick) == set(range(n)), 10)
            wait_for(lambda: g.breaker("sick").state_name() == "closed", 5)
            return (healthy, before, timeouts >= 2, set(sick))
        finally:
            ctx.stop()

    got = {pkg: run(pkg) for pkg in PLANES}
    assert got["port"] == got["ref"] == (
        list(range(6)), [], True, set(range(6)))


def test_unarmed_plane_adds_no_work(monkeypatch):
    calls = []
    monkeypatch.setattr(tfp, "fire", lambda name: calls.append(name))
    assert not tfp.ACTIVE
    ctx = flb.create(device="cpu", flush="50ms", grace="1")
    ffd = ctx.input("lib", tag="t")
    ctx.filter("grep", match="t", regex="log x")
    ctx.output("null", match="t")
    ctx.start()
    try:
        for i in range(40):
            ctx.push(ffd, json.dumps([{"log": f"x {i}"}] * 40))
        ctx.flush_now()
    finally:
        ctx.stop()
    assert calls == []


# ------------------------------------------- the device error class


def grep_pair(monkeypatch, decoded):
    """The reference's engine and the port's with one grep filter and a
    dummy input, configured as start() would; ``decoded`` keeps the
    port's grep off the raw path."""
    if decoded:
        monkeypatch.setattr(GrepFilter, "can_filter_raw", lambda self: False)
    pair = []
    for e in (RefEngine(), Engine(device=torch.device("cpu"))):
        f = e.filter("grep")
        f.set("exclude", "log health-check")
        e.input("dummy")
        for x in e.inputs + e.filters:
            x.configure()
            x.plugin.init(x, e)
        pair.append(e)
    return pair


def grep_append(encode, k, n=64):
    return b"".join(
        encode({"log": ("GET /health-check" if i % 5 == 0 else
                        f"GET /a/{k}/{i} 200")}, 1700000000.0 + i)
        for i in range(n))


@pytest.mark.parametrize("path", ["raw", "decoded"])
def test_device_dispatch_raises_to_the_caller(monkeypatch, path):
    """``device.dispatch=1*return`` after grep's launch (the plain route
    here): the append raises DeviceError, nothing is pooled, the engine
    counts one failure under lane grep; the next append launches and
    its records are the reference's."""
    ref_e, port_e = grep_pair(monkeypatch, path == "decoded")
    grep = port_e.filters[0].plugin
    tfp.enable("device.dispatch", "1*return")
    with pytest.raises(DeviceError, match="injected") as err:
        port_e.input_log_append(port_e.inputs[0], "t",
                                grep_append(encode_event, 0))
    assert err.value.lane == "grep"
    assert port_e.inputs[0].pool.drain() == []
    assert port_e.m_device_failures.get(("grep",)) == 1
    assert tfp.snapshot()["device.dispatch"]["triggered"] == 1
    assert port_e.m_failpoint_triggered.get(("device.dispatch",)) == 0
    for e, enc in ((ref_e, ref_encode), (port_e, encode_event)):
        e.input_log_append(e.inputs[0], "t", grep_append(enc, 1))
    got = [(c.tag, c.get_bytes()) for c in port_e.inputs[0].pool.drain()]
    assert got == [(c.tag, c.get_bytes())
                   for c in ref_e.inputs[0].pool.drain()]
    assert port_e.m_device_failures.get(("grep",)) == 1
    if path == "raw":
        # the failed append's segment is not counted
        assert grep.raw_timings["records"] == 64
    else:
        assert len(grep.match_seconds) == 1


def test_host_error_in_a_filter_passes_records_on(monkeypatch, caplog):
    """A filter that raises a host error is logged and its records pass
    on, in both; the same filter raising a device error fails the
    append."""
    got = {}
    for pkg, eng in (("ref", RefEngine()),
                     ("port", Engine(device=torch.device("cpu")))):
        f = eng.filter("grep")
        f.set("regex", "log a")
        eng.input("dummy")
        for x in eng.inputs + eng.filters:
            x.configure()
            x.plugin.init(x, eng)

        def boom(events, tag, engine):
            raise KeyError("a filter bug")

        monkeypatch.setattr(eng.filters[0].plugin, "filter", boom)
        monkeypatch.setattr(type(eng.filters[0].plugin), "can_filter_raw",
                            lambda self: False)
        enc = ref_encode if pkg == "ref" else encode_event
        data = b"".join(enc({"log": f"b {i}"}, 1.0 + i) for i in range(3))
        with caplog.at_level("ERROR", logger="flb.engine"):
            n = eng.input_log_append(eng.inputs[0], "t", data)
        got[pkg] = (n, [c.get_bytes() for c in eng.inputs[0].pool.drain()])
    assert got["port"] == got["ref"] and got["port"][0] == 3
    assert sum("filter grep.0 failed" in r.getMessage()
               for r in caplog.records) == 2

    def device_boom(events, tag, engine):
        raise DeviceError("grep_dfa failed: CUDA error 700")

    monkeypatch.setattr(eng.filters[0].plugin, "filter", device_boom)
    with pytest.raises(DeviceError):
        eng.input_log_append(eng.inputs[0], "t", data)
    assert eng.m_device_failures.get(("grep",)) == 1


def test_device_errors_are_runtime_errors():
    assert DeviceError in DEVICE_ERRORS
    assert all(issubclass(c, RuntimeError) for c in DEVICE_ERRORS)
    assert DeviceError("x", lane="flux").lane == "flux"


# ------------------------------------------ no except swallows them

CHECKED = ["core/engine.py", "core/output_thread.py", "flux/plugin.py",
           *sorted(str(p.relative_to(PKG_ROOT))
                   for p in (PKG_ROOT / "plugins").glob("filter_*.py"))]

#: (file, function) → why its broad handlers reach no launch
NO_LAUNCH = {
    ("core/engine.py", "ensure_collector"):
        "call_soon_threadsafe on a closed loop",
    ("core/engine.py", "_main"): "binding the server inputs",
    ("core/engine.py", "_dump_stuck_shutdown"): "faulthandler's dump",
    ("core/engine.py", "_drain_event_queue"):
        "the queued callbacks create flush futures",
    ("core/engine.py", "_spawn_flush"): "queueing on a closed loop",
    ("core/engine.py", "_flush_body"):
        "an output's flush and the test formatter (no output launches)",
    ("core/engine.py", "_schedule_retry"): "a timer on a closed loop",
    ("core/engine.py", "_quarantine_at_stop"): "the stop's DLQ write",
    ("core/engine.py", "_handle_flush_result"):
        "the DLQ write of a dropped chunk",
    ("core/engine.py", "flush_now"): "call_soon_threadsafe on a closed loop",
    ("core/output_thread.py", "_worker"):
        "the worker hooks of an output and its loop's stop",
    ("core/output_thread.py", "stop"): "stopping a closed loop",
}

BROAD = {"Exception", "BaseException", "RuntimeError"}


def _names(node):
    if node is None:
        return {"<bare>"}
    if isinstance(node, ast.Tuple):
        return set().union(*(_names(e) for e in node.elts))
    if isinstance(node, ast.Attribute):
        return {node.attr}
    if isinstance(node, ast.Name):
        return {node.id}
    return set()


def _reraises(handler, fn_node=None):
    """The handler re-raises what it caught, or (``stop``) keeps it in a
    name that its function raises later."""
    if any(isinstance(st, ast.Raise) and st.exc is None
           for st in handler.body):
        return True
    if fn_node is None:
        return False
    kept = {t.id for st in ast.walk(handler) if isinstance(st, ast.Assign)
            for t in st.targets if isinstance(t, ast.Name)}
    return any(isinstance(st, ast.Raise) and isinstance(st.exc, ast.Name)
               and st.exc.id in kept for st in ast.walk(fn_node))


def broad_handlers(rel):
    """(function, line, ok) for every broad handler in ``rel``: ok when
    an earlier handler of its try takes ``DEVICE_ERRORS`` and re-raises,
    or the broad handler itself re-raises what it caught."""
    tree = ast.parse((PKG_ROOT / rel).read_text())
    out = []

    def visit(node, fn, fn_node):
        for child in ast.iter_child_nodes(node):
            name, owner = fn, fn_node
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name, owner = child.name, child
            if isinstance(child, ast.Try):
                device_first = False
                for h in child.handlers:
                    names = _names(h.type)
                    if "DEVICE_ERRORS" in names and _reraises(h, owner):
                        device_first = True
                    if names & (BROAD | {"<bare>"}):
                        out.append((name, h.lineno,
                                    device_first or _reraises(h)))
            visit(child, name, owner)

    visit(tree, None, None)
    return out


def test_no_broad_except_swallows_a_device_error():
    checked = []
    for rel in CHECKED:
        for fn, line, ok in broad_handlers(rel):
            if (rel, fn) in NO_LAUNCH:
                continue
            checked.append((rel, fn))
            assert ok, (f"{rel}:{line} ({fn}) takes a broad exception "
                        "without re-raising device errors first")
    # the sites that can reach a launch, each checked
    assert {("core/engine.py", f) for f in (
        "sp_task", "_collector", "stop", "_log_append_decoded",
        "_ingest_raw", "_raw_tail_decoded", "_run_filters")} <= set(checked)
    assert {("flux/plugin.py", "_emit_rows"),
            ("flux/plugin.py", "_refresh_or_defer"),
            ("plugins/filter_rewrite_tag.py", "_emit_group"),
            ("plugins/filter_log_to_metrics.py", "process_batch"),
            ("core/output_thread.py", "submit")} <= set(checked)
    # every exempt site still exists
    sites = {(rel, fn) for rel in CHECKED
             for fn, _l, _ok in broad_handlers(rel)}
    assert set(NO_LAUNCH) <= sites

"""The port's guard plane against the reference's.

The scenarios of tests/test_guard.py run through both packages on the
CPU (the port on ``device="cpu"``), each with the same test-local
outputs registered in its own registry and the same appends:

- the breaker's state machine, driven by the same outcome sequence under
  a fake clock: every answer and transition equal;
- the deadline order (the output's ``flush_timeout``, the service's
  ``guard.flush_timeout``, 2 x ``grace``);
- a hung flush soft-killed into a RETRY, and a worker wedged in sync
  code hard-abandoned (with the cooperative cancel flag seen);
- a breaker that short-circuits and recovers by probe, breaker shedding
  and readmission, the health verdicts;
- a worker pool that does not start failing over to inline flushes, a
  stuck shutdown's stack dump, ``io_deadline``;
- the delivery probe of an output that answers RETRY with no limit:
  5 retries in both with the guard on (its breaker opens), and the
  backoff's own count with ``guard.enable off``.

Delivered records, breaker transitions, timeouts, shed counts and health
verdicts are compared exactly; where a count depends on the timer
(short-circuits, abandoned flushes, retries with the guard off), the
bound is stated beside it. No test waits out a real backoff: each sets
``backoff_full_jitter`` in both engine modules to the same 20 ms.
"""

import asyncio
import json
import logging
import time

import pytest
import torch

import fluentbit_tpu as ref
import fluentbit_tpu_torch as flb
from fluentbit_tpu import failpoints as rfp
from fluentbit_tpu.codec import chunk as ref_chunk
from fluentbit_tpu.codec.events import decode_events as ref_decode
from fluentbit_tpu.core import config as ref_config
from fluentbit_tpu.core import engine as ref_engine
from fluentbit_tpu.core import guard as rguard
from fluentbit_tpu.core import output_thread as ref_output_thread
from fluentbit_tpu.core import plugin as ref_plugin
from fluentbit_tpu_torch import failpoints as tfp
from fluentbit_tpu_torch.codec import chunk as port_chunk
from fluentbit_tpu_torch.codec.events import decode_events, encode_event
from fluentbit_tpu_torch.core import config as port_config
from fluentbit_tpu_torch.core import engine as port_engine
from fluentbit_tpu_torch.core import guard as tguard
from fluentbit_tpu_torch.core import output_thread as port_output_thread
from fluentbit_tpu_torch.core import plugin as port_plugin

#: per package: create, decode, guard module, plugin module, config
#: module, engine module, failpoint plane, output_thread module
PKGS = {
    "ref": (ref.create, ref_decode, rguard, ref_plugin, ref_config,
            ref_engine, rfp, ref_output_thread),
    "port": (lambda **kw: flb.create(device="cpu", **kw), decode_events,
             tguard, port_plugin, port_config, port_engine, tfp,
             port_output_thread),
}


def wait_for(cond, timeout=8.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(interval)
    raise TimeoutError(f"condition not met within {timeout}s")


def small_backoff(base, cap, attempt, rng=None):
    return 0.02


def output_classes(pkg):
    """The reference test's outputs, built on ``pkg``'s plugin model."""
    _c, decode, guard, plugin_mod, config_mod, *_ = PKGS[pkg]
    Entry = config_mod.ConfigMapEntry
    FlushResult = plugin_mod.FlushResult

    class GuardHang(plugin_mod.OutputPlugin):
        """Hangs (async) for the first ``hang_n`` flushes, then
        delivers."""
        name = "guard_hang"
        config_map = [Entry("hang_n", "int", default=1)]

        def init(self, instance, engine):
            self.calls = 0
            self.delivered = []

        async def flush(self, data, tag, engine):
            self.calls += 1
            if self.calls <= self.hang_n:
                await asyncio.sleep(60)
            self.delivered.extend(ev.body["seq"] for ev in decode(data))
            return FlushResult.OK

    class GuardBlock(plugin_mod.OutputPlugin):
        """Blocks its worker thread in sync code once, then delivers;
        notes whether the cooperative cancel flag was set."""
        name = "guard_block"
        config_map = [Entry("block_ms", "int", default=1000)]

        def init(self, instance, engine):
            self.calls = 0
            self.delivered = []
            self.saw_cancel_flag = False

        async def flush(self, data, tag, engine):
            self.calls += 1
            if self.calls == 1:
                time.sleep(self.block_ms / 1e3)
                self.saw_cancel_flag = guard.cancel_requested()
            self.delivered.extend(ev.body["seq"] for ev in decode(data))
            return FlushResult.OK

    class GuardFlaky(plugin_mod.OutputPlugin):
        """RETRY until ``ok`` is set, then delivers."""
        name = "guard_flaky"

        def init(self, instance, engine):
            self.calls = 0
            self.ok = False
            self.delivered = []

        async def flush(self, data, tag, engine):
            self.calls += 1
            if not self.ok:
                return FlushResult.RETRY
            self.delivered.extend(ev.body["seq"] for ev in decode(data))
            return FlushResult.OK

    return (GuardHang, GuardBlock, GuardFlaky)


@pytest.fixture
def guarded(monkeypatch):
    """The test outputs in both registries, the small backoff in both
    engine modules, and both failpoint planes disarmed around the test."""
    for pkg, (_c, _d, _g, plugin_mod, _cfg, engine_mod, fp, _ot) \
            in PKGS.items():
        for cls in output_classes(pkg):
            monkeypatch.setitem(plugin_mod.registry.outputs, cls.name, cls)
        monkeypatch.setattr(engine_mod, "backoff_full_jitter",
                            small_backoff)
        fp.reset()
    yield
    for _c, _d, _g, _p, _cfg, _e, fp, _ot in PKGS.values():
        fp.reset()


def both(scenario):
    """``scenario(pkg)`` in each package; returns {pkg: result}."""
    return {pkg: scenario(pkg) for pkg in PKGS}


# ---------------------------------------------------------------------
# the breaker's state machine, under a fake clock
# ---------------------------------------------------------------------

BREAKER_RUNS = {
    # (breaker keys, ops): "f" failure, "o" ok, "a" allow, "v" available,
    # "r" reset, a float: the clock moves there
    "consecutive_failures": ({"failures": 3, "cooldown": 5.0},
                             "f f a f a v"),
    "windowed_error_rate": ({"failures": 100, "error_rate": 0.5,
                             "window": 10}, "o f o f o f o f o f a"),
    "ok_resets_consecutive": ({"failures": 3}, "f f o f f a"),
    "half_open_single_probe": ({"failures": 1, "cooldown": 5.0},
                               "f 4.9 a 5.1 v a a o a"),
    "probe_failure_fresh_cooldown": ({"failures": 1, "cooldown": 5.0},
                                     "f 6.0 a f 10.0 a 11.1 a"),
    "failure_while_open_rearms": ({"failures": 1, "cooldown": 5.0},
                                  "f 6.0 v f v 10.0 v 11.1 v"),
    "probes_threshold_and_reset": ({"failures": 1, "cooldown": 1.0,
                                    "probes": 2},
                                   "f 1.5 a o a o f r a"),
}


def drive_breaker(guard_mod, keys, ops):
    clock = [0.0]
    transitions = []
    br = guard_mod.CircuitBreaker(
        "out", clock=lambda: clock[0],
        on_transition=lambda n, o, new: transitions.append((o, new)),
        **keys)
    trace = []
    for op in ops.split():
        if op == "f":
            br.record_failure()
        elif op == "o":
            br.record_ok()
        elif op == "r":
            br.reset()
        elif op == "a":
            trace.append(("allow", br.allow()))
        elif op == "v":
            trace.append(("available", br.available()))
        else:
            clock[0] = float(op)
        trace.append((br.state_name(), br.state_code(),
                      round(br.retry_delay(), 9)))
    return trace, transitions


@pytest.mark.parametrize("run", sorted(BREAKER_RUNS))
def test_breaker_state_machine_equals_reference(run):
    keys, ops = BREAKER_RUNS[run]
    got = drive_breaker(tguard, keys, ops)
    assert got == drive_breaker(rguard, keys, ops)
    # an ok between failures keeps the breaker closed; every other run
    # opens it
    assert bool(got[1]) == (run != "ok_resets_consecutive")


# ---------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------


def test_deadline_resolution_order():
    def order(pkg):
        ctx = PKGS[pkg][0](grace="3", **{"guard.flush_timeout": "7s"})
        ctx.output("lib", callback=lambda d, t: None)
        out = ctx.engine.outputs[0]
        out.set("flush_timeout", "2s")
        out.configure()
        g = ctx.engine.guard
        got = [g.deadline_for(out)]           # the output's wins
        out.flush_timeout = None
        got.append(g.deadline_for(out))       # then the service's
        ctx.engine.service.guard_flush_timeout = 0.0
        got.append(g.deadline_for(out))       # then 2 x grace
        return got

    assert both(order) == {"ref": [2.0, 7.0, 6.0], "port": [2.0, 7.0, 6.0]}


def test_flush_deadline_soft_kills_into_a_retry(guarded):
    def run(pkg):
        ctx = PKGS[pkg][0](flush="50ms", grace="1",
                           **{"guard.breaker_failures": "50"})
        ffd = ctx.input("lib", tag="t")
        ctx.output("guard_hang", match="t", alias="hang", hang_n="1",
                   flush_timeout="0.2s", retry_limit="no_limits")
        plugin = ctx.engine.outputs[0].plugin
        ctx.start()
        try:
            ctx.push(ffd, '{"seq": 1}')
            wait_for(lambda: plugin.delivered == [1])
            wait_for(lambda: not ctx.engine._task_map)
            e, g = ctx.engine, ctx.engine.guard
            return (plugin.delivered, plugin.calls,
                    g.m_timeouts.get(("hang",)),
                    e.m_out_retries.get(("hang",)),
                    e.m_out_proc_records.get(("hang",)))
        finally:
            ctx.stop()

    got = both(run)
    assert got["port"] == got["ref"] == ([1], 2, 1.0, 1.0, 1.0)


def test_worker_flush_hard_abandoned(guarded):
    """A worker wedged in sync code past its deadline: its soft-kill
    cannot land, so it is counted abandoned (timer-dependent: the retry
    queued behind the wedged worker may time out too, so at least 1);
    the cooperative flag is set when it wakes, and the record arrives."""
    def run(pkg):
        ctx = PKGS[pkg][0](flush="50ms", grace="2", **{
            "guard.leak_grace": "0.1", "guard.breaker_failures": "50"})
        ffd = ctx.input("lib", tag="t")
        ctx.output("guard_block", match="t", alias="blocky", workers="1",
                   block_ms="800", flush_timeout="0.2s",
                   retry_limit="no_limits")
        plugin = ctx.engine.outputs[0].plugin
        ctx.start()
        try:
            ctx.push(ffd, '{"seq": 9}')
            g = ctx.engine.guard
            wait_for(lambda: g.m_abandoned.get(("blocky",)) >= 1)
            wait_for(lambda: 9 in plugin.delivered)
            return (set(plugin.delivered), plugin.saw_cancel_flag,
                    g.m_abandoned.get(("blocky",)) >= 1,
                    g.m_timeouts.get(("blocky",)) >= 1)
        finally:
            ctx.stop()

    got = both(run)
    assert got["port"] == got["ref"] == ({9}, True, True, True)


# ---------------------------------------------------------------------
# breakers on every output
# ---------------------------------------------------------------------


def test_breaker_short_circuits_and_recovers_by_probe(guarded):
    def run(pkg):
        ctx = PKGS[pkg][0](flush="50ms", grace="1", **{
            "guard.breaker_failures": "2",
            "guard.breaker_cooldown": "0.5"})
        ffd = ctx.input("lib", tag="t")
        ctx.output("guard_flaky", match="t", alias="flaky",
                   retry_limit="no_limits")
        plugin = ctx.engine.outputs[0].plugin
        ctx.start()
        try:
            g = ctx.engine.guard
            ctx.push(ffd, '{"seq": 5}')
            wait_for(lambda: g.breaker("flaky").state_name() == "open")
            calls_at_open = plugin.calls
            wait_for(lambda: g.m_short_circuit.get(("flaky",)) >= 1)
            # open: the retries short-circuit, no flush is attempted
            no_attempt = plugin.calls == calls_at_open
            plugin.ok = True
            wait_for(lambda: plugin.delivered == [5])
            wait_for(lambda: g.breaker("flaky").state_name() == "closed")
            e = ctx.engine
            return (plugin.delivered, calls_at_open, no_attempt,
                    {s for s in ("open", "half-open", "closed")
                     if g.m_transitions.get(("flaky", s)) >= 1},
                    e.m_out_retries_failed.get(("flaky",)),
                    e.m_out_dropped.get(("flaky",)))
        finally:
            ctx.stop()

    got = both(run)
    assert got["port"] == got["ref"] == (
        [5], 2, True, {"open", "half-open", "closed"}, 0.0, 0.0)


def test_retry_probe_counts_equal(guarded, monkeypatch):
    """An output that answers RETRY with no limit, a 10 ms backoff, for
    0.4 s: with the guard on (the default) its breaker opens after 5
    failures, so both count 5 retries. With ``guard.enable off`` each
    counts what its timer allows: at least 10 and at most 45 (40
    backoffs of 10 ms fit in 0.4 s, and the stop may fire one more)."""
    for _c, _d, _g, _p, _cfg, engine_mod, _fp, _ot in PKGS.values():
        monkeypatch.setattr(engine_mod, "backoff_full_jitter",
                            lambda base, cap, attempt, rng=None: 0.01)

    def probe(service):
        def run(pkg):
            ctx = PKGS[pkg][0](flush="20ms", grace="1", **service)
            ffd = ctx.input("lib", tag="t")
            ctx.output("retry", match="t", retry_limit="no_limits")
            ctx.start()
            try:
                ctx.push(ffd, '{"x": 1}')
                time.sleep(0.4)
            finally:
                ctx.stop()
            return ctx.engine.m_out_retries.get(("retry.0",))
        return both(run)

    assert probe({}) == {"ref": 5.0, "port": 5.0}
    off = probe({"guard.enable": "off"})
    assert all(10 <= n <= 45 for n in off.values()), off


# ---------------------------------------------------------------------
# breaker shedding
# ---------------------------------------------------------------------


def test_dispatch_sheds_open_breaker_routes_and_readmits(guarded):
    """Task map 4, watermark 0.5: with the sink's breaker held open, the
    first two chunks hold slots as short-circuited retries, the others
    shed, and the watchdog reclaims the retry-held slots: all 4 shed.
    Closing the breaker readmits and delivers every record once."""
    def run(pkg):
        ctx = PKGS[pkg][0](flush="50ms", grace="1", **{
            "task_map_size": "4", "guard.shed_watermark": "0.5",
            "guard.breaker_failures": "1",
            "guard.breaker_cooldown": "30"})
        got = []
        decode = PKGS[pkg][1]
        ffds = [ctx.input("lib", tag=f"t{i}") for i in range(4)]
        ctx.output("lib", match="t*", alias="sink",
                   callback=lambda d, t: got.extend(
                       ev.body["seq"] for ev in decode(d)))
        ctx.start()
        try:
            g = ctx.engine.guard
            g.breaker("sink").record_failure()
            for i, ffd in enumerate(ffds):
                ctx.push(ffd, json.dumps({"seq": i}))
            wait_for(lambda: g.shed_count() == 4)
            held = list(got)
            health = g.health()["status"]
            g.breaker("sink").reset()
            wait_for(lambda: sorted(got) == [0, 1, 2, 3])
            wait_for(lambda: not ctx.engine._task_map)
            return (held, health, sorted(got), g.m_shed.get(("sink",)),
                    g.shed_count(),
                    ctx.engine.m_out_proc_records.get(("sink",)))
        finally:
            ctx.stop()

    got = both(run)
    assert got["port"] == got["ref"] == (
        [], "degraded", [0, 1, 2, 3], 4.0, 0, 4.0)


def test_maybe_shed_needs_every_route_open_and_the_watermark():
    """Dispatch sheds a chunk only at or above the watermark (2 of 4
    slots here) and only when every route's breaker is open and cannot
    take a probe: the same answers in both."""
    def run(pkg):
        create, *_ = PKGS[pkg]
        ctx = create(**{"task_map_size": "4", "guard.shed_watermark": "0.5",
                        "guard.breaker_failures": "1",
                        "guard.breaker_cooldown": "30"})
        for alias in ("a", "b"):
            ctx.output("lib", match="*", alias=alias,
                       callback=lambda d, t: None)
        e, g = ctx.engine, ctx.engine.guard
        a, b = e.outputs
        for out in (a, b):
            out.configure()  # the alias names the output from here on
        chunk_mod = ref_chunk if pkg == "ref" else port_chunk
        answers = []

        def shed(routes):
            c = chunk_mod.Chunk("t")
            c.append(encode_event({"x": 1}, 1.0), 1)
            answers.append(g.maybe_shed(c, routes))

        shed([a])                       # every breaker closed
        g.breaker("a").record_failure()
        shed([a])                       # open, but the map is empty
        e._task_map.update({-1: None, -2: None})
        shed([a])                       # open and at the watermark
        shed([a, b])                    # b has no breaker: it can take one
        g.breaker("b").record_failure()
        shed([a, b])                    # every route open
        g.breaker("b").reset()
        shed([a, b])                    # b closed again
        e._task_map.clear()
        return answers, g.shed_count(), g.m_shed.get(("a",)), \
            g.m_shed.get(("b",))

    got = both(run)
    assert got["port"] == got["ref"] == (
        [False, False, True, False, True, False], 2, 2.0, 1.0)


def test_readmit_all_returns_the_shed_chunks_to_the_backlog():
    """At stop every shed chunk goes back to the backlog, in shed order,
    each for only the routes it was shed from (its names kept, its mask
    cleared), and each shed counts once a route."""
    def run(pkg):
        create, decode, guard_mod, *_ = PKGS[pkg]
        ctx = create()
        e, g = ctx.engine, ctx.engine.guard
        chunk_mod = (ref_chunk if pkg == "ref" else port_chunk)
        for i, names in enumerate([("a.0",), ("a.0", "b.0"), ("b.0",)]):
            c = chunk_mod.Chunk(f"t{i}")
            c.append(encode_event({"i": i}, 1.0 + i), 1)
            c.routes_mask = 0b11
            g._shed_chunk(c, list(names))
        before = g.shed_count()
        g.readmit_all()
        return (before, g.shed_count(),
                [(c.tag, c.route_names, c.routes_mask) for c in e._backlog],
                g.m_shed.get(("a.0",)), g.m_shed.get(("b.0",)))

    got = both(run)
    assert got["port"] == got["ref"] == (
        3, 0, [("t0", ("a.0",), 0), ("t1", ("a.0", "b.0"), 0),
               ("t2", ("b.0",), 0)], 2.0, 2.0)


# ---------------------------------------------------------------------
# the watchdog's health verdict
# ---------------------------------------------------------------------


def test_health_verdicts_ok_degraded_stalled(monkeypatch):
    # no housekeeping pass refreshes the heartbeat under the test
    for guard_mod in (rguard, tguard):
        monkeypatch.setattr(guard_mod.Guard, "housekeeping",
                            lambda self: None)

    def run(pkg):
        ctx = PKGS[pkg][0](flush="50ms", grace="1")
        ctx.input("lib", tag="t")
        ctx.output("lib", match="t", callback=lambda d, t: None)
        ctx.start()
        try:
            g = ctx.engine.guard

            def view():
                h = g.health()
                return (h["status"], h["breakers"], h["task_map"],
                        h["shed_chunks"], h["inflight_flushes"])

            seen = [view()]
            for _ in range(ctx.engine.service.guard_breaker_failures):
                g.breaker("sick.0").record_failure()
            seen.append(view())
            g.breaker("sick.0").reset()
            g.heartbeat = time.time() - 100
            seen.append(view())
            g.heartbeat = time.time()
            return seen
        finally:
            ctx.stop()

    got = both(run)
    size = {"occupancy": 0, "size": 2048}
    assert got["port"] == got["ref"] == [
        ("ok", {}, size, 0, 0),
        ("degraded", {"sick.0": "open"}, size, 0, 0),
        ("stalled", {"sick.0": "closed"}, size, 0, 0)]


def test_guard_disabled_is_inert():
    def run(pkg):
        ctx = PKGS[pkg][0](flush="50ms", grace="1",
                           **{"guard.enable": "off"})
        got = []
        ffd = ctx.input("lib", tag="t")
        ctx.output("lib", match="t", callback=lambda d, t: got.append(d))
        ctx.start()
        try:
            ctx.push(ffd, '{"x": 1}')
            wait_for(lambda: got)
        finally:
            ctx.stop()
        g = ctx.engine.guard
        return (g._breakers, g._flights, g.health())

    got = both(run)
    assert got["port"] == got["ref"] == (
        {}, {}, {"status": "ok", "guard": "disabled"})


def test_guard_no_work_on_ingest_hot_path(monkeypatch):
    """The guard rides the flush paths and the timer only: the port's
    ingest path calls none of its methods."""
    calls = []
    for name in ("housekeeping", "maybe_shed", "track",
                 "short_circuit_delay", "on_result", "breaker",
                 "flight", "consume_timeout"):
        real = getattr(tguard.Guard, name)
        monkeypatch.setattr(
            tguard.Guard, name,
            (lambda fn, nm: lambda self, *a, **kw: (
                calls.append(nm), fn(self, *a, **kw))[1])(real, name))
    e = port_engine.Engine(device=torch.device("cpu"))
    ins = e.input("dummy")
    for x in e.inputs:
        x.configure()
        x.plugin.init(x, e)
    for i in range(50):
        e.input_log_append(ins, "t", encode_event({"seq": i}, 1.0 + i))
    assert calls == []


# ---------------------------------------------------------------------
# worker pools, the stuck stop, io_deadline
# ---------------------------------------------------------------------


def test_worker_start_timeout_fails_over_to_inline_flush(guarded):
    def run(pkg):
        create, decode, *_rest = PKGS[pkg]
        fp = PKGS[pkg][6]
        fp.enable("output.worker_start", "delay(1000)")
        got = []
        ctx = create(flush="50ms", grace="1",
                     **{"guard.worker_start_timeout": "0.3s"})
        ffd = ctx.input("lib", tag="t")
        ctx.output("lib", match="t", alias="w", workers="1",
                   callback=lambda d, t: got.append(d))
        ctx.start()
        try:
            # the site fires on the worker's thread before start() adds
            # the engine's listener: the plane's own count is read
            fired = fp.snapshot()["output.worker_start"]["triggered"]
            fp.reset()
            out = ctx.engine.outputs[0]
            ctx.push(ffd, '{"seq": 3}')
            wait_for(lambda: got)
            return (out.worker_pool is None,
                    ctx.engine.guard.m_worker_start_fail.get(("w",)),
                    [ev.body for d in got for ev in decode(d)], fired)
        finally:
            ctx.stop()

    got = both(run)
    assert got["port"] == got["ref"] == (True, 1.0, [{"seq": 3}], 1)


def test_worker_start_injected_death_aborts_fast(guarded):
    def run(pkg):
        fp, ot = PKGS[pkg][6], PKGS[pkg][7]
        fp.enable("output.worker_start", "return(dead)")
        t0 = time.time()
        pool = ot.OutputWorkerPool("dead-test", 1, None, start_timeout=10.0)
        try:
            fast = time.time() - t0 < 5

            async def noop():
                return 1

            with pytest.raises(RuntimeError, match="never started"):
                pool.submit(noop())
            return pool.failed, fast
        finally:
            pool.stop()

    assert both(run) == {"ref": (True, True), "port": (True, True)}


def test_stuck_shutdown_warns_and_dumps_stacks(caplog, capfd):
    class _WedgedThread:
        def join(self, timeout=None):
            pass  # "times out": the thread is still alive

        def is_alive(self):
            return True

    for engine_mod in (ref_engine, port_engine):
        e = engine_mod.Engine()
        e._thread = _WedgedThread()
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="flb.engine"):
            e.stop()
        assert any("shutdown is stuck" in r.getMessage()
                   for r in caplog.records)
        err = capfd.readouterr().err
        assert "Current thread" in err or "Thread" in err
        assert e._thread is None


def test_io_deadline_raises_an_oserror_timeout():
    async def value():
        return 42

    for guard_mod in (rguard, tguard):
        async def run():
            with pytest.raises(OSError, match="deadline"):
                await guard_mod.io_deadline(asyncio.sleep(5), 0.01)
            return await guard_mod.io_deadline(value(), 1.0)

        assert asyncio.run(run()) == 42

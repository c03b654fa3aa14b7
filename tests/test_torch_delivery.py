"""The engine's delivery core in the port against the reference package.

Both packages' engines take the same appends on the CPU (the port on
``device="cpu"``) and deliver them to the same test-local output plugin,
registered in each package's registry for the test. Their deliveries
(the bytes of each chunk an output took, in order where the order is
fixed), the six output counter families and the latency histogram's
count must be equal, exactly: retries up to ``retry_limit`` with the
backoff of ``core/scheduler.py`` (an output that answers RETRY once
delivers its chunk), ERROR and a raising flush drop at once, a retry in
backoff is a loop timer that ``stop()`` drops and counts, a full task
map parks chunks on the backlog without losing or reordering one,
``workers N`` flushes round-robin on N threads, ``no_multiplex`` and a
synchronous plugin keep one flush in flight, ``route_condition`` splits
the records at ingest and sends the append down the decoded path, and
the file output writes the reference's bytes and retries a directory
that is not there yet.

No test waits out a real backoff (at least ``scheduler.base`` + 1 s):
each sets the name ``backoff_full_jitter`` in both engine modules to the
same small function.
"""

import asyncio
import collections
import json
import os
import random
import sys
import threading
import time

import pytest

import fluentbit_tpu as ref
import fluentbit_tpu_torch as port
from fluentbit_tpu.codec.events import encode_event as ref_encode
from fluentbit_tpu.core import bucket_queue as ref_bq
from fluentbit_tpu.core import config as ref_config
from fluentbit_tpu.core import engine as ref_engine
from fluentbit_tpu.core import plugin as ref_plugin
from fluentbit_tpu.core import scheduler as ref_scheduler
from fluentbit_tpu_torch.codec.events import decode_events, encode_event
from fluentbit_tpu_torch.core import bucket_queue as port_bq
from fluentbit_tpu_torch.core import config as port_config
from fluentbit_tpu_torch.core import engine as port_engine
from fluentbit_tpu_torch.core import plugin as port_plugin
from fluentbit_tpu_torch.core import scheduler as port_scheduler

FAMILIES = ("proc_records_total", "proc_bytes_total", "errors_total",
            "retries_total", "retries_failed_total", "dropped_records_total",
            "latency_seconds_count")


def probe_class(plugin_mod, config_mod):
    """A test-local output: answers its ``script`` one step a flush
    (``ok``, ``retry``, ``error`` or ``raise``; the last step repeats),
    blocks the flushing loop ``block_ms`` or awaits ``sleep_ms``, and
    notes what it delivered, its flushes in flight, the threads that
    flushed and its worker hooks."""
    Entry = config_mod.ConfigMapEntry
    FlushResult = plugin_mod.FlushResult

    class Probe(plugin_mod.OutputPlugin):
        name = "delivery_probe"
        config_map = [Entry("script", "str", default="ok"),
                      Entry("block_ms", "int", default=0),
                      Entry("sleep_ms", "int", default=0),
                      Entry("synchronous", "bool", default="false"),
                      Entry("init_sleep_ms", "int", default=0)]

        def init(self, instance, engine):
            self.steps = self.script.split(",")
            self.attempts = 0
            self.delivered = []
            self.inflight = self.max_inflight = 0
            self.threads = collections.Counter()
            self.hooks = []
            self.backlog_seen = 0
            self.lock = threading.Lock()

        def worker_init(self, index):
            self.hooks.append(("init", index))
            time.sleep(self.init_sleep_ms / 1e3)

        def worker_exit(self, index):
            self.hooks.append(("exit", index))

        async def flush(self, data, tag, engine):
            with self.lock:
                step = self.steps[min(self.attempts, len(self.steps) - 1)]
                self.attempts += 1
                self.inflight += 1
                self.max_inflight = max(self.max_inflight, self.inflight)
                self.threads[threading.current_thread().name.split("-")[-1]] \
                    += 1
                self.backlog_seen = max(self.backlog_seen,
                                        len(engine._backlog))
            try:
                time.sleep(self.block_ms / 1e3)
                await asyncio.sleep(self.sleep_ms / 1e3)
            finally:
                with self.lock:
                    self.inflight -= 1
            if step == "raise":
                raise RuntimeError("probe flush raised")
            if step == "ok":
                self.delivered.append((tag, data))
            return FlushResult[step.upper()]

    return Probe


PACKAGES = (
    (ref, ref_engine, ref_plugin, ref_config, ref_encode),
    (port, port_engine, port_plugin, port_config, encode_event),
)


def tiny_backoff(base, cap, attempt, rng=None):
    return 0.01


@pytest.fixture
def both(monkeypatch):
    """The probe in both registries and the small backoff in both engine
    modules; yields a ``set_backoff(fn)`` for tests that need another."""
    for _pkg, _eng, plugin_mod, config_mod, _enc in PACKAGES:
        monkeypatch.setitem(plugin_mod.registry.outputs, "delivery_probe",
                            probe_class(plugin_mod, config_mod))

    def set_backoff(fn):
        for _pkg, engine_mod, *_ in PACKAGES:
            monkeypatch.setattr(engine_mod, "backoff_full_jitter", fn)

    set_backoff(tiny_backoff)
    return set_backoff


def bodies(n, seed=0):
    rng = random.Random(seed)
    levels = ["info", "warn", "error"]
    return [{"log": f"GET /p/{i} HTTP/1.1 {rng.choice([200, 404, 503])} x",
             "level": rng.choice(levels), "status": rng.choice([200, 503]),
             "n": i, "u": "é☃" if i % 7 == 0 else "a"} for i in range(n)]


def encoded(encode, recs, t0=1700000000.0):
    return b"".join(encode(b, t0 + i * 0.25) for i, b in enumerate(recs))


def run(pkg_entry, outputs, appends, service=None, filters=(), expect=None,
        during=None, settle=True):
    """One package's engine: a lib input, ``filters``, ``outputs``
    (``[(name, props)]``; a lib output collects its chunks), the
    ``appends`` (``[(tag, bodies)]``) all made before the first flush
    cycle drains (the engine's lock is held around them), then wait
    until ``expect`` records are delivered or dropped over the outputs
    and the task map is empty, and stop. Returns the context and each
    output's chunks."""
    pkg, _engine_mod, _plugin, _config, encode = pkg_entry
    kw = {"flush": "20ms", "grace": "1", **(service or {})}
    ctx = pkg.create(device="cpu", **kw) if pkg is port else pkg.create(**kw)
    ctx.input("lib", tag="t")
    for name, props in filters:
        ctx.filter(name, **props)
    sinks = []
    for name, props in outputs:
        got = []
        if name == "lib":
            props = {**props, "callback":
                     lambda d, t, got=got: got.append((t, d))}
        ctx.output(name, **props)
        sinks.append(got)
    engine = ctx.engine
    ctx.start()
    try:
        with engine._ingest_lock:
            for tag, recs in appends:
                engine.input_log_append(engine.inputs[0], tag,
                                        encoded(encode, recs))
        if during is not None:
            during(ctx)
        if settle:
            wait_settled(engine, expect)
    finally:
        ctx.stop()
    for out, got in zip(engine.outputs, sinks):
        if out.plugin.name == "delivery_probe":
            got.extend(out.plugin.delivered)
    return ctx, sinks


def accounted(engine):
    return sum(m.get((o.display_name,)) for o in engine.outputs
               for m in (engine.m_out_proc_records, engine.m_out_dropped))


def wait_settled(engine, expect, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if accounted(engine) >= expect and not engine._task_map \
                and not engine._backlog:
            return
        time.sleep(0.005)
    raise AssertionError(f"not settled: {accounted(engine)} of {expect} "
                         f"records accounted, {len(engine._task_map)} tasks")


def families(engine):
    lines = engine.metrics.to_prometheus().splitlines()
    return sorted(ln for ln in lines if any(
        ln.startswith(f"fluentbit_output_{f}{{") for f in FAMILIES))


def counter(engine, family, out=0):
    key = f'fluentbit_output_{family}{{name="{engine.outputs[out].display_name}"}} '
    return sum(float(ln[len(key):]) for ln in families(engine)
               if ln.startswith(key))


def run_both(outputs, appends, **kw):
    """``run`` in each package; asserts the deliveries and the output
    families equal and returns both results."""
    res = [run(entry, outputs, appends, **kw) for entry in PACKAGES]
    (rctx, rsinks), (pctx, psinks) = res
    assert psinks == rsinks
    assert families(pctx.engine) == families(rctx.engine)
    return res


# ---------------------------------------------------------------- scheduler


@pytest.mark.parametrize("base,cap", [(5.0, 2000.0), (0.01, 0.02),
                                      (3.0, 1.0), (0.5, 0.5), (60.0, 60.0)])
def test_backoff_equals_reference(base, cap):
    got, want = random.Random(7), random.Random(7)
    for attempt in range(1, 41):
        d = port_scheduler.backoff_full_jitter(base, cap, attempt, got)
        assert d == ref_scheduler.backoff_full_jitter(base, cap, attempt, want)
        assert min(base, cap) + 1.0 <= d <= cap + 1.0
    assert port_scheduler.backoff_full_jitter(base, cap, 0, got) == \
        ref_scheduler.backoff_full_jitter(base, cap, 0, want)


def test_bucket_queue_orders_by_priority_then_fifo():
    orders = []
    for bq in (ref_bq, port_bq):
        q = bq.BucketQueue()
        q.add(bq.PRIORITY_FLUSH, "f1")
        q.add(bq.PRIORITY_TOP, "t1")
        q.add(bq.PRIORITY_FLUSH, "f2")
        q.add(5, "later")
        q.add(bq.PRIORITY_NETWORK, "n1")
        q.add(bq.PRIORITY_TOP, "t2")
        q.add(bq.PRIORITY_DEFAULT, "d")
        first = list(q.drain())
        assert not q and len(q) == 0
        q.add(99, "clamped")  # out of range: clamps to the bottom
        q.add(-3, "top")
        orders.append((first, list(q.drain())))
        with pytest.raises(IndexError):
            q.pop()
    assert orders[1] == orders[0] == (
        ["t1", "t2", "n1", "f1", "f2", "later", "d"], ["top", "clamped"])


# ---------------------------------------------------------------- retries

RETRY_CASES = {
    # script, props, (attempts, retries, retries_failed, errors, delivered)
    "retry_once_then_ok": ("retry,ok", {}, (2, 1, 0, 0, True)),
    "no_limits": ("retry,retry,retry,ok", {"retry_limit": "no_limits"},
                  (4, 3, 0, 0, True)),
    "past_the_service_limit": ("retry,retry,ok", {}, (2, 1, 1, 1, False)),
    "error_drops_at_once": ("error", {"retry_limit": "5"},
                            (1, 0, 0, 1, False)),
    "raise_is_error": ("raise", {"retry_limit": "5"}, (1, 0, 0, 1, False)),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_flush_results_equal_reference(both, case):
    """An output's answers, one a flush: RETRY runs through the retry
    scheduler up to the output's ``retry_limit`` (the service default is
    1), ERROR and a raising flush drop at once. An output that answers
    RETRY once and then OK gets its chunk: the port dropped it before
    the retry scheduler was ported."""
    script, props, (attempts, retries, failed, errors, ok) = \
        RETRY_CASES[case]
    recs = bodies(5)
    res = run_both([("delivery_probe", {"match": "*", "script": script,
                                        **props})],
                   [("t", recs)], expect=len(recs))
    for ctx, sinks in res:
        e = ctx.engine
        assert e.outputs[0].plugin.attempts == attempts
        assert counter(e, "retries_total") == retries
        assert counter(e, "retries_failed_total") == failed
        assert counter(e, "errors_total") == errors
        assert counter(e, "dropped_records_total") == (0 if ok else 5)
        assert counter(e, "proc_records_total") == (5 if ok else 0)
        assert counter(e, "latency_seconds_count") == (1 if ok else 0)
        if ok:
            assert [ev.body for _t, d in sinks[0]
                    for ev in decode_events(d)] == recs


def test_retry_plugin_exhausts_its_limit(both):
    """out_retry with ``retry_limit 2``: the first attempt and two
    retries, then the chunk drops with its records counted."""
    recs = bodies(4)
    res = run_both([("retry", {"match": "*", "retry_limit": "2"}),
                    ("lib", {"match": "*"})], [("t", recs)], expect=8)
    for ctx, sinks in res:
        e = ctx.engine
        assert e.outputs[0].plugin.attempts == 3
        assert counter(e, "retries_total") == 2
        assert counter(e, "retries_failed_total") == 1
        assert counter(e, "errors_total") == 1
        assert counter(e, "dropped_records_total") == 4
        assert counter(e, "proc_records_total", out=1) == 4
        assert len(sinks[1]) == 1


def test_retry_in_backoff_is_a_timer_and_stop_drops_it(both):
    """A retry in a long backoff holds no pending flush and no slot of
    the output's flush semaphore (``no_multiplex``): it is a loop timer
    in ``_pending_retries``. ``stop()`` cancels the timer and counts the
    chunk as dropped."""
    both(lambda base, cap, attempt, rng=None: 60.0)
    seen = []

    def during(ctx):
        e = ctx.engine
        deadline = time.time() + 5
        while not e._pending_retries and time.time() < deadline:
            time.sleep(0.005)
        time.sleep(0.05)
        seen.append((e.outputs[0].plugin.attempts, len(e._pending_retries),
                     len(e._pending_flushes),
                     e.outputs[0].flush_semaphore.locked()))

    t0 = time.time()
    res = run_both([("delivery_probe", {"match": "*", "script": "retry",
                                        "retry_limit": "5",
                                        "no_multiplex": "on"})],
                   [("t", bodies(3))], during=during, settle=False)
    assert time.time() - t0 < 10  # neither stop waited for the timer
    assert seen == [(1, 1, 0, False)] * 2
    for ctx, _sinks in res:
        e = ctx.engine
        assert not e._pending_retries and not e._task_map
        assert counter(e, "retries_total") == 1
        assert counter(e, "errors_total") == 1
        assert counter(e, "dropped_records_total") == 3


def test_task_map_pressure_parks_and_keeps_order(both):
    """``task_map_size 2`` and 50 one-record chunks to a slow output:
    the full map parks the rest of each cycle on the backlog, which the
    next cycle dispatches first. Every record arrives, in the order of
    the appends."""
    appends = [(f"t.{i}", [{"i": i}]) for i in range(50)]
    res = run_both([("delivery_probe", {"match": "*", "block_ms": "2"})],
                   appends, service={"task_map_size": "2"}, expect=50)
    for ctx, sinks in res:
        assert [t for t, _d in sinks[0]] == [t for t, _r in appends]
        assert ctx.engine.outputs[0].plugin.backlog_seen > 0
        assert counter(ctx.engine, "latency_seconds_count") == 50


# ---------------------------------------------------------------- workers


def test_workers_round_robin_and_hooks(both):
    """``workers 2``: flushes alternate between the two worker threads,
    each worker runs its init and exit hook once, every record arrives."""
    appends = [(f"t.{i}", bodies(3, seed=i)) for i in range(4)]
    res = [run(entry, [("delivery_probe", {"match": "*", "workers": "2",
                                           "sleep_ms": "5"})],
               appends, expect=12) for entry in PACKAGES]
    got = []
    for ctx, sinks in res:
        plugin = ctx.engine.outputs[0].plugin
        assert plugin.threads == {"w0": 2, "w1": 2}
        assert sorted(plugin.hooks) == [("exit", 0), ("exit", 1),
                                        ("init", 0), ("init", 1)]
        assert plugin.max_inflight <= 2
        got.append((sorted(sinks[0]), families(ctx.engine)))
    assert got[1] == got[0]


@pytest.mark.parametrize("props,most", [
    ({"no_multiplex": "on"}, 1),
    ({"synchronous": "on", "workers": "2"}, 1),
    ({}, 4),
], ids=["no_multiplex", "synchronous", "unbounded"])
def test_flushes_in_flight(both, props, most):
    """``no_multiplex`` and a synchronous plugin (which gets no worker
    threads) keep one flush in flight; an output without either takes
    the cycle's four chunks at once."""
    appends = [(f"t.{i}", bodies(2, seed=i)) for i in range(4)]
    res = run_both([("delivery_probe", {"match": "*", "sleep_ms": "15",
                                        **props})], appends, expect=8)
    for ctx, _sinks in res:
        plugin = ctx.engine.outputs[0].plugin
        assert plugin.max_inflight == most
        assert set(plugin.threads) == {"engine"}


def test_workers_under_thread_pressure(both):
    """More worker threads than cores and a very short switch interval:
    every record arrives once, each chunk counts once, and the task map
    empties (the worker loops, the engine's loop and the appending
    thread share the task map, the counters and the plugin)."""
    workers = len(os.sched_getaffinity(0)) + 1
    appends = [(f"t.{i}", bodies(5, seed=i)) for i in range(40)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ctx, sinks = run(PACKAGES[1], [("delivery_probe", {
            "match": "*", "workers": str(workers), "sleep_ms": "1"})],
            appends, expect=200)
    finally:
        sys.setswitchinterval(interval)
    got = sorted((t, ev.body["n"]) for t, d in sinks[0]
                 for ev in decode_events(d))
    assert got == sorted((t, r["n"]) for t, recs in appends for r in recs)
    e = ctx.engine
    assert counter(e, "proc_records_total") == 200
    assert counter(e, "latency_seconds_count") == 40
    assert not e._task_map and not e._pending_flushes
    assert e.outputs[0].plugin.max_inflight <= workers
    prefix = f"flb-out-{e.outputs[0].display_name}-w"
    assert not any(t.name.startswith(prefix) for t in threading.enumerate())


def test_worker_pool_that_does_not_start_raises(both):
    """A worker that misses the start barrier no longer makes ``start()``
    raise (the name is kept from when it did): within
    ``guard.worker_start_timeout`` the pool fails over to flushes on the
    engine's loop and counts it, as in the reference. The deliveries,
    the output families and the failure count are equal."""
    recs = bodies(6)
    res = run_both([("delivery_probe", {"match": "*", "workers": "2",
                                        "init_sleep_ms": "400"})],
                   [("t", recs)], expect=len(recs),
                   service={"guard.worker_start_timeout": "0.1s"})
    for ctx, sinks in res:
        e = ctx.engine
        assert e.outputs[0].worker_pool is None
        assert e.guard.m_worker_start_fail.get(("delivery_probe.0",)) == 1
        assert set(e.outputs[0].plugin.threads) == {"engine"}
        assert [ev.body for _t, d in sinks[0]
                for ev in decode_events(d)] == recs


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("cond,key,want", [
    ("$level eq error", "level", lambda v: v == "error"),
    ("$status gte 500", "status", lambda v: v >= 500),
], ids=["eq", "numeric"])
def test_route_condition_splits_records(both, cond, key, want):
    """The reference's two cases (tests/test_conditional_routing.py):
    the conditional output gets only the records its condition admits,
    the unconditional one every record."""
    recs = bodies(24, seed=3)
    recs[5] = {"n": 5}  # the field missing: no condition admits it
    res = run_both([("lib", {"match": "*"}),
                    ("lib", {"match": "*", "route_condition": cond})],
                   [("t", recs)], expect=24 + sum(
                       key in r and want(r[key]) for r in recs))
    for _ctx, (all_out, cond_out) in res:
        # the unconditional output's records come a chunk per route mask
        assert sorted((ev.body for _t, d in all_out
                       for ev in decode_events(d)),
                      key=lambda b: b["n"]) == recs
        assert [ev.body for _t, d in cond_out for ev in decode_events(d)] \
            == [r for r in recs if key in r and want(r[key])]


@pytest.mark.parametrize("conditional", [True, False],
                         ids=["route_condition", "control"])
def test_route_condition_takes_the_decoded_path(both, conditional):
    """A grep chain whose tag an output with a ``route_condition``
    matches runs on the decoded records (grep's device match on the
    plain version here), not the raw path; the records each output gets
    equal the reference's. Without the condition the append is raw."""
    rx = r"$log regex \s5[0-9][0-9]\s"
    recs = bodies(40, seed=5)
    recs[3] = {"log": 3}  # not a string: grep drops it, regex never admits
    kept = [r for r in recs if isinstance(r["log"], str)
            and r["log"].startswith("GET")]
    admitted = [r for r in kept if not conditional or " 503 " in r["log"]]
    extra = {"route_condition": rx} if conditional else {}
    res = run_both([("lib", {"match": "*"}), ("lib", {"match": "*", **extra})],
                   [("t", recs)], filters=[("grep", {"match": "*",
                                                     "regex": "log ^GET"})],
                   expect=len(kept) + len(admitted))
    ctx = res[1][0]
    grep = ctx.engine.filters[0].plugin
    assert ctx.engine.filters[0].batch_taken == 0
    if conditional:
        assert grep.raw_timings["records"] == 0
        assert len(grep.match_seconds) == 1
    else:
        assert grep.raw_timings["records"] == 40
        assert not grep.match_seconds
    for _ctx, (all_out, cond_out) in res:
        assert sorted((ev.body for _t, d in all_out
                       for ev in decode_events(d)),
                      key=lambda b: b["n"]) == kept
        assert [ev.body for _t, d in cond_out for ev in decode_events(d)] \
            == admitted


# ---------------------------------------------------------------- outputs


@pytest.mark.parametrize("fmt", ["out_file", "plain", "json_lines"])
def test_file_output_bytes_equal_reference(both, tmp_path, fmt):
    recs = bodies(6, seed=9)
    recs[2]["nested"] = {"a": [1, 2.5, None, True]}
    written = []
    for label in ("ref", "port"):
        (tmp_path / label).mkdir()
    for entry, label in zip(PACKAGES, ("ref", "port")):
        run(entry, [("file", {"match": "*", "path": str(tmp_path / label),
                              "format": fmt})], [("app.log", recs)],
            expect=6)
        written.append((tmp_path / label / "app.log").read_bytes())
    assert written[0] == written[1]
    assert written[1].count(b"\n") == 6


def test_file_output_retries_a_missing_directory(both, tmp_path):
    """The directory is not there at the first flush: the file output
    answers RETRY, and the retry delivers once it exists (made when the
    engine computes the backoff)."""
    for label in ("ref", "port"):
        target = tmp_path / label / "later"

        def backoff(base, cap, attempt, rng=None, target=target):
            target.mkdir(parents=True, exist_ok=True)
            return 0.01

        both(backoff)
        entry = PACKAGES[label == "port"]
        ctx, _ = run(entry, [("file", {"match": "*", "path": str(target),
                                       "file": "out.txt", "format": "plain",
                                       "retry_limit": "3"})],
                     [("t", bodies(4))], expect=4)
        assert counter(ctx.engine, "retries_total") == 1
        assert counter(ctx.engine, "proc_records_total") == 4
        assert counter(ctx.engine, "errors_total") == 0
    assert (tmp_path / "ref/later/out.txt").read_bytes() == \
        (tmp_path / "port/later/out.txt").read_bytes()


def test_formatter_exit_and_counting_outputs(both, capsys):
    """``output_set_test``'s formatter takes the flush's bytes and
    counts as delivered; out_exit stops the engine loop by itself after
    its flush; counter and flowcounter count what they got."""
    recs = bodies(5)
    seen = []
    for entry in PACKAGES:
        pkg = entry[0]
        got = []
        kw = {"flush": "20ms", "grace": "1"}
        ctx = pkg.create(device="cpu", **kw) if pkg is port \
            else pkg.create(**kw)
        ctx.input("lib", tag="t")
        fmt = ctx.output("stdout", match="*")
        ctx.output_set_test(fmt, "formatter",
                            lambda d, t, got=got: got.append((t, d)))
        ctx.output("flowcounter", match="*")
        ctx.output("counter", match="*")
        ctx.output("exit", match="*", flush_count="1")
        ctx.start()
        try:
            ctx.push(0, json.dumps([[1700000000 + i, r]
                                    for i, r in enumerate(recs)]))
            deadline = time.time() + 5
            while ctx.engine.running and time.time() < deadline:
                time.sleep(0.005)
            assert not ctx.engine.running  # out_exit's request_stop
        finally:
            ctx.stop()
        outs = ctx.engine.outputs
        assert "\nfluentbit_uptime " in ctx.metrics.to_prometheus()
        seen.append((got, outs[1].plugin.counts, outs[2].plugin.total,
                     families(ctx.engine)))
    assert seen[1] == seen[0]
    assert seen[1][2] == 5 and seen[1][1] == {"t": [5, len(seen[1][0][0][1])]}
    assert capsys.readouterr().out.count("(total = 5)") == 2

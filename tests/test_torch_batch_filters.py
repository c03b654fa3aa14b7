"""The raw path's batch hooks in the port against the reference package.

Both packages' engines take the same encoded appends (made from a seed)
on the CPU: the reference's on JAX's CPU backend with its own native
library, the port's on ``device="cpu"`` with its own host codec. The
port's batch hooks (``process_batch``) of rewrite_tag, parser (regex),
log_to_metrics (counter) and flux must take every append, and each
input's chunks (tag, bytes, records), every emitter's records, the flux
state and the six input and filter counter families must equal the
reference's, exactly. Also: a chunk from rewrite_tag's own emitter
passes untouched; a decline after a stateful hook finishes the chain on
the decoded records without emitting twice; dynamic labels keep
log_to_metrics on the decoded path; four lib inputs pushing from
threads through parser give the output of a serial run. The json
parser's hook (the codec extension's ``parser_json_batch``) takes a
json parser with no time format, ``reserve_data`` or ``preserve_key``,
and declines a chunk with a legacy record; two lib inputs pushing from
threads through grep's raw path give the records, totals and counters of
a serial run.
"""

import json
import random
import sys
import threading

import pytest
import torch

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu.codec.events import encode_event as ref_encode
from fluentbit_tpu.codec.msgpack import Unpacker as RefUnpacker
from fluentbit_tpu.core.engine import Engine as RefEngine
from fluentbit_tpu_torch.codec.events import decode_events, encode_event
from fluentbit_tpu_torch.codec.msgpack import Unpacker, packb
from fluentbit_tpu_torch.core.engine import Engine
from fluentbit_tpu_torch.ops.device import DeviceError
from test_torch_filter_parser import PARSERS, prefilter_events
from test_torch_flux import closed_print, corpus, fingerprint
from test_torch_native_codec import DOCS
from test_torch_rewrite_tag import CONFIG3_RULES, config3_corpus

FAMILIES = ("fluentbit_input_records_total", "fluentbit_input_bytes_total",
            "fluentbit_filter_add_records_total",
            "fluentbit_filter_drop_records_total",
            "fluentbit_filter_emit_records_total",
            "fluentbit_filter_batch_declines_total")


def build(filters, parsers=(), inputs=1):
    """The reference's engine and the port's, each with ``inputs`` dummy
    inputs and the filters ``[(name, [(key, value), ...])]``, configured
    and initialised as ``start()`` would, without the engine thread."""
    pair = []
    for engine in (RefEngine(), Engine(device=torch.device("cpu"))):
        for name in parsers:
            engine.parser(name, **PARSERS[name])
        for name, props in filters:
            f = engine.filter(name)
            for k, v in props:
                f.set(k, v)
        for _ in range(inputs):
            engine.input("dummy")
        for x in engine.inputs + engine.filters:
            x.configure()
            x.plugin.init(x, engine)
        pair.append(engine)
    return pair


def append_both(engines, data_of, tag="t", ins=0):
    """The same append into both engines; returns (ref n, port n)."""
    return tuple(e.input_log_append(e.inputs[ins], tag, data_of(e))
                 for e in engines)


def drained(engine):
    """Every input's chunks, hidden emitters included, in input order."""
    return [(i.display_name, c.tag, c.get_bytes(), c.records)
            for i in engine.inputs for c in i.pool.drain()]


def families(engine, skip=()):
    return sorted(ln for ln in engine.metrics.to_prometheus().splitlines()
                  if ln.split("{")[0] in FAMILIES
                  and ln.split("{")[0] not in skip)


def encoded(bodies, t0=1700000000.0):
    """One append's bytes in each package's own encoder (equal bytes)."""
    ref = b"".join(ref_encode(b, t0 + i * 0.5) for i, b in enumerate(bodies))
    port = b"".join(encode_event(b, t0 + i * 0.5)
                    for i, b in enumerate(bodies))
    assert ref == port
    return lambda e: port if isinstance(e, Engine) else ref


def declines(engine, name):
    text = engine.metrics.to_prometheus()
    key = f'fluentbit_filter_batch_declines_total{{name="{name}"}} '
    return sum(float(ln[len(key):]) for ln in text.splitlines()
               if ln.startswith(key))


# ---------------------------------------------------------------- rewrite_tag

CAPTURE_RULES = [r"$log ^(alpha)\w* routed.$1.$TAG[1] true",
                 "$log ^beta routed.beta false",
                 "$log sshd sec.ssh false"]


@pytest.mark.parametrize("rules", [CONFIG3_RULES, CAPTURE_RULES],
                         ids=["config3", "capture"])
def test_rewrite_tag_equals_reference(rules):
    rng = random.Random(4)
    bodies = config3_corpus(400)
    for i in range(0, 400, 5):
        bodies[i]["log"] = rng.choice(["alphaX", "alpha", "beta"]) + f" {i}"
    bodies[7] = {"log": 7}                       # not a string
    bodies[8] = {"other": "sshd"}                # no log key
    bodies[11] = {"log": "sshd " + "y" * 700}    # past 512 B
    # tpu.enable off: no decoded-path device program (the raw path's
    # hook does not use it), so no JAX compile for the reference
    ref, port = build([("rewrite_tag", [("match", "a.b"),
                                        ("tpu.enable", "off")]
                        + [("rule", r) for r in rules])])
    assert port.filters[0].plugin.can_process_batch()
    data = encoded(bodies)
    n_ref, n_port = append_both((ref, port), data, tag="a.b")
    assert n_port == n_ref < len(bodies)
    got = drained(port)
    assert got == drained(ref)
    assert len(got) > 2  # the input's chunk and emitted groups
    assert port.filters[0].batch_taken == 1
    assert declines(port, "rewrite_tag.0") == 0
    assert families(port) == families(ref)
    assert any(ln.startswith("fluentbit_filter_emit_records_total")
               for ln in families(port))


def test_rewrite_tag_emitter_reentry_passes_untouched():
    """Match * sees the emitter's append again: the hook hands it on as
    it came, the re-emitted spans byte for byte."""
    ref, port = build([("rewrite_tag",
                        [("rule", "$log ^alpha routed.alpha false")])])
    buf = encoded([{"log": f"alpha {i}"} for i in range(64)])
    assert append_both((ref, port), buf) == (0, 0)
    got = drained(port)
    assert got == drained(ref)
    assert got == [("emitter_for_rewrite_tag.0", "routed.alpha",
                    buf(port), 64)]
    assert port.filters[0].batch_taken == 2
    assert families(port) == families(ref)


def test_rewrite_tag_emit_error_keeps_the_group(monkeypatch):
    """An error of a new tag's chain other than a device one (a
    ValueError, and a RuntimeError, which failed the append before the
    host error policy was ported): that group's originals stay and the
    other groups go out, as in the reference. A device error fails the
    append and is counted under lane grep."""
    rules = ["$log ^alpha routed.alpha false", "$log ^beta routed.beta false"]
    data = encoded([{"log": ("alpha" if i % 2 else "beta") + f" {i}"}
                    for i in range(20)])
    for error in (ValueError, RuntimeError):
        ref, port = build([("rewrite_tag", [("match", "t")]
                            + [("rule", r) for r in rules])])
        for e in (ref, port):
            emitter = e.filters[0].plugin.emitter

            def add_record(tag, payload, n, orig=emitter.add_record):
                if tag == "routed.beta":
                    raise error("the new tag's chain failed")
                return orig(tag, payload, n)

            monkeypatch.setattr(emitter, "add_record", add_record)
        assert append_both((ref, port), data) == (10, 10)
        got = drained(port)
        assert got == drained(ref)
        assert [(name, tag, r) for name, tag, _b, r in got] == [
            ("dummy.0", "t", 10),
            ("emitter_for_rewrite_tag.0", "routed.alpha", 10)]
        assert families(port) == families(ref)

    def device_error(tag, payload, n):
        raise DeviceError("grep_assoc failed: CUDA error 700")

    monkeypatch.setattr(port.filters[0].plugin.emitter, "add_record",
                        device_error)
    with pytest.raises(DeviceError, match="CUDA"):
        port.input_log_append(port.inputs[0], "t", data(port))
    assert port.m_device_failures.get(("grep",)) == 1


def test_stateful_hook_then_decline_does_not_emit_twice():
    """rewrite_tag's hook emits, then grep declines (an append below its
    32 records): the engine finishes grep on the decoded records of
    rewrite_tag's output, and the emitted records go out once."""
    filters = [("rewrite_tag", [("match", "t"),
                                ("rule", "$tagkey ^go moved.out false")]),
               ("grep", [("match", "t"), ("regex", "log keep")])]
    ref, port = build(filters)
    bodies = [{"log": "keep" if i % 3 else "drop", "i": i,
               **({"tagkey": "go"} if i % 4 == 0 else {})}
              for i in range(20)]
    n = append_both((ref, port), encoded(bodies))
    assert n[0] == n[1] == sum(1 for i in range(20) if i % 4 and i % 3)
    got = drained(port)
    assert got == drained(ref)
    assert sum(r for name, _t, _b, r in got if name.startswith("emitter")) \
        == 5
    assert port.filters[0].batch_taken == 1
    assert declines(port, "grep.0") == 1
    # the reference's grep takes its host walk here: its decline count
    # differs by design; every other family is equal
    skip = ("fluentbit_filter_batch_declines_total",)
    assert families(port, skip) == families(ref, skip)


# --------------------------------------------------------------------- parser

@pytest.mark.parametrize("reserve", ["false", "true"])
def test_parser_regex_equals_reference(reserve):
    """apache2 with Types on lines that parse, miss, are missing, are bin
    (always parsed) or run past 512 B."""
    bodies = prefilter_events(3, 200)
    bodies[5] = {"log": bodies[0]["log"].encode()}
    bodies[6] = {"log": 12}
    ref, port = build([("parser", [("key_name", "log"), ("parser", "apache2"),
                                   ("reserve_data", reserve),
                                   ("tpu.enable", "off")])],
                      parsers=["apache2"])
    assert port.filters[0].plugin.thread_safe_raw
    append_both((ref, port), encoded(bodies))
    got = drained(port)
    assert got == drained(ref)
    parsed = [ev.body for ev in decode_events(got[0][2])]
    assert parsed[5]["code"] in (200, 404)       # the bin value parsed
    assert sum("host" in b for b in parsed) > 50
    assert port.filters[0].batch_taken == 1
    assert families(port) == families(ref)


JSON_PROPS = [("key_name", "log"), ("parser", "js")]


def test_parser_json_hook_equals_reference_and_decoded():
    """A json parser with no time format, reserve_data or preserve_key
    takes the hook: the chunk equals the reference engine's (its own C
    transcoder) and the port's decoded path. A legacy record in the
    chunk declines in both packages, with the same output."""
    bodies = [{"log": d, "i": i} for i, d in enumerate(DOCS * 3)]
    bodies[3] = {"log": 12}
    bodies[4] = {"n": 1}
    ref, port = build([("parser", JSON_PROPS)], parsers=["js"])
    _, decoded = build([("parser", JSON_PROPS)], parsers=["js"])
    decoded.filters[0].plugin.can_process_batch = lambda: False
    assert port.filters[0].plugin.can_process_batch()
    assert port.filters[0].plugin.thread_safe_raw
    assert ref.filters[0].plugin.can_process_batch()
    legacy = packb([1700000000, {"log": '{"legacy": true}'}])
    for tail in (b"", legacy):
        data = encoded(bodies)
        with_tail = lambda e, data=data, tail=tail: data(e) + tail
        append_both((ref, port), with_tail)
        decoded.input_log_append(decoded.inputs[0], "t", with_tail(decoded))
        got = drained(port)
        assert got == drained(ref) == drained(decoded)
        parsed = [ev.body for ev in decode_events(got[0][2])]
        assert parsed[1] == {"dup": {"replaced": [3]}, "mid": 2}
        assert parsed[3] == {"log": 12} and parsed[4] == {"n": 1}
        if tail:
            assert parsed[-1] == {"legacy": True}
    assert port.filters[0].batch_taken == 1
    assert declines(port, "parser.0") == 1 == declines(ref, "parser.0")
    assert families(port) == families(ref)


@pytest.mark.parametrize("props,parsers,hook", [
    (JSON_PROPS, ["js"], True),
    (JSON_PROPS + [("reserve_data", "true")], ["js"], False),
    (JSON_PROPS + [("preserve_key", "true")], ["js"], False),
    ([("key_name", "log"), ("parser", "json")], ["json"], False),
    ([("key_name", "$log"), ("parser", "js")], ["js"], False),
    (JSON_PROPS + [("parser", "json")], ["js", "json"], False)],
    ids=["plain", "reserve_data", "preserve_key", "time_format", "accessor",
         "two_parsers"])
def test_parser_json_gate_equals_reference(props, parsers, hook):
    ref, port = build([("parser", props)], parsers=parsers)
    assert port.filters[0].plugin.can_process_batch() is hook
    assert ref.filters[0].plugin.can_process_batch() is hook


# ------------------------------------------------------------- log_to_metrics

L2M = [("exclude", "log DENY"), ("regex", "log GET"),
       ("metric_mode", "counter"), ("metric_name", "hits"),
       ("metric_description", "GET lines"), ("tag", "m"),
       ("add_label", "app web")]


def snapshots(engine):
    """Every input's chunks; the metrics snapshots the filter emitted
    decoded, their times dropped."""
    unpack = Unpacker if isinstance(engine, Engine) else RefUnpacker
    out = []
    for ins in engine.inputs:
        for c in ins.pool.drain():
            if c.event_type == "logs":
                out.append((ins.display_name, c.tag, c.get_bytes()))
                continue
            for obj in unpack(c.get_bytes()):
                obj["meta"].pop("ts")
                for m in obj["metrics"]:
                    m.pop("ts")
                out.append((ins.display_name, c.tag, c.event_type, obj))
    return out


@pytest.mark.parametrize("extra", [[], [("discard_logs", "true")],
                                   [("label_field", "code")]],
                         ids=["static", "discard", "dynamic"])
def test_log_to_metrics_counter_equals_reference(extra):
    rng = random.Random(9)
    ref, port = build([("log_to_metrics", L2M + extra)])
    plug = port.filters[0].plugin
    for k in range(3):
        bodies = [{"log": rng.choice(["GET /a", "GET DENY", "POST /b"]),
                   "code": rng.choice([200, 404])} for _ in range(50)]
        bodies.append("not a map")
        n = 0 if ("discard_logs", "true") in extra else len(bodies)
        assert append_both((ref, port), encoded(bodies, 1.0 + k)) == (n, n)
        assert snapshots(port) == snapshots(ref)
        assert (plug.cmt.to_prometheus()
                == ref.filters[0].plugin.cmt.to_prometheus())
    # dynamic labels keep the decoded path, as in the reference
    assert plug.can_process_batch() == (extra[:1] != [("label_field",
                                                       "code")])
    assert port.filters[0].batch_taken == (3 if plug.can_process_batch()
                                           else 0)
    assert families(port) == families(ref)


# ----------------------------------------------------------------------- flux

FLUX = [("match", "app"), ("group_by", "tenant"), ("distinct_field", "user"),
        ("aggregate_field", "size"), ("topk_field", "user"), ("topk", "3"),
        ("window", "tumbling 60"), ("tag", "flux.t"),
        ("max_field_len", "16")]


def test_flux_hook_equals_reference():
    """Appends of a few tenants and one of 600 (above the 512-group cap:
    the grouped K6 route), under one clock: the state after each append
    (groups, counts, column stats bit for bit, registers, table,
    candidates, counters), the closed windows with their estimates and
    top-k, and the rows drained at the end. Exact: both packages fold
    each append's columns in record order on the host."""
    ref, port = build([("flux", FLUX)])
    states = [e.filters[0].plugin.state for e in (ref, port)]
    clock = [1000.0]
    for st in states:
        st._now = lambda: clock[0]
        st._window_start = clock[0]
    wide = corpus(13, 700, users=900)
    for i, body in enumerate(wide[:-1]):
        body["tenant"] = f"t{i % 600:03d}"
    appends = [corpus(1, 120), corpus(2, 60, long_every=7), wide,
               corpus(3, 90), corpus(4, 30)]
    closed = []
    for k, bodies in enumerate(appends):
        clock[0] = 1000.0 + 25.0 * k
        want = closed_print(states[0], states[0].tick())
        assert closed_print(states[1], states[1].tick()) == want
        closed.append(want)
        n = append_both((ref, port), encoded(bodies, 1.0), tag="app")
        assert n == (len(bodies), len(bodies))
        assert fingerprint(states[1]) == fingerprint(states[0])
    assert sum(map(len, closed)) > 600   # the wide window closed
    assert closed_print(states[1], states[1].drain()) == closed_print(
        states[0], states[0].drain())
    assert port.filters[0].batch_taken == len(appends)
    assert drained(port) == drained(ref)  # records pass untouched
    assert families(port) == families(ref)


# ------------------------------------------------- parallel inputs (parser)

PARSER_FILTER = dict(name="parser", key_name="log", parser="apache2",
                     **{"tpu.enable": "off"})


def run_lib_inputs(create, appends, threaded, filt=PARSER_FILTER, **kw):
    """A lib input per list of appends (tags t0, t1, ...) through one
    filter (parser apache2 by default) into a lib output; each input's
    appends pushed by a thread of its own, or all in turn. Returns each
    tag's bytes in arrival order and the context."""
    got = {}
    n_inputs = len(appends)
    ctx = create(flush="50ms", grace="1", **kw)
    ctx.parser("apache2", **PARSERS["apache2"])
    ffds = [ctx.input("lib", tag=f"t{i}") for i in range(n_inputs)]
    props = dict(filt)
    ctx.filter(props.pop("name"), match="t*", **props)
    ctx.output("lib", match="*", callback=lambda d, t: got.setdefault(
        t, []).append(d))
    ctx.start()
    try:
        def push(i):
            for text in appends[i]:
                assert ctx.push(ffds[i], text) > 0

        if threaded:
            threads = [threading.Thread(target=push, args=(i,))
                       for i in range(n_inputs)]
            # switch threads often: a lost update of a shared counter or
            # pool would show
            interval = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=60)
            finally:
                sys.setswitchinterval(interval)
            assert not any(th.is_alive() for th in threads)
        else:
            for i in range(n_inputs):
                push(i)
        ctx.flush_now()
    finally:
        ctx.stop()
    return {t: b"".join(v) for t, v in got.items()}, ctx


def pushed_in_turn(create, appends, filt=PARSER_FILTER, **kw):
    """``run_lib_inputs``'s chain with no engine thread: each input's
    appends pushed in turn, then each tag's bytes from its input's pool,
    in the order of the pushes (no flush cycle runs to reorder them)."""
    ctx = create(**kw)
    ctx.parser("apache2", **PARSERS["apache2"])
    ffds = [ctx.input("lib", tag=f"t{i}") for i in range(len(appends))]
    props = dict(filt)
    ctx.filter(props.pop("name"), match="t*", **props)
    e = ctx.engine
    for x in e.inputs + e.filters:
        x.configure()
        x.plugin.init(x, e)
    for ffd, texts in zip(ffds, appends):
        for text in texts:
            assert ctx.push(ffd, text) > 0
    return {x.tag: b"".join(c.get_bytes() for c in x.pool.drain())
            for x in e.inputs}


def test_parallel_inputs_equal_serial_and_reference():
    """The port's runs, serial and threaded, give each tag's bytes in the
    order of the pushes: the reference's pushed in turn with no flush
    cycle. The reference's run through its engine thread has the same
    records; its order across flush cycles is not fixed (its
    ``flush_now`` runs a cycle beside the timer's, see
    ``test_torch_pipeline.push_ordered``), so it is compared record by
    record as a multiset."""
    appends = [[json.dumps([[1700000000 + k + 0.5, b] for b in
                            prefilter_events(10 * i + k, 40)])
                for k in range(6)] for i in range(4)]
    ref, _ = run_lib_inputs(fluentbit_tpu.create, appends, False)
    serial, serial_ctx = run_lib_inputs(fluentbit_tpu_torch.create, appends,
                                        False, device="cpu")
    par, ctx = run_lib_inputs(fluentbit_tpu_torch.create, appends, True,
                              device="cpu")
    assert sorted(ref) == ["t0", "t1", "t2", "t3"]
    assert par == serial == pushed_in_turn(fluentbit_tpu.create, appends)

    def records(data):
        return sorted(ev.raw for ev in decode_events(data))

    assert {t: records(v) for t, v in par.items()} == {
        t: records(v) for t, v in ref.items()}
    assert ctx.engine.filters[0].batch_taken == 24
    assert ctx.engine.filters[0].plugin.thread_safe_raw
    assert families(ctx.engine) == families(serial_ctx.engine)
    assert len([ln for ln in families(ctx.engine)
                if ln.startswith("fluentbit_input_records_total")]) == 4


def test_grep_parallel_inputs_equal_serial():
    """grep is thread_safe_raw: two lib inputs push appends of >= 32
    records from threads of their own, each under its own lock, through
    the raw path; the records, grep's totals and the counter families
    equal a serial run's."""
    appends = [[json.dumps([[1700000000 + k + 0.5, b] for b in
                            prefilter_events(20 * i + k, 48)])
                for k in range(8)] for i in range(2)]
    grep = dict(name="grep", exclude="log 404")
    serial, serial_ctx = run_lib_inputs(fluentbit_tpu_torch.create, appends,
                                        False, grep, device="cpu")
    par, ctx = run_lib_inputs(fluentbit_tpu_torch.create, appends, True,
                              grep, device="cpu")
    assert sorted(par) == ["t0", "t1"]
    assert par == serial
    plugin, serial_plugin = (c.engine.filters[0].plugin
                             for c in (ctx, serial_ctx))
    assert plugin.thread_safe_raw
    assert plugin.raw_timings["records"] == 2 * 8 * 48 == \
        serial_plugin.raw_timings["records"]
    assert len(plugin.raw_step_seconds) == 16 and not plugin.match_seconds
    assert families(ctx.engine) == families(serial_ctx.engine)
    assert any(ln.startswith("fluentbit_filter_drop_records_total")
               for ln in families(ctx.engine))
    plugin.raw_timings["records"] = 0  # the reset every shard takes
    assert plugin.raw_timings["records"] == 0

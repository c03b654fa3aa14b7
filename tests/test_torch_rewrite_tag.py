"""filter_rewrite_tag through the port against the reference package.

The cases of tests/test_rewrite_tag.py (first match wins, captures and
tag parts, Ruby named-capture numbering, no match, re-entry through the
filter chain, emitted bodies, the emit counter, non-string fields,
failed translation, config 3's eight rules) run through both packages'
lib APIs on the CPU, with fixed timestamps: every tag's events (time and
body, in order) must be equal. The port runs each case on its raw path
(the batch hook over the host DFA twin, which takes every append), and,
with the hook off, on its decoded device path (``tpu_batch_records`` 1:
the plain torch DFA program) and its decoded host path (``tpu.enable
off``).
"""

import json

import numpy as np
import pytest
import torch

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu.codec.events import decode_events as jax_decode_events
from fluentbit_tpu_torch.codec.events import decode_events
from fluentbit_tpu_torch.ops import grep as tg
from fluentbit_tpu_torch.plugins.filter_rewrite_tag import RewriteTagFilter
from test_torch_pipeline import push_ordered

CONFIG3_RULES = [
    r"$log sshd sec.ssh false",
    r"$log kernel: sys.kernel false",
    r"$log systemd\[1\] sys.init false",
    r"$log ERROR app.error false",
    r"$log WARN app.warn false",
    r"$log nginx web.nginx false",
    r"$log cron\[\d+\] sys.cron false",
    r"$log .*OOM.* sys.oom false",
]


def config3_corpus(n=150):
    """tests/test_rewrite_tag.py's config 3 corpus, plus a line that
    two rules match (the first wins) and one past tpu_max_record_len."""
    corpus = []
    for i in range(n):
        line = {
            0: f"sshd[{i}]: Accepted publickey",
            1: "kernel: eth0 up",
            2: "systemd[1]: Started unit",
            3: "app ERROR boom",
            4: "app WARN slow",
            5: "nginx 200 GET /",
            6: f"cron[{i}]: job ran",
            7: "invoked OOM killer",
        }.get(i % 10, f"plain message {i}")
        corpus.append({"log": line, "i": i})
    corpus[9]["log"] = "sshd: ERROR and WARN"  # rules 1, 4 and 5
    corpus[19]["log"] = "nginx " + "x" * 600 + " OOM"  # overflow row
    return corpus


def grep_after(ctx):
    ctx.filter("grep", match="rt.*", regex="log keepme")


CASES = {
    "first_match_wins_and_drop": (
        ["$level error new.$level false", "$level .* catchall true"],
        [{"level": "error", "m": 1}, {"level": "warn", "m": 2}], {}),
    "captures_tag_parts_fields": (
        [r"$log ([a-z]+)-(\d+) $TAG[1].$1.$2.$kind true"],
        [{"log": "api-42 hello", "kind": "k"}], {"tag": "a.b"}),
    "ruby_named_capture_numbering": (
        [r"$log (?<svc>[a-z]+)-(\d+) new.$1 true"],
        [{"log": "api-42 hello"}], {}),
    "no_match_notouch": (
        ["$log ^ERROR et false"], [{"log": "fine"}, {"log": "also fine"}],
        {}),
    "reemitted_records_pass_through_filters": (
        ["$log .* rt.stream false"],
        [{"log": "keepme 1"}, {"log": "dropme 2"}], {"extra": grep_after}),
    "emitted_bytes_identical": (
        ["$log .* moved false"], [{"log": "x", "n": 7}], {}),
    "non_string_field_never_matches": (
        ["$n \\d+ moved false"], [{"n": 42, "m": 1}, {"n": "42", "m": 2}],
        {}),
    "failed_tag_translation_keeps_record": (
        ["$log .* $missing false"], [{"log": "hello"}], {}),
    "config3": (CONFIG3_RULES, config3_corpus(), {}),
}


def run_pipeline(create, rules, records, tag="orig", extra=None,
                 bulk=False, props=None, **create_kw):
    """lib input → rewrite_tag(rules) → every event per tag, as
    (time, body) pairs. Records go in one push each, or all in one
    push (``bulk``), each with a fixed timestamp."""
    ctx = create(flush="50ms", grace="1", **create_kw)
    in_ffd = ctx.input("lib", tag=tag)
    f = ctx.filter("rewrite_tag", **{"match": tag, **(props or {})})
    for r in rules:
        ctx.set(f, rule=r)
    if extra:
        extra(ctx)
    got = {}
    decode = (decode_events if create is fluentbit_tpu_torch.create
              else jax_decode_events)
    ctx.output("lib", match="*", callback=lambda d, t: got.setdefault(
        t, []).extend((float(ev.ts_float), ev.body) for ev in decode(d)))
    ctx.start()
    try:
        pairs = [[1700000000 + i + 0.5, rec] for i, rec in enumerate(records)]
        if bulk:
            ctx.push(in_ffd, json.dumps(pairs))
        else:
            for pair in pairs:
                ctx.push(in_ffd, json.dumps(pair))
        ctx.flush_now()
    finally:
        ctx.stop()
    return got, ctx


def in_push_order(got):
    """Every tag's (time, body) events in the order of the pushes (the
    record pushed k-th has the k-th time): the reference's run, with its
    records pushed one at a time, is held to this after
    ``push_ordered``, and the port's as it came."""
    return {t: push_ordered(evs, lambda e: e[0]) for t, evs in got.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_equals_reference(name, monkeypatch):
    """Every case on the port's raw path, decoded device path and decoded
    host path, pushed one record at a time and in bulk: each tag's
    events equal the reference's and come in the order of the pushes
    (the reference's order across its flush cycles is not fixed, see
    ``push_ordered``)."""
    rules, records, kw = CASES[name]
    ref, _ = run_pipeline(fluentbit_tpu.create, rules, records, **kw)
    assert ref
    ref = in_push_order(ref)
    for bulk in (False, True):
        raw, ctx = run_pipeline(fluentbit_tpu_torch.create, rules, records,
                                bulk=bulk, device="cpu", **kw)
        assert raw == ref, (bulk, sorted(raw), sorted(ref))
        # the batch hook took every append of the input's tag, with no
        # decline
        fi = ctx.engine.filters[0]
        assert fi.batch_taken == (1 if bulk else len(records))
        assert ('fluentbit_filter_batch_declines_total{name="rewrite_tag'
                not in ctx.engine.metrics.to_prometheus())
    monkeypatch.setattr(RewriteTagFilter, "can_process_batch",
                        lambda self: False)
    for bulk in (False, True):
        dev, ctx = run_pipeline(fluentbit_tpu_torch.create, rules, records,
                                bulk=bulk, device="cpu",
                                props={"tpu_batch_records": "1"}, **kw)
        host, _ = run_pipeline(fluentbit_tpu_torch.create, rules, records,
                               bulk=bulk, device="cpu",
                               props={"tpu.enable": "off"}, **kw)
        assert dev == ref, (bulk, sorted(dev), sorted(ref))
        assert host == ref, bulk
        if name == "config3":
            f = ctx.engine.filters[0].plugin
            assert f._program is not None
            # one device match per append of >= tpu_batch_records
            assert len(f.step_seconds) == (1 if bulk else len(records))


def test_expected_routing(monkeypatch):
    """The reference's own assertions, on the port's device path."""
    monkeypatch.setattr(RewriteTagFilter, "can_process_batch",
                        lambda self: False)

    def port(rules, records, **kw):
        return run_pipeline(fluentbit_tpu_torch.create, rules, records,
                            device="cpu", bulk=True,
                            props={"tpu_batch_records": "1"}, **kw)[0]

    def bodies(got, tag, key):
        return [b[key] for _, b in got.get(tag, [])]

    got = port(*CASES["first_match_wins_and_drop"][:2])
    assert bodies(got, "new.error", "m") == [1]
    assert bodies(got, "catchall", "m") == [2]
    assert bodies(got, "orig", "m") == [2]
    assert "b.api.42.k" in port(*CASES["captures_tag_parts_fields"][:2],
                                tag="a.b")
    assert "new.api" in port(*CASES["ruby_named_capture_numbering"][:2])
    got = port(*CASES["reemitted_records_pass_through_filters"][:2],
               extra=grep_after)
    assert bodies(got, "rt.stream", "log") == ["keepme 1"]
    assert "orig" not in got
    got = port(*CASES["non_string_field_never_matches"][:2])
    assert bodies(got, "moved", "m") == [2] and bodies(got, "orig", "m") == [1]
    got = port(*CASES["failed_tag_translation_keeps_record"][:2])
    assert len(got["orig"]) == 1
    records = CASES["config3"][1]
    got = port(CONFIG3_RULES, records)
    assert bodies(got, "sec.ssh", "i")[:2] == [0, 9]  # sshd wins on line 9
    assert 19 in bodies(got, "web.nginx", "i")
    assert "sys.oom" in got
    assert len(got["orig"]) == sum("plain" in r["log"] for r in records)


def test_emit_counter():
    ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms", grace="1")
    in_ffd = ctx.input("lib", tag="t")
    ctx.filter("rewrite_tag", match="t", rule="$log .* moved true")
    ctx.output("null", match="*")
    ctx.start()
    try:
        ctx.push(in_ffd, json.dumps({"log": "a"}))
        ctx.push(in_ffd, json.dumps({"log": "b"}))
        ctx.flush_now()
    finally:
        ctx.stop()
    fam = ctx.engine.metrics.to_prometheus()
    assert 'fluentbit_filter_emit_records_total{name="rewrite_tag.0"} 2' in fam


@pytest.mark.parametrize("prop,value", [
    ("emitter_storage.type", "filesystem"), ("emitter_mem_buf_limit", "1M")])
def test_unported_emitter_settings_raise(prop, value, tmp_path):
    """The emitter settings refused before the port had storage and
    backpressure reach the hidden emitter as the reference's do: its
    ``storage_type`` and ``mem_buf_limit`` (the defaults too)."""
    got = {}
    for name, create, kw in (("port", fluentbit_tpu_torch.create,
                              {"device": "cpu"}),
                             ("ref", fluentbit_tpu.create, {})):
        for props in ({prop: value}, {}):
            ctx = create(**kw, **{"storage.path": str(tmp_path / name)})
            ctx.input("lib", tag="t")
            ctx.filter("rewrite_tag", match="t", rule="$log .* moved true",
                       **props)
            ctx.start()
            try:
                em = ctx.engine.inputs[-1]
                got[name, bool(props)] = (em.storage_type, em.mem_buf_limit)
            finally:
                ctx.stop()
    assert got["port", True] == got["ref", True]
    assert got["port", False] == got["ref", False] == ("memory", 10 << 20)


def test_own_emitter_reentry_runs_no_second_match(monkeypatch):
    """Match * sees the re-emitted records again; the own-emitter guard
    passes them untouched, so one append makes one device match (one
    walk of the host twin on the raw path, the re-entered groups passing
    through the hook untouched), and a rule that still matches the new
    records does not recurse."""
    records = config3_corpus(100)
    raw, ctx = run_pipeline(fluentbit_tpu_torch.create, CONFIG3_RULES,
                            records, tag="syslog", bulk=True, device="cpu",
                            props={"match": "*"})
    groups = len(raw) - 1  # every tag but the original one
    assert ctx.engine.filters[0].batch_taken == 1 + groups
    monkeypatch.setattr(RewriteTagFilter, "can_process_batch",
                        lambda self: False)
    got, ctx = run_pipeline(fluentbit_tpu_torch.create, CONFIG3_RULES,
                            records, tag="syslog", bulk=True, device="cpu",
                            props={"tpu_batch_records": "1", "match": "*"})
    assert got == raw
    f = ctx.engine.filters[0].plugin
    assert len(f.step_seconds) == 1
    assert sum(len(v) for v in got.values()) == len(records)
    assert len(got["sec.ssh"]) == sum(r["log"].startswith("sshd")
                                      for r in records)


def test_config3_through_assoc_plain(monkeypatch):
    """Config 3 with "auto" resolved as on a CUDA device: the three
    per-k children take the assoc route (its plain version here), with
    the same routing as the host path and the reference."""
    monkeypatch.setattr(RewriteTagFilter, "can_process_batch",
                        lambda self: False)
    resolve = tg.kernel_for
    monkeypatch.setattr(tg, "kernel_for", lambda kernel, _d, s: resolve(
        kernel, torch.device("cuda"), s))
    tg._cached_program.cache_clear()
    try:
        records = config3_corpus()
        got, ctx = run_pipeline(fluentbit_tpu_torch.create, CONFIG3_RULES,
                                records, bulk=True, device="cpu",
                                props={"tpu_batch_records": "1"})
        prog = ctx.engine.filters[0].plugin._program
        assert prog.decision()["kernel_resolved"] == "assoc"
        assert [c.kernel_resolved for c in prog._children] == ["assoc"] * 3
    finally:
        tg._cached_program.cache_clear()
    ref, _ = run_pipeline(fluentbit_tpu.create, CONFIG3_RULES, records)
    assert got == in_push_order(ref)
    assert np.sum([len(v) for v in got.values()]) == len(records)

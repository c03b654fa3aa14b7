"""filter_parser through the port against the reference package.

Every option case of tests/test_filter_parser.py (body and time
replaced, reserve_data, preserve_key, a failed parse, parsers tried in
order, a record-accessor key, a json time of zero) runs through both
packages' filters on the CPU, on the same events: the result and every
event's packed bytes (time, metadata and body) must be equal (exact).
The port runs each case on its device path (``tpu_batch_records`` 1:
the plain torch K3 for a regex parser) and on its host path
(``tpu.enable off``); the reference runs its own prefilter with its
platform gate forced open, as its own test does. Config 2 (tail over an
NDJSON file → parser json, reserve_data → null + lib) and its regex form
(apache2) run end to end through both packages' lib APIs over a small
seeded file. A JSON value with a lone surrogate escape raises the same
exception in both packages' ``push``, and so does a ``Types`` integer
cast of a number past 64 bits (OverflowError).
"""

import json
import random
import time

import pytest
import torch

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu.codec.events import decode_events as jax_decode
from fluentbit_tpu.codec.events import encode_event as jax_encode
from fluentbit_tpu.codec.events import reencode_event as jax_reencode
from fluentbit_tpu.core.engine import Engine as JaxEngine
from fluentbit_tpu.core.plugin import registry as jax_registry
from fluentbit_tpu.ops import device as jax_device
from fluentbit_tpu_torch.codec.events import decode_events, encode_event
from fluentbit_tpu_torch.codec.events import reencode_event
from fluentbit_tpu_torch.core.engine import Engine
from fluentbit_tpu_torch.core.plugin import FilterResult, registry
from fluentbit_tpu_torch.ops import grep as tg

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" (?<code>[^ ]*) '
    r'(?<size>[^ ]*)(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
LINE = (
    '10.0.0.1 - bob [10/Oct/2000:13:55:36 -0700] '
    '"GET /i.gif HTTP/1.0" 200 99 "r" "a"'
)
TIME_FORMAT = "%d/%b/%Y:%H:%M:%S %z"
#: conf/parsers.conf's apache2 and json, and tests/test_filter_parser.py's js
PARSERS = {
    "apache2": dict(Format="regex", Regex=APACHE2, Time_Key="time",
                    Time_Format=TIME_FORMAT, Types="code:integer size:integer"),
    "json": dict(Format="json", Time_Key="time", Time_Format=TIME_FORMAT),
    "js": dict(Format="json"),
}


def make_filter(reg, engine, props):
    ins = reg.create_filter("parser")
    for k, v in props.items():
        for item in (v if isinstance(v, list) else [v]):
            ins.set(k, item)  # a list repeats the option (Parser)
    ins.configure()
    ins.plugin.init(ins, engine)
    return ins.plugin


def engines(names):
    ref, port = JaxEngine(), Engine(device=torch.device("cpu"))
    for name in names:
        ref.parser(name, **PARSERS[name])
        port.parser(name, **PARSERS[name])
    return ref, port


def run_both(names, props, bodies, ts=5.0):
    """(reference result, its packed events), then the same for the
    port's device path and its host path."""
    ref_engine, port_engine = engines(names)
    ref = make_filter(jax_registry, ref_engine, props)
    out = []
    res, evs = ref.filter([jax_decode(jax_encode(b, ts))[0] for b in bodies],
                          "t", None)
    out.append((res.name, [jax_reencode(e) for e in evs]))
    for extra in ({"tpu_batch_records": "1"}, {"tpu.enable": "off"}):
        port = make_filter(registry, port_engine, dict(props, **extra))
        res, evs = port.filter([decode_events(encode_event(b, ts))[0]
                                for b in bodies], "t", None)
        out.append((res.name, [reencode_event(e) for e in evs]))
    return out


CASES = {
    "replaces_body_and_time": (
        ["apache2", "js"], dict(key_name="log", parser="apache2"),
        [{"log": LINE, "extra": 1}]),
    "reserve_data_and_preserve_key": (
        ["apache2", "js"], dict(key_name="log", parser="apache2",
                                reserve_data="true", preserve_key="true"),
        [{"a": 1, "log": LINE, "z": "q"}]),
    "reserve_data_without_preserve_key": (
        ["apache2", "js"], dict(key_name="log", parser="apache2",
                                reserve_data="on"),
        [{"a": 1, "log": LINE}]),
    "preserve_key_without_reserve_data": (
        ["apache2", "js"], dict(key_name="log", parser="apache2",
                                preserve_key="true"),
        [{"a": 1, "log": LINE}]),
    "parse_failure_passes_untouched": (
        ["apache2", "js"], dict(key_name="log", parser="apache2"),
        [{"log": "nope"}, {"other": 1}]),
    "parsers_tried_in_order": (
        ["apache2", "js"], dict(key_name="log", parser=["apache2", "js"]),
        [{"log": '{"k": 1}'}, {"log": LINE}]),
    "ra_path_key": (
        ["apache2", "js"], dict(key_name="$nested['log']", parser="js",
                                reserve_data="true"),
        [{"nested": {"log": '{"x": 2}'}, "keep": 3}]),
    "json_time_zero_does_not_override": (
        ["js"], dict(key_name="log", parser="js"), [{"log": '{"m": 1}'}]),
    # duplicate keys: the parsed value wins (the reference's setdefault)
    "reserve_data_duplicate_key": (
        ["json"], dict(key_name="log", parser="json", reserve_data="true"),
        [{"host": "orig", "log": '{"host": "parsed", "n": 1}', "x": 2}]),
    # config 2's json parser: a parsed time, a bad one (the field is
    # dropped, the time kept), a non-string one (kept), NaN, a non-map
    "json_parser_times_and_values": (
        ["json"], dict(key_name="log", parser="json", reserve_data="true"),
        [{"log": '{"time": "10/Oct/2000:13:55:36 -0700", "a": [1, 2.5]}'},
         {"log": '{"time": "yesterday", "b": true}'},
         {"log": '{"time": 12, "c": null}'},
         {"log": '{"d": NaN, "e": -Infinity}'},
         {"log": '[1, 2]'}, {"log": 7}, {"log": b'{"bin": 1}'}]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_options_equal_reference(name):
    names, props, bodies = CASES[name]
    ref, dev, host = run_both(names, props, bodies)
    assert dev == ref
    assert host == ref


def test_replaced_body_and_time():
    _, props, bodies = CASES["replaces_body_and_time"]
    (res, evs), _, _ = run_both(["apache2"], props, bodies)
    ev = decode_events(evs[0])[0]
    assert res == FilterResult.MODIFIED.name
    assert ev.body["host"] == "10.0.0.1" and ev.body["code"] == 200
    assert "extra" not in ev.body and "time" not in ev.body
    assert ev.timestamp == 971211336


@pytest.fixture
def jax_prefilter(monkeypatch):
    """The reference's device prefilter on JAX's CPU backend: its
    platform gate forced open, as tests/test_filter_parser.py does."""
    assert jax_device.wait()
    monkeypatch.setattr(jax_device, "platform", lambda: "tpu")


def prefilter_events(seed, n=150):
    rng = random.Random(seed)
    bodies = []
    for i in range(n):
        kind = rng.randrange(6)
        t = f"{rng.randrange(1, 29):02d}/Oct/2000:13:55:{i % 60:02d} -0700"
        line = (f'10.0.{i % 7}.{i % 256} - u{i} [{t}] "GET /p/ü{i} HTTP/1.1"'
                f' {rng.choice(["200", "404"])} {rng.randrange(9999)}')
        if kind == 0:
            bodies.append({"log": line, "i": i})
        elif kind == 1:
            bodies.append({"log": line + f' "http://r/{i}" "curl 日本"'})
        elif kind == 2:
            bodies.append({"log": f"garbage {i}"})
        elif kind == 3:
            bodies.append({"n": i})
        elif kind == 4:  # past tpu_max_record_len: the overflow regex
            bodies.append({"log": line + ' "r" "' + "a" * 600 + '"'})
        else:  # the time does not parse: the field is dropped
            bodies.append({"log": line.replace(t, "99/Oct/2000:x")})
    return bodies


@pytest.mark.parametrize("seed", [0, 1])
def test_prefilter_equals_reference(jax_prefilter, seed):
    props = dict(key_name="log", parser="apache2", reserve_data="true",
                 tpu_batch_records="1")
    ref_engine, port_engine = engines(["apache2"])
    ref = make_filter(jax_registry, ref_engine, props)
    assert ref._prefilter is not None
    port = make_filter(registry, port_engine, props)
    decision = port._prefilter.decision()
    assert decision["kernel_resolved"] == "scan"
    assert decision["max_states"] > 64
    # on the card "auto" takes the scan (K3) too: apache2 is above the
    # assoc kernel's 64-state limit
    assert tg.kernel_for("auto", torch.device("cuda"),
                         decision["max_states"]) == "scan"
    bodies = prefilter_events(seed)
    _, ref_out = ref.filter([jax_decode(jax_encode(b, 5.0))[0]
                             for b in bodies], "t", None)
    before = (tg.grep_dfa.launches, tg.grep_assoc.launches)
    _, out = port.filter([decode_events(encode_event(b, 5.0))[0]
                          for b in bodies], "t", None)
    assert [reencode_event(e) for e in out] == \
        [jax_reencode(e) for e in ref_out]
    assert (tg.grep_dfa.launches, tg.grep_assoc.launches) == before
    assert len(port.step_seconds) == 1 and len(port.step_seconds[0]) == 4
    parsed = sum("host" in e.body for e in out)
    assert 0 < parsed < len(bodies)


def test_small_appends_skip_the_prefilter():
    _, port_engine = engines(["apache2"])
    port = make_filter(registry, port_engine,
                       dict(key_name="log", parser="apache2"))
    assert port.tpu_batch_records == 64 and port._prefilter is not None
    port.filter([decode_events(encode_event({"log": LINE}, 1.0))[0]] * 63,
                "t", None)
    assert not port.step_seconds
    port.filter([decode_events(encode_event({"log": LINE}, 1.0))[0]] * 64,
                "t", None)
    assert len(port.step_seconds) == 1


def test_json_parser_has_no_prefilter():
    _, port_engine = engines(["json"])
    port = make_filter(registry, port_engine,
                       dict(key_name="log", parser="json"))
    assert port._prefilter is None


@pytest.mark.parametrize("props", [{"tpu_approx": "on"},
                                   {"tpu_approx_states": "32"},
                                   {"parser": "missing"}, {"key_name": ""}])
def test_refused_settings_raise(props):
    _, port_engine = engines(["json"])
    with pytest.raises(ValueError):
        make_filter(registry, port_engine,
                    dict(dict(key_name="log", parser="json"), **props))


# ---------------------------------------------------------------- config 2


def ndjson_line(rng, i):
    """A config 2 line: JSON objects with raw and escaped non-ASCII, a
    parsed, a malformed or no time, nested values; malformed JSON and
    top-level non-objects; raw invalid UTF-8 inside a string; CRLF."""
    kind = rng.random()
    if kind < 0.05:
        return rng.choice([b'{"level": "info", "msg": "cut', b"not json {",
                           b"[1, 2, 3]", b'"a string"', b"42", b"null"])
    obj = {}
    t = rng.random()
    if t < 0.7:
        obj["time"] = (f"{rng.randrange(1, 29):02d}/"
                       f"{rng.choice(['Jan', 'Oct', 'Dec'])}/2026:"
                       f"{rng.randrange(24):02d}:{rng.randrange(60):02d}:"
                       f"{rng.randrange(60):02d} "
                       f"{rng.choice(['+0000', '-0700', '+0530'])}")
    elif t < 0.8:
        obj["time"] = rng.choice(["2026-10-17T15:12:32Z", "32/Oct/2026:1",
                                  "yesterday", ""])
    obj["level"] = rng.choice(["info", "warn", "error"])
    obj["user"] = f"u{rng.randrange(1000)}"
    msg = rng.choice(["plain ascii", "héllo wörld 日本語", "🎉🚀 ok",
                      "mixed é🎉"]) + f" {i}"
    if rng.random() < 0.2:
        obj["ctx"] = {"req": {"id": i, "tags": ["a", "b"]}, "ok": True,
                      "ratio": 0.25}
    body = json.dumps(obj, ensure_ascii=False)[:-1]
    escaped = rng.random() < 0.3  # \uXXXX escapes (surrogate pairs too)
    line = (body + ', "msg": ' + json.dumps(msg, ensure_ascii=escaped)
            + "}").encode()
    if rng.random() < 0.05:  # raw invalid UTF-8 inside the msg string
        cut = line.rindex(b'"')
        line = line[:cut] + rng.choice([b"\xc0\xaf", b"\xed\xa0\x80",
                                        b"\xe6\x97", b"\x80"]) + line[cut:]
    if rng.random() < 0.05:
        line += b"\r"
    return line


def run_config2(create, decode, path, parser, lines_expected, **kw):
    """tail (read_from_head) over ``path`` → parser (reserve_data) →
    null + lib; returns [(timestamp, body)] in order."""
    got = []
    ctx = create(flush="20ms", grace="1", **kw)
    ctx.parser(parser, **PARSERS[parser])
    ffd = ctx.input("tail", tag="ndjson", path=path, read_from_head="true")
    ctx._handles[ffd].plugin.collect_interval = 0.02
    ctx.filter("parser", match="ndjson", key_name="log", parser=parser,
               reserve_data="true")
    ctx.output("null", match="*")
    ctx.output("lib", match="*", callback=lambda d, t: got.extend(
        (ev.timestamp, ev.body) for ev in decode(d)))
    ctx.start()
    try:
        deadline = time.time() + 20
        while len(got) < lines_expected:
            assert time.time() < deadline, f"{len(got)} records"
            ctx.flush_now()
            time.sleep(0.02)
    finally:
        ctx.stop()
    return got


def same_records(ref, got):
    """Bodies equal in order (as JSON text, so types count), and the
    times equal where the parser set them (a float, not the read's
    now)."""
    assert len(got) == len(ref)
    for (rts, rbody), (gts, gbody) in zip(ref, got):
        assert json.dumps(gbody) == json.dumps(rbody)
        parsed = isinstance(rts, float)
        assert isinstance(gts, float) == parsed
        if parsed:
            assert gts == rts


def apache_file_line(rng, i):
    t = f"{rng.randrange(1, 29):02d}/Oct/2000:13:55:{i % 60:02d} -0700"
    line = (f'10.0.0.{i % 256} - u{i} [{t}] "GET /p/ü{i} HTTP/1.1" '
            f'{rng.choice(["200", "404"])} {rng.randrange(9999)}')
    kind = rng.randrange(5)
    if kind == 0:
        line += f' "http://r/{i}" "curl 日本"'
    elif kind == 1:
        line = f"junk line {i}"
    elif kind == 2:
        line += ' "r" "' + "a" * 600 + '"'
    return line.encode()


@pytest.mark.parametrize("parser,maker", [("json", ndjson_line),
                                          ("apache2", apache_file_line)])
def test_config2_tail_equals_reference(tmp_path, parser, maker):
    rng = random.Random(7)
    data = b"\n".join(maker(rng, i) for i in range(300)) + b"\n"
    path = str(tmp_path / "corpus.log")
    with open(path, "wb") as fh:
        fh.write(data)
    n = sum(1 for ln in data.split(b"\n") if ln.rstrip(b"\r"))
    ref = run_config2(fluentbit_tpu.create, jax_decode, path, parser, n)
    got = run_config2(fluentbit_tpu_torch.create, decode_events, path,
                      parser, n, device="cpu")
    same_records(ref, got)
    assert sum(isinstance(ts, float) for ts, _ in got) > 100


def test_config2_record_shapes():
    rng = random.Random(3)
    bodies = [{"log": ndjson_line(rng, i).rstrip(b"\r").decode(
        "utf-8", "replace")} for i in range(200)]
    (_, ref), (_, dev), _ = run_both(["json"], dict(
        key_name="log", parser="json", reserve_data="true"), bodies)
    assert dev == ref
    evs = [decode_events(e)[0] for e in dev]
    untouched = [e.body == b for e, b in zip(evs, bodies)]
    timed = [e.timestamp != 5.0 for e in evs]
    assert any(untouched) and any(timed)
    # a parsed record holds the parsed map only (log is the parsed key)
    assert all("log" not in e.body for e, u in zip(evs, untouched)
               if not u)
    assert not any(u and t for u, t in zip(untouched, timed))


@pytest.mark.parametrize("log", ['{"a": "\\ud800x"}',
                                 '{"n": 100000000000000000000}'])
def test_unencodable_values_raise_in_both(log):
    """A lone surrogate escape (json.loads yields it, UTF-8 refuses it)
    and an integer outside msgpack's range raise from the append in both
    packages (the reference's own behaviour, kept)."""
    errors = []
    for create, kw in ((fluentbit_tpu.create, {}),
                       (fluentbit_tpu_torch.create, {"device": "cpu"})):
        ctx = create(flush="50ms", grace="1", **kw)
        ctx.parser("js", **PARSERS["js"])
        ffd = ctx.input("lib", tag="t")
        ctx.filter("parser", match="t", key_name="log", parser="js")
        ctx.output("null", match="*")
        ctx.start()
        try:
            with pytest.raises((UnicodeEncodeError, OverflowError)) as exc:
                ctx.push(ffd, json.dumps({"log": log}))
            errors.append(exc.type)
        finally:
            ctx.stop()
    assert errors[0] is errors[1]


def test_integer_cast_past_64_bits_raises_in_both():
    """apache2 with ``Types code:integer`` on a 20-digit status code: the
    cast gives an int that msgpack cannot encode (above 2^64 - 1), so
    ``push`` raises OverflowError in both packages (the reference's own
    behaviour, kept), and nothing reaches the output."""
    line = LINE.replace('" 200 ', '" 99999999999999999999 ')
    assert line != LINE
    for create, kw in ((fluentbit_tpu.create, {}),
                       (fluentbit_tpu_torch.create, {"device": "cpu"})):
        got = []
        ctx = create(flush="50ms", grace="1", **kw)
        ctx.parser("apache2", **PARSERS["apache2"])
        ffd = ctx.input("lib", tag="t")
        ctx.filter("parser", match="t", key_name="log", parser="apache2")
        ctx.output("lib", match="*",
                   callback=lambda data, tag: got.append(data))
        ctx.start()
        try:
            with pytest.raises(OverflowError):
                ctx.push(ffd, json.dumps({"log": line}))
            ctx.flush_now()
        finally:
            ctx.stop()
        assert got == []

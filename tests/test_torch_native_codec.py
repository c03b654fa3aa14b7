"""The port's event codec extension (``csrc/codec_py.cpp``) three ways.

On the same seeded corpora the extension (``fbtpu_torch_codec``, built at
first use) must give what the port's plain Python versions give
(``decode_events_plain``, ``pack_event_plain``) and what the reference
package's ``fluentbit_tpu.codec.events`` functions give (its own C codec
where it loads, as its tests run it), and its JSON transcoder
``parser_json_batch`` must give the reference's ``parser_json_batch``
bytes and the per-record path's (``json.loads`` → ``pack_event``). No
tolerance: bytes and records equal. Decoded events are compared by
re-packing them with the plain packer, so NaN payloads, int against
float and str against bin all count. The cases are the reference's
(tests/test_native_codec.py, tests/test_batch_filters.py).
"""

import json
import random
import struct

import pytest

from fluentbit_tpu.codec import _native_codec as ref_native
from fluentbit_tpu.codec import events as ref_events
from fluentbit_tpu.codec import msgpack as ref_msgpack
from fluentbit_tpu_torch.codec import _native_codec as native
from fluentbit_tpu_torch.codec import events as E
from fluentbit_tpu_torch.codec.msgpack import EventTime, ExtType, packb
from fluentbit_tpu_torch.ops import cuda_build

mod = native.load()
#: the reference's C codec, None where its toolchain is missing (its
#: events functions then run its pure-Python codec)
REF = ref_native.load()

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**63 - 1, 2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
        -32769, -2**31, -2**31 - 1, -2**63]


def to_ref(v):
    """A port value as the reference's types (EventTime, ExtType)."""
    if isinstance(v, EventTime):
        return ref_msgpack.EventTime(v.sec, v.nsec)
    if isinstance(v, ExtType):
        return ref_msgpack.ExtType(v.code, v.data)
    if isinstance(v, dict):
        return {k: to_ref(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_ref(x) for x in v)
    return v


def canonical(events, pack=packb):
    """Each event re-packed with a plain packer, beside its raw span."""
    return [(pack([[ev.timestamp, ev.metadata], ev.body]), ev.raw)
            for ev in events]


def ref_canonical(events):
    return canonical(events, ref_msgpack.packb)


def f64(bits):
    return b"\xcb" + struct.pack(">Q", bits)


def crafted_record(i):
    """A V2 record whose body holds what no Python packer writes: f32,
    NaN with a payload, invalid UTF-8, u64 max and i64 min, bin8, a
    fixext8 EventTime."""
    bad = b"\xff\xfe ok \xc3"
    body = {b"f32": b"\xca" + struct.pack(">f", 1.5 + i),
            b"nan": f64(0x7FF8000000000001 + i),
            b"bad": bytes([0xA0 | len(bad)]) + bad,
            b"u64": b"\xcf" + b"\xff" * 8,
            b"i64": b"\xd3\x80" + b"\x00" * 7,
            b"bin": b"\xc4\x03abc"}
    out = bytes([0x80 | len(body)])
    for k, v in body.items():
        out += bytes([0xA0 | len(k)]) + k + v
    ts = b"\xd7\x00" + struct.pack(">II", 1700000000 + i, 999)
    return b"\x92\x92" + ts + b"\x80" + out


def corpus(seed=0, n=200):
    """Records from the plain packer (V2 and legacy, every int width,
    floats, bin, nesting, multi-byte UTF-8) and crafted ones."""
    rng = random.Random(seed)
    buf = bytearray()
    for i in range(n):
        body = {
            "log": f"line {i} " + "x" * rng.randrange(0, 300),
            "i": rng.choice(INTS), "j": rng.randrange(-2**40, 2**40),
            "f": rng.random() * 10 ** rng.randrange(-6, 6),
            "inf": float("inf"), "nz": -0.0, "nan": float("nan"),
            "b": bool(i % 2), "none": None,
            "nested": {"a": [1, "x", {"y": -2}], "t": [3, 4]},
            "by": bytes(range(i % 60)),
            "uni": "héllo wörld ☃ 日本 𝄞" * (i % 3),
            "long": "é" * rng.choice([0, 15, 16, 127, 128, 40000]),
        }
        ts = rng.choice([EventTime(1700000000 + i, rng.randrange(10**9)),
                         float(i) + 0.25, i, -1, -2])
        meta = {"m": i} if i % 3 else {}
        buf += E.pack_event_plain(ts, meta, body)
        if i % 50 == 7:
            buf += packb([1234 + i, {"log": "legacy"}])
            buf += crafted_record(i)
    return bytes(buf)


# ------------------------------------------------------------ the decoder

@pytest.mark.parametrize("seed", [0, 1])
def test_decode_equals_plain_and_reference(seed):
    buf = corpus(seed)
    got = mod.decode_events(buf)
    assert len(got) == 200 + 8
    assert canonical(got) == canonical(E.decode_events_plain(buf))
    assert canonical(E.decode_events(buf)) == canonical(got)
    assert ref_canonical(ref_events.decode_events(buf)) == canonical(got)
    assert [ev.raw for ev in E.iter_events(buf)] == [ev.raw for ev in got]
    assert all(type(ev) is E.LogEvent for ev in got)
    kinds = {type(ev.timestamp) for ev in got}
    assert kinds == {EventTime, float, int}
    bad = [ev.body["bad"] for ev in got if "bad" in ev.body]
    assert bad and all("�" in s for s in bad)  # errors="replace"


def test_decode_memoryview_and_empty():
    buf = corpus(2, 20)
    assert canonical(E.decode_events(memoryview(buf))) == \
        canonical(E.decode_events(buf))
    assert E.decode_events(b"") == []


# ------------------------------------------------------------- the packer

def pack_cases(seed=5, n=150):
    rng = random.Random(seed)
    for i in range(n):
        body = {"s": "x" * rng.choice([0, 31, 32, 255, 256, 65535, 65536]
                                      if i < 14 else [rng.randrange(400)]),
                "i": INTS[i % len(INTS)], "n": None, "t": (1, "z"),
                "lst": list(range(i % 20)), "bin": bytes(i % 300),
                "ba": bytearray(b"ab"), "f": rng.random(),
                "nan": struct.unpack(">d", struct.pack(
                    ">Q", 0x7FF8000000000000 | i))[0],
                "uni": "ü€𝄞" * (i % 5), "deep": [[[{"k": [i]}]]]}
        ts = rng.choice([EventTime(1, 2), EventTime(2**32 - 1, 999999999),
                         float(i), i, True, -2**63])
        meta = {str(k): k for k in range(i % 20)}  # map16 past 15 keys
        yield ts, meta, body


def test_pack_equals_plain_and_reference():
    for ts, meta, body in pack_cases():
        got = mod.pack_event(ts, meta, body)
        assert got == E.pack_event_plain(ts, meta, body)
        assert got == E.encode_event(body, ts, meta)
        assert got == E.reencode_event(E.LogEvent(ts, body, meta))
        assert got == ref_events.encode_event(to_ref(body), to_ref(ts),
                                              meta)
    pairs = [(float(i), {"i": i}) for i in range(5)]
    assert E.encode_events(pairs) == b"".join(
        E.encode_event(b, t) for t, b in pairs)


@pytest.mark.parametrize("value,error", [(2**64, OverflowError),
                                         (-2**63 - 1, OverflowError),
                                         ("\ud800", UnicodeEncodeError)])
def test_unpackable_values_raise_as_plain(value, error):
    with pytest.raises(error):
        mod.pack_event(1.0, {}, {"v": value})
    with pytest.raises(error):
        E.pack_event_plain(1.0, {}, {"v": value})


# ------------------------------------------------ FallbackError and edges

def test_ext_types_fall_back_to_plain():
    assert issubclass(mod.FallbackError, ValueError)
    assert issubclass(mod.TruncatedError, ValueError)
    with pytest.raises(mod.FallbackError):
        mod.pack_event(1.0, {}, {"x": ExtType(5, b"zz")})
    body = {"x": ExtType(5, b"zz")}
    assert E.encode_event(body, 1.0) == packb([[1.0, {}], body]) == \
        ref_events.encode_event(to_ref(body), 1.0)
    weird = packb([[1.0, {}], {"x": ExtType(9, b"abc")}])
    with pytest.raises(mod.FallbackError):
        mod.decode_events(weird)
    evs = E.decode_events(weird)
    assert evs[0].body["x"] == ExtType(9, b"abc")
    assert E.reencode_event(evs[0]) == weird
    assert canonical(evs) == canonical(E.decode_events_plain(weird))


def test_torn_tail_keeps_prefix():
    good = E.encode_event({"log": "x"}, 1.0)
    torn = good + E.encode_event({"log": "y"}, 2.0)[:-3]
    for decode in (mod.decode_events, E.decode_events,
                   E.decode_events_plain):
        evs = decode(torn)
        assert len(evs) == 1 and evs[0].body == {"log": "x"}
        assert evs[0].raw == good
    assert len(ref_events.decode_events(torn)) == 1
    assert mod.decode_events(good[:-2]) == []
    assert mod.decode_events(b"\xd9") == []  # a torn str8 header
    with pytest.raises(ValueError):
        mod.decode_events(b"\xc1")           # the reserved byte raises
    with pytest.raises(ValueError, match="invalid log event"):
        mod.decode_events(b"\x05")


def test_deep_nesting_raises_value_error():
    hostile = b"\x91" * 2_000_000 + b"\x90"
    with pytest.raises(ValueError, match="nesting"):
        mod.decode_events(hostile)
    with pytest.raises(ValueError, match="nesting"):
        E.decode_events(hostile)
    deep = cur = []
    for _ in range(10000):
        nxt = []
        cur.append(nxt)
        cur = nxt
    with pytest.raises(ValueError, match="nesting"):
        mod.pack_event(1.0, {}, {"d": deep})
    with pytest.raises(ValueError, match="nesting"):
        E.encode_event({"d": deep}, 1.0)


def test_unhashable_keys_become_repr():
    crafted = packb([[1.0, {}], {}])[:-1] + b"\x81\x92\x01\x02\xa1v"
    want = {"[1, 2]": "v"}
    assert mod.decode_events(crafted)[0].body == want
    assert E.decode_events_plain(crafted)[0].body == want
    assert ref_events.decode_events(crafted)[0].body == want
    crafted = packb([[1.0, {}], {}])[:-1] + b"\x81\x81\x01\x02\xa1v"
    assert mod.decode_events(crafted)[0].body == {"{1: 2}": "v"} == \
        E.decode_events_plain(crafted)[0].body


def test_extension_is_the_ports_own_build():
    assert mod.__name__ == "fbtpu_torch_codec"
    path = cuda_build.library_path("codec_py")
    assert mod.__file__ == str(path)
    assert path.parent == cuda_build.BUILD_DIR
    assert cuda_build.source_path("codec_py") == \
        cuda_build.CSRC_DIR / "codec_py.cpp"
    assert "-I" in cuda_build._flags("codec_py")


def test_missing_python_header_raises_by_name(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "python_include", lambda: str(tmp_path))
    with pytest.raises(RuntimeError, match="Python.h"):
        cuda_build.KernelLibraries().load("codec_py")
    assert not list(tmp_path.iterdir())


def test_failed_build_raises_naming_the_source(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="codec_py.cpp"):
        cuda_build.KernelLibraries().load("codec_py")


# -------------------------------------------------- the JSON transcoder

DOCS = [
    '{"a": 1, "b": "x", "nest": {"y": [1, 2.5, null, true, false]}}',
    '{"dup": 1, "mid": 2, "dup": {"replaced": [3]}}',
    '{"esc": "q\\u00e9\\ud834\\udd1e\\n\\t\\"\\b\\f\\r", "s": "\\/"}',
    '{"neg": -129, "wide": 5000000000, "tiny": -0.0, "e": 1e-7, "z": 0}',
    '{"n": NaN, "inf": Infinity, "minf": -Infinity}',
    '{"max": 18446744073709551615, "min": -9223372036854775808}',
    '{"f": 1.7976931348623157e308, "g": 5e-324, "h": 123456789.125e-3}',
    '  {"ws": [ 1 ,\t2 ]}\r\n',
    '{"uni": "héllo wörld ✓ 日本語 𝄞", "k": "ünïcode"}',
    '{}', '[1, 2, 3]', '"just a string"', '42', 'not json',
    '{"trailing": 1} x', '{"bad": 01}', '{"ctl": "a\tb"}', '{"a": }',
    '{"a": 1,}', '{"x": "' + "y" * 70000 + '"}',
    '{' + ", ".join(f'"k{i}": {i}' for i in range(100)) + '}',
    '{"d": ' + '[' * 60 + ']' * 60 + '}',
]

FALLBACK_DOCS = [
    '{"lone": "\\ud800x"}', '{"low": "\\udc00"}',
    '{"big": 18446744073709551616}', '{"small": -9223372036854775809}',
    '{"d": ' + '[' * 70 + ']' * 70 + '}',
    '{' + ", ".join(f'"k{i}": {i}' for i in range(130)) + '}',
]


def per_record(buf, key="log"):
    """The per-record path: json.loads of the field's string, a dict
    re-packed as [[ts, meta], obj], anything else kept as it came."""
    out = bytearray()
    events = E.decode_events_plain(buf)
    parsed = 0
    for ev in events:
        v = ev.body.get(key)
        obj = None
        if isinstance(v, str):
            try:
                obj = json.loads(v)
            except ValueError:
                obj = None
        if isinstance(obj, dict):
            out += E.pack_event_plain(ev.timestamp, ev.metadata, obj)
            parsed += 1
        else:
            out += ev.raw
    return bytes(out), len(events), parsed


def json_doc(rng, depth=0):
    """A random JSON document: nested objects and arrays, every scalar
    kind, repeated keys, escapes and multi-byte text."""
    kind = rng.randrange(9 if depth < 3 else 6)
    if kind == 0:
        return str(rng.choice(INTS[:13] + [rng.randrange(-10**6, 10**6)]))
    if kind == 1:
        return repr(rng.uniform(-1e6, 1e6))
    if kind == 2:
        return rng.choice(["true", "false", "null", "NaN", "-Infinity"])
    if kind in (3, 4, 5):
        s = "".join(rng.choice("ab é日\n\"\\/\t𝄞") for _ in range(
            rng.randrange(40)))
        return json.dumps(s, ensure_ascii=rng.random() < 0.5)
    if kind == 6:
        return "[" + ", ".join(json_doc(rng, depth + 1)
                               for _ in range(rng.randrange(5))) + "]"
    keys = [rng.choice(["a", "b", "c", "ü", "k" + str(rng.randrange(30))])
            for _ in range(rng.randrange(8))]
    return "{" + ",".join(f"{json.dumps(k)}: {json_doc(rng, depth + 1)}"
                          for k in keys) + "}"


def chunk_of(docs, seed=0, extra=()):
    rng = random.Random(seed)
    out = bytearray()
    for i, d in enumerate(docs):
        ts = rng.choice([float(i) + 0.5, i, EventTime(1700000000 + i, 7)])
        meta = {"m": i} if i % 4 == 1 else {}
        out += E.pack_event_plain(ts, meta, {"log": d, "other": i,
                                             **dict(extra)})
    return bytes(out)


def check_transcode(buf, key=b"log"):
    got = mod.parser_json_batch(buf, key)
    assert got == per_record(buf, key.decode())
    if REF is not None:
        assert REF.parser_json_batch(buf, key) == got
    return got


def test_json_transcode_reference_cases():
    out, n, parsed = check_transcode(chunk_of(DOCS * 3))
    assert n == 3 * len(DOCS) and 0 < parsed < n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_json_transcode_random_documents(seed):
    rng = random.Random(seed)
    docs = ["{" + f'"r": {json_doc(rng)}, "s": {json_doc(rng)}, "r": '
            f'{json_doc(rng)}' + "}" for _ in range(150)]
    docs += [json_doc(rng) for _ in range(50)]
    out, n, parsed = check_transcode(chunk_of(docs, seed))
    assert n == 200 and parsed >= 150


def test_json_transcode_field_kinds():
    """No field, a non-string field (kept), the key last of two, a body
    that is no map: all kept or parsed as the per-record path does."""
    recs = [E.pack_event_plain(1.0, {}, {"other": 1}),
            E.pack_event_plain(1.0, {}, {"log": 5}),
            E.pack_event_plain(1.0, {}, {"log": None}),
            packb([[1.0, {}], "not a map"]),
            packb([[1.0, {}], {"log": "x", 7: "y"}])]
    dup = (b"\x92\x92" + f64(0x3FF0000000000000) + b"\x80\x82"
           + b"\xa3log\xa8{\"a\": 1}" + b"\xa3log\xa8{\"b\": 2}")
    out, n, parsed = check_transcode(b"".join(recs) + dup)
    assert (n, parsed) == (6, 1)
    assert E.decode_events(out)[-1].body == {"b": 2}
    assert mod.parser_json_batch(b"", b"log") == (b"", 0, 0)


def bin_field(doc):
    raw = doc.encode()
    return (b"\x92\x92" + f64(0x3FF0000000000000) + b"\x80\x81\xa3log"
            + b"\xc4" + bytes([len(raw)]) + raw)


@pytest.mark.parametrize("case", [
    "legacy", "bin", "invalid_utf8", "f32_ts", "wide_int_meta",
    "str8_meta", "torn", "surrogate", "low_surrogate", "big_int",
    "small_int", "depth", "entries"])
def test_json_transcode_fallback_cases(case):
    """The records the transcoder cannot reproduce exactly raise
    FallbackError in both packages' extensions."""
    good = chunk_of(['{"ok": 1}'])
    head = b"\x92\x92" + f64(0x3FF0000000000000)
    doc = b'{"a": 1}'
    field = b"\x81\xa3log" + bytes([0xA0 | len(doc)]) + doc
    cases = {
        "legacy": packb([1.0, {"log": '{"a": 1}'}]),
        "bin": bin_field('{"a": 1}'),
        "invalid_utf8": (head + b"\x80\x81\xa3log\xa9{\"a\":\"\xff\"}"),
        "f32_ts": b"\x92\x92\xca" + struct.pack(">f", 1.0) + b"\x80" + field,
        "wide_int_meta": head + b"\x81\xa1m\xcc\x05" + field,
        "str8_meta": head + b"\x81\xa1m\xd9\x01x" + field,
        "torn": good[:-2],
    }
    docs = dict(zip(["surrogate", "low_surrogate", "big_int", "small_int",
                     "depth", "entries"], FALLBACK_DOCS))
    buf = good + (cases[case] if case in cases else chunk_of([docs[case]]))
    with pytest.raises(mod.FallbackError):
        mod.parser_json_batch(buf, b"log")
    if REF is not None:
        with pytest.raises(REF.FallbackError):
            REF.parser_json_batch(buf, b"log")


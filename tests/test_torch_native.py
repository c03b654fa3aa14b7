"""The port's host codec against the reference package's native codec.

``fluentbit_tpu_torch.native`` (the port's own ``csrc/codec_host.cpp``,
built with ``g++`` at first use) and ``fluentbit_tpu.native`` (the
reference's ``native/fbtpu_native.cpp``) take the same seeded msgpack
buffers: V1 and V2 event headers, EventTime / int / float timestamps,
str, bin, non-string and missing fields, duplicate and non-string keys,
values past the row width, nested maps, truncated buffers and trailing
garbage. Record counts, offsets, staged rows and lengths (the serial walk
and the threaded one), compacted bytes and the arena stager must be
equal, bytes past a row's length aside (neither side writes them).

The host DFA twin (``grep_match`` over ``GrepTables`` built from each
package's own DFAs) must give the reference's mask, offsets and count on
random rule sets, with rows the DFA rejects early, invalid UTF-8, ``bin``
values, non-map bodies, missing keys, V1 and V2 framing and values past
512 B, serial and threaded; ``stage_field_f64`` its values and kinds on
integers past 2^53, floats of both widths, bool, nil and numeric
strings.
"""

import random
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fluentbit_tpu import native as ref_native
from fluentbit_tpu.regex import FlbRegex as RefRegex
from fluentbit_tpu_torch.regex import FlbRegex
from fluentbit_tpu_torch import native
from fluentbit_tpu_torch.codec import events
from fluentbit_tpu_torch.codec.msgpack import EventTime, packb

L = 64


def _str_hdr(n):
    if n < 32:
        return bytes([0xA0 | n])
    if n < 256:
        return bytes([0xD9, n])
    return b"\xda" + struct.pack(">H", n)


def _value(rng, depth=0):
    kind = rng.randrange(9 if depth < 2 else 6)
    if kind == 0:
        return "".join(rng.choice("ab GET/ü日") for _ in range(rng.choice(
            [0, 1, 5, L - 1, L, L + 1, 300])))
    if kind == 1:
        return bytes(rng.randrange(256) for _ in range(rng.choice([0, 4, 70])))
    if kind == 2:
        return rng.choice([0, -1, 2 ** 40, 1.5, None, True])
    if kind == 3:
        return "GET /index.html 200"
    if kind == 4:
        return EventTime(5, 6)
    if kind == 5:
        return ""
    if kind == 6:
        return [_value(rng, depth + 1) for _ in range(rng.choice([0, 3, 17]))]
    return {f"n{i}": _value(rng, depth + 1) for i in range(rng.choice([0, 2, 16]))}


def _record(rng, i):
    """One encoded record of a random shape."""
    body = {k: _value(rng) for k in rng.sample(["log", "code", "msg", "x"],
                                               rng.randrange(4))}
    if rng.random() < 0.2:  # a nested map under the key itself
        body["log"] = {"log": "inner"}
    ts = rng.choice([EventTime(1_700_000_000 + i, rng.randrange(10 ** 9)),
                     1_700_000_000 + i, 1_700_000_000.25 + i])
    kind = rng.randrange(10)
    if kind == 0:  # V1 (legacy) header
        return packb([ts, body])
    if kind == 1:  # a body that is not a map
        return packb([[ts, {}], "not a map"])
    if kind == 2:  # duplicate keys (the last wins) and a non-string key
        val = "dup " + "z" * rng.randrange(80)
        pairs = (_str_hdr(3) + b"log" + _str_hdr(5) + b"first"
                 + b"\x07" + _str_hdr(1) + b"x"
                 + _str_hdr(3) + b"log" + _str_hdr(len(val)) + val.encode())
        return b"\x92" + packb([ts, {}]) + b"\x83" + pairs
    if kind == 3:  # a three-element record
        return packb([[ts, {"m": 1}], body, "extra"])
    return packb([[ts, {"m": i} if i % 3 else {}], body])


def _buffer(seed, n):
    rng = random.Random(seed)
    return b"".join(_record(rng, i) for i in range(n))


def _staged(mod, buf, key, B, threads):
    batch = np.full((B, L), 0xAB, dtype=np.uint8)
    lengths = np.full(B, -7, dtype=np.int32)
    offsets = np.empty(B + 1, dtype=np.int64)
    n = mod.stage_field_into(buf, key, batch, lengths, n_hint=B,
                             threads=threads, offsets_out=offsets)
    return n, batch, lengths, offsets


def _assert_same_rows(got, ref):
    n, batch, lengths, offsets = got
    rn, rbatch, rlengths, roffsets = ref
    assert n == rn
    if n is None:
        return
    assert np.array_equal(lengths[:n], rlengths[:n])
    assert np.array_equal(offsets[: n + 1], roffsets[: n + 1])
    for i in range(n):
        ln = max(int(lengths[i]), 0)
        assert bytes(batch[i, :ln]) == bytes(rbatch[i, :ln])


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 50), (2, 300), (3, 1500)])
@pytest.mark.parametrize("key", [b"log", b"code", b"nope"])
def test_stage_count_scan_equal_reference(seed, n, key):
    buf = _buffer(seed, n)
    assert native.available()
    assert native.count_records(buf) == ref_native.count_records(buf) == n
    assert np.array_equal(native.scan_offsets(buf),
                          ref_native.scan_offsets(buf))
    for threads in (1, 8):  # the serial walk and the worker pool
        _assert_same_rows(_staged(native, buf, key, n, threads),
                          _staged(ref_native, buf, key, n, threads))
    assert events.fast_count_records(buf) == n


@pytest.mark.parametrize("seed", [4, 5])
def test_compact_and_arena_stager_equal_reference(seed):
    buf = _buffer(seed, 200)
    offsets = native.scan_offsets(buf)
    keep = np.random.default_rng(seed).random(200) < 0.5
    got = native.compact(buf, offsets, keep)
    assert got == ref_native.compact(buf, offsets, keep)
    assert got == b"".join(buf[offsets[i]: offsets[i + 1]]
                           for i in np.nonzero(keep)[0])
    assert native.compact(buf, offsets, np.ones(200, bool)) == buf
    assert native.compact(buf, offsets, np.zeros(200, bool)) == b""
    a = native.stage_field(buf, b"log", L, pad_to=256)
    b = ref_native.stage_field(buf, b"log", L, pad_to=256)
    assert a[3] == b[3] == 200
    assert a[0].shape == b[0].shape == (256, L)
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert (a[1][200:] == -1).all()


@pytest.mark.parametrize("cut", ["truncated", "garbage", "deep"])
def test_malformed_buffers_equal_reference(cut):
    buf = _buffer(6, 40)
    if cut == "truncated":
        buf = buf[:-3]
    elif cut == "garbage":
        buf = buf + b"\xc1\x00"  # 0xc1 is never used
    else:  # a record past the walker's 64 levels of nesting
        buf = buf + b"\x92" + b"\x91" * 70 + b"\x01" + b"\x80"
    assert native.count_records(buf) is None
    assert ref_native.count_records(buf) is None
    assert native.scan_offsets(buf) is None
    assert ref_native.scan_offsets(buf) is None
    for threads in (1, 8):
        assert _staged(native, buf, b"log", 80, threads)[0] is None
        assert _staged(ref_native, buf, b"log", 80, threads)[0] is None
    # the Python count decides where the walker refuses (deep nesting)
    from fluentbit_tpu.codec import events as ref_events

    assert (events.fast_count_records(buf)
            == ref_events.fast_count_records(buf))
    if cut == "deep":
        assert events.fast_count_records(buf) == 41


def test_mistyped_targets_decline():
    buf = _buffer(7, 10)
    ok = np.zeros((10, L), np.uint8)
    lens = np.zeros(10, np.int32)
    assert native.stage_field_into(buf, b"log", ok[:5], lens) is None
    assert native.stage_field_into(buf, b"log", ok.astype(np.int8),
                                   lens) is None
    assert native.stage_field_into(buf, b"log", ok, lens[::2]) is None
    assert native.stage_field_into(buf, b"log", ok, lens,
                                   offsets_out=np.zeros(3, np.int64)) is None
    assert native.stage_field_into(buf, b"log", ok, lens) == 10


_values = st.one_of(st.text(max_size=80), st.binary(max_size=20),
                    st.integers(-2 ** 63, 2 ** 64 - 1), st.none(),
                    st.floats(allow_nan=False))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.dictionaries(st.sampled_from(["log", "a", "b"]), _values,
                                max_size=3), min_size=1, max_size=30),
       st.booleans())
def test_random_bodies_equal_reference(bodies, v1):
    buf = b"".join(packb([i, body] if v1 else [[EventTime(i, 7), {}], body])
                   for i, body in enumerate(bodies))
    n = len(bodies)
    _assert_same_rows(_staged(native, buf, b"log", n, 1),
                      _staged(ref_native, buf, b"log", n, 1))
    got = _staged(native, buf, b"log", n, 1)
    for i, body in enumerate(bodies):
        v = body.get("log")
        if isinstance(v, str) and len(v.encode()) <= L:
            assert got[2][i] == len(v.encode())
        else:
            assert got[2][i] == (-2 if isinstance(v, str) else -1)


TWIN_PATTERNS = ["GET", "^a", "b$", "日", r"\d+", "a{10}", r"x[0-9]+y", "^$",
                 ".*OOM.*", "(ab|cd)+e", r"^\S+ \S+$", "inner", "ü"]


def _twin_buffer(seed, n):
    """``_buffer``'s shapes, plus string values of invalid UTF-8 and
    values past 512 B of each rule key."""
    rng = random.Random(seed)
    recs = [_record(rng, i) for i in range(n)]
    for i in range(0, n, 7):
        key = rng.choice(["log", "code", "msg"])
        if rng.random() < 0.5:
            val = b"GET \xff\xfe ab" + bytes([0xc3, 0x28])
        else:
            val = ("a" * 10 + " GET 12 " + "x" * rng.choice([505, 600, 4000])
                   + " OOM").encode()
        recs[i] = (b"\x92" + packb([EventTime(i, 0), {}]) + b"\x81"
                   + _str_hdr(len(key)) + key.encode()
                   + (b"\xdb" + struct.pack(">I", len(val)) + val))
    return b"".join(recs)


def _twin_tables(rng, R):
    rules = [(rng.choice([b"log", b"code", b"msg", b"nope"]),
              rng.choice(TWIN_PATTERNS)) for _ in range(R)]
    return (native.GrepTables([(k, FlbRegex(p).dfa) for k, p in rules]),
            ref_native.GrepTables([(k, RefRegex(p).dfa) for k, p in rules]))


@pytest.mark.parametrize("seed,n,R", [(10, 1, 1), (11, 300, 3), (12, 700, 8),
                                      (13, 4500, 5)])
def test_grep_match_equals_reference(seed, n, R):
    buf = _twin_buffer(seed, n)
    tables, ref_tables = _twin_tables(random.Random(seed), R)
    rmask, roffsets, rn = ref_native.grep_match(buf, ref_tables)
    assert rn == n
    for threads in (1, 8):  # the serial sweep and the worker pool
        mask, offsets, got_n = native.grep_match(buf, tables,
                                                 threads=threads)
        assert got_n == n and mask.shape == (R, n) and mask.dtype == bool
        assert np.array_equal(mask, rmask)
        assert np.array_equal(offsets, roffsets)
    assert np.array_equal(native.grep_match(buf, tables, n_hint=n)[0], rmask)
    if n >= 300:  # the rule sets both match and miss
        assert rmask.any() and not rmask.all()


def test_grep_match_declines_as_reference():
    buf = _twin_buffer(14, 40)
    tables, ref_tables = _twin_tables(random.Random(14), 2)
    # more records than the hint, a truncated buffer, garbage
    for b, hint in ((buf, 39), (buf[:-3], None), (buf + b"\xc1", None)):
        assert native.grep_match(b, tables, n_hint=hint) is None
        assert ref_native.grep_match(b, ref_tables, n_hint=hint) is None
    empty = native.grep_match(b"", tables)
    assert empty[2] == 0 and empty[0].shape == (2, 0)
    assert list(empty[1]) == [0]


def _num_record(i, value):
    return packb([[EventTime(i, 0), {}], {"v": value, "w": "x"}])


NUMS = [0, 1, -1, 127, 128, -33, 255, 256, 65535, 2 ** 31, -2 ** 31 - 1,
        2 ** 53 + 1, -(2 ** 53) - 3, 2 ** 63 - 1, -2 ** 63, 2 ** 64 - 1,
        0.5, -2.25, 1e300, float("inf"), True, False, None, "12", "1.5",
        "", b"7", [1], {"a": 2}]


def test_stage_field_f64_equals_reference():
    recs = [_num_record(i, v) for i, v in enumerate(NUMS)]
    recs.append(packb([1, {"v": 3}]))                 # V1 framing
    recs.append(packb([[EventTime(1, 0), {}], "no map"]))
    recs.append(packb([[EventTime(2, 0), {}], {"w": 1}]))  # missing
    # f32, duplicate keys (the last decides), a non-numeric last one
    recs.append(b"\x92" + packb([EventTime(3, 0), {}]) + b"\x81\xa1v"
                + b"\xca" + struct.pack(">f", 0.1))
    recs.append(b"\x92" + packb([EventTime(4, 0), {}]) + b"\x82\xa1v\x05"
                b"\xa1v\xcb" + struct.pack(">d", 2.5))
    recs.append(b"\x92" + packb([EventTime(5, 0), {}]) + b"\x82\xa1v\x05"
                b"\xa1v\xa1x")
    buf = b"".join(recs) + _buffer(15, 200)
    n = len(recs) + 200
    for key in (b"v", b"code", b"x", b"nope"):
        values, kinds, got_n = native.stage_field_f64(buf, key)
        rvalues, rkinds, rn = ref_native.stage_field_f64(buf, key)
        assert got_n == rn == n
        assert np.array_equal(kinds, rkinds)
        assert np.array_equal(values, rvalues)
    values, kinds, _ = native.stage_field_f64(buf, b"v")
    assert list(kinds[:len(NUMS)]) == [
        1 if isinstance(v, int) and not isinstance(v, bool)
        else 2 if isinstance(v, float) else 0 for v in NUMS]
    for i, v in enumerate(NUMS):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert values[i] == float(v)  # float(int): round to nearest
    assert native.stage_field_f64(buf, b"v", n_hint=n - 1) is None
    assert native.stage_field_f64(buf[:-2], b"v") is None
    assert native.has_flux_stagers() and ref_native.has_flux_stagers()

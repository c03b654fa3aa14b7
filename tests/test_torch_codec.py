"""The port's msgpack/event codec against the reference package's.

The same events, made from a seed, must encode to the same bytes, decode
to the same events with the same raw spans, and re-encode identically.
"""

import random

import pytest

from fluentbit_tpu.codec import events as jax_events
from fluentbit_tpu.codec.msgpack import EventTime as JaxEventTime
from fluentbit_tpu_torch.codec import events
from fluentbit_tpu_torch.codec.msgpack import EventTime, packb, unpackb


def _value(rng, depth=0):
    kind = rng.randrange(9 if depth < 2 else 7)
    if kind == 0:
        return rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536,
                           2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 64 - 1,
                           -1, -32, -33, -128, -129, -32768, -32769,
                           -2 ** 31, -2 ** 31 - 1, -2 ** 63])
    if kind == 1:
        return rng.choice([0.0, -1.5, 3.141592653589793, 1e300])
    if kind == 2:
        n = rng.choice([0, 5, 31, 32, 255, 256, 70000])
        return "".join(rng.choice("aZ9 ü日\n\"") for _ in range(n))
    if kind == 3:
        return bytes(rng.randrange(256) for _ in range(rng.choice([0, 3, 300])))
    if kind == 4:
        return None
    if kind == 5:
        return rng.random() < 0.5
    if kind == 6:
        return "GET /x 200"
    if kind == 7:
        return [_value(rng, depth + 1) for _ in range(rng.choice([0, 3, 17]))]
    return {f"k{i}": _value(rng, depth + 1)
            for i in range(rng.choice([0, 2, 16]))}


def _records(seed, n=40):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        body = {"log": f"line {i}", **{f"f{j}": _value(rng)
                                       for j in range(rng.randrange(4))}}
        meta = {} if i % 3 else {"m": i}
        sec, nsec = 1_700_000_000 + i, rng.randrange(10 ** 9)
        out.append((body, sec, nsec, meta))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_event_bytes_identical(seed):
    for body, sec, nsec, meta in _records(seed):
        got = events.encode_event(body, EventTime(sec, nsec), meta)
        ref = jax_events.encode_event(body, JaxEventTime(sec, nsec), meta)
        assert got == ref


@pytest.mark.parametrize("seed", [3, 4])
def test_decode_events_round_trip_identical(seed):
    recs = _records(seed)
    buf = b"".join(jax_events.encode_event(b, JaxEventTime(s, ns), m)
                   for b, s, ns, m in recs)
    # a legacy [ts, body] record decodes too
    buf += packb([1700000000, {"legacy": True}])
    got = events.decode_events(buf)
    ref = jax_events.decode_events(buf)
    assert len(got) == len(ref) == len(recs) + 1
    for g, r in zip(got, ref):
        assert g.raw == r.raw
        assert g.body == r.body and g.metadata == r.metadata
        assert float(g.timestamp) == float(r.timestamp)
        assert events.reencode_event(g) == jax_events.reencode_event(r)
    assert b"".join(g.raw for g in got) == buf


def test_event_time_ext_round_trip():
    t = EventTime.from_float(1700000000.123456789)
    assert unpackb(packb(t)) == t
    assert packb(t) == b"\xd7\x00" + t.to_bytes()

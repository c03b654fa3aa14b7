"""The port's forward input against the reference's, over loopback.

The same forward messages, made from a numpy seed and encoded once, go
over a raw TCP socket to a ``forward`` input of the reference package
(``fluentbit_tpu``, JAX on the CPU) and of the port
(``fluentbit_tpu_torch``, ``device="cpu"``); each engine writes to a
``lib`` output, and the bytes each tag receives must be equal. Covered:
the Message, Forward, PackedForward and CompressedPackedForward (gzip,
several members) modes; ``EventTime``, integer and float times;
invalid UTF-8 inside a msgpack str; the ``chunk`` ack, written after
the absorb; the ``shared_key`` handshake with the right and the wrong
key; ``tag_prefix``; a chunk resent with the same id absorbed once; and
wire stamps of every shape degraded as the reference's ``_wire_stamp``
degrades them. Then the pieces on their own: the port's in-memory
``DedupLedger`` against the reference's, ``Unpacker.feed`` across read
boundaries, and what raises by name.
"""

import gzip
import hashlib
import socket
import time

import numpy as np
import pytest

import fluentbit_tpu as ref
import fluentbit_tpu_torch as flb
from fluentbit_tpu.codec.msgpack import EventTime as JEventTime
from fluentbit_tpu_torch.codec import msgpack as tmp
from fluentbit_tpu_torch.codec.msgpack import EventTime, Unpacker, packb
from fluentbit_tpu_torch.codec.events import decode_events
from test_torch_pipeline import push_ordered_bytes

PLACEHOLDER = "\u0001INVALID\u0001"  # 9 bytes, replaced on the wire


def wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.01)
    raise TimeoutError("condition not met")


def with_invalid_utf8(data: bytes) -> bytes:
    """Swap every encoded placeholder for 9 bytes of invalid UTF-8 (the
    fixstr header stays: the length is the same)."""
    return data.replace(PLACEHOLDER.encode(), b"bad\xff\xfe\xc3(x\x80")


def make_record(rng, i, log_len=None):
    n = int(rng.integers(5, 60)) if log_len is None else log_len
    text = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))
    rec = {"log": f"{i} {text}", "stream": ["stdout", "stderr"][i % 2],
           "n": int(rng.integers(-2**40, 2**40))}
    if i % 7 == 3:
        rec["log"] = PLACEHOLDER + rec["log"]
    if i % 11 == 5:
        rec["nested"] = {"a": [1, 2.5, None, True], "b": {"c": "d"}}
    return rec


def stamp(rng, i, form):
    """A time of the given form: EventTime, int or float."""
    sec = 1700000000 + i
    if form == 0:
        return EventTime(sec, int(rng.integers(0, 10**9)))
    if form == 1:
        return sec
    return sec + float(rng.integers(0, 1000)) / 1000.0


def entries(rng, start, n):
    return [[stamp(rng, start + j, (start + j) % 3),
             make_record(rng, start + j)] for j in range(n)]


def message(tag, mode, ents, option=None):
    """One forward message in ``mode`` (message, forward, packed, gzip)."""
    if mode == "message":
        ts, rec = ents[0]
        msg = [tag, ts, rec] + ([option] if option is not None else [])
    elif mode == "forward":
        msg = [tag, ents] + ([option] if option is not None else [])
    else:
        blob = b"".join(packb(e) for e in ents)
        if mode == "gzip":
            half = len(ents) // 2
            a = b"".join(packb(e) for e in ents[:half])
            blob = gzip.compress(a) + gzip.compress(blob[len(a):])
            option = dict(option or {}, compressed="gzip")
        msg = [tag, blob] + ([option] if option is not None else [])
    return with_invalid_utf8(packb(msg))


class Client:
    """A raw-socket forward client: the handshake, messages, acks."""

    def __init__(self, port, shared_key=None, hostname="edge-1"):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.u = Unpacker()
        self.pong = None
        if shared_key is not None:
            helo = self.read()
            assert helo[0] == "HELO"
            nonce = helo[1]["nonce"]
            salt = b"0123456789abcdef"
            digest = hashlib.sha512(salt + hostname.encode() + nonce
                                    + shared_key.encode()).hexdigest()
            self.sock.sendall(packb(["PING", hostname, salt, digest, "",
                                     ""]))
            self.pong = self.read()

    def read(self):
        while True:
            for obj in self.u:
                return obj
            data = self.sock.recv(65536)
            if not data:
                return None
            self.u.feed(data)

    def send(self, data: bytes, ack=None):
        self.sock.sendall(data)
        if ack is not None:
            got = self.read()
            assert got == {"ack": ack}, got

    def close(self):
        self.sock.close()


def serve(create, sends, n_records, server_props=None, filters=(), **kw):
    """Start an engine with a forward input, ``filters`` ((name, props)
    pairs) and a lib output, run ``sends(port)``, wait for ``n_records``
    records; returns (the bytes each tag received, the context)."""
    ctx = create(flush="50ms", grace="1", **kw)
    ctx.input("forward", port="0", listen="127.0.0.1",
              **(server_props or {}))
    for name, props in filters:
        ctx.filter(name, **props)
    got = {}
    count = [0]

    def cb(data, tag):
        got.setdefault(tag, []).append(bytes(data))
        count[0] += len(list(tmp.Unpacker(data)))

    ctx.output("lib", match="*", callback=cb)
    ctx.start()
    plugin = ctx.engine.inputs[0].plugin
    try:
        port = wait_for(lambda: getattr(plugin, "bound_port", None))
        sends(port)
        if n_records:
            wait_for(lambda: (ctx.flush_now(), count[0] >= n_records)[1])
        ctx.flush_now()
    finally:
        ctx.stop()
    return {tag: b"".join(parts) for tag, parts in got.items()}, ctx


def both(sends, n_records, server_props=None, ordered=True):
    """``serve`` in each package. With ``ordered`` (every record of a
    tag sent once, at an increasing second), the reference's bytes of
    each tag come in the order sent (``push_ordered``: its
    ``flush_now`` beside the timer may queue a tag's chunks in either
    order), and the port's as they came."""
    want, ref_ctx = serve(ref.create, sends, n_records, server_props)
    got, port_ctx = serve(flb.create, sends, n_records, server_props,
                          device="cpu")
    if ordered:
        want = {t: push_ordered_bytes(v) for t, v in want.items()}
    return (want, got, ref_ctx.engine.inputs[0].plugin,
            port_ctx.engine.inputs[0].plugin)


def test_four_modes_byte_equal_to_reference():
    """Every mode, every time form, invalid UTF-8, acks on half of the
    messages: the port's lib output equals the reference's, tag by tag."""
    rng = np.random.default_rng(11)
    msgs, n = [], 0
    for k, mode in enumerate(["message", "forward", "packed", "gzip"] * 3):
        size = 1 if mode == "message" else int(rng.integers(1, 40))
        ents = entries(rng, n, size)
        n += size
        option = {"chunk": f"c{k}"} if k % 2 else None
        msgs.append((message(f"app.{mode}", mode, ents, option),
                     option and option["chunk"]))

    def sends(port):
        c = Client(port)
        for data, ack in msgs:
            c.send(data, ack)
        c.close()

    want, got, _, plugin = both(sends, n)
    assert got == want
    assert set(got) == {"app.message", "app.forward", "app.packed",
                        "app.gzip"}
    assert sum(len(list(Unpacker(v))) for v in got.values()) == n
    assert plugin.health_block()["absorbed"] == len(msgs)


def test_invalid_utf8_decodes_as_the_reference():
    """A str with invalid UTF-8 decodes to the same replacement text in
    both Unpackers, and so reaches both outputs alike."""
    from fluentbit_tpu.codec.msgpack import unpackb as junpackb

    raw = with_invalid_utf8(packb({"log": PLACEHOLDER + "tail"}))
    assert tmp.unpackb(raw) == junpackb(raw)
    assert "�" in tmp.unpackb(raw)["log"]


@pytest.mark.parametrize("split", [1, 7, 4096])
def test_unpacker_feed_across_read_boundaries(split):
    """Messages split at every ``split`` bytes come out whole, in order,
    as they do from the reference's Unpacker."""
    from fluentbit_tpu.codec.msgpack import Unpacker as JUnpacker

    rng = np.random.default_rng(split)
    stream = b"".join(message("t", mode, entries(rng, 0, 3),
                              {"chunk": b"\x00\x01bin"})
                      for mode in ("message", "forward", "packed", "gzip"))
    u, ju, out, jout = Unpacker(), JUnpacker(), [], []
    for i in range(0, len(stream), split):
        u.feed(stream[i:i + split])
        ju.feed(stream[i:i + split])
        out.extend(u)
        jout.extend(ju)
    assert len(out) == 4
    assert packb(out) == packb(_to_port(jout))
    assert isinstance(out[1][1][0][0], (EventTime, int, float))
    assert out[0][3] == {"chunk": b"\x00\x01bin"}


def _to_port(obj):
    """The reference's decoded objects with its EventTime mapped to the
    port's (the two classes pack alike)."""
    if isinstance(obj, JEventTime):
        return EventTime(obj.sec, obj.nsec)
    if isinstance(obj, list):
        return [_to_port(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_port(v) for k, v in obj.items()}
    return obj


def test_ack_handshake_and_eventtime_packing():
    """``{"ack": ...}``, HELO and PONG pack alike in both codecs, and an
    EventTime comes back as ext type 0."""
    from fluentbit_tpu.codec.msgpack import packb as jpackb

    for obj in ({"ack": "c1"}, {"ack": b"\x00\xffid"},
                ["HELO", {"nonce": b"n" * 16, "auth": b"",
                          "keepalive": True}],
                ["PONG", False, "shared_key mismatch", "host", "ab" * 64]):
        assert packb(obj) == jpackb(obj)
    data = packb([EventTime(1700000000, 5)])
    assert data == jpackb([JEventTime(1700000000, 5)])
    assert data[1:3] == b"\xd7\x00"
    assert tmp.unpackb(data) == [EventTime(1700000000, 5)]


@pytest.mark.parametrize("key", ["s3cret", "wrong"])
def test_shared_key_handshake(key):
    """The right key: PONG ok, records absorbed and acked. The wrong
    one: PONG not ok, the connection closes, nothing absorbed."""
    rng = np.random.default_rng(3)
    ents = entries(rng, 0, 5)
    pongs = []

    def sends(port):
        c = Client(port, shared_key=key)
        pongs.append(c.pong)
        if c.pong[1]:
            c.send(message("app.auth", "forward", ents, {"chunk": "a1"}),
                   ack="a1")
        else:
            assert c.read() is None  # closed by the server
        c.close()

    want, got, _, _ = both(sends, 5 if key == "s3cret" else 0,
                           {"shared_key": "s3cret"})
    assert got == want
    assert [p[:3] for p in pongs] == [
        ["PONG", key == "s3cret", "" if key == "s3cret"
         else "shared_key mismatch"]] * 2
    assert [p[3] for p in pongs] == ["fluentbit-tpu"] * 2
    assert bool(got) == (key == "s3cret")


def test_tag_prefix():
    rng = np.random.default_rng(4)
    ents = entries(rng, 0, 3)

    def sends(port):
        c = Client(port)
        c.send(message("app.x", "packed", ents, {"chunk": "p"}), "p")
        c.close()

    want, got, _, _ = both(sends, 3, {"tag_prefix": "edge"})
    assert got == want and list(got) == ["edge.app.x"]


def test_resent_chunk_absorbed_once():
    """A chunk resent with the same id (as a lost ack makes an edge do)
    is acked every time and absorbed once; ``dedup off`` absorbs it
    every time."""
    rng = np.random.default_rng(5)
    first = message("app.r", "gzip", entries(rng, 0, 8), {"chunk": "dup"})
    other = message("app.r", "forward", entries(rng, 8, 4),
                    {"chunk": b"\x01raw-id"})

    def sends(port):
        c = Client(port)
        for data, ack in ((first, "dup"), (other, b"\x01raw-id"),
                          (first, "dup"), (first, "dup"),
                          (other, b"\x01raw-id")):
            c.send(data, ack)
        c.close()

    want, got, ref_plugin, plugin = both(sends, 12)
    assert got == want
    assert len(list(Unpacker(got["app.r"]))) == 12
    health = plugin.health_block()
    assert health == ref_plugin.health_block()
    assert (health["absorbed"], health["dedup_hits"],
            health["dedup_entries"]) == (2, 3, 2)
    # dedup off: every resend absorbed again. The port's records come in
    # the order sent; the reference's are the same records, its chunks
    # in an order its flush cycles decide (see push_ordered)
    want, undup, _, _ = both(sends, 32, {"dedup": "off"}, ordered=False)
    sent = [ev.raw for ev in decode_events(got["app.r"])]
    first, other = sent[:8], sent[8:]
    assert [ev.raw for ev in decode_events(undup["app.r"])] == (
        first + other + first + first + other)
    assert sorted(ev.raw for ev in decode_events(want["app.r"])) == sorted(
        ev.raw for ev in decode_events(undup["app.r"]))
    assert len(list(Unpacker(undup["app.r"]))) == 32


STAMPS = [{"tenant": "acme", "priority": 3}, {"tenant": "x" * 129},
          {"tenant": ""}, {"tenant": 7, "priority": "high"},
          {"tenant": "t", "priority": True}, {"priority": -5},
          {"priority": 99}, {"tenant": b"bytes"}]


@pytest.mark.parametrize("option", STAMPS)
def test_wire_stamp_degrades_as_the_reference(option):
    from fluentbit_tpu.plugins.net_forward import _wire_stamp as jstamp
    from fluentbit_tpu_torch.plugins.net_forward import _wire_stamp

    assert _wire_stamp(option) == jstamp(option)
    assert _wire_stamp(None) == jstamp(None) == (None, None)


def test_stamped_messages_absorbed_as_the_reference():
    """Stamped messages of every shape are absorbed: each tag receives
    the reference's bytes (one stamp shape per tag)."""
    rng = np.random.default_rng(6)
    msgs = [message(f"app.s{i}", "forward", entries(rng, 10 * i, 3),
                    dict(opt, chunk=f"s{i}"))
            for i, opt in enumerate(STAMPS)]

    def sends(port):
        c = Client(port)
        for i, data in enumerate(msgs):
            c.send(data, f"s{i}")
        c.close()

    want, got, _, _ = both(sends, 3 * len(STAMPS))
    assert got == want and len(got) == len(STAMPS)


def test_four_connections_keep_each_tags_order():
    """Four connections at once, each with its own tags: every tag's
    records arrive in the order sent, equal to the reference's."""
    import threading

    rng = np.random.default_rng(8)
    per_conn = [[message(f"app.c{c}.t{t}", ["packed", "gzip"][k % 2],
                         entries(rng, 100 * c + 10 * k, 6),
                         {"chunk": f"{c}-{k}"})
                 for k in range(4) for t in (k % 2,)] for c in range(4)]

    def sends(port):
        def run(msgs, c):
            cl = Client(port)
            for k, data in enumerate(msgs):
                cl.send(data, f"{c}-{k}")
            cl.close()

        threads = [threading.Thread(target=run, args=(m, c))
                   for c, m in enumerate(per_conn)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    want, got, _, _ = both(sends, 4 * 4 * 6)
    assert got == want and len(got) == 8


def test_dedup_ledger_equals_reference():
    """The in-memory ledger: ``seen``, ``record``, the TTL and the hit
    count step for step with the reference's ``root=None`` form."""
    from fluentbit_tpu.core.relay import DedupLedger as JLedger
    from fluentbit_tpu_torch.core.relay import DedupLedger

    now = [1000.0]
    a = DedupLedger(None, ttl=10, clock=lambda: now[0])
    b = JLedger(None, ttl=10, clock=lambda: now[0])
    rng = np.random.default_rng(9)
    for step in range(300):
        cid = f"c{int(rng.integers(20))}"
        now[0] += float(rng.random())
        if rng.random() < 0.5:
            assert a.seen(cid) == b.seen(cid)
        else:
            a.record(cid)
            b.record(cid)
        assert a.snapshot() == b.snapshot()
        assert (a.size(), a.dedup_hits) == (b.size(), b.dedup_hits)


def test_unported_forward_options_raise_by_name(tmp_path):
    """The options the port refused before it had storage and
    backpressure now start as the reference's do (``threaded``,
    ``storage.type``, ``defer_ack_window``, ``mem_buf_limit``, a durable
    ledger under ``storage.path``); a tenant still raises by name."""
    from fluentbit_tpu.core.relay import DedupLedger as JLedger
    from fluentbit_tpu_torch.core.relay import DedupLedger

    for props in ({"threaded": "on"}, {"storage.type": "filesystem"},
                  {"defer_ack_window": "10"}, {"mem_buf_limit": "5M"}):
        ctx = flb.create(device="cpu", **{"storage.path": str(tmp_path)})
        ffd = ctx.input("forward", port="0", listen="127.0.0.1", **props)
        ctx.start()
        try:
            assert ctx.bound_port(ffd)
            ins = ctx.engine.inputs[0]
            want = ref.create()
            want.input("forward", port="0", **props)
            wins = want.engine.inputs[0]
            wins.configure()
            assert (ins.threaded, ins.storage_type, ins.mem_buf_limit,
                    ins.plugin.defer_ack_window) == (
                wins.threaded, wins.storage_type, wins.mem_buf_limit,
                float(props.get("defer_ack_window", 5)))
        finally:
            ctx.stop()
    ctx = flb.create(device="cpu")
    ctx.input("forward", port="0", tenant="a")
    with pytest.raises(ValueError, match="'tenant' is not ported"):
        ctx.start()
    # the durable ledger: what one package records, the other reads
    DedupLedger(str(tmp_path / "l")).record("c1")
    assert JLedger(str(tmp_path / "l")).snapshot() == {"c1": 1}
    JLedger(str(tmp_path / "m")).record("c2")
    assert DedupLedger(str(tmp_path / "m")).snapshot() == {"c2": 1}
    ctx = flb.create(device="cpu")
    ctx.service_set(**{"storage.path": "/x"})
    assert ctx.engine.service.storage_path == "/x"


def test_counters_registered_and_counted():
    rng = np.random.default_rng(10)
    data = message("app.m", "packed", entries(rng, 0, 4), {"chunk": "m"})

    def sends(port):
        c = Client(port)
        c.send(data, "m")
        c.send(data, "m")
        c.close()

    ctx = flb.create(device="cpu", flush="50ms", grace="1")
    ffd = ctx.input("forward", port="0", listen="127.0.0.1")
    ctx.output("null", match="*")
    ctx.start()
    try:
        sends(ctx.bound_port(ffd))
    finally:
        ctx.stop()
    text = ctx.engine.metrics.to_prometheus()
    for name in ("dedup_hits_total", "absorbed_chunks_total",
                 "deferred_acks_total", "withheld_acks_total"):
        assert f"fluentbit_forward_{name}" in text
    assert 'fluentbit_forward_absorbed_chunks_total{instance="forward.0"} 1' \
        in text
    assert 'fluentbit_forward_dedup_hits_total{instance="forward.0"} 1' \
        in text

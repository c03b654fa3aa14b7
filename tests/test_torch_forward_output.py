"""The port's forward output and its pieces against the reference's.

The same inputs, made from a numpy seed, go through the reference package
(``fluentbit_tpu``, JAX on the CPU) and the port (``fluentbit_tpu_torch``,
``device="cpu"``), and every comparison is exact:

- the frames of one chunk (PackedForward, byte-equal; gzip'd, compared
  as the reference's own test compares them) and the stable chunk id;
- an ``UpstreamHA`` pick sequence from one upstream file, and circuit
  breaker state sequences under an injected clock (with the guard's
  breaker families);
- a partition spool written by one package and loaded by the other;
- the relay over loopback in all four pairings of edge and aggregator
  (lib → forward output with acks, gzip and ``shared_key`` → forward
  input → grep Exclude → lib), the aggregator's bytes per tag equal to
  each other and to the records sent; with TLS (a certificate from
  ``openssl``) and an HA upstream file whose first node refuses;
- an ack lost and the chunk redelivered (absorbed once), and a partition
  healed through the spool;
- the http input with TLS, and what still raises by name;
- a stop while a client streams: every acked record is delivered.
"""

import gzip
import os
import socket
import ssl
import subprocess
import threading
import time
import urllib.request

import numpy as np
import pytest

import fluentbit_tpu as ref
import fluentbit_tpu_torch as flb
from fluentbit_tpu.core import guard as rguard
from fluentbit_tpu.core import relay as rrelay
from fluentbit_tpu.core import upstream as rupstream
from fluentbit_tpu.plugins.net_forward import ForwardOutput as RefOutput
from fluentbit_tpu_torch.codec.events import encode_event
from fluentbit_tpu_torch.codec.msgpack import EventTime, Unpacker, packb
from fluentbit_tpu_torch.core import guard as tguard
from fluentbit_tpu_torch.core import relay as trelay
from fluentbit_tpu_torch.core import upstream as tupstream
from fluentbit_tpu_torch.plugins.net_forward import ForwardOutput
from test_torch_pipeline import push_ordered_bytes

SHARED_KEY = "s3cret"
EXCLUDE = "DROP"
TAGS = ("app.web", "app.db", "sys.kern")


def wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.01)
    raise TimeoutError("condition not met")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_chunks(seed: int, n_chunks: int = 9, max_records: int = 60):
    """(tag, V2 bytes, n, [(ts, record)]) appends from the seed: times as
    EventTime, int and float; ~1 record in 8 carries the Exclude word;
    nested values and non-ASCII text."""
    rng = np.random.default_rng(seed)
    out = []
    k = 0
    for c in range(n_chunks):
        tag = TAGS[c % len(TAGS)]
        n = int(rng.integers(1, max_records))
        rows = []
        for _ in range(n):
            sec = 1700000000 + k
            form = k % 3
            ts = (EventTime(sec, int(rng.integers(0, 10 ** 9))) if form == 0
                  else sec if form == 1
                  else sec + float(rng.integers(0, 1000)) / 1000.0)
            word = EXCLUDE if rng.random() < 0.125 else "ok"
            rec = {"log": f"{k} {word} " + "é" * int(rng.integers(0, 5))
                   + "x" * int(rng.integers(0, 80)),
                   "n": int(rng.integers(-2 ** 40, 2 ** 40)),
                   "nested": {"a": [1, 2.5, None, True]}}
            rows.append((ts, rec))
            k += 1
        data = b"".join(encode_event(r, t) for t, r in rows)
        out.append((tag, data, n, rows))
    return out


def expected_bytes(chunks, time_as_integer=False) -> dict:
    """What the aggregator's lib output must receive per tag: the forward
    input re-encodes each kept entry with the time the edge sent (a
    float time as EventTime, an integer as is)."""
    want: dict = {}
    for tag, _data, _n, rows in chunks:
        for ts, rec in rows:
            if EXCLUDE in rec["log"]:
                continue
            if time_as_integer:
                ts = int(float(ts))
            elif isinstance(ts, float):
                ts = EventTime.from_float(ts)
            want.setdefault(tag, []).append(encode_event(rec, ts))
    return {t: b"".join(v) for t, v in want.items()}


def create(pkg, **service):
    if pkg == "ref":
        return ref.create(**service)
    return flb.create(device="cpu", **service)


class Aggregator:
    """forward input → grep Exclude → lib output, on ``pkg``."""

    def __init__(self, pkg, port="0", **props):
        self.ctx = create(pkg, flush="50ms", grace="1")
        self.ctx.input("forward", port=str(port), listen="127.0.0.1",
                       **props)
        self.ctx.filter("grep", match="*", exclude=f"log {EXCLUDE}")
        self.got: dict = {}
        self.count = 0
        self.ctx.output("lib", match="*", callback=self._cb)
        self.ctx.start()
        self.plugin = self.ctx.engine.inputs[0].plugin
        self.port = wait_for(lambda: self.plugin.bound_port)

    def _cb(self, data, tag):
        self.got.setdefault(tag, []).append(bytes(data))
        self.count += len(list(Unpacker(bytes(data))))

    def stop(self) -> dict:
        self.ctx.flush_now()
        self.ctx.stop()
        return {t: b"".join(v) for t, v in self.got.items()}


def run_edge(pkg, out_props, chunks, service=None, until=None):
    """lib input → forward output on ``pkg``: every chunk appended, one
    flush, then ``until()`` awaited before the edge stops."""
    ctx = create(pkg, flush="50ms", grace="1", **(service or {}))
    ctx.input("lib", tag="edge")
    ctx.output("forward", match="*", **out_props)
    ctx.start()
    try:
        ins = ctx.engine.inputs[0]
        for tag, data, n, _rows in chunks:
            ctx.engine.input_log_append(ins, tag, data, n)
        ctx.flush_now()
        if until is not None:
            wait_for(until, 20)
    finally:
        stop_edge(ctx)
    return ctx.engine.outputs[0].plugin


def as_sent(edge, got: dict) -> dict:
    """What an aggregator received from ``edge``, each tag's records held
    to the order the edge's appends were made: as they came from the
    port's edge; from the reference's in the order of the appends
    (``push_ordered``: its ``flush_now`` beside the timer may queue, and
    so send, a tag's chunks in either order)."""
    if edge == "port":
        return got
    return {t: push_ordered_bytes(v) for t, v in got.items()}


def stop_edge(ctx) -> None:
    """Stop an edge and end its connection: the reference's ``exit``
    closes the writer on the engine's closed loop, which leaves the
    socket open until it is collected, and the reference aggregator's
    stop waits for it."""
    w = ctx.engine.outputs[0].plugin._writer
    sock = w.get_extra_info("socket") if w is not None else None
    ctx.stop()
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


# ---------------------------------------------------------------- frames


def _bare(cls, compress, time_as_integer):
    out = object.__new__(cls)
    out.compress = compress
    out.time_as_integer = time_as_integer
    return out


@pytest.mark.parametrize("compress", [None, "gzip"])
@pytest.mark.parametrize("time_as_integer", [False, True])
def test_frames_equal_reference(compress, time_as_integer):
    """One chunk framed by both packages: the entry stream, its record
    offsets and the chunk id equal; the frame byte-equal without gzip,
    and with gzip equal after gunzip with the same option map."""
    for tag, data, n, _rows in make_chunks(3, n_chunks=4):
        mine = _bare(ForwardOutput, compress, time_as_integer)
        theirs = _bare(RefOutput, compress, time_as_integer)
        blob, n_got, ends = mine._packed_entries(data)
        assert (blob, n_got, ends) == theirs._packed_entries(data)
        assert n_got == n
        cid = trelay.stable_chunk_id(tag, blob)
        assert cid == rrelay.stable_chunk_id(tag, blob)
        a = mine._frame(tag, blob, n, cid, None, None)
        b = theirs._frame(tag, blob, n, cid, None, None)
        if compress is None:
            assert a == b
            continue
        (ta, pa, oa), = list(Unpacker(a))
        (tb, pb, ob), = list(Unpacker(b))
        assert (ta, oa) == (tb, ob)
        assert oa["compressed"] == "gzip" and oa["chunk"] == cid
        assert gzip.decompress(pa) == gzip.decompress(pb) == blob


# ---------------------------------------------------- breakers and the HA set


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("cfg", [
    dict(failures=3, error_rate=0.5, window=6, cooldown=2.0, probes=1),
    dict(failures=1, error_rate=0.3, window=4, cooldown=0.5, probes=2),
    dict(failures=50, error_rate=0.5, window=10, cooldown=1.0, probes=1),
])
def test_breaker_state_sequence_equal_reference(cfg):
    """Random allow / available / ok / failure / reset / clock steps: the
    two breakers answer and move alike, transitions included."""
    rng = np.random.default_rng(cfg["failures"])
    seen = {"t": [], "r": []}
    clocks = {"t": Clock(), "r": Clock()}
    brs = {
        "t": tguard.CircuitBreaker("b", clock=clocks["t"], **cfg,
                                   on_transition=lambda *a: seen["t"].append(a)),
        "r": rguard.CircuitBreaker("b", clock=clocks["r"], **cfg,
                                   on_transition=lambda *a: seen["r"].append(a)),
    }
    for _ in range(400):
        op = int(rng.integers(0, 7))
        dt = float(rng.random()) * cfg["cooldown"]
        do_reset = rng.random() < 0.1
        got = {}
        for k, br in brs.items():
            if op == 0:
                got[k] = br.allow()
            elif op == 1:
                got[k] = br.available()
            elif op in (2, 3):
                got[k] = br.record_failure()
            elif op == 4:
                got[k] = br.record_ok()
            elif op == 5:
                clocks[k].t += dt
                got[k] = br.retry_delay()
            else:
                got[k] = br.reset() if do_reset else None
            got[k] = (got[k], br.state_name(), br.state_code(),
                      br.is_closed())
        assert got["t"] == got["r"]
    assert seen["t"] == seen["r"] and len(seen["t"]) > 3


def test_guard_breakers_and_families_equal_reference():
    """The engine's named breakers take the service's guard.breaker_*
    keys, and their state gauge and transition counter read alike."""
    keys = {"guard.breaker_failures": "2", "guard.breaker_cooldown": "3",
            "guard.breaker_probes": "1", "guard.breaker_window": "5",
            "guard.breaker_error_rate": "0.6"}
    engines = [ref.create(**keys).engine,
               flb.create(device="cpu", **keys).engine]
    for eng in engines:
        clock = Clock()
        for name in ("forward:a:1", "forward:b:2"):
            br = eng.guard.breaker(name)
            br.clock = clock
            assert eng.guard.breaker(name) is br
            assert (br.failures, br.cooldown, br.window) == (2, 3.0, 5)
        a, b = eng.guard.breaker("forward:a:1"), eng.guard.breaker(
            "forward:b:2")
        a.record_failure()
        a.record_failure()  # open
        b.record_failure()
        clock.t += 3.5
        assert a.allow()  # half-open probe
        a.record_ok()  # closed
        a.record_failure()
        a.record_failure()  # open again

    def families(eng):
        return sorted(ln for ln in eng.metrics.to_prometheus().splitlines()
                      if ln.startswith("fluentbit_guard_breaker"))

    assert families(engines[1]) == families(engines[0])
    assert any("state=\"open\"} 2" in ln for ln in families(engines[1]))


UPSTREAM = """
[UPSTREAM]
    name  fwd-ha

[NODE]
    name  n1
    host  127.0.0.1
    port  24001
    weight 1

[NODE]
    name  n2
    host  localhost
    port  24002
    weight 3

[NODE]
    name  n3
    host  127.0.0.1
    port  24003
    weight 2
    extra value
"""


def test_upstream_ha_pick_sequence_equal_reference(tmp_path):
    """One upstream file, both packages: nodes, weights and properties
    equal, and the same weighted pick sequence with nodes marked down and
    up and the clock moving past the retry window."""
    path = tmp_path / "up.conf"
    path.write_text(UPSTREAM)
    sets = [tupstream.parse_upstream_file(str(path)),
            rupstream.parse_upstream_file(str(path))]
    assert [(n.name, n.host, n.port, n.weight, n.properties)
            for n in sets[0].nodes] == [
        (n.name, n.host, n.port, n.weight, n.properties)
        for n in sets[1].nodes]
    assert sets[0].name == sets[1].name == "fwd-ha"
    clocks = [Clock(), Clock()]
    for ha, clock in zip(sets, clocks):
        for n in ha.nodes:
            n.breaker.clock = clock
    rng = np.random.default_rng(5)
    seq = [[], []]
    for _ in range(300):
        op = int(rng.integers(0, 5))
        which = int(rng.integers(0, 3))
        dt = float(rng.random()) * 6.0
        for k, (ha, clock) in enumerate(zip(sets, clocks)):
            if op == 0:
                ha.mark_down(ha.nodes[which])
            elif op == 1:
                ha.mark_up(ha.nodes[which])
            elif op == 2:
                clock.t += dt
            seq[k].append((ha.pick().name,
                           [n.breaker.state_name() for n in ha.nodes]))
    assert seq[0] == seq[1]
    assert {s[0] for s in seq[0]} == {"n1", "n2", "n3"}
    empty = tmp_path / "empty.conf"
    empty.write_text("[UPSTREAM]\n    name x\n")
    with pytest.raises(ValueError, match="defines no nodes"):
        tupstream.parse_upstream_file(str(empty))


def test_resolve_caches_and_invalidates():
    import asyncio

    async def go():
        assert await tupstream.resolve("127.0.0.1", 1) == ["127.0.0.1"]
        addrs = await tupstream.resolve("localhost", 24224)
        assert addrs and ("localhost", 24224) in tupstream._dns_cache
        assert addrs == await rupstream.resolve("localhost", 24224)
        tupstream.invalidate_dns("localhost", 24224)
        assert ("localhost", 24224) not in tupstream._dns_cache

    asyncio.run(go())


# ------------------------------------------------------------------- spool


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_spool_written_by_one_package_loads_in_the_other(tmp_path, writer):
    """Three packed chunks spooled by one package: the other lists them
    in spool order and loads the same payload, count and envelope; a
    reopened spool continues the sequence; a dropped chunk is gone."""
    spools = {"port": trelay.ForwardSpool, "ref": rrelay.ForwardSpool}
    reader = "ref" if writer == "port" else "port"
    w = spools[writer](str(tmp_path))
    chunks = make_chunks(11, n_chunks=3)
    for i, (tag, data, n, _rows) in enumerate(chunks):
        blob, _, ends = _bare(ForwardOutput, None, False)._packed_entries(
            data)
        w.put(tag, blob, ends, {"tag": tag, "chunk": f"c{i}",
                                "tenant": None, "priority": None,
                                "quota_id": f"fwd-spool:forward.0:{i + 1}"})
    r = spools[reader](str(tmp_path))
    files = r.pending()
    assert [f.name for f in files] == [f.name for f in w.pending()]
    assert [f.name for f in files] == ["%012d" % i for i in range(3)]
    for i, f in enumerate(files):
        got = r.load(f)
        assert got == w.load(f)
        blob, n, meta = got
        assert n == chunks[i][2] and meta["chunk"] == f"c{i}"
        assert meta["n"] == n and len(list(Unpacker(blob))) == n
    assert r._seq == 3
    r.drop(files[0])
    assert [f.name for f in w.pending()] == ["%012d" % i for i in (1, 2)]


# ------------------------------------------------------------------- relay


PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port"), ("ref", "ref")]


@pytest.mark.parametrize("edge,agg", PAIRS)
def test_relay_pairings_equal(edge, agg):
    """Edge → aggregator over loopback with acks, gzip and the shared
    key, in every pairing of the packages: the aggregator's bytes per tag
    are the records sent, the Exclude rule applied; every flush acked
    once, nothing lost or resent."""
    chunks = make_chunks(7)
    want = expected_bytes(chunks)
    n_want = sum(len(list(Unpacker(v))) for v in want.values())
    a = Aggregator(agg, shared_key=SHARED_KEY)
    try:
        out = run_edge(edge, dict(host="127.0.0.1", port=str(a.port),
                                  require_ack_response="on",
                                  compress="gzip", shared_key=SHARED_KEY,
                                  self_hostname="edge-1"),
                       chunks, until=lambda: a.count >= n_want)
    finally:
        got = a.stop()
    assert {t: len(v) for t, v in got.items()} == {
        t: len(v) for t, v in want.items()}
    assert as_sent(edge, got) == want
    h = out.health_block()
    assert h["acks_waited"] >= len(TAGS) and h["acks_lost"] == 0
    assert h["resends"] == 0 and h["spooled"] == 0
    assert h["upstreams"] == {f"127.0.0.1:{a.port}": "closed"}
    assert a.plugin.health_block()["absorbed"] == h["acks_waited"]
    text = out._engine.metrics.to_prometheus()
    assert (f'fluentbit_forward_acks_waited_total{{instance="forward.0"}} '
            f'{h["acks_waited"]}') in text


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    crt, key = str(d / "srv.crt"), str(d / "srv.key")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", crt, "-days", "2",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    return crt, key


@pytest.mark.parametrize("edge", ["port", "ref"])
def test_tls_and_ha_failover(tmp_path, certs, edge):
    """TLS on both sides (verified against the certificate), an upstream
    file whose first node has nothing listening and a breaker that opens
    on the first refused dial: every record arrives once through the
    second node, the dead node's breakers read open, one open transition
    each; the port's edge moves as the reference's."""
    crt, key = certs
    chunks = make_chunks(13)
    want = expected_bytes(chunks, time_as_integer=True)
    n_want = sum(len(list(Unpacker(v))) for v in want.values())
    a = Aggregator("port", tls="on",
                   **{"tls.crt_file": crt, "tls.key_file": key})
    dead = free_port()
    up = tmp_path / "up.conf"
    up.write_text(f"[UPSTREAM]\n    name agg\n\n[NODE]\n    name dead\n"
                  f"    host 127.0.0.1\n    port {dead}\n\n[NODE]\n"
                  f"    name live\n    host localhost\n    port {a.port}\n")
    try:
        out = run_edge(edge, {"upstream": str(up), "tls": "on",
                              "tls.verify": "on", "tls.ca_file": crt,
                              "require_ack_response": "on",
                              "time_as_integer": "on"},
                       chunks, service={"guard.breaker_failures": "1",
                                        "guard.breaker_cooldown": "600"},
                       until=lambda: a.count >= n_want)
    finally:
        got = a.stop()
    assert as_sent(edge, got) == want
    h = out.health_block()
    assert h["upstreams"] == {f"127.0.0.1:{dead}": "open",
                              f"localhost:{a.port}": "closed"}
    assert h["acks_lost"] == 0 and h["spooled"] == 0
    text = out._engine.metrics.to_prometheus()
    name = f"forward:127.0.0.1:{dead}"
    assert f'fluentbit_forward_breaker_state{{upstream="{name}"}} 2' in text
    assert (f'fluentbit_guard_breaker_transitions_total{{name="{name}",'
            f'state="open"}} 1') in text


class LossyProxy:
    """A TCP relay in front of an aggregator that swallows the first ack
    it carries back: the edge's ack times out and it sends the same frame
    again on a new connection."""

    def __init__(self, target_port: int):
        self.target = target_port
        self.dropped = 0
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.threads = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            s = socket.create_connection(("127.0.0.1", self.target))
            for src, dst, back in ((c, s, False), (s, c, True)):
                t = threading.Thread(target=self._pipe,
                                     args=(src, dst, back), daemon=True)
                t.start()

    def _pipe(self, src, dst, back):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if back and self.dropped == 0:
                    self.dropped = 1
                    continue  # the lost ack
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("edge", ["port", "ref"])
def test_lost_ack_redelivered_absorbed_once(edge):
    """One chunk, its ack lost: the edge fails over to a new connection
    with the same chunk id, the aggregator acks it from its ledger, and
    the records arrive once."""
    chunks = make_chunks(17, n_chunks=1)
    want = expected_bytes(chunks)
    n_want = sum(len(list(Unpacker(v))) for v in want.values())
    a = Aggregator("port")
    proxy = LossyProxy(a.port)
    try:
        out = run_edge(edge, dict(host="127.0.0.1", port=str(proxy.port),
                                  require_ack_response="on",
                                  ack_timeout="0.5"),
                       chunks, until=lambda: a.count >= n_want)
    finally:
        proxy.close()
        got = a.stop()
    assert as_sent(edge, got) == want
    h = out.health_block()
    assert (h["acks_waited"], h["acks_lost"], h["resends"]) == (2, 1, 0)
    assert proxy.dropped == 1
    ah = a.plugin.health_block()
    assert (ah["absorbed"], ah["dedup_hits"]) == (1, 1)


@pytest.mark.parametrize("edge", ["port", "ref"])
def test_partition_spooled_then_replayed_on_heal(tmp_path, edge):
    """No aggregator at first: each flush fails its two attempts and
    parks its chunk in the spool (OK to the engine). The aggregator comes
    up on that port; the heal task replays the spool in order with each
    chunk's own id, and every record arrives exactly once."""
    chunks = make_chunks(19, n_chunks=5)
    want = expected_bytes(chunks)
    n_want = sum(len(list(Unpacker(v))) for v in want.values())
    port = free_port()
    holder = {}

    def heal():
        out = holder["out"]
        if out.n_spooled >= len(TAGS) and "agg" not in holder:
            holder["agg"] = Aggregator("port", port=port)
        agg = holder.get("agg")
        return agg is not None and agg.count >= n_want and \
            out.n_replayed == out.n_spooled

    ctx = create(edge, flush="50ms", grace="5",
                 **{"guard.breaker_cooldown": "0.2"})
    ctx.input("lib", tag="edge")
    ctx.output("forward", match="*", host="127.0.0.1", port=str(port),
               require_ack_response="on",
               storage_spool=str(tmp_path / "spool"))
    ctx.start()
    try:
        holder["out"] = ctx.engine.outputs[0].plugin
        ins = ctx.engine.inputs[0]
        for tag, data, n, _rows in chunks:
            ctx.engine.input_log_append(ins, tag, data, n)
        ctx.flush_now()
        wait_for(heal, 30)
    finally:
        stop_edge(ctx)
        got = holder["agg"].stop() if "agg" in holder else {}
    out = holder["out"]
    assert as_sent(edge, got) == want
    assert out.n_spooled == out.n_replayed == len(TAGS)
    assert not os.listdir(tmp_path / "spool" / "forward-spool")
    text = ctx.engine.metrics.to_prometheus()
    assert 'fluentbit_forward_replayed_chunks_total{instance="forward.0"} ' \
           f'{out.n_replayed}' in text


# ------------------------------------------------------- http TLS, raising


def test_http_input_with_tls(certs):
    """The http input behind TLS: an HTTPS POST verified against the
    certificate is answered 201 and its records arrive as in the
    reference."""
    crt, key = certs
    got = {}
    for pkg in ("port", "ref"):
        ctx = create(pkg, flush="50ms", grace="1")
        ctx.input("http", port="0", listen="127.0.0.1", tag="h", tls="on",
                  **{"tls.crt_file": crt, "tls.key_file": key})
        rows = []
        ctx.output("lib", match="*",
                   callback=lambda d, t, rows=rows: rows.extend(
                       e[1] for e in Unpacker(bytes(d))))
        ctx.start()
        try:
            port = wait_for(lambda: ctx.engine.inputs[0].plugin.bound_port)
            req = urllib.request.Request(
                f"https://localhost:{port}/app", method="POST",
                data=b'[{"a": 1}, {"b": "\\u00e9"}]',
                headers={"Content-Type": "application/json"})
            sslctx = ssl.create_default_context(cafile=crt)
            with urllib.request.urlopen(req, context=sslctx,
                                        timeout=10) as resp:
                assert resp.status == 201
            wait_for(lambda: (ctx.flush_now(), len(rows) == 2)[1])
        finally:
            ctx.stop()
        got[pkg] = rows
    assert got["port"] == got["ref"] == [{"a": 1}, {"b": "é"}]


@pytest.mark.parametrize("kind,name,props,word", [
    ("input", "dummy", {"tls": "on"}, "'tls' is not ported"),
    ("output", "null", {"tls.verify": "off"}, "'tls.verify' is not ported"),
    ("output", "forward", {"net.keepalive": "on"},
     "'net.keepalive' is not ported"),
    ("output", "forward", {"proxy": "http://p:3128"}, "HTTP proxy"),
    ("input", "forward", {"tls": "on"}, "tls on requires tls.crt_file"),
    ("input", "http", {"tls": "on"}, "tls on requires tls.crt_file"),
    ("output", "forward", {"tls.ca_file": "/nonexistent/ca.pem"},
     "No such file"),
])
def test_unported_or_bad_tls_keys_raise(kind, name, props, word):
    ctx = flb.create(device="cpu")
    if kind == "input":
        ctx.input(name, port="0", **props) if name != "dummy" else \
            ctx.input(name, **props)
        ctx.output("null", match="*")
    else:
        ctx.input("lib", tag="t")
        ctx.output(name, match="*", **props)
    if name == "forward" and kind == "output" and "tls.ca_file" in props:
        # the client context is built at the first dial: the flush fails
        ctx.set(1, tls="on")
        ctx.start()
        try:
            out = ctx.engine.outputs[0].plugin
            import asyncio
            with pytest.raises(OSError, match=word):
                asyncio.run(out._connect())
        finally:
            ctx.stop()
        return
    with pytest.raises(ValueError, match=word):
        ctx.start()


@pytest.mark.parametrize("key", ["qos.enable", "daemon",
                                 "tpu.enable", "hot_reload_diff",
                                 "http_server"])
def test_unported_service_keys_raise(key):
    with pytest.raises(ValueError, match=f"'{key}' is not ported"):
        flb.create(device="cpu", **{key: "on"})


def test_ported_service_keys_set_what_the_reference_sets():
    keys = {"hot_reload": "on", "guard.breaker_failures": "3",
            "guard.breaker_error_rate": "0.25", "guard.breaker_window": "8",
            "guard.breaker_cooldown": "1500ms", "guard.breaker_probes": "2",
            "guard.enable": "off", "guard.flush_timeout": "750ms",
            "guard.shed_watermark": "0.6", "guard.stall_after": "12s",
            "guard.leak_grace": "2", "guard.worker_start_timeout": "3s",
            "storage.path": "/var/lib/fb", "storage.sync": "full",
            "storage.checksum": "on", "storage.backlog.mem_limit": "3M",
            "storage.max_chunks_up": "9"}
    a = flb.create(device="cpu", **keys).service
    b = ref.create(**keys).service
    for attr in ("hot_reload", "guard_breaker_failures",
                 "guard_breaker_error_rate", "guard_breaker_window",
                 "guard_breaker_cooldown", "guard_breaker_probes",
                 "guard_enable", "guard_flush_timeout",
                 "guard_shed_watermark", "guard_stall_after",
                 "guard_leak_grace", "guard_worker_start_timeout",
                 "storage_path", "storage_sync", "storage_checksum",
                 "storage_backlog_mem_limit", "storage_max_chunks_up"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert packb(a.guard_breaker_cooldown) == packb(1.5)


def test_stop_delivers_every_acked_record():
    """A client streams acked Forward messages while the aggregator
    stops: every record it saw acked reaches the output. The server
    inputs close before the final drain (the reference drains first and
    keeps acking, and loses what it acked after the drain)."""
    got = [0]
    ctx = flb.create(device="cpu", flush="0.2", grace="1")
    ctx.input("forward", port="0", listen="127.0.0.1")
    ctx.output("lib", match="*", callback=lambda d, t: got.__setitem__(
        0, got[0] + len(list(Unpacker(bytes(d))))))
    ctx.start()
    port = ctx.engine.inputs[0].plugin.bound_port
    acked = [0]
    running = threading.Event()
    running.set()

    def client():
        s = socket.create_connection(("127.0.0.1", port))
        u = Unpacker()
        i = 0
        try:
            while running.is_set():
                ents = [[1700000000 + i, {"i": i, "k": j}] for j in range(20)]
                s.sendall(packb(["t", ents, {"chunk": f"c{i}"}]))
                while not list(u):
                    data = s.recv(65536)
                    if not data:
                        return
                    u.feed(data)
                acked[0] += 20
                i += 1
        except OSError:
            return
        finally:
            s.close()

    th = threading.Thread(target=client)
    th.start()
    wait_for(lambda: acked[0] >= 2000)
    ctx.stop()
    running.clear()
    th.join(10)
    assert got[0] == acked[0] > 2000

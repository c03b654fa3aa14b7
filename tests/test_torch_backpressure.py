"""Input backpressure of the port against the reference package.

The flush is held (the flush timer's cycles are gated off: only the
test's ``flush_now`` drains the pools), so every append's verdict is
deterministic, and both
packages (the port on ``device="cpu"``) must refuse the same appends
(-1), pause and resume their inputs at the same points, and deliver the
same records: ``mem_buf_limit``, ``storage.pause_on_chunks_overlimit``
with ``storage.max_chunks_up``, and ``memrb`` eviction with its counters.

Then what sits on backpressure: the emitters' buffer limit (rewrite_tag
keeps the originals of a group its emitter refuses, on the batch hook
and on the decoded path: the fault the port had, now closed), a
``threaded on`` tail, the dummy input's sample budget, the tail's lost
read (a behaviour of the reference that the port keeps), the http and
lib inputs' answers, the forward input's ``defer_ack_window`` (deferred
and withheld acks) and its durable dedup ledger across a restart.
Inputs come from numpy seeds.
"""

import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

import fluentbit_tpu as ref
import fluentbit_tpu_torch as port
from fluentbit_tpu.codec.events import decode_events as ref_decode
from fluentbit_tpu.codec.events import encode_event as ref_encode
from fluentbit_tpu.plugins.filter_rewrite_tag import \
    RewriteTagFilter as RefRewriteTag
from fluentbit_tpu_torch.codec.events import decode_events, encode_event
from fluentbit_tpu_torch.plugins.filter_rewrite_tag import RewriteTagFilter
from test_torch_forward import Client, entries, message
from test_torch_pipeline import APACHE2, make_appends
from test_torch_rewrite_tag import CONFIG3_RULES, config3_corpus

PKGS = {"ref": (ref, ref_encode, ref_decode),
        "port": (port, encode_event, decode_events)}
FAST = {"flush": "50ms", "grace": "1"}


def create(name, **kw):
    pkg = PKGS[name][0]
    return pkg.create(device="cpu", **kw) if name == "port" \
        else pkg.create(**kw)


def wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.01)
    raise AssertionError("condition not reached")


class Held:
    """The flush held on a started context: the engine's cycles (the
    timer's, ``flush_now``'s, the stop's drain) run only while the gate
    is open: in ``flush()`` and from ``release()`` on. Both packages'
    timers call the instance's ``flush_all``."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.open = False
        real = ctx.engine.flush_all

        def gated():
            if self.open:
                real()

        ctx.engine.flush_all = gated

    def flush(self):
        self.open = True
        try:
            self.ctx.flush_now()
        finally:
            self.open = False

    def release(self):
        self.open = True


def note_pauses(ins, events):
    """Record the plugin's pause and resume callbacks."""
    ins.plugin.pause = lambda: events.append("pause")
    ins.plugin.resume = lambda: events.append("resume")


# --------------------------------------------------- the held flush

CASES = {
    "mem_buf_limit": ({"mem_buf_limit": "6K"}, {}, 1),
    "chunks_overlimit": ({"storage.type": "filesystem",
                          "storage.pause_on_chunks_overlimit": "on"},
                         {"storage.max_chunks_up": "3"}, 5),
    "memrb": ({"storage.type": "memrb", "mem_buf_limit": "5K"}, {}, 4),
}


def held_run(name, case, seed, via, tmp_path):
    """Appends under a held flush, ``flush_now`` after every fifth: each
    append's verdict, the paused flag after each append and each flush,
    the pause/resume callbacks, the memrb families and the delivered
    bytes per tag."""
    in_props, service, n_tags = CASES[case]
    _pkg, encode, _decode = PKGS[name]
    ctx = create(name, **FAST, **service,
                 **{"storage.path": str(tmp_path / name)})
    ffd = ctx.input("lib", tag="app.log", **in_props)
    ctx.filter("grep", match="app.*", regex="log " + APACHE2)
    out = {}
    ctx.output("lib", match="*", callback=lambda d, t: out.setdefault(
        t, []).append(d))
    ctx.start()
    held = Held(ctx)
    e = ctx.engine
    ins = e.inputs[0]
    calls = []
    note_pauses(ins, calls)
    steps = []
    try:
        appends = make_appends(seed, sizes=[int(n) for n in np.random.
                                            default_rng(seed).integers(
                                                1, 60, 18)])
        for k, recs in enumerate(appends):
            tag = f"app.{k % n_tags}"
            if via == "push":
                rc = ctx.push(ffd, json.dumps(recs)) if n_tags == 1 else \
                    e.input_log_append(ins, tag, b"".join(
                        encode(b, t) for t, b in recs))
            else:
                rc = e.input_log_append(ins, tag, b"".join(
                    encode(b, t) for t, b in recs))
            steps.append(("append", rc, ins.paused))
            if k % 5 == 4:
                held.flush()
                steps.append(("flush", ins.paused))
        held.flush()
        fams = sorted(ln for ln in e.metrics.to_prometheus().splitlines()
                      if ln.startswith("fluentbit_input_memrb"))
    finally:
        held.release()
        ctx.stop()
    return steps, calls, fams, {t: b"".join(d) for t, d in out.items()}


@pytest.mark.parametrize("via", ["append", "push"])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_held_flush_verdicts_equal_reference(case, seed, via, tmp_path):
    got = {name: held_run(name, case, seed, via, tmp_path)
           for name in ("ref", "port")}
    assert got["port"] == got["ref"]
    steps, calls, fams, out = got["port"]
    verdicts = [s[1] for s in steps if s[0] == "append"]
    assert out
    if case == "memrb":
        assert -1 not in verdicts and not calls
        assert any("chunks_total" in f and not f.endswith(" 0")
                   for f in fams)
    else:
        refused = 0 if via == "push" and case == "mem_buf_limit" else -1
        assert refused in verdicts and "pause" in calls \
            and "resume" in calls


# -------------------------------------------------- the emitters


def emitter_run(name, decoded, monkeypatch, limit="1500"):
    """Config 3's rules over pushes of 8 records with the flush held and
    a small ``emitter_mem_buf_limit``, ``flush_now`` after every fifth
    push: every tag's bodies, and how the emitter's appends went."""
    if decoded:
        for cls in (RewriteTagFilter, RefRewriteTag):
            monkeypatch.setattr(cls, "can_process_batch", lambda self: False)
    _pkg, _encode, decode = PKGS[name]
    ctx = create(name, **FAST)
    ffd = ctx.input("lib", tag="syslog")
    f = ctx.filter("rewrite_tag", match="syslog",
                   emitter_mem_buf_limit=limit)
    for r in CONFIG3_RULES:
        ctx.set(f, rule=r)
    got = {}
    ctx.output("lib", match="*", callback=lambda d, t: got.setdefault(
        t, []).extend(ev.body for ev in decode(d)))
    ctx.start()
    held = Held(ctx)
    em = ctx.engine.inputs[-1]
    calls = []
    note_pauses(em, calls)
    try:
        corpus = config3_corpus(160)
        for k in range(0, len(corpus), 8):
            pairs = [[1700000000 + k + i, rec]
                     for i, rec in enumerate(corpus[k: k + 8])]
            ctx.push(ffd, json.dumps(pairs))
            if k % 40 == 32:
                held.flush()
        held.flush()
    finally:
        held.release()
        ctx.stop()
    return got, calls


@pytest.mark.parametrize("decoded", [False, True])
def test_emitter_limit_keeps_originals_as_reference(decoded, monkeypatch):
    """The emitter refuses a group once its pool holds
    ``emitter_mem_buf_limit``: rewrite_tag keeps that group's originals
    under the old tag, the same records in both packages, on both
    paths. Without the limit, fewer originals stay."""
    got = {name: emitter_run(name, decoded, monkeypatch)
           for name in ("ref", "port")}
    assert got["port"] == got["ref"]
    tags, calls = got["port"]
    assert "pause" in calls and "resume" in calls
    free, _c = emitter_run("port", decoded, monkeypatch, limit="10M")
    assert len(tags.get("syslog", [])) > len(free.get("syslog", []))


def test_flux_and_log_to_metrics_emitters_take_the_limit():
    """flux's and log_to_metrics' hidden emitters get
    ``emitter_mem_buf_limit`` as the reference's do."""
    got = {}
    for name in ("ref", "port"):
        ctx = create(name, **FAST)
        ctx.input("lib", tag="app")
        ctx.filter("flux", match="app", group_by="k", tag="rows",
                   window="tumbling 60", emitter_mem_buf_limit="3K")
        ctx.filter("log_to_metrics", match="app", metric_mode="counter",
                   metric_name="c", metric_description="d", tag="m",
                   regex="k a", emitter_mem_buf_limit="2K")
        ctx.start()
        try:
            got[name] = sorted((i.display_name, i.mem_buf_limit)
                               for i in ctx.engine.inputs)
        finally:
            ctx.stop()
    assert got["port"] == got["ref"]
    assert sorted(m for _n, m in got["port"] if m) == [2048, 3072]


# -------------------------------------------------------- inputs


def tail_file(path, n, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"line {i} " + "y" * int(rng.integers(0, 300)) + "\n")
    return os.path.getsize(path)


def tail_run(name, path, size, props, held):
    _pkg, _encode, decode = PKGS[name]
    ctx = create(name, **FAST)
    ctx.input("tail", tag="t", path=path, read_from_head="true", **props)
    got = []
    ctx.output("lib", match="*", callback=lambda d, t: got.extend(
        ev.body["log"] for ev in decode(d)))
    ctx.start()
    gate = Held(ctx) if held else None
    try:
        tail = ctx.engine.inputs[0].plugin
        wait_for(lambda: any(tf.offset == size for tf in
                             tail._files.values()))
        if gate is not None:
            gate.flush()
        else:
            ctx.flush_now()
    finally:
        if gate is not None:
            gate.release()
        ctx.stop()
    return got


def test_threaded_tail_delivers_what_the_reference_does(tmp_path):
    path = str(tmp_path / "a.log")
    size = tail_file(path, 3000, seed=4)
    got = {name: tail_run(name, path, size, {"threaded": "on"}, False)
           for name in ("ref", "port")}
    assert got["port"] == got["ref"] and len(got["port"]) == 3000


def test_tail_read_refused_is_lost_as_in_the_reference(tmp_path):
    """A behaviour of the reference that the port keeps: the tail drains
    its file in 64 KiB reads within one collect and ignores an append's
    -1 (fluentbit_tpu/plugins/in_tail.py:633-634), so past
    ``mem_buf_limit`` the rest of that collect's reads are lost; a
    paused tail is not collected until the flush resumes it."""
    path = str(tmp_path / "b.log")
    size = tail_file(path, 3000, seed=5)
    got = {name: tail_run(name, path, size, {"mem_buf_limit": "1K"}, True)
           for name in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert 0 < len(got["port"]) < 3000
    assert [s.split(" ")[1] for s in got["port"]] == [
        str(i) for i in range(len(got["port"]))]


def test_dummy_keeps_its_sample_budget(tmp_path):
    """A refused dummy append does not spend its samples: every sample
    is delivered, in both packages."""
    got = {}
    for name in ("ref", "port"):
        _pkg, _encode, decode = PKGS[name]
        ctx = create(name, flush="50ms", grace="1")
        ctx.input("dummy", tag="d", dummy='{"x":1}', rate="200",
                  samples="40", mem_buf_limit="1")
        n = []
        ctx.output("lib", match="*", callback=lambda d, t: n.extend(
            decode(d)))
        ctx.start()
        try:
            wait_for(lambda: len(n) >= 40)
            time.sleep(0.2)
        finally:
            ctx.stop()
        got[name] = len(n)
    assert got["port"] == got["ref"] == 40


def test_http_and_lib_answers_under_backpressure():
    """Over ``mem_buf_limit`` the http input still answers 201 and the
    lib push returns 0, as the reference's do; the refused records are
    not delivered."""
    got = {}
    for name in ("ref", "port"):
        _pkg, _encode, decode = PKGS[name]
        ctx = create(name, **FAST)
        ctx.input("http", port="0", listen="127.0.0.1", tag="h",
                  mem_buf_limit="10")
        lib = ctx.input("lib", tag="l", mem_buf_limit="10")
        out = []
        ctx.output("lib", match="*", callback=lambda d, t: out.extend(
            (t, ev.body["i"]) for ev in decode(d)))
        ctx.start()
        held = Held(ctx)
        try:
            port_no = wait_for(
                lambda: ctx.engine.inputs[0].plugin.bound_port)
            codes, pushes = [], []
            for i in range(3):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port_no}/",
                    data=json.dumps([{"i": i}]).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    codes.append(r.status)
                pushes.append(ctx.push(lib, json.dumps({"i": i})))
            held.flush()
        finally:
            held.release()
            ctx.stop()
        got[name] = (codes, pushes, sorted(out))
    assert got["port"] == got["ref"]
    assert got["port"][1] == [1, 0, 0]


# ------------------------------------------------- the forward input


def ack_or_none(client, timeout):
    client.sock.settimeout(timeout)
    try:
        return client.read()
    except socket.timeout:
        return None
    finally:
        client.sock.settimeout(10)


def forward_run(name, tmp_path, plan):
    """A forward input with ``mem_buf_limit`` and a short
    ``defer_ack_window`` under a held flush; ``plan`` sends messages and
    flushes. Returns what each step saw, the input's counts and the
    delivered bodies."""
    _pkg, _encode, decode = PKGS[name]
    ctx = create(name, **FAST, **{"storage.path": str(tmp_path / name)})
    ctx.input("forward", port="0", listen="127.0.0.1",
              mem_buf_limit="200", defer_ack_window="0.4")
    out = []
    ctx.output("lib", match="*", callback=lambda d, t: out.extend(
        ev.body["log"] for ev in decode(d)))
    ctx.start()
    held = Held(ctx)
    try:
        plugin = ctx.engine.inputs[0].plugin
        client = Client(wait_for(lambda: plugin.bound_port))
        seen = plan(held, client)
        client.close()
        held.flush()
        counts = (plugin.n_absorbed, plugin.n_deferred_acks,
                  plugin.n_withheld_acks, plugin._ledger.dedup_hits)
    finally:
        held.release()
        ctx.stop()
    return seen, counts, out


def forward_messages(seed, n):
    rng = np.random.default_rng(seed)
    return [message("kube.t", "packed", entries(rng, 10 * i, 5),
                    {"chunk": f"c{i}"}) for i in range(n)]


def test_defer_ack_window_withholds_then_dedups(tmp_path):
    """The first message is absorbed and acked; the second is refused,
    its ack deferred for the window and then withheld; after a flush
    the peer's resend is absorbed once and acked. The same in both."""
    msgs = forward_messages(3, 2)

    def plan(held, client):
        client.sock.sendall(msgs[0])
        a = ack_or_none(client, 5)
        client.sock.sendall(msgs[1])
        b = ack_or_none(client, 1.5)  # past the 0.4 s window
        held.flush()
        client.sock.sendall(msgs[1])  # the peer resends
        c = ack_or_none(client, 5)
        return [a, b, c]

    got = {name: forward_run(name, tmp_path, plan)
           for name in ("ref", "port")}
    assert got["port"] == got["ref"]
    seen, counts, out = got["port"]
    assert seen == [{"ack": "c0"}, None, {"ack": "c1"}]
    assert counts == (2, 1, 1, 0) and len(out) == 10


def test_deferred_ack_leaves_once_the_flush_resumes(tmp_path):
    """A refused message whose input resumes inside the window is
    absorbed by the defer loop and acked late (deferred, not withheld).
    The flush runs on the engine's loop, between the loop's retries."""
    msgs = forward_messages(4, 2)

    def plan(held, client):
        e = held.ctx.engine
        client.sock.sendall(msgs[0])
        a = ack_or_none(client, 5)
        e.inputs[0].plugin.defer_ack_window = 5.0
        client.sock.sendall(msgs[1])
        wait_for(lambda: e.inputs[0].plugin.n_deferred_acks)
        held.release()  # the timer's next cycle drains and resumes
        b = ack_or_none(client, 5)
        held.open = False
        return [a, b]

    got = {name: forward_run(name, tmp_path, plan)
           for name in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert got["port"][0] == [{"ack": "c0"}, {"ack": "c1"}]
    assert got["port"][1] == (2, 1, 0, 0)


@pytest.mark.parametrize("second", ["ref", "port"])
@pytest.mark.parametrize("first", ["ref", "port"])
def test_durable_ledger_absorbs_an_acked_chunk_zero_times(first, second,
                                                          tmp_path):
    """A chunk acked before a restart is acked again and absorbed zero
    times after it: the ledger under ``storage.path`` survives, whichever
    package wrote it."""
    msg = forward_messages(5, 1)[0]
    root = str(tmp_path / "st")
    runs = []
    for name in (first, second):
        _pkg, _encode, decode = PKGS[name]
        ctx = create(name, flush="50ms", grace="1", **{"storage.path": root})
        ctx.input("forward", port="0", listen="127.0.0.1")
        out = []
        ctx.output("lib", match="*", callback=lambda d, t: out.extend(
            decode(d)))
        ctx.start()
        try:
            plugin = ctx.engine.inputs[0].plugin
            client = Client(wait_for(lambda: plugin.bound_port))
            client.send(msg, ack="c0")
            client.close()
            ctx.flush_now()
            runs.append((len(out), plugin.n_absorbed,
                         plugin._ledger.dedup_hits))
        finally:
            ctx.stop()
    assert runs == [(5, 1, 0), (0, 0, 1)]

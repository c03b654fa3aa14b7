"""Filesystem storage of the port against the reference package.

``fluentbit_tpu_torch.core.storage`` keeps the reference's file layout
byte for byte: the same chunks written by both packages' ``Storage``
give equal chunk files and offset sidecars (only the random name suffix
and the process's chunk ids differ), and each package recovers the
other's root and DLQ to equal chunks (tag, records, payload, route
names, event type, stream) over v1 files, open files torn inside a
record, finalized files, and finalized files with a bad CRC (moved to
``dlq/<name>.corrupt`` by both). The sidecar route and the decode walk
of a replay give the same chunks.

Then the engines, the port on ``device="cpu"`` beside the reference:
config 1 with ``storage.type filesystem`` delivers equal lib bytes and
leaves no file behind; under RETRY the file stays until delivered; an
ERROR and a stop with retries pending leave equal DLQ payloads; a
restart delivers the backlog before new records, in both, also from a
root the other package wrote. Inputs come from numpy seeds.
"""

import glob
import os
import shutil
import struct
import time
import zlib

import numpy as np
import pytest

import fluentbit_tpu_torch as port
from fluentbit_tpu.codec.chunk import Chunk as RefChunk
from fluentbit_tpu.codec.events import encode_event as ref_encode
from fluentbit_tpu.core.storage import Storage as RefStorage
from fluentbit_tpu_torch.codec.chunk import Chunk as PortChunk
from fluentbit_tpu_torch.codec.events import decode_events, encode_event
from fluentbit_tpu_torch.core.storage import Storage as PortStorage
from test_torch_delivery import PACKAGES, both  # noqa: F401 (fixture)
from test_torch_pipeline import APACHE2, make_appends

SIDE = {"ref": (RefStorage, RefChunk, ref_encode),
        "port": (PortStorage, PortChunk, encode_event)}


def chunk_specs(seed, n_chunks=4):
    """Chunks made from a numpy seed: tag, stream, route names, and the
    appends (each a list of bodies) that fill each."""
    rng = np.random.default_rng(seed)
    specs = []
    for c in range(n_chunks):
        appends = []
        for _ in range(int(rng.integers(1, 4))):
            appends.append([{"log": "x" * int(rng.integers(0, 60)),
                             "n": int(rng.integers(-2**40, 2**40)),
                             "u": "é☃" * int(rng.integers(0, 3)),
                             "f": float(rng.random())}
                            for _ in range(int(rng.integers(1, 6)))])
        routes = None
        if rng.random() < 0.5:
            routes = tuple(f"lib.{i}" for i in range(int(
                rng.integers(1, 3))))
        specs.append({"tag": f"t.{c}", "in_name": f"lib.{c % 2}",
                      "routes": routes, "appends": appends,
                      "metrics": c == 3 and seed % 2 == 0})
    return specs


def write_root(side, root, specs, finalize=True, offsets=True,
               checksum=True):
    """Write ``specs`` through one package's ``Storage``; returns the
    storage and each chunk's file path."""
    Storage, Chunk, encode = SIDE[side]
    st = Storage(root, checksum=checksum)
    paths = []
    for spec in specs:
        c = Chunk(spec["tag"], "metrics" if spec["metrics"] else "logs",
                  spec["in_name"])
        c.route_names = spec["routes"]
        t = 1700000000.0
        for bodies in spec["appends"]:
            parts = [encode(b, t + i) for i, b in enumerate(bodies)]
            data = b"".join(parts)
            c.append(data, len(parts))
            ends = list(np.cumsum([len(p) for p in parts])) \
                if offsets else None
            st.write_through(c, data, offsets=ends)
        if finalize:
            st.finalize(c)
        paths.append(st._files[c.id][1])
    return st, paths


def file_bytes(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        side = p + ".offs"
        with open(side, "rb") as f:
            out.append((os.path.basename(os.path.dirname(p)), data,
                        f.read()))
    return out


def chunk_view(c):
    return (c.tag, c.event_type, c.in_name, c.records, c.get_bytes(),
            c.route_names)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("offsets", [True, False])
def test_files_equal_reference(seed, checksum, offsets, tmp_path):
    """Equal chunks give equal chunk files and sidecars (open and
    finalized) and equal DLQ files."""
    specs = chunk_specs(seed)
    got = {}
    for side in ("ref", "port"):
        st, paths = write_root(side, str(tmp_path / side), specs,
                               finalize=False, offsets=offsets,
                               checksum=checksum)
        opened = file_bytes(paths)
        Storage, Chunk, encode = SIDE[side]
        dlq = []
        for spec in specs[:2]:
            c = Chunk(spec["tag"], "logs", spec["in_name"])
            c.route_names = spec["routes"]
            data = b"".join(encode(b, 1.5) for b in spec["appends"][0])
            c.append(data, len(spec["appends"][0]))
            with open(st.quarantine(c), "rb") as f:
                dlq.append(f.read())
        st.close()
        _st, paths = write_root(side, str(tmp_path / (side + "f")), specs,
                                checksum=checksum, offsets=offsets)
        got[side] = (opened, file_bytes(paths), dlq)
    assert got["port"] == got["ref"]


def v1_file(path, tag, payload, state=1, crc=None):
    """A v1 chunk file (no routes field), as the reference's first
    layout wrote it."""
    t = tag.encode()
    if crc is None:
        crc = zlib.crc32(payload) & 0xFFFFFFFF
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sBBBBIH", b"FBTC", 1, 0, state, 0, crc,
                            len(t)) + t + payload)


def make_case(case, writer, root, seed):
    """A root of ``case`` written by ``writer``; returns the names of the
    files that must go to the DLQ as corrupt."""
    specs = chunk_specs(seed)
    if case == "v1":
        encode = SIDE[writer][2]
        payload = b"".join(encode({"k": i}, 5.0 + i) for i in range(7))
        v1_file(os.path.join(root, "streams", "old.0", "9-aa.flb"), "v1tag",
                payload)
        v1_file(os.path.join(root, "streams", "old.0", "10-bb.flb"), "open",
                payload[:-3], state=0, crc=0)
        os.makedirs(os.path.join(root, "dlq"), exist_ok=True)
        return []
    finalize = case in ("final", "bad_crc", "no_sidecar")
    st, paths = write_root(writer, root, specs, finalize=finalize)
    st.close()
    if case == "torn":
        # the last append cut inside its last record, the sidecar
        # ahead of the payload (the crash window between the flushes)
        with open(paths[0], "r+b") as f:
            f.truncate(os.path.getsize(paths[0]) - 3)
    if case == "no_sidecar":
        for p in paths:
            os.unlink(p + ".offs")
    if case == "bad_crc":
        with open(paths[1], "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
        return [os.path.basename(paths[1]) + ".corrupt"]
    return []


@pytest.mark.parametrize("case", ["final", "open", "torn", "v1", "bad_crc",
                                  "no_sidecar"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_recovers_the_others_root(case, writer, tmp_path):
    """Whoever wrote the root, both packages recover the same chunks from
    it, put the same files into ``dlq/*.corrupt``, and read the same
    DLQ."""
    root = str(tmp_path / "root")
    corrupt = make_case(case, writer, root, seed=len(case))
    got = {}
    for reader in ("ref", "port"):
        copy = str(tmp_path / reader)
        shutil.copytree(root, copy)
        st = SIDE[reader][0](copy, checksum=True)
        chunks = [chunk_view(c) for c in st.scan_backlog()]
        dlq_names = sorted(os.listdir(os.path.join(copy, "dlq")))
        got[reader] = (chunks, dlq_names,
                       [chunk_view(c) for c in st.dlq_chunks()])
        st.close()
    assert got["port"] == got["ref"]
    chunks, dlq_names, _ = got["port"]
    assert chunks and all(c[3] > 0 for c in chunks)
    assert [n for n in dlq_names if n.endswith(".corrupt")] == corrupt
    if case == "torn":
        # the torn record is cut: the chunk keeps its whole records only
        evs = decode_events(chunks[0][4])
        assert len(evs) == chunks[0][3]


@pytest.mark.parametrize("finalize", [True, False])
def test_replay_routes_give_the_same_chunks(finalize, tmp_path):
    """The sidecar's mmap route and the decode walk recover equal chunks
    in the port, equal to the reference's, and the port counts each
    route."""
    root = str(tmp_path / "root")
    st, paths = write_root("port", root, chunk_specs(7), finalize=finalize)
    st.close()
    n = len(paths)
    views = set()
    for route in ("sidecar", "walk"):
        for side in ("port", "ref"):
            copy = str(tmp_path / f"{route}-{side}")
            shutil.copytree(root, copy)
            if route == "walk":
                for p in glob.glob(os.path.join(copy, "streams", "*",
                                                "*.offs")):
                    os.unlink(p)
            st = SIDE[side][0](copy, checksum=True)
            views.add(tuple(chunk_view(c) for c in st.scan_backlog()))
            if side == "port":
                assert (st.replay_sidecar_hits, st.replay_sidecar_trusted,
                        st.replay_decode_walks) == (
                    (n, n if finalize else 0, 0) if route == "sidecar"
                    else (0, 0, n))
            st.close()
    assert len(views) == 1


# ------------------------------------------------------------ engines


def config1(pkg_entry, root, appends, outputs=(("lib", {}),),
            filesystem=True, during=None, service=None, grep=True):
    """Config 1 (lib → grep apache2 → ``outputs``) over ``root``; the
    appends go in through ``input_log_append`` under the engine's lock
    before the first cycle drains. Returns the context and each lib
    output's (tag, bytes)."""
    pkg, _eng, _plugin, _config, encode = pkg_entry
    kw = {"flush": "50ms", "grace": "1", "storage.path": root,
          "storage.checksum": "on", "scheduler.base": "0.05",
          "scheduler.cap": "0.1", **(service or {})}
    ctx = pkg.create(device="cpu", **kw) if pkg is port else pkg.create(**kw)
    ctx.input("lib", tag="app.log",
              **({"storage.type": "filesystem"} if filesystem else {}))
    if grep:
        ctx.filter("grep", match="app.*", regex="log " + APACHE2)
    sinks = []
    for name, props in outputs:
        got = []
        if name == "lib":
            props = {**props,
                     "callback": lambda d, t, got=got: got.append((t, d))}
        ctx.output(name, match="*", **props)
        sinks.append(got)
    ctx.start()
    try:
        e = ctx.engine
        with e._ingest_lock:
            for recs in appends:
                e.input_log_append(e.inputs[0], "app.log", b"".join(
                    encode(body, ts) for ts, body in recs))
        if during is not None:
            during(ctx)
    finally:
        ctx.stop()
    return ctx, sinks


def wait_for(cond, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached")


def settle(e):
    wait_for(lambda: not e._task_map and not e._backlog
             and not e._pending_retries)


def in_backoff(ctx):
    """Wait (on the flush timer, not ``flush_now``, which waits for the
    retries in both packages) until a retry is in backoff."""
    wait_for(lambda: ctx.engine._pending_retries)


def streams(root):
    return sorted(glob.glob(os.path.join(root, "streams", "*", "*.flb")))


def dlq_payloads(root, side="port"):
    st = SIDE[side][0](root, checksum=True)
    try:
        return sorted((c.tag, c.records, c.get_bytes())
                      for c in st.dlq_chunks())
    finally:
        st.close()


@pytest.mark.parametrize("filesystem", [True, False])
def test_config1_with_storage_equals_reference(filesystem, tmp_path):
    """Equal lib bytes with storage on; no stream file after delivery."""
    appends = make_appends(seed=11, sizes=(64, 5, 40, 33))
    got = {}
    for pkg_entry, name in zip(PACKAGES, ("ref", "port")):
        root = str(tmp_path / name)
        ctx, (sink,) = config1(pkg_entry, root, appends,
                               filesystem=filesystem,
                               during=lambda c: (c.flush_now(),
                                                 settle(c.engine)))
        got[name] = b"".join(d for _t, d in sink)
        assert streams(root) == []
        assert not os.listdir(os.path.join(root, "dlq"))
    assert got["port"] == got["ref"] and got["port"]


def test_retry_keeps_the_file_until_delivered(both, tmp_path):
    """Under RETRY the chunk's file stays on disk; the retry delivers it
    and the file goes, in both packages."""
    def slow(base, cap, attempt, rng=None):
        return 0.4

    both(slow)
    appends = make_appends(seed=3, sizes=(40,))
    seen = {}
    for pkg_entry, name in zip(PACKAGES, ("ref", "port")):
        root = str(tmp_path / name)

        def during(ctx, root=root, name=name):
            e = ctx.engine
            in_backoff(ctx)
            files = streams(root)
            time.sleep(0.1)  # in backoff
            seen[name] = (len(files), len(streams(root)))
            settle(e)
            seen[name] += (len(streams(root)),
                           len(e.outputs[0].plugin.delivered))

        config1(pkg_entry, root, appends,
                outputs=(("delivery_probe", {"script": "retry,ok",
                                             "retry_limit": "3"}),),
                during=during)
    assert seen["port"] == seen["ref"] == (1, 1, 0, 1)


@pytest.mark.parametrize("filesystem", [True, False])
def test_error_quarantines_equal_payloads(both, filesystem, tmp_path):
    """An ERROR drops the chunk into the DLQ (memory or filesystem), the
    same payloads in both packages, and leaves no stream file."""
    appends = make_appends(seed=5, sizes=(40, 7))
    got = {}
    for pkg_entry, name in zip(PACKAGES, ("ref", "port")):
        root = str(tmp_path / name)
        config1(pkg_entry, root, appends, filesystem=filesystem,
                outputs=(("delivery_probe", {"script": "error"}),),
                during=lambda c: (c.flush_now(), settle(c.engine)))
        assert streams(root) == []
        got[name] = dlq_payloads(root)
    assert got["port"] == got["ref"] and got["port"]


def test_stop_with_pending_retries(both, tmp_path):
    """A stop with retries pending: a memory chunk goes to the DLQ, a
    filesystem chunk stays on disk for the next start, equal in both."""
    def slow(base, cap, attempt, rng=None):
        return 30.0

    both(slow)
    appends = make_appends(seed=9, sizes=(40,))
    got = {}
    for pkg_entry, name in zip(PACKAGES, ("ref", "port")):
        for filesystem in (False, True):
            root = str(tmp_path / f"{name}{filesystem}")

            config1(pkg_entry, root, appends, filesystem=filesystem,
                    outputs=(("delivery_probe", {"script": "retry",
                                                 "retry_limit": "5"}),),
                    during=in_backoff)
            kept = [SIDE["port"][0](root).scan_backlog()]
            got[name, filesystem] = (
                dlq_payloads(root),
                [(c.tag, c.records, c.get_bytes()) for c in kept[0]])
    for fs in (False, True):
        assert got["port", fs] == got["ref", fs]
    assert got["port", False][0] and not got["port", False][1]
    assert got["port", True][1] and not got["port", True][0]


@pytest.mark.parametrize("first", ["ref", "port"])
def test_restart_delivers_the_backlog_first(first, both, tmp_path):
    """Chunks left on disk by a run whose output never delivered (the
    ``first`` package) are delivered by the next start before its new
    records, by either package over the same root."""
    def slow(base, cap, attempt, rng=None):
        return 30.0

    both(slow)
    old = make_appends(seed=21, sizes=(40, 35))
    new = make_appends(seed=22, sizes=(36,))
    entry = dict(zip(("ref", "port"), PACKAGES))
    got = {}
    for second in ("ref", "port"):
        root = str(tmp_path / second)
        config1(entry[first], root, old,
                outputs=(("delivery_probe", {"script": "retry",
                                             "retry_limit": "5"}),),
                during=in_backoff)
        assert len(streams(root)) == 1
        ctx, (sink,) = config1(entry[second], root, new,
                               during=lambda c: (c.flush_now(),
                                                 settle(c.engine)))
        got[second] = [ev.body for _t, d in sink for ev in decode_events(d)]
        assert streams(root) == []
    assert got["port"] == got["ref"]
    want_old = [b for recs in old for _ts, b in recs
                if isinstance(b.get("log"), str)]
    assert len(got["port"]) > len(new[0]) // 2
    assert got["port"][0] in want_old  # the backlog came first


def test_shed_chunk_is_written_through(tmp_path):
    """The guard sheds a memory chunk: with storage on, it is written
    through and finalized (the same file in both packages); readmitted
    at stop, it is delivered and its file deleted."""
    got = {}
    for pkg_entry, name in zip(PACKAGES, ("ref", "port")):
        pkg, _eng, _plugin, _config, encode = pkg_entry
        root = str(tmp_path / name)
        kw = {"flush": "50ms", "grace": "1", "storage.path": root,
              "storage.checksum": "on"}
        ctx = pkg.create(device="cpu", **kw) if pkg is port \
            else pkg.create(**kw)
        out = []
        ctx.output("lib", match="*", alias="a",
                   callback=lambda d, t: out.append(d))
        ctx.start()
        try:
            chunk = SIDE[name][1]("t.shed")
            data = b"".join(encode({"i": i}, 1.0 + i) for i in range(5))
            chunk.append(data, 5)
            ctx.engine.guard._shed_chunk(chunk, ["a"])
            files = file_bytes(streams(root))
        finally:
            ctx.stop()
        got[name] = (files, b"".join(out), streams(root))
    assert got["port"] == got["ref"]
    files, delivered, left = got["port"]
    assert len(files) == 1 and delivered and left == []

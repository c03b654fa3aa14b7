"""The storage failpoint sites and the crash-recovery soak of the port.

Each failpoint site that storage brings (``storage.append``,
``storage.flush``, ``storage.finalize``, ``storage.crc_verify``,
``storage.backlog_load``, ``engine.shutdown_quarantine``) armed in the
port's plane has the outcome the same site has in the reference's plane:
what raises, what lands on disk, what recovers and what reaches the DLQ.

The soak (``fluentbit_tpu_torch.failpoints.soak``) runs the port in a
child process on ``device="cpu"`` with filesystem storage, kills it with
a ``crash`` failpoint mid-run, restarts it over the same root and holds
the runs to the durability contract. The short matrix (a crash at
``storage.append``, at ``storage.finalize`` and at
``engine.flush_dispatch`` with a chunk then corrupted on disk) runs its
three scenarios side by side; the full matrix is marked ``slow``.
"""

import os
import time

import numpy as np
import pytest

import fluentbit_tpu as ref
import fluentbit_tpu_torch as port
from fluentbit_tpu import failpoints as rfp
from fluentbit_tpu.codec.chunk import Chunk as RefChunk
from fluentbit_tpu.codec.events import encode_event as ref_encode
from fluentbit_tpu.core.storage import Storage as RefStorage
from fluentbit_tpu_torch import failpoints as tfp
from fluentbit_tpu_torch.codec.chunk import Chunk as PortChunk
from fluentbit_tpu_torch.codec.events import encode_event
from fluentbit_tpu_torch.core.storage import Storage as PortStorage
from fluentbit_tpu_torch.failpoints import soak
from test_torch_delivery import both  # noqa: F401 (fixture)

SIDE = {"ref": (RefStorage, RefChunk, ref_encode, rfp),
        "port": (PortStorage, PortChunk, encode_event, tfp)}


@pytest.fixture(autouse=True)
def clean_planes():
    rfp.reset()
    tfp.reset()
    yield
    rfp.reset()
    tfp.reset()


def appends(seed, n=3):
    rng = np.random.default_rng(seed)
    return [[{"seq": int(i), "log": "z" * int(rng.integers(1, 40))}
             for i in range(int(rng.integers(2, 6)))] for _ in range(n)]


def storage_outcome(side, root, site, spec):
    """Write three appends and finalize one chunk with ``site`` armed,
    then recover the root: what raised at each step, the files on disk
    and what the recovery gives."""
    Storage, Chunk, encode, plane = SIDE[side]
    st = Storage(root, checksum=True)
    c = Chunk("t", "logs", "lib.0")
    raised = []
    at_write = site in ("storage.append", "storage.flush",
                        "storage.finalize")
    if at_write:
        plane.enable(site, spec)
    for k, bodies in enumerate(appends(len(site))):
        data = b"".join(encode(b, 1.0 + i) for i, b in enumerate(bodies))
        c.append(data, len(bodies))
        try:
            st.write_through(c, data)
            raised.append(None)
        except OSError as e:
            raised.append(type(e).__name__)
    try:
        st.finalize(c)
        raised.append(None)
    except OSError as e:
        raised.append(type(e).__name__)
    st.close()
    plane.reset()
    files = sorted((os.path.relpath(p, root).split(os.sep)[0],
                    open(p, "rb").read())
                   for p in _files(root) if p.endswith(".flb"))
    if not at_write:
        plane.enable(site, spec)
    try:
        got = Storage(root, checksum=True).scan_backlog()
        recovered = [(x.tag, x.records, x.get_bytes()) for x in got]
    except OSError as e:
        recovered = type(e).__name__
    dlq = sorted(n.endswith(".corrupt")
                 for n in os.listdir(os.path.join(root, "dlq")))
    return raised, files, recovered, dlq


def _files(root):
    for dirpath, _dirs, names in os.walk(root):
        for n in names:
            yield os.path.join(dirpath, n)


@pytest.mark.parametrize("site,spec", [
    ("storage.append", "1*off->1*partial(6)"),
    ("storage.append", "1*off->1*return"),
    ("storage.flush", "2*off->1*return"),
    ("storage.finalize", "return"),
    ("storage.crc_verify", "return"),
    ("storage.backlog_load", "return"),
])
def test_storage_sites_have_the_reference_outcome(site, spec, tmp_path):
    got = {side: storage_outcome(side, str(tmp_path / side), site, spec)
           for side in ("ref", "port")}
    assert got["port"] == got["ref"]
    raised, _files_, recovered, dlq = got["port"]
    if site == "storage.crc_verify":
        assert recovered == [] and dlq == [True]
    elif site == "storage.backlog_load":
        assert recovered == "FailpointError"
    else:
        assert "FailpointError" in raised or site == "storage.append"


def test_shutdown_quarantine_site_has_the_reference_outcome(both, tmp_path):
    """``engine.shutdown_quarantine`` armed: the stop's quarantine of a
    memory chunk whose retry is pending fails (logged), so the DLQ stays
    empty, and the drop is still counted, in both packages."""
    def slow(base, cap, attempt, rng=None):
        return 30.0

    both(slow)
    got = {}
    for side, pkg in (("ref", ref), ("port", port)):
        root = str(tmp_path / side)
        kw = {"flush": "50ms", "grace": "1", "storage.path": root}
        ctx = pkg.create(device="cpu", **kw) if pkg is port \
            else pkg.create(**kw)
        ffd = ctx.input("lib", tag="t")
        ctx.output("delivery_probe", match="t", script="retry",
                   retry_limit="5")
        ctx.start()
        SIDE[side][3].enable("engine.shutdown_quarantine", "return")
        try:
            ctx.push(ffd, '[{"a": 1}, {"a": 2}]')
            deadline = time.time() + 5
            while not ctx.engine._pending_retries and time.time() < deadline:
                time.sleep(0.01)
        finally:
            ctx.stop()
        snap = SIDE[side][3].snapshot()["engine.shutdown_quarantine"]
        e = ctx.engine
        got[side] = (os.listdir(os.path.join(root, "dlq")),
                     e.m_out_dropped.get((e.outputs[0].display_name,)),
                     snap["triggered"])
    assert got["port"] == got["ref"] == ([], 2, 1)


def test_sites_listed():
    for site in ("storage.append", "storage.flush", "storage.finalize",
                 "storage.crc_verify", "storage.backlog_load",
                 "engine.shutdown_quarantine", "flux.snapshot"):
        assert site in tfp.SITES and site in rfp.SITES


def test_flux_snapshot_site_keeps_the_old_snapshot(tmp_path):
    """``flux.snapshot`` armed: the write raises after the synced
    temporary file, which is removed, and the old snapshot stays whole,
    in both packages."""
    from fluentbit_tpu.flux.state import FluxState as RefState
    from fluentbit_tpu_torch.flux.state import FluxState

    got = {}
    for side, cls in (("ref", RefState), ("port", FluxState)):
        path = str(tmp_path / side / "snap.pkl")
        os.makedirs(os.path.dirname(path))
        cls.write_snapshot({"v": 1}, path)
        with open(path, "rb") as f:
            old = f.read()
        SIDE[side][3].enable("flux.snapshot", "return")
        try:
            cls.write_snapshot({"v": 2}, path)
            raised = None
        except OSError as e:
            raised = type(e).__name__
        with open(path, "rb") as f:
            got[side] = (raised, f.read() == old,
                         sorted(os.listdir(os.path.dirname(path))))
    assert got["port"] == got["ref"] == ("FailpointError", True,
                                         ["snap.pkl"])


# ------------------------------------------------------------- the soak


def corrupt_one_chunk(outcome):
    """Flip the last payload byte of one on-disk chunk; returns the
    sequences it carried (read before the flip)."""
    files = [p for p in outcome.stream_files() if p.endswith(".flb")]
    assert files, "the scenario expected chunks on disk at the crash"
    path = files[0]
    st = PortStorage(os.path.join(outcome.workdir, soak.STORAGE_DIR),
                     checksum=True)
    from fluentbit_tpu_torch.codec.events import decode_events

    seqs = [ev.body["seq"] for ev in decode_events(
        st._read_chunk_file(path).get_bytes())]
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    return seqs


SHORT = {
    # SIGKILL on the 13th storage append: every acked record recovers
    # from the open chunk
    "append": dict(records=30, failpoints="storage.append=12*off->1*crash"),
    # SIGKILL before the CRC stamp at the drain: the open chunk replays
    # whole
    "finalize": dict(records=20, flush="5s", final_flush=True,
                     failpoints="storage.finalize=1*crash"),
    # SIGKILL after the finalize, before any delivery; then one chunk
    # is corrupted on disk
    "dispatch": dict(records=24, tags=3, flush="5s", final_flush=True,
                     failpoints="engine.flush_dispatch=1*crash"),
}


@pytest.fixture(scope="module")
def short_matrix(tmp_path_factory):
    """The short matrix's three scenarios side by side: the ingest
    children together, the corruption, then the recover children
    together."""
    base = tmp_path_factory.mktemp("soak")
    dirs = {name: str(base / name) for name in SHORT}
    procs = {name: soak.spawn_child(dirs[name], "ingest", device="cpu",
                                    run_id="1", **kw)
             for name, kw in SHORT.items()}
    rcs = {name: soak.wait_child(p, dirs[name]) for name, p in procs.items()}
    before = {name: soak.SoakOutcome(d) for name, d in dirs.items()}
    bad = corrupt_one_chunk(before["dispatch"])
    procs = {name: soak.spawn_child(d, "recover", device="cpu", run_id="2")
             for name, d in dirs.items()}
    rcs2 = {name: soak.wait_child(p, dirs[name]) for name, p in procs.items()}
    return {name: (rcs[name], rcs2[name], before[name],
                   soak.SoakOutcome(dirs[name])) for name in SHORT}, bad


@pytest.mark.parametrize("name", sorted(SHORT))
def test_soak_short_matrix(name, short_matrix):
    runs, bad = short_matrix
    rc1, rc2, before, outcome = runs[name]
    assert rc1 in (-9, 137) and rc2 == 0
    acked = {"append": 12, "finalize": 20, "dispatch": 24}[name]
    assert len(outcome.acked) == acked
    if name == "dispatch":
        assert not before.delivered_all(), "the crash preceded delivery"
        assert bad
        soak.verify_contract(outcome, restarts=1, quarantined=bad)
        assert any(n.endswith(".corrupt") for n in outcome.dlq_files())
    else:
        soak.verify_contract(outcome, restarts=1)
    assert not [p for p in outcome.stream_files() if p.endswith(".flb")], \
        "delivered chunks must be deleted"


def test_contract_check_catches_a_loss_and_a_duplicate(tmp_path):
    """The contract check itself: an acked record never delivered, and
    a record delivered twice in one run, each fail it."""
    d = str(tmp_path)
    for line in ("0", "1", "2"):
        soak._append_line(os.path.join(d, soak.INGESTED_LOG), line)
    soak._append_line(os.path.join(d, soak.DELIVERED_LOG),
                      '{"run": "1", "tag": "t", "seqs": [0, 1, 1]}')
    with pytest.raises(AssertionError, match="lost"):
        soak.verify_contract(soak.SoakOutcome(d), restarts=1)
    soak.verify_contract(soak.SoakOutcome(d), restarts=1,
                         allowed_missing=[2], declared_retries=1)
    with pytest.raises(AssertionError, match="within one run"):
        soak.verify_contract(soak.SoakOutcome(d), restarts=1,
                             allowed_missing=[2])


@pytest.mark.slow
class TestSoakFullMatrix:
    """The rest of the reference's matrix: each an ingest crash and a
    recovery over a fresh root."""

    def test_crash_unflushed_write(self, tmp_path):
        """SIGKILL between the write and its flush: the buffered append
        is the only loss."""
        d = str(tmp_path)
        rc = soak.run_child(d, "ingest", device="cpu", records=30,
                            run_id="1",
                            failpoints="storage.flush=10*off->1*crash")
        assert rc in (-9, 137)
        assert soak.run_child(d, "recover", device="cpu", run_id="2") == 0
        outcome = soak.SoakOutcome(d)
        assert len(outcome.acked) == 10
        soak.verify_contract(outcome, restarts=1)

    def test_crash_scheduling_retry(self, tmp_path):
        d = str(tmp_path)
        rc = soak.run_child(
            d, "ingest", device="cpu", records=20, flush="5s",
            final_flush=True, run_id="1",
            failpoints="soak.deliver=return;engine.retry_schedule=1*crash")
        assert rc in (-9, 137)
        assert soak.run_child(d, "recover", device="cpu", run_id="2") == 0
        outcome = soak.SoakOutcome(d)
        assert len(outcome.acked) == 20
        soak.verify_contract(outcome, restarts=1, declared_retries=1)

    def test_crash_during_backlog_recovery(self, tmp_path):
        d = str(tmp_path)
        rc = soak.run_child(d, "ingest", device="cpu", records=16,
                            run_id="1",
                            failpoints="storage.append=8*off->1*crash")
        assert rc in (-9, 137)
        rc = soak.run_child(d, "recover", device="cpu", run_id="2",
                            failpoints="storage.backlog_load=1*crash")
        assert rc in (-9, 137)
        assert soak.run_child(d, "recover", device="cpu", run_id="3") == 0
        outcome = soak.SoakOutcome(d)
        assert len(outcome.acked) == 8
        soak.verify_contract(outcome, restarts=2)

    def test_torn_write_then_crash(self, tmp_path):
        d = str(tmp_path)
        rc = soak.run_child(
            d, "ingest", device="cpu", records=30, flush="5s", run_id="1",
            failpoints="storage.append=10*off->1*partial(6)->1*crash")
        assert rc in (-9, 137)
        assert soak.run_child(d, "recover", device="cpu", run_id="2") == 0
        outcome = soak.SoakOutcome(d)
        assert len(outcome.acked) == 11
        soak.verify_contract(outcome, restarts=1, allowed_missing=[10])
        assert 10 not in set(outcome.delivered_all())

    def test_crash_after_partial_delivery_duplicates_bounded(self,
                                                              tmp_path):
        d = str(tmp_path)
        rc = soak.run_child(
            d, "ingest", device="cpu", records=40, tags=4, flush="100ms",
            run_id="1", failpoints="storage.append=35*off->1*crash")
        assert rc in (-9, 137)
        assert soak.run_child(d, "recover", device="cpu", run_id="2") == 0
        soak.verify_contract(soak.SoakOutcome(d), restarts=1)

    def test_crash_mid_batch_on_the_grep_raw_path(self, tmp_path):
        """Config 1's grep on the path, appends of 512 records: the raw
        path's write-through crashes on the fifth append."""
        d = str(tmp_path)
        rc = soak.run_child(d, "ingest", device="cpu", records=4096,
                            batch=512, grep=True, run_id="1",
                            failpoints="storage.append=4*off->1*crash")
        assert rc in (-9, 137)
        assert soak.run_child(d, "recover", device="cpu", run_id="2") == 0
        outcome = soak.SoakOutcome(d)
        assert len(outcome.acked) == 4 * 512
        soak.verify_contract(outcome, restarts=1)

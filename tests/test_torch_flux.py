"""The port's flux plane (K9, K10, FluxState) against the reference's.

``fluentbit_tpu_torch.flux`` on the CPU runs the kernels' plain torch
versions (``segment_counts_plain``, ``fused_absorb_plain``); counts,
register stacks and tables must equal the reference package's
``segment_counts`` / ``fused_absorb`` (JAX's CPU backend) and its host
twin exactly (tolerance 0). Whole states must equal the reference's
``FluxState`` on its host route and on the simulated mesh
(``mesh=True``) — groups, counts, column stats (floats compared bit for
bit), registers, table, candidates and counters — over tumbling,
hopping and event-time windows with an injected clock, on both sides of
the 512-group cap (above it, one grouped K6 per distinct field).
Snapshots restore across the two packages both ways.
The CUDA kernel is held against the plain versions in
tests/test_torch_gpu.py.
"""

import pickle
import random
import struct

import numpy as np
import pytest
import torch

from fluentbit_tpu.codec.events import decode_events as jdecode
from fluentbit_tpu.codec.events import encode_event as jencode
from fluentbit_tpu.flux import kernels as jk
from fluentbit_tpu.flux.state import FluxSpec as JSpec
from fluentbit_tpu.flux.state import FluxState as JState
from fluentbit_tpu.flux.state import WindowSpec as JWindow
from fluentbit_tpu.ops import sketch as jsk
from fluentbit_tpu_torch.codec.events import decode_events as tdecode
from fluentbit_tpu_torch.flux import kernels as tk
from fluentbit_tpu_torch.flux import state as tstate
from fluentbit_tpu_torch.flux.state import FluxSpec as TSpec
from fluentbit_tpu_torch.flux.state import FluxState as TState
from fluentbit_tpu_torch.flux.state import WindowSpec as TWindow
from fluentbit_tpu_torch.ops import sketch as tsk
from fluentbit_tpu_torch.ops.mesh import Mesh


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K9 and K10 against the reference's programs
# ---------------------------------------------------------------------------


def seg_valid(rng, B, n_seg, pad=0):
    """Segment ids and a valid column; ``pad`` trailing pad rows (segment
    0, valid 0), as the reference's buckets make them."""
    seg = rng.integers(0, n_seg, size=B).astype(np.int32)
    valid = np.ones(B, dtype=np.int32)
    if pad:
        seg[-pad:] = 0
        valid[-pad:] = 0
    return seg, valid


@pytest.mark.parametrize("B,n_seg,pad", [(0, 1, 0), (1, 1, 0), (17, 7, 5),
                                         (4096, 200, 100)])
def test_segment_counts_equal_reference(B, n_seg, pad):
    rng = np.random.default_rng(B + n_seg)
    seg, valid = seg_valid(rng, B, n_seg, pad)
    want = jk.segment_counts(seg, valid, n_seg)
    assert np.array_equal(jk.host_segment_counts(seg, valid, n_seg), want)
    assert np.array_equal(tk.host_segment_counts(seg, valid, n_seg), want)
    assert np.array_equal(
        tk.segment_counts_plain(t(seg), t(valid), n_seg).numpy(), want)
    before = tk.segment_counts.launches
    assert np.array_equal(tk.segment_counts(t(seg), t(valid), n_seg).numpy(),
                          want)
    assert tk.segment_counts.launches == before  # CPU: the plain version


def field_rows(rng, B, L, invalid=False):
    """Rows with every length class (-1, 0, L and random) and repeated
    values, so that scatters collide; all invalid when asked."""
    batch = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(-1, L + 1, size=B).astype(np.int32)
    special = np.array([-1, 0, L, -1], dtype=np.int32)[:B]
    lengths[:len(special)] = special
    if B > 12:
        batch[8:12] = batch[4]
        lengths[8:12] = lengths[4]
    if invalid:
        lengths[:] = -1
    return batch, lengths


# (distinct fields F, groups G, composites, rows B, width L, all invalid)
FUSED_CASES = [(1, 1, False, 0, 16, False), (1, 7, True, 1, 16, False),
               (2, 7, True, 17, 0, False), (1, 200, True, 4096, 32, False),
               (2, 200, False, 17, 256, False), (1, 7, True, 17, 16, True),
               (2, 1, True, 300, 16, False)]


@pytest.mark.parametrize("F,G,comp,B,L,invalid", FUSED_CASES)
def test_fused_absorb_equal_reference(F, G, comp, B, L, invalid):
    p = 12
    rng = np.random.default_rng(F * 1000 + G + B + L)
    pad = min(B, 3)
    seg, valid = seg_valid(rng, B, G, pad)
    fields = [field_rows(rng, B, L, invalid) for _ in range(F)]
    for _, ln in fields:
        ln[B - pad:] = -1  # pad rows carry length -1
    regs = [[rng.integers(0, 6, size=1 << p).astype(np.int32)
             for _ in range(G)] for _ in range(F)]
    cms = jsk.CountMin(depth=4, width=512)
    table = rng.integers(0, 1 << 20, size=(4, 512)).astype(np.int32)
    c = cl = None
    if comp:
        c, cl = field_rows(rng, B + 5, L, invalid)
    want_counts, want_regs, want_table = jk.fused_absorb(
        seg, valid, fields, regs, c, cl, table if comp else None,
        hll_p=p, cms=cms if comp else None, n_seg=G)
    stacks = [t(np.stack(r)) for r in regs]
    got_table = t(table.copy())
    got_counts = tk.fused_absorb(
        t(seg), t(valid), [(t(b), t(ln)) for b, ln in fields], stacks,
        None if c is None else t(c), None if cl is None else t(cl),
        got_table if comp else None, hll_p=p, n_seg=G)
    assert np.array_equal(got_counts.numpy(), np.asarray(want_counts))
    for stack, want in zip(stacks, want_regs):
        assert np.array_equal(stack.numpy(), np.asarray(want)[:G])
    if comp:
        assert np.array_equal(got_table.numpy(), np.asarray(want_table))
        if not invalid:
            assert not np.array_equal(got_table.numpy(), table)
    if invalid:  # nothing but the counts moves
        for stack, r in zip(stacks, regs):
            assert np.array_equal(stack.numpy(), np.stack(r))


def test_wrappers_take_the_plain_version_on_cpu_and_raise_elsewhere():
    seg = torch.zeros(4, dtype=torch.int32)
    before = (tk.fused_absorb.launches, tk.segment_counts.launches)
    got = tk.fused_absorb(seg, torch.ones(4, dtype=torch.int32), [], [],
                          hll_p=12, n_seg=2)
    assert got.tolist() == [4, 0]
    meta = seg.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_absorb(meta, meta, [], [], hll_p=12, n_seg=2)
    with pytest.raises(ValueError, match="CUDA"):
        tk.segment_counts(meta, meta, 2)
    assert (tk.fused_absorb.launches, tk.segment_counts.launches) == before


# ---------------------------------------------------------------------------
# whole states against the reference's FluxState
# ---------------------------------------------------------------------------


def fbits(x):
    """A float compared bit for bit (NaN included), anything else as is."""
    return struct.pack("<d", x) if isinstance(x, float) else x


def group_print(key, g):
    cols = {f: tuple(fbits(v) for v in (st.has, st.sum, st.min, st.max,
                                         st.min_int, st.max_int))
            for f, st in g.cols.items()}
    hlls = {f: np.asarray(h.registers).tobytes() for f, h in g.hlls.items()}
    return key, g.count, cols, hlls


def fingerprint(state):
    """Groups (open pane, hopping panes, event windows), counts, column
    stats, registers, table, candidates and counters."""
    return ([group_print(k, g) for k, g in state._groups.items()],
            [[group_print(k, g) for k, g in p.items()]
             for p in state._panes],
            {w: [group_print(k, g) for k, g in p.items()]
             for w, p in state._event_windows.items()},
            None if state.cms is None
            else np.asarray(state.cms.table).tobytes(),
            {k: list(v) for k, v in state._candidates.items()},
            (state.records_total, state.late_records_total,
             state.window_emits_total, state.batches_total),
            fbits(state._window_start), state._watermark)


def closed_print(state, closed):
    """A closed window as the filter renders it: each group's print, its
    HLL estimates and its top-k."""
    out = []
    for key, g in closed:
        est = {f: h.estimate() for f, h in g.hlls.items()}
        out.append((group_print(key, g), est, state.topk(key)))
    return out


def corpus(seed, n, tenants=("a", "b", None, "c"), users=40, long_every=0):
    """Records in the shape of tests/test_flux.py's corpus: a missing
    tenant, ints, floats, inf and NaN, non-numeric values, booleans, a
    non-map body; ``long_every`` adds users longer than max_len."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        body = {"tenant": rng.choice(tenants),
                "user": f"u{rng.randrange(users)}",
                "size": rng.choice([rng.randrange(10**9),
                                    rng.random() * 100, "NaNish", None,
                                    True])}
        if body["tenant"] is None:
            del body["tenant"]
        x = rng.random()
        if x < 0.08:
            body["size"] = float("inf")
        elif x < 0.12:
            body["size"] = float("nan")
        elif x < 0.14:
            body["size"] = -float("inf")
        if long_every and i % long_every == 0:
            body["user"] = "L" * 300
        out.append(body)
    out.append("not-a-dict")
    return out


def encode(bodies, ts0):
    return b"".join(jencode(b, ts0 + i * 0.5) for i, b in enumerate(bodies))


class Pair:
    """The port's CPU state beside the reference's (host route, and the
    mesh route when asked; the port's over a hand-built 8-shard CPU mesh
    with ``port_mesh``), fed the same bytes under one clock."""

    def __init__(self, mesh=False, port_mesh=False, **kw):
        self.clock = [1000.0]
        now = lambda: self.clock[0]  # noqa: E731
        jkw = dict(kw)
        tkw = dict(kw)
        for d, W in ((jkw, JWindow), (tkw, TWindow)):
            if "window" in d:
                d["window"] = W(*d["window"])
        self.ref = JState(JSpec("t", mesh=mesh, **jkw), now=now)
        if mesh:
            assert self.ref._mesh is not None
        self.port = TState(TSpec("t", mesh=port_mesh, **tkw), now=now,
                           device="cpu")
        if port_mesh:
            self.port._mesh = Mesh((torch.device("cpu"),) * 8, "flux")

    def absorb(self, bodies, ts0=1000.0):
        buf = encode(bodies, ts0)
        self.ref.absorb_events(jdecode(buf))
        self.port.absorb_events(tdecode(buf))
        self.check()

    def tick(self, at):
        self.clock[0] = at
        want = closed_print(self.ref, self.ref.tick())
        assert closed_print(self.port, self.port.tick()) == want
        self.check()
        return want

    def drain(self):
        want = closed_print(self.ref, self.ref.drain())
        assert closed_print(self.port, self.port.drain()) == want
        return want

    def check(self):
        assert fingerprint(self.port) == fingerprint(self.ref)


SPEC = dict(group_by=("tenant",), distinct=("user",), numeric=("size",),
            topk_field="user", topk=3)
# the simulated mesh lane needs the virtual 8-device CPU mesh
ROUTES = ["host", "mesh"]


def _mesh(route):
    if route == "mesh" and len(__import__("jax").devices()) < 8:
        pytest.skip("need the simulated 8-device mesh")
    return route == "mesh"


@pytest.mark.parametrize("route", ROUTES)
def test_tumbling_windows_equal_reference(route):
    pair = Pair(mesh=_mesh(route), window=("tumbling", 60), **SPEC)
    pair.absorb(corpus(1, 120))
    pair.absorb(corpus(2, 60, long_every=7))
    assert pair.tick(1059.0) == []
    assert len(pair.tick(1060.0)) == 4             # a, b, c and missing
    pair.absorb(corpus(3, 90))
    assert pair.tick(1125.0)
    pair.absorb(corpus(4, 30))
    assert pair.drain()


@pytest.mark.parametrize("route", ROUTES)
def test_hopping_windows_equal_reference(route):
    pair = Pair(mesh=_mesh(route), window=("hopping", 60, 20), **SPEC)
    pair.absorb(corpus(5, 80))
    assert pair.tick(1020.0)
    pair.absorb(corpus(6, 40))
    assert pair.tick(1040.0)                       # panes merge
    pair.absorb(corpus(7, 40))
    pair.tick(1085.0)                              # the first pane slid out
    pair.absorb(corpus(8, 20))
    assert pair.drain()


def test_event_time_windows_equal_reference():
    pair = Pair(window=("tumbling", 60), event_time=True, **SPEC)
    pair.absorb(corpus(9, 60), ts0=1025.0)         # w17 (1020..1080)
    pair.absorb(corpus(10, 20), ts0=1021.0)        # in-window disorder
    assert pair.tick(2000.0) == []                 # the clock plays no part
    pair.absorb(corpus(11, 80), ts0=1070.0)        # w17 and w18: w17 closes
    assert pair.tick(2000.0)
    pair.absorb(corpus(22, 40), ts0=1200.0)        # w20: w18 closes
    assert pair.tick(2000.0)
    pair.absorb(corpus(12, 10), ts0=1001.0)        # late: counted, dropped
    assert pair.port.late_records_total == pair.ref.late_records_total > 0
    assert pair.drain()


def wide_then_narrow(route, distinct, monkeypatch):
    """600 tenants in one append take the unfused route (one grouped K6
    per distinct field over all 600 groups, one K7); the next append's
    few tenants take the fused one. Both states equal the reference's
    after each append and at the window's close."""
    calls, grouped = [], []
    fused, by_group = tk.fused_absorb, tsk.hll_update_groups_rows
    monkeypatch.setattr(tk, "fused_absorb",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    monkeypatch.setattr(tsk, "hll_update_groups_rows", lambda regs, *a: (
        grouped.append(len(regs)) or by_group(regs, *a)))
    wide = [f"t{i:03d}" for i in range(600)]
    pair = Pair(mesh=_mesh(route), window=("tumbling", 60),
                group_by=("tenant",), distinct=distinct, numeric=("size",),
                topk_field="user", max_len=16)
    bodies = corpus(13, 700, users=900)
    for i, body in enumerate(bodies[:-1]):
        body["tenant"] = wide[i % 600]
    pair.absorb(bodies)
    n_groups = len(pair.port._groups)
    assert n_groups > tstate.FluxState._FUSED_MAX_GROUPS
    assert calls == []
    assert grouped == [n_groups] * len(distinct)  # one launch per field
    pair.absorb(corpus(14, 50))
    assert calls == [1]
    assert grouped == [n_groups] * len(distinct)
    assert pair.tick(1060.0)


@pytest.mark.parametrize("route", ROUTES)
def test_both_sides_of_the_group_cap_equal_reference(route, monkeypatch):
    wide_then_narrow(route, ("user",), monkeypatch)


@pytest.mark.parametrize("route", ROUTES)
def test_wide_append_one_grouped_update_per_field(route, monkeypatch):
    """Two distinct fields above the cap: two grouped K6 calls."""
    wide_then_narrow(route, ("user", "tenant"), monkeypatch)


def test_absorb_batch_equals_reference():
    """The staged-column entry (the column stagers' layout) on both
    packages, an empty chunk included."""
    pair = Pair(window=("tumbling", 60), **SPEC)
    bodies = [b if isinstance(b, dict) else {} for b in corpus(23, 120)]
    port = pair.port
    strcols = {f: port._str_column(bodies, f)
               for f in port.spec.string_fields}
    numcols = {f: port._num_column(bodies, f) for f in port.spec.numeric}
    for n in (len(bodies), 0):
        assert (port.absorb_batch(n, strcols, numcols)
                == pair.ref.absorb_batch(n, strcols, numcols) == n)
        pair.check()


def test_oversize_group_prefix_equal_reference():
    """A group label near max_len makes the composite prefix wider than
    the staging width: that group has no top-k on either package."""
    pair = Pair(group_by=("tenant",), topk_field="user", max_len=64)
    big = "T" * 64
    pair.absorb([{"tenant": big, "user": "u1"},
                 {"tenant": "ok", "user": "u2"},
                 {"tenant": "ok", "user": "v" * 62}])  # composite too wide
    assert pair.port.topk((big.encode(),)) == pair.ref.topk((big.encode(),))
    assert pair.port.topk((b"ok",)) == pair.ref.topk((b"ok",)) == [
        (1, b"u2")]


def test_failed_launch_leaves_state_as_it_was(monkeypatch):
    pair = Pair(window=("tumbling", 60), **SPEC)
    pair.absorb(corpus(15, 50))
    before = fingerprint(pair.port)

    def boom(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tk, "fused_absorb", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        pair.port.absorb_events(tdecode(encode(
            corpus(16, 50, tenants=("a", "new")), 1000.0)))
    assert fingerprint(pair.port) == before


def test_state_without_a_device_asks_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TState(TSpec("t", distinct=("user",)))


# ---------------------------------------------------------------------------
# snapshots carried across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "jax_mesh_to_port_mesh"])
def test_snapshot_carries_across(direction, tmp_path):
    """One package absorbs the first half and is snapshotted (in memory,
    and through persist/load); the other restores it, and both absorb the
    rest: states and closed windows stay equal. The mesh case: the
    reference absorbs on its 8-device mesh, the port goes on over
    ``Mesh((cpu,) * 8)``."""
    kw = dict(SPEC, window=("hopping", 60, 20))
    on_mesh = direction == "jax_mesh_to_port_mesh"
    pair = Pair(mesh=on_mesh and _mesh("mesh"), port_mesh=on_mesh, **kw)
    src, dst = ((pair.port, pair.ref) if direction == "port_to_jax"
                else (pair.ref, pair.port))
    buf = encode(corpus(17, 150), 1000.0)
    src.absorb_events((jdecode if src is pair.ref else tdecode)(buf))
    pair.clock[0] = 1020.0
    src.tick()
    src.absorb_events((jdecode if src is pair.ref else tdecode)(
        encode(corpus(18, 40), 1020.0)))
    snap = pickle.loads(pickle.dumps(src.snapshot(), protocol=4))
    dst.restore(snap)
    pair.check()
    path = str(tmp_path / "flux.snap")
    src.persist(path)
    fresh = (TState(TSpec("t", **dict(kw, window=TWindow("hopping", 60,
                                                         20))),
                    now=lambda: pair.clock[0], device="cpu")
             if dst is pair.port
             else JState(JSpec("t", **dict(kw, window=JWindow("hopping", 60,
                                                              20))),
                         now=lambda: pair.clock[0]))
    assert fresh.load(path)
    assert fingerprint(fresh) == fingerprint(src)
    pair.absorb(corpus(19, 60))
    assert pair.tick(1040.0)
    pair.absorb(corpus(20, 30))
    assert pair.drain()


def test_snapshot_of_another_shape_is_refused():
    ref = JState(JSpec("t", group_by=("tenant",), distinct=("user",)))
    ref.absorb_events(jdecode(encode(corpus(21, 10), 1000.0)))
    port = TState(TSpec("t", group_by=("tenant",), distinct=("user",),
                        hll_p=14), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        port.restore(ref.snapshot())
    assert port.records_total == 0

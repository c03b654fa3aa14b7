"""K8 and the mesh halves of K9 and K10, in the port against the reference.

The port's sharded sketch and flux programs over a hand-built
``Mesh((cpu,) * n)`` (each shard runs the kernels' plain versions, the
merge ``shard_merge_plain``) against the reference's ``shard_map``
programs over the first n of its 8 virtual CPU devices
(tests/conftest.py), for n in {1, 2, 8}: ``sharded_hll_registers``,
``sharded_cms_table``, ``sharded_segment_counts`` and
``sharded_fused_absorb``. Registers, tables and counts must be equal bit
for bit (tolerance 0: integer merges), with B not divisible by n, B < n,
B = 0, all-invalid rows, a table near 2^31 - 1 and composites of another
row count than the batch; the snapshots handed in must come back
unmutated. Then whole ``FluxState``s with ``spec.mesh`` and a hand mesh
against the reference's mesh state and the port's unsharded state.
Each reference program compiles once per n and shape, so the shapes are
few.
"""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import jax
from fluentbit_tpu.codec.events import decode_events as jdecode
from fluentbit_tpu.flux import kernels as jk
from fluentbit_tpu.flux.state import FluxSpec as JSpec
from fluentbit_tpu.flux.state import FluxState as JState
from fluentbit_tpu.flux.state import WindowSpec as JWindow
from fluentbit_tpu.ops import sketch as jsk
from fluentbit_tpu_torch.codec.events import decode_events as tdecode
from fluentbit_tpu_torch.flux import kernels as tk
from fluentbit_tpu_torch.flux.state import FluxSpec as TSpec
from fluentbit_tpu_torch.flux.state import FluxState as TState
from fluentbit_tpu_torch.flux.state import WindowSpec as TWindow
from fluentbit_tpu_torch.ops import mesh as tmesh
from fluentbit_tpu_torch.ops import sketch as tsk

from test_torch_flux import corpus, encode, field_rows, fingerprint

NS = [1, 2, 8]
CPU = torch.device("cpu")
B, L = 37, 32  # B divides by neither 2 nor 8


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def meshes(n, axis="flux"):
    if len(jax.devices()) < n:
        pytest.skip("need the simulated 8-device mesh")
    return (tmesh.Mesh((CPU,) * n, axis),
            JaxMesh(np.asarray(jax.devices()[:n]), (axis,)))


def test_flux_partition_rules():
    """The flux rows of ``PARTITION_RULES`` equal the reference's."""
    from fluentbit_tpu.ops import mesh as jmesh

    for key in ("flux-hll", "flux-cms", "flux-counts", "flux-fused"):
        assert tmesh.PARTITION_RULES[key] == jmesh.PARTITION_RULES[key]
    rules = tmesh.partition_rules("flux-fused", "flux")
    x = torch.arange(16).view(8, 2)
    assert torch.equal(tmesh.shard_leaf(rules, "batch", x, "flux", 4, 1),
                       x[2:4])
    assert tmesh.shard_leaf(rules, "registers", x, "flux", 4, 1) is x


# ---------------------------------------------------------------------------
# K8: the sharded HLL and count-min updates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_sharded_hll_equals_reference(n):
    mesh, jm = meshes(n)
    rng = np.random.default_rng(n)
    batch, lengths = field_rows(rng, B, L)
    snap = rng.integers(0, 4, size=1 << 10).astype(np.int32)
    ref = jsk.HyperLogLog(p=10)
    want = np.asarray(jsk.sharded_hll_registers(ref, jm, batch, lengths,
                                                registers=snap))
    port = tsk.HyperLogLog(p=10, device="cpu")
    snap_t = t(snap.copy())
    live = port.registers.clone()
    got = tsk.sharded_hll_registers(port, mesh, batch, lengths,
                                    registers=snap_t)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(snap_t.numpy(), snap)        # snapshot unmutated
    assert torch.equal(port.registers, live)           # sketch untouched
    # the unsharded kernel gives the same registers
    one = t(snap.copy())
    tsk.hll_update_plain(one, t(batch), t(lengths), 10)
    assert torch.equal(got, one)
    # commit
    tsk.sharded_hll_update(port, mesh, batch, lengths)
    tsk.hll_update_plain(live, t(batch), t(lengths), 10)
    assert torch.equal(port.registers, live)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("invalid", [False, True])
def test_sharded_cms_equals_reference_near_int32_max(n, invalid):
    """A table whose counters sit at 2^31 - 1 - k wraps on both sides
    as int32 arithmetic does; all-invalid rows add nothing."""
    mesh, jm = meshes(n)
    rng = np.random.default_rng(10 + n)
    batch, lengths = field_rows(rng, B, L, invalid)
    batch[:20] = batch[0]                              # one hot column
    lengths[:20] = max(int(lengths[0]), 0) if not invalid else -1
    snap = (np.iinfo(np.int32).max
            - rng.integers(0, 8, size=(4, 256))).astype(np.int32)
    ref = jsk.CountMin(depth=4, width=256)
    want = np.asarray(jsk.sharded_cms_table(ref, jm, batch, lengths,
                                            table=snap))
    port = tsk.CountMin(4, 256, device="cpu")
    snap_t = t(snap.copy())
    got = tsk.sharded_cms_table(port, mesh, batch, lengths, table=snap_t)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(snap_t.numpy(), snap)
    assert not port.table.any()
    if invalid:
        assert np.array_equal(want, snap)
    else:
        assert (want < 0).any()                        # it wrapped
    one = t(snap.copy())
    tsk.cms_update_plain(one, t(batch), t(lengths))
    assert torch.equal(got, one)


@pytest.mark.parametrize("rows", [0, 3, 8])
def test_sharded_sketches_few_rows(rows):
    """B = 0 launches and adds nothing; B < n gives shards of zero rows;
    the int64 table merges too. Against the unsharded plain versions."""
    mesh = tmesh.Mesh((CPU,) * 8)
    rng = np.random.default_rng(rows)
    batch, lengths = field_rows(rng, rows, L)
    hll = tsk.HyperLogLog(p=8, device="cpu")
    hll.registers.random_(0, 3)
    want = hll.registers.clone()
    tsk.hll_update_plain(want, t(batch), t(lengths), 8)
    assert torch.equal(tsk.sharded_hll_registers(hll, mesh, batch, lengths),
                       want)
    for dtype in (torch.int32, torch.int64):
        cms = tsk.CountMin(2, 64, device="cpu", dtype=dtype)
        cms.table.random_(0, 100)
        want = cms.table.clone()
        tsk.cms_update_plain(want, t(batch), t(lengths))
        got = tsk.sharded_cms_table(cms, mesh, batch, lengths)
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("op", ["max", "add"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_shard_merge_plain(op, dtype):
    """The merge's plain version, and its wrapper on CPU tensors (which
    counts no launch), against numpy; int32 adds wrap."""
    rng = np.random.default_rng(3)
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    parts = rng.integers(-9, 10, size=(5, 7, 3))
    base = rng.integers(-9, 10, size=(7, 3))
    base[0, 0] = info.max - 3
    parts[:, 0, 0] = 2
    np_dtype = np.int32 if dtype == torch.int32 else np.int64
    parts, base = parts.astype(np_dtype), base.astype(np_dtype)
    with np.errstate(over="ignore"):
        want = (np.maximum(base, parts.max(0)) if op == "max"
                else base + parts.sum(0, dtype=np_dtype))
    got = t(base.copy())
    before = tsk.shard_merge.launches
    tsk.shard_merge(t(parts), got, op)
    assert tsk.shard_merge.launches == before
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tsk.shard_merge(t(parts), got, "min")
    with pytest.raises(ValueError):
        tsk.shard_merge(t(parts[:, :3]), got, op)


# ---------------------------------------------------------------------------
# K9's and K10's mesh halves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_sharded_segment_counts_equals_reference(n):
    mesh, jm = meshes(n)
    rng = np.random.default_rng(20 + n)
    seg = rng.integers(0, 7, size=B).astype(np.int32)
    valid = (rng.random(B) < 0.8).astype(np.int32)
    want = jk.sharded_segment_counts(jm, seg, valid, 7)
    got = tk.sharded_segment_counts(mesh, t(seg), t(valid), 7)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jk.host_segment_counts(seg, valid, 7))
    # B < n and B = 0
    for rows in (3, 0):
        got = tk.sharded_segment_counts(mesh, t(seg[:rows]),
                                        t(valid[:rows]), 7)
        assert np.array_equal(
            got.numpy(), jk.host_segment_counts(seg[:rows], valid[:rows], 7))


def fused_inputs(rng, rows, n_comp, G=5, F=1, invalid=False):
    seg = rng.integers(0, G, size=rows).astype(np.int32)
    valid = np.ones(rows, dtype=np.int32)
    fields = [field_rows(rng, rows, L, invalid) for _ in range(F)]
    regs = [[rng.integers(0, 5, size=1 << 10).astype(np.int32)
             for _ in range(G)] for _ in range(F)]
    c, cl = field_rows(rng, n_comp, L, invalid)
    table = rng.integers(0, 1 << 20, size=(4, 256)).astype(np.int32)
    return seg, valid, fields, regs, c, cl, table


def port_fused(fn, seg, valid, fields, regs, c, cl, table, G, mesh=None):
    stacks = [t(np.stack(r)) for r in regs]
    tbl = t(table.copy())
    args = (t(seg), t(valid), [(t(b), t(ln)) for b, ln in fields], stacks,
            t(c), t(cl), tbl)
    if mesh is not None:
        args = (mesh,) + args
    counts = fn(*args, hll_p=10, n_seg=G)
    return counts.numpy(), [s.numpy() for s in stacks], tbl.numpy()


@pytest.mark.parametrize("n", NS)
def test_sharded_fused_absorb_equals_reference(n):
    """B = 37 rows and 23 composites (Bc != B), 5 groups, one field:
    counts, stacks and table equal the reference's mesh program and the
    port's unsharded K10; the snapshots handed in are not mutated."""
    mesh, jm = meshes(n)
    rng = np.random.default_rng(30 + n)
    seg, valid, fields, regs, c, cl, table = fused_inputs(rng, B, 23)
    regs0 = [[r.copy() for r in rr] for rr in regs]
    cms = jsk.CountMin(depth=4, width=256)
    w_counts, w_regs, w_table = jk.sharded_fused_absorb(
        jm, seg, valid, fields, regs, c, cl, table, hll_p=10, cms=cms,
        n_seg=5)
    assert all(np.array_equal(a, b) for a, b in zip(regs[0], regs0[0]))
    got = port_fused(tk.sharded_fused_absorb, seg, valid, fields, regs, c,
                     cl, table, 5, mesh)
    assert np.array_equal(got[0], np.asarray(w_counts))
    assert np.array_equal(got[1][0], np.asarray(w_regs[0])[:5])
    assert np.array_equal(got[2], np.asarray(w_table))
    one = port_fused(tk.fused_absorb, seg, valid, fields, regs, c, cl,
                     table, 5)
    for a, b in zip(got, one):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)) \
            if isinstance(a, list) else np.array_equal(a, b)


@pytest.mark.parametrize("rows,n_comp,F,invalid",
                         [(0, 0, 1, False), (0, 5, 1, False),
                          (3, 11, 2, False), (20, 20, 1, True),
                          (64, 0, 2, False)])
def test_sharded_fused_absorb_edges(rows, n_comp, F, invalid):
    """B = 0 (with and without composites), B < n, all-invalid rows and
    no composites over 8 shards, against the unsharded plain K10."""
    mesh = tmesh.Mesh((CPU,) * 8, "flux")
    rng = np.random.default_rng(rows * 100 + n_comp)
    seg, valid, fields, regs, c, cl, table = fused_inputs(
        rng, rows, n_comp, F=F, invalid=invalid)
    got = port_fused(tk.sharded_fused_absorb, seg, valid, fields, regs, c,
                     cl, table, 5, mesh)
    want = port_fused(tk.fused_absorb, seg, valid, fields, regs, c, cl,
                      table, 5)
    assert np.array_equal(got[0], want[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert np.array_equal(got[2], want[2])
    if invalid or rows == 0:
        assert all(np.array_equal(a, np.stack(r))
                   for a, r in zip(got[1], regs))


def test_mesh_programs_count_no_launch_on_cpu():
    mesh = tmesh.Mesh((CPU,) * 2, "flux")
    counters = (tk.flux_mesh_launches, tk.fused_absorb, tsk.shard_merge,
                tsk.hll_mesh, tsk.cms_mesh)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(0)
    port_fused(tk.sharded_fused_absorb, *fused_inputs(rng, 9, 4), 5, mesh)
    batch, lengths = field_rows(rng, 9, L)
    tsk.sharded_hll_registers(tsk.HyperLogLog(8, "cpu"), mesh, batch,
                              lengths)
    assert [c.launches for c in counters] == before
    assert tk.flux_mesh() is None                      # no CUDA here


# ---------------------------------------------------------------------------
# whole states on a mesh
# ---------------------------------------------------------------------------


SPEC = dict(group_by=("tenant",), distinct=("user",), numeric=("size",),
            topk_field="user", topk=3)


def states(window):
    clock = [1000.0]
    now = lambda: clock[0]  # noqa: E731
    ref = JState(JSpec("t", mesh=True, window=JWindow(*window), **SPEC),
                 now=now)
    if ref._mesh is None:
        pytest.skip("need the simulated 8-device mesh")
    port = TState(TSpec("t", mesh=True, window=TWindow(*window), **SPEC),
                  now=now, device="cpu")
    assert port._mesh is None                          # no CUDA devices
    port._mesh = tmesh.Mesh((CPU,) * 8, "flux")
    plain = TState(TSpec("t", window=TWindow(*window), **SPEC), now=now,
                   device="cpu")
    return clock, (ref, port, plain)


def test_mesh_state_equals_reference_and_unsharded(monkeypatch):
    """FluxState(spec.mesh) over a hand-built 8-shard mesh against the
    reference's mesh state (its 8 virtual devices) and the port's
    unsharded state: equal fingerprints after every absorb and tick."""
    calls = []
    sharded = tk.sharded_fused_absorb
    monkeypatch.setattr(tk, "sharded_fused_absorb",
                        lambda *a, **kw: calls.append(1) or sharded(*a, **kw))
    clock, trio = states(("tumbling", 60))
    for seed, at in ((31, None), (32, 1061.0), (33, None)):
        buf = encode(corpus(seed, 90), 1000.0)
        for st in trio:
            st.absorb_events((jdecode if st is trio[0] else tdecode)(buf))
        prints = [fingerprint(st) for st in trio]
        assert prints[1] == prints[0] == prints[2]
        if at is not None:
            clock[0] = at
            closed = [[(k, g.count) for k, g in st.tick()] for st in trio]
            assert closed[1] == closed[0] == closed[2]
    assert len(calls) == 3

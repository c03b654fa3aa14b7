"""The port's sketches (K6 HyperLogLog, K7 count-min) against the reference's.

``fluentbit_tpu_torch.ops.sketch`` on the CPU runs the plain torch
versions of the two kernels (``hll_update_plain``, ``cms_update_plain``,
and K6's grouped form ``hll_update_groups_plain``) and the host twins
(``add_cpu``); registers, tables, hashes and
estimates must equal the reference package's exactly (tolerance 0:
integers compared with ``np.array_equal``, estimates with ``==``). The
reference runs its jit on JAX's CPU backend (``device_registers`` /
``device_table``, which commit nothing). The CUDA kernels are held
against the plain versions in tests/test_torch_gpu.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluentbit_tpu.ops import sketch as jsk
from fluentbit_tpu_torch.ops import sketch as tsk
from fluentbit_tpu_torch.ops.batch import assemble


def make_rows(seed, B, L):
    """Seeded ``[B, L]`` rows: random bytes, every length class (-2, -1,
    0, 1, L and random), all-0xFF rows, and repeated values so that
    scatters collide."""
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, size=(B,)).astype(np.int32)
    special = np.array([-2, -1, 0, min(1, L), L, L, -2, 0], dtype=np.int32)
    lengths[: len(special)] = special
    batch[4:6] = 0xFF  # all-0xFF rows, full length
    if B > 24:
        batch[16:24] = batch[8]  # the same value eight times
        lengths[16:24] = lengths[8]
    return batch, lengths


@functools.lru_cache(maxsize=None)
def jax_hll(p):
    return jsk.HyperLogLog(p=p)  # one jit per precision, reused


@functools.lru_cache(maxsize=None)
def jax_cms(d, w):
    return jsk.CountMin(depth=d, width=w)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("L", [0, 1, 17, 256])
def test_hash_equals_reference(L):
    batch, lengths = make_rows(L, 64, L)
    want = np.asarray(jsk._fnv1a_scan(jnp.asarray(batch),
                                      jnp.asarray(lengths)))
    got = tsk.fnv1a_mix_plain(t(batch), t(lengths)).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_mix_pins_wraparound():
    """fmix32 on values whose products leave 32 (and 63) bits: the
    all-ones word and words with the top bit set."""
    words = np.array([0xFFFFFFFF, 0x80000000, 0xDEADBEEF, 0x811C9DC5, 0, 1,
                      0x7FFFFFFF, 0xFFFF0000], dtype=np.uint32)
    want = np.asarray(jsk._mix(jnp.asarray(words))).astype(np.int64)
    got = tsk._mix_plain(t(words.astype(np.int64))).numpy()
    assert np.array_equal(got, want)
    assert [tsk._mix32(int(w)) for w in words] == want.tolist()


@pytest.mark.parametrize("p", [4, 10, 14])
@pytest.mark.parametrize("L", [0, 17, 256])
def test_hll_index_rank_equals_reference(p, L):
    batch, lengths = make_rows(p * 100 + L, 96, L)
    idx, rank = jsk.hll_index_rank(jnp.asarray(batch), jnp.asarray(lengths),
                                   p)
    got_idx, got_rank = tsk.hll_index_rank_plain(t(batch), t(lengths), p)
    assert np.array_equal(got_idx.numpy(), np.asarray(idx))
    assert np.array_equal(got_rank.numpy(), np.asarray(rank))
    assert int(got_rank.max()) <= 33 - p


@pytest.mark.parametrize("p", [4, 10, 14])
@pytest.mark.parametrize("L", [1, 256])
def test_hll_update_from_state_equals_reference(p, L):
    rng = np.random.default_rng(p + L)
    state = rng.integers(0, 34 - p, size=(1 << p,)).astype(np.int32)
    state[: (1 << p) // 2] = 0  # half empty: ranks land on both kinds
    batch, lengths = make_rows(p + 7 * L, 256, L)
    want = np.asarray(jax_hll(p).device_registers(
        batch, lengths, wait=True, registers=state))
    port = tsk.from_jax_state(state, "cpu")
    port.update(batch, lengths)
    assert port.registers.dtype == torch.int32
    assert np.array_equal(port.registers.numpy(), want)
    ref = jsk.HyperLogLog(p=p)
    ref.registers = want.copy()
    assert port.estimate() == ref.estimate()


# (groups G, rows B, width L, case): segment ids in [0, G) unless the
# case says otherwise; make_rows gives lengths -2, -1, 0, 1, L and random
GROUP_CASES = [(1, 256, 256, "plain"), (7, 300, 17, "plain"),
               (600, 1500, 16, "plain"), (7, 300, 17, "out_of_range"),
               (7, 200, 0, "plain"), (7, 301, 33, "unaligned"),
               (7, 256, 64, "one_group")]


@pytest.mark.parametrize("G,B,L,case", GROUP_CASES)
def test_hll_update_groups_plain_equals_reference(G, B, L, case):
    """K6's grouped form on the CPU (``hll_update_groups_rows``, which
    takes ``hll_update_groups_plain`` for CPU registers) against the
    reference's ``HyperLogLog._update_impl`` run one group at a time: group g's
    registers from their own start, over the rows whose segment is g
    (every other row's length set to -1, which changes nothing). Segment
    ids outside [0, G), negative ones included, change nothing."""
    p = 10
    rng = np.random.default_rng(G * 1000 + B + L)
    batch, lengths = make_rows(G + B + L, B, L)
    seg = rng.integers(0, G, size=B).astype(np.int32)
    if case == "out_of_range":
        seg = rng.integers(-3, G + 3, size=B).astype(np.int32)
        assert (seg < 0).any() and (seg >= G).any()
    elif case == "one_group":
        seg[:] = G // 2
    state = rng.integers(0, 34 - p, size=(G, 1 << p)).astype(np.int32)
    state[:, : (1 << p) // 2] = 0
    ref = jax_hll(p)
    want = [np.asarray(ref.device_registers(
        batch, np.where(seg == g, lengths, -1).astype(np.int32), wait=True,
        registers=state[g])) for g in range(G)]
    regs = [t(state[g].copy()) for g in range(G)]
    rows = t(batch)
    if case == "unaligned":  # a view at an odd offset
        flat = torch.zeros(1 + batch.size, dtype=torch.uint8)
        rows = flat[1:].view(B, L)
        rows.copy_(t(batch))
    before = tsk.hll_update_groups.launches
    tsk.hll_update_groups_rows(regs, rows, t(lengths), t(seg), p)
    assert tsk.hll_update_groups.launches == before  # CPU: the plain version
    for g in range(G):
        assert np.array_equal(regs[g].numpy(), want[g]), g
    if case == "one_group":
        others = [g for g in range(G) if g != G // 2]
        assert all(np.array_equal(regs[g].numpy(), state[g]) for g in others)
    if G == 1:  # the one-array form is the same update
        one = t(state[0].copy())
        tsk.hll_update_plain(one, t(batch), t(lengths), p)
        assert np.array_equal(one.numpy(), want[0])


@pytest.mark.parametrize("d,w", [(4, 512), (4, 16384)])
@pytest.mark.parametrize("L", [0, 17, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_cms_update_from_state_equals_reference(d, w, L, weighted):
    rng = np.random.default_rng(d * w + L)
    state = rng.integers(0, 1000, size=(d, w)).astype(np.int32)
    batch, lengths = make_rows(w + L, 256, L)
    weights = (rng.integers(-3, 1 << 20, size=(256,)).astype(np.int32)
               if weighted else None)
    want = np.asarray(jax_cms(d, w).device_table(
        batch, lengths, weights, wait=True, table=state))
    port = tsk.from_jax_state(state, "cpu")
    port.update(batch, lengths, weights)
    assert port.table.dtype == torch.int32
    assert np.array_equal(port.table.numpy(), want)


@pytest.mark.parametrize("w", [512, 16384])
def test_cms_int64_table_equals_reference_hashes(w):
    """An int64 table (the reference's under x64) carried across with
    counters past 2^31: the reference's columns (``CountMin._hashes``)
    with an int64 scatter-add in numpy are the expected table."""
    d = 4
    rng = np.random.default_rng(w)
    state = rng.integers(0, 1 << 40, size=(d, w)).astype(np.int64)
    batch, lengths = make_rows(w, 256, 256)
    weights = rng.integers(-5, 1 << 30, size=(256,)).astype(np.int32)
    cols = np.asarray(jax_cms(d, w)._hashes(jnp.asarray(batch),
                                            jnp.asarray(lengths)))
    want = state.copy()
    add = (lengths >= 0).astype(np.int64) * weights.astype(np.int64)
    for r in range(d):
        np.add.at(want[r], cols[r], add)
    assert np.array_equal(tsk.cms_cols_plain(t(batch), t(lengths), d,
                                             w).numpy(), cols)
    port = tsk.from_jax_state(state, "cpu")
    port.update(batch, lengths, weights)
    assert port.table.dtype == torch.int64
    assert np.array_equal(port.table.numpy(), want)


def test_add_cpu_equals_plain_update_and_reference():
    """The host twins agree with the staged update and with the
    reference's ``add_cpu``, values past the staged width included."""
    rng = np.random.default_rng(5)
    vals = [bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
            for n in rng.integers(0, 300, size=150)]
    vals += [b"\xff" * 64, b"", b"user-1", b"user-1"]
    wide = assemble(vals, 300)  # every value fits: the batch reference
    staged = assemble(vals, 32)  # values > 32 B overflow to add_cpu

    j_hll, j_cms = jsk.HyperLogLog(p=10), jsk.CountMin(depth=4, width=512)
    by_row = tsk.HyperLogLog(10, "cpu")
    by_value = tsk.HyperLogLog(10, "cpu")
    mixed = tsk.HyperLogLog(10, "cpu")
    c_row = tsk.CountMin(4, 512, "cpu")
    c_value = tsk.CountMin(4, 512, "cpu")
    c_mixed = tsk.CountMin(4, 512, "cpu")
    by_row.update(wide.batch, wide.lengths)
    c_row.update(wide.batch, wide.lengths)
    mixed.update(staged.batch, staged.lengths)
    c_mixed.update(staged.batch, staged.lengths)
    for i in staged.overflow:
        mixed.add_cpu(vals[i])
        c_mixed.add_cpu(vals[i])
    for v in vals:
        by_value.add_cpu(v)
        c_value.add_cpu(v, 3)
        j_hll.add_cpu(v)
        j_cms.add_cpu(v, 3)
        assert tsk._hash32_cpu(v) == int(jsk._hash32_cpu(v))
        assert c_value._cols_cpu(v) == j_cms._cols_cpu(v)
    assert len(staged.overflow) > 50
    regs = by_row.registers.numpy()
    assert np.array_equal(by_value.registers.numpy(), regs)
    assert np.array_equal(mixed.registers.numpy(), regs)
    assert np.array_equal(regs, np.asarray(j_hll.registers))
    assert np.array_equal(c_mixed.table.numpy(), c_row.table.numpy())
    assert np.array_equal(c_value.table.numpy(), 3 * c_row.table.numpy())
    assert np.array_equal(c_value.table.numpy(), np.asarray(j_cms.table))
    assert by_row.estimate() == j_hll.estimate()
    assert c_value.query_many(vals) == j_cms.query_many(vals)
    assert c_value.query_many([]) == []


def test_from_jax_state_rejects_other_shapes():
    with pytest.raises(ValueError):
        tsk.from_jax_state(np.zeros((100,), np.int32), "cpu")
    with pytest.raises(ValueError):
        tsk.from_jax_state(np.zeros((2, 8), np.float32), "cpu")


def test_kernel_wrappers_raise_off_cuda():
    """A wrapper given CPU tensors raises instead of running anything;
    the CPU path goes through the plain version and counts no launch."""
    batch, lengths = make_rows(1, 32, 16)
    regs = torch.zeros(1 << 10, dtype=torch.int32)
    table = torch.zeros((4, 512), dtype=torch.int32)
    before = (tsk.hll_update.launches, tsk.cms_update.launches,
              tsk.hll_update_groups.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.hll_update(regs, t(batch), t(lengths), 10)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.hll_update_groups([regs], t(batch), t(lengths),
                              torch.zeros(32, dtype=torch.int32), 10)
    meta = t(batch).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tsk.hll_update_groups([regs.to("meta")], meta, t(lengths).to("meta"),
                              t(lengths).to("meta"), 10)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.cms_update(table, t(batch), t(lengths))
    tsk.hll_update_rows(regs, t(batch), t(lengths), 10)
    tsk.cms_update_rows(table, t(batch), t(lengths))
    tsk.hll_update_groups_rows([regs], t(batch), t(lengths),
                               torch.zeros(32, dtype=torch.int32), 10)
    assert (tsk.hll_update.launches, tsk.cms_update.launches,
            tsk.hll_update_groups.launches) == before
    assert int(regs.max()) > 0 and int(table.sum()) == 4 * int(
        (lengths >= 0).sum())

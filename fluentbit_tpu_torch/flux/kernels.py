"""Device kernels of the flux plane — the port of ``fluentbit_tpu/flux/kernels.py``.

Two functions, each with a plain torch version and a hand-written CUDA
kernel in ``csrc/sketch.cu``:

- ``segment_counts`` (K9, the reference's ``_counts_impl``): group
  counts ``out[seg] += valid`` into int32 ``[n_seg]``;
- ``fused_absorb`` (K10, ``build_fused_absorb``): in one launch, K9's
  counts, for each distinct field K6's register index and rank
  scatter-maxed into a per-group register stack ``stack[seg, idx] max=
  rank``, and K7's weight-1 count-min update of the top-k composites.

Their mesh halves run over an ``ops.mesh.Mesh`` (``flux_mesh`` builds
one over the visible CUDA devices, None below two; a mesh built by hand
may repeat a device): ``sharded_segment_counts`` (K9's, the reference's
``build_sharded_counts`` / ``sharded_segment_counts``) and
``sharded_fused_absorb`` (K10's). The batch columns pad to a multiple of
the shard count (pad rows: segment 0, valid 0, length -1; the
composites pad along their own rows) and shard by the ``flux-counts`` /
``flux-fused`` partition rules; each shard launches the kernel into
zeroed partial counts, stacks and a zeroed count-min delta on its
device; then ``ops.sketch.shard_merge`` folds them: counts and delta by
sum (the reference's ``psum``), each stack by max into the stack it was
given (``pmax``). Integer merges make the result equal the reference's
bit for bit. ``flux_mesh_launches`` counts the shard launches.

The wrappers take the plain version for CPU tensors and launch the
kernel for CUDA tensors (anything else raises); a failed build or launch
raises. Each wrapper counts its launches in ``launches``.

``fused_absorb`` and ``sharded_fused_absorb`` update the stacks and the
table they are given in place. The caller (``FluxState._fused_absorb``)
hands them freshly assembled stacks and a copy of the table and commits
them after the launch has returned — the reference's snapshot-in /
commit-on-finish contract (``_fused_call``). Integer scatters (add, max)
make every route give the same state bit for bit.

The reference's jit buckets (``_pad_segments``, ``_pad_rows_to``) exist
for XLA's shape cache and are not carried over: pad rows are no-ops, and
results cover ``[:n_seg]`` only. ``guarded_segment_counts`` waits for
the device fault lane.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.device import dispatch_point
from ..ops.mesh import (Mesh, MeshLaunches, build_mesh, pad_to_devices,
                        partition_rules, shard_leaf)
from ..ops.sketch import (_SketchKernel, _check_rows, _vec16,
                          cms_update_plain, gather_partials,
                          hll_index_rank_plain, pad_rows, shard_merge,
                          shard_partials)

__all__ = ["host_segment_counts", "segment_counts_plain",
           "fused_absorb_plain", "segment_counts", "fused_absorb",
           "flux_mesh", "sharded_segment_counts", "sharded_fused_absorb",
           "flux_mesh_launches"]

Rows = Tuple[torch.Tensor, torch.Tensor]


def host_segment_counts(seg: np.ndarray, valid: np.ndarray,
                        n_seg: int) -> np.ndarray:
    """Host twin: rows-per-segment over valid rows (int64 → int32-safe
    counts; a chunk has < 2^31 rows by construction)."""
    if n_seg <= 0:
        return np.zeros((0,), dtype=np.int32)
    return np.bincount(
        seg[valid.astype(bool)], minlength=n_seg
    ).astype(np.int32)[:n_seg]


# ---------------------------------------------------------------------------
# plain versions (torch ops on any device)
# ---------------------------------------------------------------------------


def segment_counts_plain(seg: torch.Tensor, valid: torch.Tensor,
                         n_seg: int,
                         counts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``zeros(n_seg).at[seg].add(valid)`` in int32 (``_counts_impl``);
    ``seg`` must lie in ``[0, n_seg)``. With ``counts`` (int32
    ``[n_seg]``), the rows add into it, and it is returned."""
    if counts is None:
        counts = torch.zeros((n_seg,), dtype=torch.int32, device=seg.device)
    return counts.index_add_(0, seg.long(), valid.to(torch.int32))


def fused_absorb_plain(seg: torch.Tensor, valid: torch.Tensor,
                       fields: Sequence[Rows], stacks: Sequence[torch.Tensor],
                       comp: Optional[torch.Tensor] = None,
                       comp_len: Optional[torch.Tensor] = None,
                       table: Optional[torch.Tensor] = None, *, hll_p: int,
                       n_seg: int,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused absorb in torch ops: returns the counts (added into
    ``counts`` when given), and updates each field's ``stack`` [n_seg,
    2^p] (scatter-max of the rows' ranks at ``seg * 2^p + idx``) and
    ``table`` (weight-1 count-min update of the composites) in place. A
    row with a negative length has rank 0, a no-op under max, so pad rows
    may carry any segment id."""
    counts = segment_counts_plain(seg, valid, n_seg, counts)
    seg64 = seg.long() << hll_p
    for (batch, lengths), stack in zip(fields, stacks):
        idx, rank = hll_index_rank_plain(batch, lengths, hll_p)
        stack.view(-1).scatter_reduce_(0, seg64 + idx, rank, "amax")
    if comp is not None and table is not None:
        cms_update_plain(table, comp, comp_len)
    return counts


# ---------------------------------------------------------------------------
# the CUDA kernel's wrappers
# ---------------------------------------------------------------------------


def _check_i32(name: str, arg: str, x: torch.Tensor, shape: tuple,
               dev: torch.device) -> None:
    if (x.dtype != torch.int32 or tuple(x.shape) != shape
            or x.device != dev or not x.is_contiguous()):
        raise ValueError(f"{name}: {arg} must be contiguous int32 "
                         f"{list(shape)} on {dev}")


#: distinct fields one K10 launch takes (``kMaxFields`` of
#: ``csrc/sketch.cu``, which refuses more): a spec with more fields takes
#: one more launch for each further chunk
FIELDS_PER_LAUNCH = 8


class _FluxLaunch(_SketchKernel):
    """``flux_absorb_launch`` of ``csrc/sketch.cu``, built and bound at
    first use."""

    symbol = "flux_absorb_launch"
    argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p])

    def _run(self, name: str, seg: torch.Tensor, valid: torch.Tensor,
             fields: Sequence[Rows], stacks: Sequence[torch.Tensor],
             comp: Optional[torch.Tensor], comp_len: Optional[torch.Tensor],
             table: Optional[torch.Tensor], hll_p: int,
             n_seg: int, counts: Optional[torch.Tensor]) -> torch.Tensor:
        dev = seg.device
        if dev.type != "cuda":
            raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
        B = seg.shape[0] if seg.dim() == 1 else -1
        _check_i32(name, "seg", seg, (B,), dev)
        _check_i32(name, "valid", valid, (B,), dev)
        if n_seg < 0:
            raise ValueError(f"{name}: n_seg must be >= 0")
        if len(stacks) != len(fields):
            raise ValueError(f"{name}: one register stack per field")
        if fields and not 1 <= hll_p <= 24:
            raise ValueError(f"{name}: unsupported precision p={hll_p}")
        L = fields[0][0].shape[1] if fields else 0
        for (batch, lengths), stack in zip(fields, stacks):
            _check_rows(name, batch, lengths, dev)
            if tuple(batch.shape) != (B, L):
                raise ValueError(f"{name}: every field must be uint8 "
                                 f"[{B}, {L}]")
            _check_i32(name, "stack", stack, (n_seg, 1 << hll_p), dev)
        Bc = W = d = w = 0
        comp_vec16 = 0
        if comp is not None:
            if comp_len is None or table is None:
                raise ValueError(f"{name}: composites need comp_len and "
                                 f"the table")
            _check_rows(name, comp, comp_len, dev)
            if (table.dtype != torch.int32 or table.dim() != 2
                    or min(table.shape) < 1 or table.device != dev
                    or not table.is_contiguous()):
                raise ValueError(f"{name}: table must be a contiguous "
                                 f"int32 [d, w] tensor on {dev}")
            Bc, W = comp.shape
            d, w = table.shape
            comp_vec16 = _vec16(comp)
        if counts is None:
            counts = torch.zeros((n_seg,), dtype=torch.int32, device=dev)
        else:
            _check_i32(name, "counts", counts, (n_seg,), dev)
        if max(B, Bc) == 0:
            return counts
        # the field descriptors go by value in the kernel's parameters, at
        # most FIELDS_PER_LAUNCH a launch: the first launch also counts
        # and takes the composites, a further one each next chunk of fields
        pairs = list(zip(fields, stacks))
        for k in range(0, max(len(pairs), 1), FIELDS_PER_LAUNCH):
            chunk = pairs[k:k + FIELDS_PER_LAUNCH]
            first = k == 0
            descr = (ctypes.c_void_p * (3 * len(chunk)))(
                *[x for (b, ln), st in chunk
                  for x in (b.data_ptr(), ln.data_ptr(), st.data_ptr())])
            vec16 = int(all(_vec16(b) for (b, _), _ in chunk))
            has_comp = first and comp is not None
            self._launch(dev, seg.data_ptr(), valid.data_ptr(), B, n_seg,
                         counts.data_ptr() if first else None, descr,
                         len(chunk), L, hll_p, vec16,
                         comp.data_ptr() if has_comp else None,
                         comp_len.data_ptr() if has_comp else None,
                         Bc if has_comp else 0, W, comp_vec16,
                         table.data_ptr() if has_comp else None, d, w)
        return counts


class FusedAbsorb(_FluxLaunch):
    """K10, the flux absorb: see :func:`fused_absorb_plain` for what it
    computes. CPU tensors take the plain version (not counted in
    ``launches``); CUDA tensors launch the kernel on the current stream;
    anything else raises. The ``device.dispatch`` site fires after
    either."""

    def __call__(self, seg: torch.Tensor, valid: torch.Tensor,
                 fields: Sequence[Rows], stacks: Sequence[torch.Tensor],
                 comp: Optional[torch.Tensor] = None,
                 comp_len: Optional[torch.Tensor] = None,
                 table: Optional[torch.Tensor] = None, *, hll_p: int,
                 n_seg: int,
                 counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        if seg.device.type == "cpu":
            out = fused_absorb_plain(seg, valid, fields, stacks, comp,
                                     comp_len, table, hll_p=hll_p,
                                     n_seg=n_seg, counts=counts)
        else:
            out = self._run("fused_absorb", seg, valid, fields, stacks,
                            comp, comp_len, table, hll_p, n_seg, counts)
        dispatch_point("flux")
        return out


class SegmentCounts(_FluxLaunch):
    """K9, group counts (K10's counts-only launch): CPU tensors take
    :func:`segment_counts_plain`, CUDA tensors the kernel."""

    def __call__(self, seg: torch.Tensor, valid: torch.Tensor,
                 n_seg: int,
                 counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        if seg.device.type == "cpu":
            out = segment_counts_plain(seg, valid, n_seg, counts)
        else:
            out = self._run("segment_counts", seg, valid, (), (), None,
                            None, None, 0, n_seg, counts)
        dispatch_point("flux")
        return out


#: the process's flux kernel wrappers (one build, one launch count each)
fused_absorb = FusedAbsorb()
segment_counts = SegmentCounts()
#: the mesh halves' shard launches (K9 and K10 count them too)
flux_mesh_launches = MeshLaunches()


# ---------------------------------------------------------------------------
# the mesh halves: per-shard launches into zeroed partials, then the merge
# ---------------------------------------------------------------------------


def flux_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """A mesh over the visible CUDA devices (axis ``flux``); None below
    two (sharding would be pure overhead)."""
    return build_mesh(n_devices, axis="flux")


def _shard_col(mesh: Mesh, rules, name: str, x: torch.Tensor, i: int,
               dev: torch.device) -> torch.Tensor:
    """Shard ``i``'s slice of the batch column ``name`` on its device."""
    part = shard_leaf(rules, name, x, mesh.axis_names[0], mesh.size, i)
    return part.to(dev, non_blocking=True).contiguous()


def sharded_segment_counts(mesh: Mesh, seg: torch.Tensor,
                           valid: torch.Tensor, n_seg: int) -> torch.Tensor:
    """K9's mesh half: ``seg`` / ``valid`` int32 ``[B]`` pad to the shard
    multiple (segment 0, valid 0), shard by the ``flux-counts`` rules,
    each shard counts into its zeroed partial, and the partials' sum is
    the int32 ``[n_seg]`` result on the mesh's first device."""
    n = mesh.size
    Bp = pad_to_devices(seg.shape[0], n)
    seg, valid = pad_rows(seg, Bp, 0), pad_rows(valid, Bp, 0)
    counts = torch.zeros((n_seg,), dtype=torch.int32, device=mesh.devices[0])
    if Bp == 0 or n_seg == 0:
        return counts
    rules = partition_rules("flux-counts", mesh.axis_names[0])
    parts, outs = shard_partials(mesh, (n_seg,), torch.int32)
    for i, (dev, out) in enumerate(zip(mesh.devices, outs)):
        segment_counts(_shard_col(mesh, rules, "seg", seg, i, dev),
                       _shard_col(mesh, rules, "valid", valid, i, dev),
                       n_seg, out)
        if dev.type == "cuda":
            flux_mesh_launches.launches += 1
    gather_partials(mesh, parts, outs)
    shard_merge(parts, counts, "add")
    return counts


def sharded_fused_absorb(mesh: Mesh, seg: torch.Tensor, valid: torch.Tensor,
                         fields: Sequence[Rows],
                         stacks: Sequence[torch.Tensor],
                         comp: Optional[torch.Tensor] = None,
                         comp_len: Optional[torch.Tensor] = None,
                         table: Optional[torch.Tensor] = None, *, hll_p: int,
                         n_seg: int) -> torch.Tensor:
    """K10's mesh half (the reference's ``sharded_fused_absorb``): what
    :func:`fused_absorb` computes, over ``mesh``. The batch columns pad
    to the shard multiple (segment 0, valid 0, lengths -1) and the
    composites to theirs (length -1); shard i launches K10 over its rows
    and composites into zeroed partial counts, stacks and delta; the
    merges add the counts, take each stack's max into ``stacks`` and add
    the delta into ``table``, both in place (they live on the mesh's
    first device: the caller's fresh snapshot, never live state).
    Returns the int32 ``[n_seg]`` counts."""
    n = mesh.size
    dev0 = mesh.devices[0]
    Bp = pad_to_devices(seg.shape[0], n)
    seg, valid = pad_rows(seg, Bp, 0), pad_rows(valid, Bp, 0)
    fields = [(pad_rows(b, Bp, 0), pad_rows(ln, Bp, -1))
              for b, ln in fields]
    has_cms = comp is not None and table is not None
    Bc = 0
    if has_cms:
        Bc = pad_to_devices(comp.shape[0], n)
        comp, comp_len = pad_rows(comp, Bc, 0), pad_rows(comp_len, Bc, -1)
    counts = torch.zeros((n_seg,), dtype=torch.int32, device=dev0)
    if Bp == 0 and Bc == 0:
        return counts
    rules = partition_rules("flux-fused", mesh.axis_names[0])
    p_counts, o_counts = shard_partials(mesh, (n_seg,), torch.int32)
    p_stacks, o_stacks = zip(*[shard_partials(mesh, tuple(st.shape),
                                              torch.int32)
                               for st in stacks]) if stacks else ((), ())
    p_delta = o_delta = None
    if has_cms:
        p_delta, o_delta = shard_partials(mesh, tuple(table.shape),
                                          table.dtype)
    for i, dev in enumerate(mesh.devices):
        def col(name, x):
            return _shard_col(mesh, rules, name, x, i, dev)

        fused_absorb(
            col("seg", seg), col("valid", valid),
            [(col("batch", b), col("lengths", ln)) for b, ln in fields],
            [o[i] for o in o_stacks],
            col("comp", comp) if has_cms else None,
            col("comp_len", comp_len) if has_cms else None,
            o_delta[i] if has_cms else None, hll_p=hll_p, n_seg=n_seg,
            counts=o_counts[i])
        if dev.type == "cuda":  # the shard's rows or composites: >= 1
            flux_mesh_launches.launches += 1
    gather_partials(mesh, p_counts, o_counts)
    shard_merge(p_counts, counts, "add")
    for parts, outs, stack in zip(p_stacks, o_stacks, stacks):
        gather_partials(mesh, parts, outs)
        shard_merge(parts, stack, "max")
    if has_cms:
        gather_partials(mesh, p_delta, o_delta)
        shard_merge(p_delta, table, "add")
    return counts

"""Device sketches for log_to_metrics and flux — the port of ``fluentbit_tpu/ops/sketch.py``.

A HyperLogLog (``2^p`` int32 registers of max-rank) and a count-min
sketch (``[d, w]`` counters, Kirsch-Mitzenmacher double hashing) whose
state lives as tensors on one explicit torch device. A staged batch of
field values (``[B, L] uint8`` rows with ``lengths`` int32; a negative
length counts nothing) is hashed with FNV-1a 32 plus the murmur3 fmix32
finaliser and scattered into the state:

- HLL: register ``idx = h >> (32 - p)`` takes the max of itself and
  ``rank = min(clz(h << p) + 1, 33 - p)``;
- count-min: ``h1 = h``, ``h2 = fmix32(h1) | 1``, and depth row r adds
  the row's weight at column ``(h1 + r * h2 mod 2^32) mod w``.

On a CUDA tensor the update is the hand-written kernel
``csrc/sketch.cu`` (``hll_update`` / ``cms_update``, K6 / K7 of the
reference). On a CPU tensor it is the plain torch version below, which
computes in int64 masked to 32 bits (CPU torch has no ``>>``, ``<<`` or
``%`` on uint32). Values longer than the staged width take the host
twins (``add_cpu``), bit-identical to both. There is no other path: a
failed build or launch raises. The flux plane's fused absorb
(``flux/kernels.py``) reuses the plain hashes and the launcher base.

K6 also has a grouped form, ``hll_update_groups``: one launch updates
any number of register arrays, row i going to ``registers[seg[i]]``
(the flux state's branch above its group cap); the one-array
``hll_update`` is the same kernel with G = 1.

K8, the sharded updates (``sharded_hll_registers`` / ``sharded_cms_table``
and their committing forms), run over an ``ops.mesh.Mesh``: the rows pad
to a multiple of the shard count (zero bytes, length -1), each shard
absorbs its slice into a zeroed partial state on its own device (K6 or
K7), and one ``shard_merge`` launch folds the partials into a copy of
the snapshot on the mesh's first device: the max for HLL registers (the
reference's ``lax.pmax``), the sum for count-min tables (``lax.psum``
plus the table). ``shard_merge`` is a kernel of ``csrc/sketch.cu`` too,
with ``shard_merge_plain`` beside it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .device import (ArrayLike, DeviceError, DeviceLike, dispatch_point,
                     resolve, to_device)
from .mesh import Mesh, MeshLaunches, mesh_key, pad_to_devices

FNV_OFFSET = 0x811C9DC5
FNV_PRIME = 0x01000193
MASK32 = 0xFFFFFFFF
_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35

# ---------------------------------------------------------------------------
# plain versions (torch ops on any device; the kernels' CPU path and their
# reference on the card). Hashes are int64 tensors holding uint32 values.
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for uint32 values held in int64, split into
    16-bit halves so that no product leaves int64's range."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix_plain(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 (the reference's ``_mix``)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX_C2)
    return h ^ (h >> 16)


def fnv1a_mix_plain(batch: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``fmix32(FNV-1a 32)`` over bytes ``[0, length)`` of each ``[B, L]``
    row (``_fnv1a_scan``): int64 ``[B]`` in ``[0, 2^32)``. Pad positions
    leave the hash unchanged, so a negative length hashes the empty
    string."""
    B, L = batch.shape
    h = torch.full((B,), FNV_OFFSET, dtype=torch.int64, device=batch.device)
    data = batch.to(torch.int64)
    for pos in range(L):
        nh = ((h ^ data[:, pos]) * FNV_PRIME) & MASK32
        h = torch.where(pos < lengths, nh, h)
    return _mix_plain(h)


def _nlz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values in int64 (32 for 0): ``32 -
    bit_length`` by a shift ladder (torch has no clz or popcount)."""
    bits = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        bits = bits + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return 32 - (bits + (x > 0).to(torch.int64))


def hll_index_rank_plain(batch: torch.Tensor, lengths: torch.Tensor,
                         p: int) -> tuple:
    """Per-row register index (int64) and rank (int32; 0 for a negative
    length) — ``hll_index_rank``."""
    h = fnv1a_mix_plain(batch, lengths)
    idx = h >> (32 - p)
    rank = torch.clamp(_nlz32((h << p) & MASK32) + 1, max=32 - p + 1)
    rank = torch.where(lengths >= 0, rank, 0)
    return idx, rank.to(torch.int32)


def hll_update_plain(registers: torch.Tensor, batch: torch.Tensor,
                     lengths: torch.Tensor, p: int) -> None:
    """``registers.at[idx].max(rank)`` in place (``_update_impl``)."""
    idx, rank = hll_index_rank_plain(batch, lengths, p)
    registers.scatter_reduce_(0, idx, rank, "amax", include_self=True)


def hll_update_groups_plain(registers: Sequence[torch.Tensor],
                            batch: torch.Tensor, lengths: torch.Tensor,
                            seg: torch.Tensor, p: int) -> None:
    """K6's grouped form in torch ops: for each group g, ``registers[g]``
    takes :func:`hll_update_plain` of the rows whose ``seg`` is g, in
    place. A segment id outside ``[0, len(registers))`` changes nothing.
    The rows are hashed once and each group's are scattered, which is the
    same state (max is order-free)."""
    G = len(registers)
    if G == 0 or batch.shape[0] == 0:
        return
    idx, rank = hll_index_rank_plain(batch, lengths, p)
    seg = seg.long()
    key = torch.where((seg >= 0) & (seg < G), seg, G)  # G: dropped
    order = torch.argsort(key, stable=True)
    sizes = torch.bincount(key, minlength=G + 1).tolist()
    for regs, rows in zip(registers, torch.split(order, sizes)):
        if rows.numel():
            regs.scatter_reduce_(0, idx[rows], rank[rows], "amax",
                                 include_self=True)


def shard_merge_plain(parts: torch.Tensor, base: torch.Tensor,
                      op: str) -> None:
    """Fold the shards' partials ``parts`` ``[n, ...]`` into ``base``
    ``[...]`` in place: ``op="max"`` takes the elementwise max (the
    reference's ``pmax`` of ``max(snapshot, update)``), ``op="add"``
    adds their sum (``table + psum(delta)``), wrapping as int32 or int64
    arithmetic does."""
    if op == "max":
        torch.maximum(base, parts.amax(0), out=base)
    elif op == "add":
        total = base.long() + parts.long().sum(0)
        if base.dtype == torch.int32:  # two's complement wrap to 32 bits
            total = ((total + (1 << 31)) & MASK32) - (1 << 31)
        base.copy_(total)
    else:
        raise ValueError(f"shard_merge: unknown op {op!r}")


def cms_cols_plain(batch: torch.Tensor, lengths: torch.Tensor, d: int,
                   w: int) -> torch.Tensor:
    """Column of each row in each depth row, int64 ``[d, B]``
    (``CountMin._hashes``): the uint32 wrap comes before the modulo."""
    h1 = fnv1a_mix_plain(batch, lengths)
    h2 = _mix_plain(h1) | 1
    r = torch.arange(d, dtype=torch.int64, device=batch.device)[:, None]
    return ((h1[None, :] + r * h2[None, :]) & MASK32) % w


def cms_update_plain(table: torch.Tensor, batch: torch.Tensor,
                     lengths: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> None:
    """``table.at[r, cols[r]].add((lengths >= 0) * weight)`` for each
    depth row, in place (``CountMin._update_impl``)."""
    d, w = table.shape
    cols = cms_cols_plain(batch, lengths, d, w)
    valid = (lengths >= 0).to(table.dtype)
    if weights is not None:
        valid = valid * weights.to(table.dtype)
    for r in range(d):
        table[r].index_add_(0, cols[r], valid)


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _check_rows(name: str, batch: torch.Tensor, lengths: torch.Tensor,
                dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    if batch.dtype != torch.uint8 or batch.dim() != 2:
        raise ValueError(f"{name}: batch must be uint8 [B, L]")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != batch.shape[:1]:
        raise ValueError(f"{name}: lengths must be int32 [B]")
    for arg, x in (("batch", batch), ("lengths", lengths)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {dev}")


def _vec16(batch: torch.Tensor) -> int:
    return int(batch.shape[1] % 16 == 0 and batch.data_ptr() % 16 == 0)


class _SketchKernel:
    """A ``csrc/sketch.cu`` launcher: built and bound at first use.
    ``launches`` counts the launches made (a plain integer a caller may
    reset)."""

    symbol = ""
    argtypes: list = []

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _launch(self, dev: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(cuda_build.libraries.load("sketch"), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(dev):
            rc = self._fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise DeviceError(f"{self.symbol} failed: CUDA error {rc}",
                              lane="flux")
        self.launches += 1


def _check_registers(name: str, registers: torch.Tensor, p: int,
                     dev: torch.device) -> None:
    if (registers.dtype != torch.int32 or tuple(registers.shape) != (1 << p,)
            or registers.device != dev or not registers.is_contiguous()):
        raise ValueError(f"{name}: registers must be contiguous int32 "
                         f"[{1 << p}] on {dev}")


def _check_p(name: str, p: int) -> None:
    if not 1 <= p <= 24:
        raise ValueError(f"{name}: unsupported precision p={p}")


class HllUpdateKernel(_SketchKernel):
    """K6: ``registers`` int32 ``[2^p]`` takes the max rank of each row of
    ``batch`` u8 ``[B, L]`` / ``lengths`` i32 ``[B]``, in place, on the
    current stream (the kernel's one-array case, G = 1)."""

    symbol = "hll_update_launch"
    argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    def __call__(self, registers: torch.Tensor, batch: torch.Tensor,
                 lengths: torch.Tensor, p: int) -> None:
        dev = registers.device
        _check_rows("hll_update", batch, lengths, dev)
        _check_p("hll_update", p)
        _check_registers("hll_update", registers, p, dev)
        B, L = batch.shape
        if B == 0:
            return
        self._launch(dev, batch.data_ptr(), lengths.data_ptr(), None,
                     (ctypes.c_void_p * 1)(registers.data_ptr()), None, 1, B,
                     L, p, _vec16(batch))


#: register arrays K6's grouped form takes by value in the kernel's
#: parameters (``kGroupsByValue`` of ``csrc/sketch.cu``); more groups go
#: through a device array of pointers, copied to the card first
GROUPS_BY_VALUE = 1024


class HllUpdateGroupsKernel(HllUpdateKernel):
    """K6's grouped form, one launch for any number of register arrays:
    row i of ``batch`` u8 ``[B, L]`` / ``lengths`` i32 ``[B]`` updates
    ``registers[seg[i]]`` (each int32 ``[2^p]``, a tensor of its own) in
    place, on the current stream; a ``seg`` outside ``[0,
    len(registers))`` changes nothing."""

    def __call__(self, registers: Sequence[torch.Tensor], batch: torch.Tensor,
                 lengths: torch.Tensor, seg: torch.Tensor,
                 p: int) -> None:
        dev = registers[0].device if registers else seg.device
        name = "hll_update_groups"
        _check_rows(name, batch, lengths, dev)
        _check_p(name, p)
        if (seg.dtype != torch.int32 or seg.shape != lengths.shape
                or not seg.is_contiguous()):
            raise ValueError(f"{name}: seg must be contiguous int32 [B] on "
                             f"{dev}")
        for regs in registers:
            _check_registers(name, regs, p, dev)
        B, L = batch.shape
        G = len(registers)
        if B == 0 or G == 0:
            return
        ptrs = [r.data_ptr() for r in registers]
        by_value = by_device = None
        if G <= GROUPS_BY_VALUE:  # in the kernel's parameters
            by_value = (ctypes.c_void_p * G)(*ptrs)
        else:  # a device array, pinned so that the copy is asynchronous
            by_device = torch.tensor(ptrs, dtype=torch.int64).pin_memory(
            ).to(dev, non_blocking=True)
        self._launch(dev, batch.data_ptr(), lengths.data_ptr(),
                     seg.data_ptr(), by_value,
                     None if by_device is None else by_device.data_ptr(), G,
                     B, L, p, _vec16(batch))


class CmsUpdateKernel(_SketchKernel):
    """K7: ``table`` int32 or int64 ``[d, w]`` adds each row's weight
    (``weights`` i32 ``[B]``, or 1) in every depth row, in place, on the
    current stream."""

    symbol = "cms_update_launch"
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def __call__(self, table: torch.Tensor, batch: torch.Tensor,
                 lengths: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> None:
        dev = table.device
        _check_rows("cms_update", batch, lengths, dev)
        if (table.dtype not in (torch.int32, torch.int64) or table.dim() != 2
                or min(table.shape) < 1 or not table.is_contiguous()):
            raise ValueError("cms_update: table must be a contiguous int32 "
                             "or int64 [d, w] tensor")
        if weights is not None and (
                weights.dtype != torch.int32
                or tuple(weights.shape) != tuple(lengths.shape)
                or weights.device != dev or not weights.is_contiguous()):
            raise ValueError(f"cms_update: weights must be contiguous int32 "
                             f"[B] on {dev}")
        B, L = batch.shape
        if B == 0:
            return
        d, w = table.shape
        self._launch(dev, batch.data_ptr(), lengths.data_ptr(),
                     None if weights is None else weights.data_ptr(),
                     table.data_ptr(), B, L, d, w,
                     int(table.dtype == torch.int64), _vec16(batch))


class ShardMergeKernel(_SketchKernel):
    """The shard merge: see :func:`shard_merge_plain`. CPU tensors take
    the plain version (not counted in ``launches``); CUDA tensors launch
    the kernel on the current stream; anything else raises."""

    symbol = "shard_merge_launch"
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]

    def __call__(self, parts: torch.Tensor, base: torch.Tensor,
                 op: str) -> None:
        if op not in ("max", "add"):
            raise ValueError(f"shard_merge: unknown op {op!r}")
        if (parts.dim() < 1 or tuple(parts.shape[1:]) != tuple(base.shape)
                or parts.dtype != base.dtype
                or base.dtype not in (torch.int32, torch.int64)):
            raise ValueError("shard_merge: parts must be [n, *base.shape] "
                             "of base's dtype, int32 or int64")
        if base.device.type == "cpu" and parts.device.type == "cpu":
            shard_merge_plain(parts, base, op)
            return
        dev = base.device
        if dev.type != "cuda":
            raise ValueError(f"shard_merge runs on CUDA tensors, got {dev}")
        if (parts.device != dev or not parts.is_contiguous()
                or not base.is_contiguous()):
            raise ValueError(f"shard_merge: parts and base must be "
                             f"contiguous on {dev}")
        if parts.shape[0] == 0 or base.numel() == 0:
            return
        self._launch(dev, parts.data_ptr(), parts.shape[0], base.data_ptr(),
                     base.numel(), int(op == "add"),
                     int(base.dtype == torch.int64))


#: the process's sketch kernel wrappers (one build, one launch count each)
hll_update = HllUpdateKernel()
hll_update_groups = HllUpdateGroupsKernel()
cms_update = CmsUpdateKernel()
shard_merge = ShardMergeKernel()
#: K8's shard launches (``hll_update`` / ``cms_update`` count them too)
hll_mesh = MeshLaunches()
cms_mesh = MeshLaunches()


def hll_update_rows(registers: torch.Tensor, batch: torch.Tensor,
                    lengths: torch.Tensor, p: int) -> None:
    """The plain version for CPU tensors, the kernel for everything else
    (which raises off CUDA); then the ``device.dispatch`` site."""
    if registers.device.type == "cpu":
        hll_update_plain(registers, batch, lengths, p)
    else:
        hll_update(registers, batch, lengths, p)
    dispatch_point("flux")


def hll_update_groups_rows(registers: Sequence[torch.Tensor],
                           batch: torch.Tensor, lengths: torch.Tensor,
                           seg: torch.Tensor, p: int) -> None:
    """The plain version for CPU registers, the kernel for everything else
    (which raises off CUDA); then the ``device.dispatch`` site."""
    if not registers:
        return
    if registers[0].device.type == "cpu":
        hll_update_groups_plain(registers, batch, lengths, seg, p)
    else:
        hll_update_groups(registers, batch, lengths, seg, p)
    dispatch_point("flux")


def cms_update_rows(table: torch.Tensor, batch: torch.Tensor,
                    lengths: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> None:
    """The plain version for CPU tensors, the kernel for everything else
    (which raises off CUDA); then the ``device.dispatch`` site."""
    if table.device.type == "cpu":
        cms_update_plain(table, batch, lengths, weights)
    else:
        cms_update(table, batch, lengths, weights)
    dispatch_point("flux")


# ---------------------------------------------------------------------------
# host twins: one value at a time, bit-identical to the batch update
# ---------------------------------------------------------------------------


def _mix32(h: int) -> int:
    """fmix32 on a Python int (the reference's ``_mix_np``)."""
    h ^= h >> 16
    h = (h * _FMIX_C1) & MASK32
    h ^= h >> 13
    h = (h * _FMIX_C2) & MASK32
    return h ^ (h >> 16)


def _hash32_cpu(value: bytes) -> int:
    """fmix32(FNV-1a 32) of one value, as the batch update hashes it."""
    h = FNV_OFFSET
    for b in value:
        h = ((h ^ b) * FNV_PRIME) & MASK32
    return _mix32(h)


# ---------------------------------------------------------------------------
# the sketches
# ---------------------------------------------------------------------------


class HyperLogLog:
    """HLL over 32-bit hashes; ``registers`` int32 ``[2^p]`` on ``device``."""

    def __init__(self, p: int = 14, device: DeviceLike = None):
        self.p = p
        self.m = 1 << p
        self.device = resolve(device)
        self.registers = torch.zeros((self.m,), dtype=torch.int32,
                                     device=self.device)
        self._mesh_cache: dict = {}  # K8's partial buffers, per mesh

    def update(self, batch: ArrayLike, lengths: ArrayLike) -> None:
        """Absorb a staged ``[B, L]`` batch (rows with length < 0 count
        nothing). Host arrays move with one non-blocking copy each."""
        hll_update_rows(self.registers,
                        to_device(batch, torch.uint8, self.device),
                        to_device(lengths, torch.int32, self.device), self.p)

    def add_cpu(self, value: bytes) -> None:
        """One value hashed on the host (a row longer than the staged
        width), applied to the registers where they live."""
        h = _hash32_cpu(value)
        idx = h >> (32 - self.p)
        rest = (h << self.p) & MASK32
        rank = min(32 - rest.bit_length() + 1, 32 - self.p + 1)
        self.registers[idx:idx + 1].clamp_(min=rank)

    def merge_registers(self, other: torch.Tensor) -> None:
        """Union with another sketch of the same precision: the
        elementwise max, in place (the reference's ``merge_registers``)."""
        torch.maximum(self.registers, other.to(self.device),
                      out=self.registers)

    def estimate(self) -> float:
        """Standard HLL estimator with small/large range corrections (one
        device→host copy of the registers)."""
        return estimate_registers(self.registers.cpu().numpy())


def estimate_registers(regs: np.ndarray) -> float:
    """The HLL estimate of host registers int32 ``[2^p]`` (the reference's
    ``HyperLogLog.estimate``, operation for operation)."""
    m = float(regs.shape[0])
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)))
    if e <= 2.5 * m:
        v = int(np.sum(regs == 0))
        if v > 0:
            e = m * np.log(m / v)
    elif e > (1 << 32) / 30.0:
        e = -(2.0 ** 32) * np.log(1.0 - e / 2.0 ** 32)
    return float(e)


class CountMin:
    """Count-min sketch ``table[d, w]`` on ``device``; point queries take
    the row-min. The table is int32 unless ``dtype=torch.int64`` (the
    reference's table under x64)."""

    def __init__(self, depth: int = 4, width: int = 16384,
                 device: DeviceLike = None, dtype: torch.dtype = torch.int32):
        if dtype not in (torch.int32, torch.int64):
            raise ValueError(f"count-min table dtype must be int32 or int64, "
                             f"got {dtype}")
        self.depth = depth
        self.width = width
        self.device = resolve(device)
        self.table = torch.zeros((depth, width), dtype=dtype,
                                 device=self.device)
        self._mesh_cache: dict = {}  # K8's partial buffers, per mesh

    def update(self, batch: ArrayLike, lengths: ArrayLike,
               weights: Optional[ArrayLike] = None) -> None:
        """Absorb a staged ``[B, L]`` batch with int32 ``weights`` (1 when
        absent); rows with length < 0 count nothing."""
        cms_update_rows(
            self.table, to_device(batch, torch.uint8, self.device),
            to_device(lengths, torch.int32, self.device),
            None if weights is None
            else to_device(weights, torch.int32, self.device))

    def _cols_cpu(self, value: bytes) -> List[int]:
        """Column per depth row for one value (uint32 wrap before the
        modulo, as in the batch update)."""
        h1 = _hash32_cpu(value)
        h2 = _mix32(h1) | 1
        return [((h1 + r * h2) & MASK32) % self.width
                for r in range(self.depth)]

    def add_cpu(self, value: bytes, weight: int = 1) -> None:
        """One value hashed on the host (a row longer than the staged
        width), applied to the table where it lives."""
        for r, c in enumerate(self._cols_cpu(value)):
            self.table[r, c:c + 1].add_(weight)

    def query_cols(self, cols: Sequence[Sequence[int]],
                   table: Optional[np.ndarray] = None) -> List[int]:
        """Row-min estimates for precomputed ``_cols_cpu`` columns, with
        one device→host copy of the table (none when the caller passes a
        host copy as ``table``)."""
        if not len(cols):
            return []
        if table is None:
            table = self.table.cpu().numpy()
        c = np.asarray(cols, dtype=np.int64)
        return table[np.arange(self.depth)[None, :], c].min(axis=1).tolist()

    def query_many(self, values: Iterable[bytes],
                   table: Optional[np.ndarray] = None) -> List[int]:
        """Point estimates for many values, one table copy (or none, from
        a host copy passed as ``table``)."""
        return self.query_cols([self._cols_cpu(v) for v in values], table)


# ---------------------------------------------------------------------------
# K8: the sharded updates (a mesh of shards, then one merge)
# ---------------------------------------------------------------------------


def _as_tensor(x: ArrayLike) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x


def pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``x`` with its leading axis padded up to ``n`` rows of ``fill``."""
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x.new_full((n - x.shape[0],) + tuple(x.shape[1:]),
                                    fill)])


def _pad_to_mesh(mesh: Mesh, batch: ArrayLike, lengths: ArrayLike
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows padded to a multiple of the shard count
    (``pad_to_devices``): pad rows carry zero bytes and length -1, so
    they change no sketch."""
    b, ln = _as_tensor(batch), _as_tensor(lengths)
    Bp = pad_to_devices(b.shape[0], mesh.size)
    return pad_rows(b, Bp, 0), pad_rows(ln, Bp, -1)


def shard_partials(mesh: Mesh, shape: tuple, dtype: torch.dtype,
                   cache: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Zeroed partial states for a sharded call: ``parts`` ``[n, *shape]``
    on the mesh's first device, and the tensor each shard's kernel
    writes: its slice of ``parts`` where the shard's device is the first
    one, else a tensor on its own device that ``gather_partials`` copies
    in. With ``cache``, the buffers are kept per mesh structure, shape
    and dtype and zeroed again on each call."""
    dev0 = mesh.devices[0]
    key = (mesh_key(mesh), tuple(shape), dtype)
    got = None if cache is None else cache.get(key)
    if got is None:
        parts = torch.zeros((mesh.size, *shape), dtype=dtype, device=dev0)
        outs = [parts[i] if d == dev0
                else torch.zeros(shape, dtype=dtype, device=d)
                for i, d in enumerate(mesh.devices)]
        got = (parts, outs)
        if cache is not None:
            cache[key] = got
    else:
        got[0].zero_()
        for out, d in zip(got[1], mesh.devices):
            if d != dev0:
                out.zero_()
    return got


def gather_partials(mesh: Mesh, parts: torch.Tensor,
                    outs: Sequence[torch.Tensor]) -> None:
    """Copy the partials of shards on other devices into ``parts``."""
    for i, (out, d) in enumerate(zip(outs, mesh.devices)):
        if d != mesh.devices[0]:
            parts[i].copy_(out)


def _sharded_rows(mesh: Mesh, counter: MeshLaunches, batch: ArrayLike,
                  lengths: ArrayLike, base: torch.Tensor, op: str,
                  update: Callable, cache: dict) -> torch.Tensor:
    """K8's body: ``update(out, rows, lengths)`` of each shard's slice into
    its zeroed partial, then one merge into ``base`` (a fresh copy of
    the snapshot on the mesh's first device), which is returned."""
    b, ln = _pad_to_mesh(mesh, batch, lengths)
    if b.shape[0] == 0:
        return base
    step = b.shape[0] // mesh.size
    parts, outs = shard_partials(mesh, tuple(base.shape), base.dtype, cache)
    for i, (dev, out) in enumerate(zip(mesh.devices, outs)):
        update(out, to_device(b[i * step:(i + 1) * step], torch.uint8, dev),
               to_device(ln[i * step:(i + 1) * step], torch.int32, dev))
        if dev.type == "cuda" and step:
            counter.launches += 1
    gather_partials(mesh, parts, outs)
    shard_merge(parts, base, op)
    return base


def _snapshot_on(mesh: Mesh, state: torch.Tensor,
                 snapshot: Optional[ArrayLike]) -> torch.Tensor:
    """A fresh copy of ``snapshot`` (default: the sketch's own ``state``)
    on the mesh's first device: the merge's base, never the live state."""
    src = state if snapshot is None else _as_tensor(snapshot)
    return src.to(mesh.devices[0], dtype=state.dtype, copy=True)


def sharded_hll_registers(hll: HyperLogLog, mesh: Mesh, batch: ArrayLike,
                          lengths: ArrayLike,
                          registers: Optional[ArrayLike] = None
                          ) -> torch.Tensor:
    """K8 for HLL (the reference's ``sharded_hll_registers``): the merged
    registers on the mesh's first device, computed from the explicit
    ``registers`` snapshot (default: the sketch's own), which nothing
    here mutates; the sketch is not touched either."""
    base = _snapshot_on(mesh, hll.registers, registers)
    return _sharded_rows(
        mesh, hll_mesh, batch, lengths, base, "max",
        lambda out, b, ln: hll_update_rows(out, b, ln, hll.p),
        hll._mesh_cache)


def sharded_hll_update(hll: HyperLogLog, mesh: Mesh, batch: ArrayLike,
                       lengths: ArrayLike) -> None:
    """Compute-and-commit over :func:`sharded_hll_registers`."""
    merged = sharded_hll_registers(hll, mesh, batch, lengths)
    hll.registers = merged.to(hll.device)


def sharded_cms_table(cms: CountMin, mesh: Mesh, batch: ArrayLike,
                      lengths: ArrayLike,
                      table: Optional[ArrayLike] = None) -> torch.Tensor:
    """K8 for count-min (the reference's ``sharded_cms_table``): each
    shard adds its rows at weight 1 into a zeroed delta; the merged table
    (snapshot plus the deltas' sum) on the mesh's first device. The
    explicit ``table`` snapshot (default: the sketch's own) and the
    sketch are not mutated."""
    base = _snapshot_on(mesh, cms.table, table)
    return _sharded_rows(
        mesh, cms_mesh, batch, lengths, base, "add",
        lambda out, b, ln: cms_update_rows(out, b, ln), cms._mesh_cache)


def sharded_cms_update(cms: CountMin, mesh: Mesh, batch: ArrayLike,
                       lengths: ArrayLike) -> None:
    """Compute-and-commit over :func:`sharded_cms_table`."""
    merged = sharded_cms_table(cms, mesh, batch, lengths)
    cms.table = merged.to(cms.device)


def from_jax_state(state: np.ndarray, device: DeviceLike = None):
    """A sketch on ``device`` holding state carried across from the
    reference package: ``registers`` int32 ``[2^p]`` gives a
    :class:`HyperLogLog`, ``table`` int32 or int64 ``[d, w]`` a
    :class:`CountMin` of the same dtype."""
    state = np.ascontiguousarray(state)
    if state.ndim == 1:
        p = int(math.log2(state.shape[0]))
        if 1 << p != state.shape[0] or state.dtype != np.int32:
            raise ValueError("HLL registers must be int32 [2^p]")
        sk = HyperLogLog(p, device)
        sk.registers.copy_(torch.from_numpy(state))
        return sk
    if state.ndim == 2 and state.dtype in (np.int32, np.int64):
        sk = CountMin(state.shape[0], state.shape[1], device,
                      torch.int32 if state.dtype == np.int32 else torch.int64)
        sk.table.copy_(torch.from_numpy(state))
        return sk
    raise ValueError(f"unrecognised sketch state {state.dtype} {state.shape}")

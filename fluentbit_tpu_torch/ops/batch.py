"""Batch assembly — variable-length records → fixed-shape device arrays.

The port's counterpart of ``fluentbit_tpu/ops/batch.py``: field values
become a ``[B, L] uint8`` padded matrix + ``lengths`` i32, staged in
numpy. ``staging`` allocates the host buffers in pinned memory when the
batch is bound for a CUDA device, so the whole ``[R, B, L]`` matrix moves
with one non-blocking copy. ``bucket_size`` and ``len_bucket`` round the
row count and the row width to the reference's small sets of shapes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Batch:
    """Fixed-shape batch of byte strings.

    batch   : uint8 [B, L]  padded with 0 (pad positions are identified by
              lengths, not by the pad byte value)
    lengths : int32 [B]     valid byte count per row; -1 marks an INVALID
              row (missing field) which must never match
    overflow: indices of source strings longer than L (CPU regex path)
    """

    __slots__ = ("batch", "lengths", "overflow", "n")

    def __init__(self, batch: np.ndarray, lengths: np.ndarray,
                 overflow: List[int], n: int):
        self.batch = batch
        self.lengths = lengths
        self.overflow = overflow
        self.n = n


def staging(shape: Tuple[int, ...], dtype: torch.dtype,
            device: torch.device, fill: Optional[int] = 0) -> torch.Tensor:
    """Host tensor for a batch bound for ``device``, filled with
    ``fill`` (left as allocated for None): pinned when that is a CUDA
    device (a non-blocking copy needs pinned memory). The raw path
    stages its rows unfilled and its lengths at -1: the kernels and
    their plain versions never read a byte past a row's length."""
    pin = device.type == "cuda"
    if fill is None:
        return torch.empty(shape, dtype=dtype, pin_memory=pin)
    return torch.full(shape, fill, dtype=dtype, pin_memory=pin)


def assemble(
    values: Sequence[Optional[bytes]],
    max_len: int = 512,
    pad_batch_to: Optional[int] = None,
    out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Batch:
    """Pack byte strings into a padded [B, L] uint8 matrix.

    ``None`` entries (missing record-accessor field) get length -1.
    Strings longer than ``max_len`` are recorded in ``overflow`` and get
    length -2 (the kernel treats them as invalid; the caller resolves
    them with the regex). ``pad_batch_to`` rounds B up to a bucket.
    ``out`` = (batch[B', max_len] uint8 zeros, lengths[B'] int32) fills
    caller-owned buffers (pinned staging views) instead of allocating.
    """
    n = len(values)
    B = pad_batch_to if pad_batch_to and pad_batch_to >= n else n
    if out is None:
        batch = np.zeros((B, max_len), dtype=np.uint8)
        lengths = np.empty((B,), dtype=np.int32)
    else:
        batch, lengths = out
        if batch.shape != (B, max_len) or lengths.shape != (B,):
            raise ValueError(f"staging buffers {batch.shape}/{lengths.shape} "
                             f"do not fit [{B}, {max_len}]")
    lengths[:] = -1
    overflow: List[int] = []
    for i, v in enumerate(values):
        if v is None:
            continue
        ln = len(v)
        if ln > max_len:
            overflow.append(i)
            lengths[i] = -2
            continue
        if ln:
            batch[i, :ln] = np.frombuffer(v, dtype=np.uint8)
        lengths[i] = ln
    return Batch(batch, lengths, overflow, n)


#: cap on bucket * max_len padding (bytes)
_PAD_BYTE_BUDGET = 256 * 1024 * 1024


def bucket_size(n: int, buckets: Sequence[int] = (256, 1024, 4096, 16384, 65536),
                max_len: Optional[int] = None,
                byte_budget: int = _PAD_BYTE_BUDGET,
                multiple_of: Optional[int] = None) -> int:
    """Round a batch size up to a small set of stable shapes (the same
    buckets as the reference package, so both stage identical shapes).

    ``max_len`` clamps the rounding: the padded ``bucket * max_len``
    staging matrix must stay inside ``byte_budget``; past it, the batch
    takes minimal 64-record-granularity padding. ``multiple_of`` then
    aligns the result to a mesh's shard count, so every shard of the
    batch axis gets the same rows."""
    pick = None
    for b in buckets:
        if n <= b:
            pick = b
            break
    if pick is None:
        pick = ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]
    if max_len and pick * max_len > byte_budget:
        pick = ((n + 63) // 64) * 64
    if multiple_of and multiple_of > 1:
        pick = ((pick + multiple_of - 1) // multiple_of) * multiple_of
    return pick


#: scan widths the raw path stages at (the reference grep's buckets)
_LEN_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def len_bucket(n: int, cap: int) -> int:
    """Round the longest staged value up to a small set of row widths,
    never past ``cap``: the DFA walk is sequential in L, so a segment of
    short values walks a narrow batch."""
    for b in _LEN_BUCKETS:
        if n <= b:
            return min(b, cap)
    return cap

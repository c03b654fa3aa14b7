"""The host msgpack codec of the raw chunk path, bound with ctypes.

The port's counterpart of ``fluentbit_tpu/native/__init__.py``, trimmed to
what the raw grep path needs, with the same names and contracts. The
library is the port's own ``csrc/codec_host.cpp``, built with ``g++`` at
first use into ``fluentbit_tpu_torch/_build/`` (``ops/cuda_build.py``). A
failed build raises: there is no pure-Python stand-in, and no switch that
turns the codec off.

API:
  count_records(buf)                         → int | None
  scan_offsets(buf)                          → int64 offsets[n+1] | None
  compact(buf, offsets, keep)                → bytes | None
  stage_field_into(buf, key, batch, lengths) → n | None
  stage_field(buf, key, max_len, pad_to)     → (batch, lengths, offsets, n)
                                               | None
  stage_threads()                            → the staging fan-out

None means the buffer is malformed or a caller's buffer is too small: the
caller declines to the decoded path.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .ops import cuda_build

_i64p = ctypes.POINTER(ctypes.c_longlong)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)

_tls = threading.local()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The codec library, built (``cuda_build.libraries`` serialises the
    build) and bound on first use; raises RuntimeError if ``g++`` fails,
    and a later call tries again."""
    lib = cuda_build.libraries.load("codec_host")
    lib.fbtpu_count_records.restype = ctypes.c_longlong
    lib.fbtpu_count_records.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.fbtpu_scan_offsets.restype = ctypes.c_longlong
    lib.fbtpu_scan_offsets.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, _i64p, ctypes.c_longlong]
    stage = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p,
             ctypes.c_longlong, _u8p, _i32p, ctypes.c_longlong,
             ctypes.c_longlong, _i64p]
    lib.fbtpu_stage_field.restype = ctypes.c_longlong
    lib.fbtpu_stage_field.argtypes = stage
    lib.fbtpu_stage_field_mt.restype = ctypes.c_longlong
    lib.fbtpu_stage_field_mt.argtypes = stage + [ctypes.c_int32]
    lib.fbtpu_compact.restype = ctypes.c_longlong
    lib.fbtpu_compact.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, _i64p, _u8p,
        ctypes.c_longlong, _u8p]
    return lib


def available() -> bool:
    """True once the codec is built and loaded; raises if it cannot be."""
    _load()
    return True


def _buf_arg(buf):
    """(arg, length, keepalive) presenting a C-contiguous bytes-like
    object to a ``c_char_p`` parameter without copying: ``bytes`` goes
    straight through ctypes, anything else (memoryview, bytearray, a
    uint8 array) as a pointer into its buffer through an
    ``np.frombuffer`` view, which the caller keeps referenced for the
    call."""
    if isinstance(buf, bytes):
        return buf, len(buf), None
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data_as(ctypes.c_char_p), arr.size, arr


def count_records(buf) -> Optional[int]:
    """Top-level msgpack objects in ``buf``; None if it is malformed."""
    p, blen, _keep = _buf_arg(buf)
    n = _load().fbtpu_count_records(p, blen)
    return None if n < 0 else int(n)


def scan_offsets(buf) -> Optional[np.ndarray]:
    """Record boundaries: int64 ``offsets[n+1]``, record i spanning
    ``[offsets[i], offsets[i+1])``; None if ``buf`` is malformed."""
    p, blen, _keep = _buf_arg(buf)
    cap = blen + 1  # worst case: 1-byte records
    offsets = np.empty(cap + 1, dtype=np.int64)
    n = _load().fbtpu_scan_offsets(
        p, blen, offsets.ctypes.data_as(_i64p), cap)
    if n < 0:
        return None
    return offsets[: n + 1]


def compact(buf, offsets: np.ndarray, keep: np.ndarray) -> Optional[bytes]:
    """Order-preserving copy of the records with ``keep[i]`` true
    straight from the source buffer (the raw path's survivor re-emit);
    None if an offset lies outside ``buf``."""
    p, blen, _keep_ref = _buf_arg(buf)
    n = len(keep)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    if offs.shape[0] < n + 1:
        raise ValueError(f"compact: {offs.shape[0]} offsets for {n} records")
    out = np.empty(blen, dtype=np.uint8)
    keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
    w = _load().fbtpu_compact(p, blen, offs.ctypes.data_as(_i64p),
                              keep_u8.ctypes.data_as(_u8p), n,
                              out.ctypes.data_as(_u8p))
    if w < 0:
        return None
    return out[:w].tobytes()


def stage_threads() -> int:
    """Requested staging fan-out: ``FBTPU_STAGE_THREADS``, by default
    (unset, 0 or not a number) every core. The library caps it at the
    hardware's threads and 16."""
    try:
        want = int(os.environ.get("FBTPU_STAGE_THREADS", "0"))
    except ValueError:
        want = 0
    return want or (os.cpu_count() or 1)


def stage_field_into(buf, key: bytes, out_batch: np.ndarray,
                     out_lengths: np.ndarray, n_hint: Optional[int] = None,
                     threads: Optional[int] = None,
                     offsets_out: Optional[np.ndarray] = None
                     ) -> Optional[int]:
    """Stage the top-level string field ``key`` of each record straight
    into caller-provided arrays (``out_batch`` u8 ``[B, L]``,
    ``out_lengths`` i32 ``[>= B]``, both C-contiguous): length per row,
    -1 for a missing or non-string value or a non-map body, -2 for a
    value longer than L. The extraction fans out over the library's
    worker pool (``threads``, default ``stage_threads()``).

    Writes rows ``[0, n)`` only: bytes past a row's length are NOT
    zeroed (the DFA kernels and their plain versions mask by length),
    and rows past ``n`` are left untouched, so pre-fill ``out_lengths``
    with -1 for pad rows. ``offsets_out`` (i64, >= n+1 entries,
    contiguous) receives the record boundaries the walk finds anyway.
    Returns the record count, or None (malformed buffer, more records
    than rows, or a mistyped or non-contiguous target)."""
    est = n_hint if n_hint is not None else count_records(buf)
    if est is None:
        return None
    B, L = out_batch.shape
    if (est > B or out_batch.dtype != np.uint8
            or not out_batch.flags["C_CONTIGUOUS"]
            or out_lengths.dtype != np.int32 or out_lengths.shape[0] < B
            or not out_lengths.flags["C_CONTIGUOUS"]):
        return None
    if offsets_out is not None:
        if (offsets_out.dtype != np.int64 or offsets_out.shape[0] < est + 1
                or not offsets_out.flags["C_CONTIGUOUS"]):
            return None
        offsets = offsets_out
    else:
        offsets = np.empty(est + 1, dtype=np.int64)
    p, blen, _keep = _buf_arg(buf)
    n = _load().fbtpu_stage_field_mt(
        p, blen, key, len(key), out_batch.ctypes.data_as(_u8p),
        out_lengths.ctypes.data_as(_i32p), est, L,
        offsets.ctypes.data_as(_i64p),
        threads if threads is not None else stage_threads())
    return None if n < 0 else int(n)


def stage_field(buf, key: bytes, max_len: int, pad_to: Optional[int] = None,
                n_hint: Optional[int] = None, threads: Optional[int] = None
                ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """The staging matrix of one top-level string field straight from
    chunk bytes: ``(batch[B, L] u8, lengths[B] i32, offsets[n+1] i64,
    n)``. ``pad_to`` rounds B up (pad rows get -1); ``n_hint``, a
    record count the caller knows, skips the counting walk.

    The arrays are views of a per-thread arena reused across calls:
    consume or copy them before this thread's next call. Bytes past
    ``lengths[i]`` in a row are not zeroed."""
    est = n_hint if n_hint is not None else count_records(buf)
    if est is None:
        return None
    B = pad_to if pad_to and pad_to >= est else est
    arena = getattr(_tls, "stage", None)
    if arena is None or arena[0].shape[0] < B or arena[0].shape[1] != max_len:
        rows = max(B, 1024)
        _tls.stage = arena = (np.zeros((rows, max_len), dtype=np.uint8),
                              np.empty(rows, dtype=np.int32),
                              np.empty(rows + 1, dtype=np.int64))
    batch, lengths, offsets = arena
    n = stage_field_into(buf, key, batch[:B], lengths, n_hint=est,
                         threads=threads, offsets_out=offsets)
    if n is None:
        return None
    lengths[n:B] = -1  # pad rows stay "missing"
    return batch[:B], lengths[:B], offsets[: n + 1], n

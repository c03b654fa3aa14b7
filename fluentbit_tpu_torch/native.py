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
  GrepTables(rules)                          → the packed DFA tables of
                                               (key, dfa) rules
  grep_match(buf, tables)                    → (mask[R, n], offsets, n)
                                               | None
  stage_field_f64(buf, key)                  → (values, kinds, n) | None
  has_flux_stagers()                         → True (flux's stagers)

None means the buffer is malformed or a caller's buffer is too small: the
caller declines to the decoded path.

``grep_match`` is the host DFA twin the raw path's batch hooks of
rewrite_tag, parser and log_to_metrics build their verdicts with, on any
device (as the reference's hooks do): one walk of the chunk finds every
rule key's string value per record and each rule's DFA runs over it, so
values of any length are matched and there are no overflow rows.
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
    build) and bound on first use; raises DeviceError if ``g++`` fails,
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
    lib.fbtpu_grep_match.restype = ctypes.c_longlong
    lib.fbtpu_grep_match.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p, _i64p,
        ctypes.c_longlong, _i32p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int16), _i64p, _i32p, _i32p, _i32p, _u8p,
        ctypes.c_longlong, _i64p, ctypes.c_int32]
    lib.fbtpu_stage_field_f64.restype = ctypes.c_longlong
    lib.fbtpu_stage_field_f64.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_double), _u8p,
        ctypes.c_longlong]
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


class GrepTables:
    """The packed tables of the host DFA twin: rules ``(key: bytes, dfa)``
    (a top-level field name and a ``regex.dfa.DFA``), rules on the same
    key sharing one extraction. The fields the walk reads of the
    reference's ``native.GrepTables``: one int16 ``[S, C]`` transition
    table per rule (``trans_cat`` at ``troffs``), its int32 class map
    (257 entries, 256 the EOL class), start state and class count."""

    __slots__ = ("n_rules", "keys_cat", "key_offs", "key_of_rule",
                 "trans_cat", "troffs", "cmaps", "starts", "ncls")

    def __init__(self, rules):
        keys: list = []
        key_idx: dict = {}
        key_of_rule = []
        trans, troffs, cmaps, starts, ncls = [], [0], [], [], []
        for key, dfa in rules:
            if key not in key_idx:
                key_idx[key] = len(keys)
                keys.append(key)
            key_of_rule.append(key_idx[key])
            t = np.asarray(dfa.trans)
            S, C = t.shape
            if S >= 32768:
                raise ValueError(f"DFA too large for int16 tables ({S})")
            trans.append(np.ascontiguousarray(t, dtype=np.int16).reshape(-1))
            troffs.append(troffs[-1] + t.size)
            cmaps.append(np.ascontiguousarray(dfa.class_map, dtype=np.int32))
            starts.append(int(dfa.start))
            ncls.append(C)
        if not key_of_rule:
            raise ValueError("GrepTables needs at least one rule")
        self.n_rules = len(key_of_rule)
        self.keys_cat = b"".join(keys)
        self.key_offs = np.cumsum([0] + [len(k) for k in keys],
                                  dtype=np.int64)
        self.key_of_rule = np.asarray(key_of_rule, dtype=np.int32)
        self.trans_cat = np.concatenate(trans)
        self.troffs = np.asarray(troffs[:-1], dtype=np.int64)
        self.cmaps = np.concatenate(cmaps)
        self.starts = np.asarray(starts, dtype=np.int32)
        self.ncls = np.asarray(ncls, dtype=np.int32)


def grep_match(buf, tables: GrepTables, n_hint: Optional[int] = None,
               threads: Optional[int] = None
               ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """One walk of the chunk and every rule's DFA over its key's values:
    ``(mask[R, n] bool, offsets[n+1] i64, n)``, ``mask[r, i]`` true when
    record i's value of rule r's key is a string the DFA accepts (a
    missing or non-string value, ``bin`` included, or a non-map body
    never matches). ``n_hint`` is the record count when the caller knows
    it; None if the buffer is malformed or holds more records than the
    hint. ``threads`` fans the DFA sweep out (default
    ``stage_threads()``; chunks below 4096 records sweep serially)."""
    est = n_hint if n_hint is not None else count_records(buf)
    if est is None:
        return None
    p, blen, _keep = _buf_arg(buf)
    cap = max(est, 1)
    match = np.empty((tables.n_rules, cap), dtype=np.uint8)
    offsets = np.empty(cap + 1, dtype=np.int64)
    n = _load().fbtpu_grep_match(
        p, blen, tables.keys_cat, tables.key_offs.ctypes.data_as(_i64p),
        len(tables.key_offs) - 1, tables.key_of_rule.ctypes.data_as(_i32p),
        tables.n_rules,
        tables.trans_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        tables.troffs.ctypes.data_as(_i64p),
        tables.cmaps.ctypes.data_as(_i32p),
        tables.starts.ctypes.data_as(_i32p),
        tables.ncls.ctypes.data_as(_i32p), match.ctypes.data_as(_u8p), cap,
        offsets.ctypes.data_as(_i64p),
        threads if threads is not None else stage_threads())
    if n < 0:
        return None
    return match[:, :n].view(bool), offsets[: n + 1], int(n)


def stage_field_f64(buf, key: bytes, n_hint: Optional[int] = None
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Stage the top-level numeric field ``key`` of each record:
    ``(values[n] f64, kinds[n] u8, n)``, kind 1 for a msgpack integer
    (converted with round-to-nearest, as ``float(int)``), 2 for a float,
    0 for a missing or non-numeric value (numeric strings, bool and nil
    included) or a non-map body; the last occurrence of a duplicate key
    decides. Fresh arrays each call (a flux state keeps the columns).
    None if the buffer is malformed or holds more records than the
    hint."""
    est = n_hint if n_hint is not None else count_records(buf)
    if est is None:
        return None
    p, blen, _keep = _buf_arg(buf)
    values = np.zeros(max(est, 1), dtype=np.float64)
    kinds = np.zeros(max(est, 1), dtype=np.uint8)
    n = _load().fbtpu_stage_field_f64(
        p, blen, key, len(key),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        kinds.ctypes.data_as(_u8p), est)
    if n < 0:
        return None
    return values[:n], kinds[:n], int(n)


def has_flux_stagers() -> bool:
    """True once the codec with flux's column stagers is loaded (the
    port builds it from its own source, so it always has them); raises
    if it cannot be built."""
    _load()
    return True

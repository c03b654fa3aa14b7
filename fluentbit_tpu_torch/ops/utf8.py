"""Device UTF-8 validation — the port of ``fluentbit_tpu/ops/utf8.py``.

Reference: src/simdutf/flb_simdutf_connector.cpp + src/flb_utf8.c (SIMD
Unicode validation; written for the corpus of BASELINE config 2,
benchmarks/utf8_surrogate_bench_10k.ndjson). A byte-class DFA runs over
``[B, L] uint8`` staged batches (``ops.batch.assemble``), validating a
whole batch of records per dispatch.

The automaton is built from the RFC 3629 well-formedness table
(overlongs, UTF-16 surrogates ED A0..BF, and > U+10FFFF all rejected):

  classes: ASCII, 80-8F, 90-9F, A0-BF, C2-DF, E0, E1-EC|EE-EF, ED,
           F0, F1-F3, F4, invalid (C0-C1, F5-FF)
  states:  OK, C1 (one continuation), C2, C3, E0' (A0-BF then C1),
           ED' (80-9F then C1), F0' (90-BF then C2), F4' (80-8F then
           C2), DEAD

``valid[b] = final == OK and lengths[b] >= 0``; positions at or past
``lengths[b]`` count as ASCII, so a sequence cut at the length fails.
On a CUDA tensor the verdict comes from the hand-written kernel
``csrc/utf8.cu`` (``utf8_validate``, K11 of the reference); on a CPU
tensor from the plain torch version ``utf8_validate_plain``, a column
loop of table gathers as the reference's ``lax.scan``. There is no other
path: a failed build or launch raises. ``utf8_validate_pieces_plain``
computes the verdict the way the kernel does (transition maps of 16 B
pieces, composed in order, 512 B windows) and is what the kernel is held
against on the card, beside ``utf8_validate_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .device import ArrayLike, DeviceLike, resolve, to_device
from .grep import _Kernel

# byte classes
_ASCII, _80_8F, _90_9F, _A0_BF, _C2_DF, _E0, _E1_EC_EE_EF, _ED, _F0, \
    _F1_F3, _F4, _BAD = range(12)
N_CLASSES = 12

# states
OK, C1, C2, C3, E0S, EDS, F0S, F4S, DEAD = range(9)
N_STATES = 9


def _byte_classes() -> np.ndarray:
    cls = np.full(256, _BAD, dtype=np.int32)
    cls[0x00:0x80] = _ASCII
    cls[0x80:0x90] = _80_8F
    cls[0x90:0xA0] = _90_9F
    cls[0xA0:0xC0] = _A0_BF
    cls[0xC2:0xE0] = _C2_DF
    cls[0xE0] = _E0
    cls[0xE1:0xED] = _E1_EC_EE_EF
    cls[0xED] = _ED
    cls[0xEE:0xF0] = _E1_EC_EE_EF
    cls[0xF0] = _F0
    cls[0xF1:0xF4] = _F1_F3
    cls[0xF4] = _F4
    return cls


def _transitions() -> np.ndarray:
    t = np.full((N_STATES, N_CLASSES), DEAD, dtype=np.int32)
    cont = (_80_8F, _90_9F, _A0_BF)
    t[OK, _ASCII] = OK
    t[OK, _C2_DF] = C1
    t[OK, _E0] = E0S
    t[OK, _E1_EC_EE_EF] = C2
    t[OK, _ED] = EDS
    t[OK, _F0] = F0S
    t[OK, _F1_F3] = C3
    t[OK, _F4] = F4S
    for c in cont:
        t[C1, c] = OK
        t[C2, c] = C1
        t[C3, c] = C2
    t[E0S, _A0_BF] = C1            # E0: A0-BF only (no overlongs)
    t[EDS, _80_8F] = C1            # ED: 80-9F only (no surrogates)
    t[EDS, _90_9F] = C1
    t[F0S, _90_9F] = C2            # F0: 90-BF only (no overlongs)
    t[F0S, _A0_BF] = C2
    t[F4S, _80_8F] = C2            # F4: 80-8F only (<= U+10FFFF)
    return t


_CLS = _byte_classes()
_TRANS = _transitions()


def validate_bytes(data: bytes) -> bool:
    """CPU reference validator (the oracle the kernel must match)."""
    state = OK
    for b in data:
        state = _TRANS[state, _CLS[b]]
        if state == DEAD:
            return False
    return state == OK


def utf8_validate_plain(class_map: torch.Tensor, trans: torch.Tensor,
                        batch: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """K11 (``Utf8Validator._impl``) in torch ops on any device:
    ``class_map`` int32 [256], ``trans`` int32 [9 * 12], ``batch`` u8
    [B, L], ``lengths`` i32 [B] → bool [B]. The scan
    ``state ← trans[state · 12 + class]`` as a loop over the columns."""
    B, L = batch.shape
    # a uint8 index tensor would be a boolean mask, not a gather
    cls = class_map.long()[batch.long()]  # [B, L]
    pos = torch.arange(L, device=batch.device)
    cls = torch.where(pos[None, :] >= lengths[:, None].long(), _ASCII, cls)
    flat = trans.long().reshape(-1)
    state = torch.full((B,), OK, dtype=torch.long, device=batch.device)
    for t in range(L):
        state = flat[state * N_CLASSES + cls[:, t]]
    return (state == OK) & (lengths >= 0)


# ---------------------------------------------------------------------------
# the kernel's form of the walk: maps of 16 B pieces, composed in order
# ---------------------------------------------------------------------------

#: bytes of a piece, and pieces of a window (a warp's 32 lanes)
PIECE = 16
WINDOW_PIECES = 32

#: A piece's transition map, packed: nibble s (bits 4s .. 4s + 3) is the
#: state that state s (OK .. F4S) reaches over the piece. DEAD is
#: absorbing, so it has no nibble, and a nibble of 8 or more is DEAD.
IDENTITY_MAP = 0x76543210
#: the map of an all-ASCII piece: OK to OK, every other state to DEAD
ASCII_MAP = 0x88888880

_MAP_SHIFTS = 4 * torch.arange(DEAD, dtype=torch.int64)


def unpack_maps(maps: torch.Tensor) -> torch.Tensor:
    """int64 packed maps ``[...]`` → the image of each state below DEAD,
    int64 ``[..., 8]`` (DEAD as 8)."""
    shifts = _MAP_SHIFTS.to(maps.device)
    return ((maps.long()[..., None] >> shifts) & 15).clamp(max=DEAD)


def pack_maps(images: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`unpack_maps` (images of 8 or more as DEAD)."""
    shifts = _MAP_SHIFTS.to(images.device)
    return (images.long().clamp(max=DEAD) << shifts).sum(-1)


def _follow(images: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
    """``images[..., s]`` for each state s of ``states`` (same leading
    dims), DEAD for DEAD."""
    picked = torch.gather(images, -1, states.clamp(max=DEAD - 1))
    return torch.where(states >= DEAD, DEAD, picked)


def compose_maps(first: torch.Tensor, then: torch.Tensor) -> torch.Tensor:
    """The packed map of ``first`` followed by ``then``: state s goes to
    ``then[first[s]]``, and to DEAD where ``first`` sends it there."""
    return pack_maps(_follow(unpack_maps(then), unpack_maps(first)))


def piece_maps(trans: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """Packed maps of pieces given as byte classes ``[..., n]``: each
    state below DEAD walked over the n classes (``trans`` int32 [9 * 12],
    whose DEAD row is all DEAD)."""
    flat = trans.long().reshape(-1)
    state = torch.arange(DEAD, dtype=torch.int64, device=cls.device)
    state = state.expand(*cls.shape[:-1], DEAD)
    for k in range(cls.shape[-1]):
        state = flat[state * N_CLASSES + cls[..., k:k + 1].long()]
    return pack_maps(state)


def utf8_validate_pieces_plain(class_map: torch.Tensor, trans: torch.Tensor,
                               batch: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """K11's verdict the way ``csrc/utf8.cu`` computes it, in torch ops
    on any device (same arguments and result as
    :func:`utf8_validate_plain`). Bytes at or past a row's length count
    as ASCII, and the row is cut into 16 B pieces (the last padded with
    ASCII); each piece's packed map comes from walking its bytes from
    every state; a window's 32 maps compose in a pairwise tree, in
    order, as the warp's shuffles do; and the windows take the carried
    state from OK through the one that holds the row's length."""
    B, L = batch.shape
    dev = batch.device
    n_pieces = -(-L // PIECE)
    windows = -(-n_pieces // WINDOW_PIECES)
    cls = class_map.long()[batch.long()]  # [B, L]
    pos = torch.arange(L, device=dev)
    cls = torch.where(pos[None, :] >= lengths[:, None].long(), _ASCII, cls)
    width = windows * WINDOW_PIECES * PIECE
    cls = torch.nn.functional.pad(cls, (0, width - L), value=_ASCII)
    maps = piece_maps(trans, cls.view(B, windows, WINDOW_PIECES, PIECE))
    while maps.shape[-1] > 1:  # [B, windows, 32] -> [B, windows, 1]
        maps = compose_maps(maps[..., 0::2], maps[..., 1::2])
    images = unpack_maps(maps[..., 0])  # [B, windows, 8]
    n = lengths.long().clamp(min=0, max=L)
    used = -(-n // (WINDOW_PIECES * PIECE))  # windows up to the length
    state = torch.full((B,), OK, dtype=torch.int64, device=dev)
    for w in range(windows):
        step = _follow(images[:, w], state[:, None])[:, 0]
        state = torch.where(used > w, step, state)
    return (state == OK) & (lengths >= 0)


class Utf8ValidateKernel(_Kernel):
    """Wrapper of ``csrc/utf8.cu`` (K11): checks the tensors, makes the
    rows contiguous (an unaligned or strided view is copied), allocates
    the output, launches on the current stream."""

    source, symbol = "utf8", "utf8_validate_launch"
    argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def __call__(self, class_map: torch.Tensor, trans: torch.Tensor,
                 batch: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        dev = batch.device
        if dev.type != "cuda":
            raise ValueError(f"utf8_validate runs on CUDA tensors, got {dev}")
        if batch.dtype != torch.uint8 or batch.dim() != 2:
            raise ValueError("utf8_validate: batch must be uint8 [B, L]")
        B, L = batch.shape
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
            raise ValueError("utf8_validate: lengths must be int32 [B]")
        for name, x, n in (("class_map", class_map, 256),
                           ("trans", trans, N_STATES * N_CLASSES)):
            if (x.dtype != torch.int32 or x.device != dev or x.numel() != n
                    or not x.is_contiguous()):
                raise ValueError(f"utf8_validate: {name} must be a "
                                 f"contiguous int32 [{n}] tensor on {dev}")
        if lengths.device != dev:
            raise ValueError(f"utf8_validate: lengths must be on {dev}")
        batch = batch.contiguous()
        lengths = lengths.contiguous()
        out = torch.empty((B,), dtype=torch.bool, device=dev)
        if B == 0:
            return out
        vec16 = int(L % 16 == 0 and batch.data_ptr() % 16 == 0)
        self._launch(dev, batch.data_ptr(), lengths.data_ptr(),
                     class_map.data_ptr(), trans.data_ptr(), out.data_ptr(),
                     B, L, vec16)
        return out


#: the process's K11 wrapper (one build, one launch count)
utf8_validate = Utf8ValidateKernel()


def validate_rows(class_map: torch.Tensor, trans: torch.Tensor,
                  batch: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for everything else
    (which raises off CUDA)."""
    if batch.device.type == "cpu":
        return utf8_validate_plain(class_map, trans, batch, lengths)
    return utf8_validate(class_map, trans, batch, lengths)


class Utf8Validator:
    """Batched validation on one torch device: ``valid[b]`` per staged
    row. The tables live on the device from construction."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve(device)
        self.class_map = torch.from_numpy(_CLS).to(self.device)
        self.trans = torch.from_numpy(_TRANS.reshape(-1)).to(self.device)

    def dispatch(self, batch: ArrayLike, lengths: ArrayLike) -> torch.Tensor:
        """Move the staged rows to the device and launch; returns
        ``bool[B]`` on the device without waiting for it."""
        b = to_device(batch, torch.uint8, self.device)
        ln = to_device(lengths, torch.int32, self.device)
        return validate_rows(self.class_map, self.trans, b, ln)

    def validate(self, batch: ArrayLike, lengths: ArrayLike) -> np.ndarray:
        """bool [B] (numpy) — row i's first lengths[i] bytes are
        well-formed UTF-8 (rows with negative length report False)."""
        return self.dispatch(batch, lengths).cpu().numpy()


@functools.lru_cache(maxsize=8)
def _cached_validator(device: str) -> Utf8Validator:
    return Utf8Validator(device)


def validator(device: DeviceLike = None) -> Utf8Validator:
    """The process's validator for ``device`` (``cuda`` by default)."""
    return _cached_validator(str(resolve(device)))

"""Device DFA execution for filter_grep — the port of ``fluentbit_tpu/ops/grep.py``.

R compiled DFAs run over a ``[R, B, L] uint8`` batch of staged field
values and give ``bool[R, B]``: does rule r's pattern occur in row b.
The tables are the reference package's, built by the same code (this
module's ``build_tables`` mirrors ``GrepProgram.__init__``): k-byte
super-step tables ``trans_flat[R, max_flat]`` pre-composed to ``C^k``
columns, per-rule class maps with the EOL class at index 256, and for
even k the byte-pair class tables.

On a CUDA tensor the verdict comes from the hand-written kernel
``csrc/grep_dfa.cu`` (the reference's K1/K2 super-symbol prepass fused
with the K3 walk), through ``grep_dfa``. On a CPU tensor it comes from
the plain torch versions below, which transcribe the reference's jnp
programs step for step. There is no other path: a failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..regex.dfa import ACC, DFA, compile_dfa, compose_supersteps
from . import cuda_build
from .device import ArrayLike, DeviceLike, resolve, to_device

# table budget for k-byte super-stepping (bytes); C^k columns * S rows * 4.
# The reference package's TPU budget, kept so tables and decision() match
# it bit for bit; re-deriving k for Hopper is later work.
_TABLE_BUDGET = 4 * 1024 * 1024

#: byte-pair class tables cost R * 65536 * 4 bytes; skip beyond this
_PAIR_MAP_MAX_RULES = 32

#: rule count from which the reference keeps one fused table set (its
#: rule-sharded mesh regime) instead of splitting per-k child programs
_RULE_SHARD_R = 64

Tables = Dict[str, torch.Tensor]


def choose_k(n_states: int, n_classes: int, budget: int = _TABLE_BUDGET) -> int:
    """Largest stride whose composed table fits the budget (strides up
    to 6 — small alphabets with few states compose deep)."""
    k = 1
    while k < 6:
        cols = n_classes ** (k + 1)
        if n_states * cols * 4 > budget:
            break
        k += 1
    return k


def build_tables(dfas: Sequence[DFA], k: int) -> Dict[str, np.ndarray]:
    """The numpy table set of R DFAs at stride k — the same arrays as the
    reference's ``GrepProgram._np`` (``pair_maps`` only for even k and
    R <= 32, where the reference has None)."""
    R = len(dfas)
    tables = [compose_supersteps(d.trans, k) for d in dfas]
    max_flat = max(t.shape[0] * t.shape[1] for t in tables)
    flat = np.zeros((R, max_flat), dtype=np.int32)
    for r, t in enumerate(tables):
        flat[r, : t.size] = t.reshape(-1)
    cmaps = np.zeros((R, 257), dtype=np.int32)
    for r, d in enumerate(dfas):
        cmaps[r] = d.class_map.astype(np.int32)
    out = {
        "trans_flat": flat,
        "C": np.asarray([d.n_classes for d in dfas], dtype=np.int32),
        "Ck": np.asarray([d.n_classes ** k for d in dfas], dtype=np.int32),
        "class_maps": cmaps,
        "eol_cls": np.asarray([d.eol_class for d in dfas], dtype=np.int32),
        "starts": np.asarray([d.start for d in dfas], dtype=np.int32),
    }
    if k % 2 == 0 and R <= _PAIR_MAP_MAX_RULES:
        pair_maps = np.zeros((R, 65536), dtype=np.int32)
        w = np.arange(65536, dtype=np.int64)
        for r, d in enumerate(dfas):
            cm = d.class_map[:256].astype(np.int64)
            pair_maps[r] = (cm[w & 255] * d.n_classes
                            + cm[w >> 8]).astype(np.int32)
        out["pair_maps"] = pair_maps
    return out


# ---------------------------------------------------------------------------
# plain versions (torch ops on any device; the kernel's CPU path and its
# reference on the card)
# ---------------------------------------------------------------------------


def _classes(class_maps: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-rule byte → class gather: class_maps[r][b[r, ...]]."""
    return torch.gather(class_maps, 1, b.flatten(1).long()).reshape(b.shape)


def super_symbols_plain(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                        k: int) -> torch.Tensor:
    """K1 (``GrepProgram._super_symbols``): bytes → per-rule k-byte
    super-symbols ``[R, B, Lk]`` int32."""
    R, B, L = batch.shape
    cls = _classes(t["class_maps"], batch)  # [R,B,L] i32
    pos = torch.arange(L, dtype=torch.int32, device=batch.device)
    pad = pos[None, None, :] >= lengths[:, :, None]
    eol = t["eol_cls"][:, None, None]
    cls = torch.where(pad, eol, cls)
    # append EOL block: guarantees >=1 EOL and rounds L to multiple of k
    extra = (k - (L % k)) % k + k
    cls = torch.cat([cls, eol.expand(R, B, extra)], dim=2)
    Lk = cls.shape[2] // k
    cls = cls.reshape(R, B, Lk, k)
    comb = cls[..., 0]
    for j in range(1, k):
        comb = comb * t["C"][:, None, None] + cls[..., j]
    return comb


def super_symbols_pairs_plain(t: Tables, batch: torch.Tensor,
                              lengths: torch.Tensor, k: int) -> torch.Tensor:
    """K2 (``GrepProgram._super_symbols_pairs``): the even-k packing
    through the byte-pair class tables, with the mixed boundary pair and
    the fully padded pairs fixed up in pair space."""
    R, B, L = batch.shape
    if L % 2:
        batch = torch.cat([batch, torch.zeros((R, B, 1), dtype=batch.dtype,
                                              device=batch.device)], dim=2)
        L += 1
    idx = batch[..., 0::2].int() + 256 * batch[..., 1::2].int()  # [R,B,L2]
    pcls = _classes(t["pair_maps"], idx)
    L2 = L // 2
    t2 = torch.arange(L2, dtype=torch.int32, device=batch.device) * 2
    C = t["C"][:, None, None]
    eol = t["eol_cls"][:, None, None]
    eol_pair = eol * C + eol
    if L2:  # (an empty row has no pair to fix up, nor a last byte to read)
        # boundary pair (first byte valid, second padded): class(last)*C + eol
        last_idx = torch.clamp(lengths - 1, min=0)[..., None]  # [R,B,1]
        last_b = torch.gather(batch, 2, last_idx.long())
        mixed = _classes(t["class_maps"], last_b) * C + eol
        pcls = torch.where(t2[None, None, :] + 1 == lengths[:, :, None],
                           mixed, pcls)
        pcls = torch.where(t2[None, None, :] >= lengths[:, :, None],
                           eol_pair, pcls)
    # append EOL-pair block: >=1 full EOL super-symbol, rounds L2 to k/2
    k2 = k // 2
    extra = (k2 - (L2 % k2)) % k2 + k2
    pcls = torch.cat([pcls, eol_pair.expand(R, B, extra)], dim=2)
    Lk = pcls.shape[2] // k2
    pcls = pcls.reshape(R, B, Lk, k2)
    C2 = C * C
    comb = pcls[..., 0]
    for j in range(1, k2):
        comb = comb * C2 + pcls[..., j]
    return comb


def match_plain(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                k: int) -> torch.Tensor:
    """K3 (``GrepProgram._match_impl``) over K1/K2's symbols: the scan
    ``state ← trans_flat[r, state·Ck[r] + sym]`` as a loop of gathers;
    ``(final == ACC) & (lengths >= 0)``."""
    R, B, _ = batch.shape
    if "pair_maps" in t:
        comb = super_symbols_pairs_plain(t, batch, lengths, k)
    else:
        comb = super_symbols_plain(t, batch, lengths, k)
    state = t["starts"][:, None].expand(R, B)
    Ck = t["Ck"][:, None]
    for step in range(comb.shape[2]):
        idx = state * Ck + comb[:, :, step]
        state = torch.gather(t["trans_flat"], 1, idx.long())
    return (state == ACC) & (lengths >= 0)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

#: the tables the kernel reads, with their ranks (pair_maps it does not)
_TABLE_DIMS = {"trans_flat": 2, "class_maps": 2, "C": 1, "Ck": 1,
               "eol_cls": 1, "starts": 1}


class GrepDfaKernel:
    """Wrapper of ``csrc/grep_dfa.cu``: checks the tensors, allocates the
    output, launches on the current stream. ``launches`` counts the
    launches made (a plain integer a caller may reset)."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = cuda_build.libraries.load("grep_dfa").grep_dfa_launch
            fn.argtypes = ([ctypes.c_void_p] * 9
                           + [ctypes.c_int] * 4
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                 k: int) -> torch.Tensor:
        dev = batch.device
        if dev.type != "cuda":
            raise ValueError(f"grep_dfa runs on CUDA tensors, got {dev}")
        if batch.dtype != torch.uint8 or batch.dim() != 3:
            raise ValueError("grep_dfa: batch must be uint8 [R, B, L]")
        R, B, L = batch.shape
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (R, B):
            raise ValueError("grep_dfa: lengths must be int32 [R, B]")
        if not 1 <= k <= 6 or R > 65535:
            raise ValueError(f"grep_dfa: unsupported k={k} or R={R}")
        for name, dims in _TABLE_DIMS.items():
            x = t[name]
            if (x.dtype != torch.int32 or x.device != dev
                    or x.dim() != dims or x.shape[0] != R
                    or not x.is_contiguous()):
                raise ValueError(f"grep_dfa: table {name} must be a "
                                 f"contiguous int32 [{R}, ...] tensor on {dev}")
        if t["class_maps"].shape[1] != 257:
            raise ValueError("grep_dfa: class_maps must be [R, 257]")
        for name, x in (("batch", batch), ("lengths", lengths)):
            if x.device != dev or not x.is_contiguous():
                raise ValueError(f"grep_dfa: {name} must be contiguous on {dev}")
        out = torch.empty((R, B), dtype=torch.bool, device=dev)
        if R * B == 0:
            return out
        fn = self._launcher()
        vec16 = int(L % 16 == 0 and batch.data_ptr() % 16 == 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(batch.data_ptr(), lengths.data_ptr(),
                    t["trans_flat"].data_ptr(), t["class_maps"].data_ptr(),
                    t["C"].data_ptr(), t["Ck"].data_ptr(),
                    t["eol_cls"].data_ptr(), t["starts"].data_ptr(),
                    out.data_ptr(), R, B, L, k, t["trans_flat"].shape[1],
                    vec16, stream)
        if rc != 0:
            raise RuntimeError(f"grep_dfa launch failed: CUDA error {rc}")
        self.launches += 1
        return out


#: the process's grep_dfa kernel wrapper (one build, one launch count)
grep_dfa = GrepDfaKernel()


def match_rows(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
               k: int) -> torch.Tensor:
    """``bool[R, B]`` verdicts: the plain version for CPU tensors, the
    CUDA kernel for everything else (which raises off CUDA)."""
    if batch.device.type == "cpu":
        return match_plain(t, batch, lengths, k)
    return grep_dfa(t, batch, lengths, k)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class TorchGrepProgram:
    """R compiled DFAs fused into one device program on ``device``.

    ``match(batch_u8[R,B,L], lengths[R,B]) -> bool[R,B]`` (numpy), with
    the surface of the reference's ``GrepProgram``: ``dispatch``,
    ``decision()``, the per-k child split when rules disagree on k.
    """

    def __init__(self, dfas: Sequence[DFA], max_len: int = 512,
                 device: DeviceLike = None, kernel: str = "auto"):
        if kernel not in ("scan", "assoc", "auto"):
            raise ValueError(f"unknown grep kernel {kernel!r}")
        if kernel == "assoc":
            raise NotImplementedError(
                "the parallel-in-time assoc kernel (K4) is not ported yet")
        self.dfas = list(dfas)
        self.max_len = max_len
        self.device = resolve(device)
        self.kernel = kernel
        # "auto" resolves to the scan kernel until K4 has a counterpart
        self.kernel_resolved = "scan"
        R = len(self.dfas)
        self.k_by_rule = [choose_k(d.n_states, d.n_classes) for d in self.dfas]
        self.max_states = max(d.n_states for d in self.dfas)
        self._children: Optional[List["TorchGrepProgram"]] = None
        self._child_idxs: Optional[List[torch.Tensor]] = None
        self._inv_perm: Optional[torch.Tensor] = None
        self.tables: Optional[Tables] = None
        distinct_ks = sorted(set(self.k_by_rule))
        if len(distinct_ks) > 1 and R < _RULE_SHARD_R:
            # rules disagree on k: one homogeneous child program per k,
            # merged back to rule order with the inverse permutation
            idxs = [np.asarray([i for i, kk in enumerate(self.k_by_rule)
                                if kk == k], dtype=np.int64)
                    for k in distinct_ks]
            self._children = [
                TorchGrepProgram([self.dfas[int(i)] for i in ix], max_len,
                                 self.device, kernel)
                for ix in idxs
            ]
            self._child_idxs = [torch.from_numpy(ix).to(self.device)
                                for ix in idxs]
            self._inv_perm = torch.from_numpy(
                np.argsort(np.concatenate(idxs))).to(self.device)
            self.k = distinct_ks[0]
            return
        self.k = min(self.k_by_rule)
        self._set_tables(build_tables(self.dfas, self.k))

    def _set_tables(self, np_tables: Dict[str, Optional[np.ndarray]]) -> None:
        """Upload the tables this device's route reads: all of them for
        the CPU plain versions, the kernel's (no ``pair_maps``) on CUDA."""
        cpu = self.device.type == "cpu"
        self.tables = {
            name: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for name, a in np_tables.items()
            if a is not None and (cpu or name in _TABLE_DIMS)
        }

    def decision(self) -> dict:
        """The resolved compile/kernel decisions, per rule — the same
        dict as the reference's ``GrepProgram.decision()``, except that
        ``kernel_resolved`` is known at construction ("scan")."""
        rules = []
        for r, d in enumerate(self.dfas):
            st = d.shrink
            rules.append({
                "pattern": d.pattern,
                "s_raw": st.s_raw if st else None,
                "c_raw": st.c_raw if st else None,
                "s": d.n_states,
                "c": d.n_classes,
                "minimized": bool(st.minimized) if st else False,
                "approx_of": st.approx_of if st else None,
                "k": self.k_by_rule[r],
            })
        k_groups = ([int(c.k) for c in self._children]
                    if self._children is not None else [int(self.k)])
        return {
            "rules": rules,
            "k": int(self.k),
            "k_groups": k_groups,
            "max_states": int(self.max_states),
            "assoc_eligible": self.max_states <= 64,
            "kernel": self.kernel,
            "kernel_resolved": self.kernel_resolved,
        }

    def dispatch(self, batch: ArrayLike, lengths: ArrayLike) -> torch.Tensor:
        """Move the staged batch to the device (one non-blocking copy
        each for bytes and lengths; pinned host memory makes it
        asynchronous) and launch; returns ``bool[R, B]`` on the device
        without waiting for it."""
        b = to_device(batch, torch.uint8, self.device)
        ln = to_device(lengths, torch.int32, self.device)
        if self._children is not None:
            parts = [c.dispatch(b.index_select(0, ix), ln.index_select(0, ix))
                     for c, ix in zip(self._children, self._child_idxs)]
            return torch.cat(parts, dim=0).index_select(0, self._inv_perm)
        return match_rows(self.tables, b, ln, self.k)

    def match(self, batch: ArrayLike, lengths: ArrayLike) -> np.ndarray:
        """Run the program; returns bool [R, B] (numpy)."""
        return self.dispatch(batch, lengths).cpu().numpy()


def from_jax_tables(np_tables: Dict[str, Optional[np.ndarray]], k: int,
                    max_len: int = 512, device: DeviceLike = None,
                    dfas: Sequence[DFA] = ()) -> TorchGrepProgram:
    """A single-k program over a table set carried across from the
    reference package (``GrepProgram._np``: trans_flat, C, Ck,
    class_maps, eol_cls, starts, pair_maps or None). Read ``_np`` before
    the reference program materializes: materializing frees it.
    ``dfas`` only feeds ``decision()``."""
    prog = TorchGrepProgram.__new__(TorchGrepProgram)
    prog.dfas = list(dfas)
    prog.max_len = max_len
    prog.device = resolve(device)
    prog.kernel = "auto"
    prog.kernel_resolved = "scan"
    prog.k = int(k)
    prog.k_by_rule = [prog.k] * int(np_tables["starts"].shape[0])
    prog.max_states = max((d.n_states for d in prog.dfas), default=0)
    prog._children = prog._child_idxs = prog._inv_perm = None
    prog._set_tables(np_tables)
    return prog


@functools.lru_cache(maxsize=64)
def _cached_program(patterns: Tuple[str, ...], max_len: int,
                    device: str) -> TorchGrepProgram:
    return TorchGrepProgram([compile_dfa(p) for p in patterns], max_len,
                            device)


def program_for(patterns: Sequence[str], max_len: int = 512,
                device: DeviceLike = None) -> TorchGrepProgram:
    """Compiled-program cache keyed by the pattern tuple, row width and
    device."""
    return _cached_program(tuple(patterns), max_len, str(resolve(device)))

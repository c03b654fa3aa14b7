"""Device DFA execution for filter_grep — the port of ``fluentbit_tpu/ops/grep.py``.

R compiled DFAs run over a ``[R, B, L] uint8`` batch of staged field
values and give ``bool[R, B]``: does rule r's pattern occur in row b.
The tables are the reference package's, built by the same code (this
module's ``build_tables`` mirrors ``GrepProgram.__init__``): k-byte
super-step tables ``trans_flat[R, max_flat]`` pre-composed to ``C^k``
columns, per-rule class maps with the EOL class at index 256, and for
even k the byte-pair class tables.

Two kernels compute the verdict, chosen per program as the reference's
``_resolve_kernel`` chooses: the sequential scan (K3) and the
parallel-in-time walk (K4, "assoc"), which walks segments of the line
over all S states and composes the segment functions in a log-depth
tree. ``kernel="auto"`` takes scan on the CPU and assoc on CUDA when the
program has at most 64 states. On a CUDA tensor the verdict comes from
the hand-written kernel, ``csrc/grep_dfa.cu`` (the K1/K2 super-symbol
prepass fused with the K3 walk, through ``grep_dfa``) or
``csrc/grep_assoc.cu`` (K4, through ``grep_assoc``). On a CPU tensor it
comes from the plain torch versions below, which transcribe the
reference's jnp programs step for step. There is no other path: a failed
build or launch raises.

The kernels walk each row only up to its length and stop at DEAD or ACC
(exact by the DFA contract ``check_contract`` enforces), over tables of
their own built beside the reference's (``build_stride_tables``: uint16,
symbol-major, at the largest stride whose table fits a block's shared
memory). ``match_stop_plain`` and ``match_assoc_cut_plain`` are those
walks in plain torch, held against the reference by the CPU tests.

K5, the sharded dispatch (``dispatch_mesh``, ``match_mesh``,
``match_sharded``), runs the same kernels once per shard of an
``ops.mesh.Mesh``: the batch axis (or, for large rule sets, the rule
axis) is cut into one slice per mesh entry, each slice and its table
shard go to that entry's device, and every shard launches before any
result is read back. Per-rule match counts come from the kernels' counts
epilogue (one warp-aggregated atomic add per warp of verdicts), summed
over the shards of the batch variant (the reference's ``psum``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..regex.dfa import ACC, DEAD, DFA, compile_dfa, compose_supersteps
from . import cuda_build
from .device import (ArrayLike, DeviceError, DeviceLike, dispatch_point,
                     resolve, to_device)
from .mesh import (Mesh, MeshLaunches, mesh_key, pad_to_devices,
                   partition_rules, replicated_table_bytes, shard_leaf)

# table budget for k-byte super-stepping (bytes); C^k columns * S rows * 4.
# The reference package's TPU budget, kept so tables and decision() match
# it bit for bit; re-deriving k for Hopper is later work.
_TABLE_BUDGET = 4 * 1024 * 1024

#: byte-pair class tables cost R * 65536 * 4 bytes; skip beyond this
_PAIR_MAP_MAX_RULES = 32

#: rule count from which a program keeps one fused table set (the
#: rule-sharded mesh regime) instead of splitting per-k child programs,
#: and from which ``mesh_variant`` shards the rule axis
#: (``FBTPU_MESH_RULE_SHARD_R``)
_RULE_SHARD_R = 64

#: replicated table bytes (times the shard count) past which
#: ``mesh_variant`` shards the rule axis (``FBTPU_MESH_TABLE_BUDGET``)
_MESH_TABLE_BUDGET = 64 * 1024 * 1024


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))

#: "auto" takes the assoc kernel on an accelerator up to this many states
_ASSOC_MAX_STATES = 64

#: shared memory a block may take on Hopper (227 KB)
_MAX_SMEM = 232448

#: a kernel block's shared bytes ahead of its table: an mbarrier (16 B)
#: and the class map (260 int32)
_SMEM_HEAD = 16 + 260 * 4

#: the stride tables' byte budgets. K3: half an SM's shared memory
#: (228 KB, 1 KB reserved a block), so that two blocks share an SM; on
#: the card a block's whole 227 KB lost wherever it gave a larger table
#: (GET at stride 6, 156 KB: PERF.md §6). K4 walks every state of a
#: row's segments, so a longer stride saves it little and each of its
#: many blocks stages the table: 16 KB, at a stride dividing 16 (a lane
#: packs the symbols of its own 16 bytes), stride 1 beyond that while a
#: table stays under 65,536 entries (K4 keeps ``sym * S`` in 16 bits).
_SCAN_TABLE_BUDGET = (228 * 1024 - 2 * 1024) // 2 - _SMEM_HEAD
_ASSOC_TABLE_BUDGET = 16 * 1024
_ASSOC_TABLE_FLOOR = 2 * 65535
_ASSOC_STRIDES = (1, 2, 4)

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
    R <= 32, where the reference has None), plus ``n_states`` [R], each
    rule's state count, which K4 reads."""
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
        # the assoc kernel walks each rule over its own states only
        "n_states": np.asarray([d.n_states for d in dfas], dtype=np.int32),
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


def check_contract(dfas: Sequence[DFA]) -> None:
    """Raise ValueError, naming the pattern, unless every DFA keeps the
    contract the kernels' early stop rests on: DEAD and ACC map to
    themselves on every class, and the EOL class sends every state to
    DEAD or ACC (``compile_dfa``'s tables always do: its accept state
    absorbs, and no pattern edge consumes EOL)."""
    for d in dfas:
        t = np.asarray(d.trans)
        ok = (t.ndim == 2 and t.shape[0] > ACC
              and bool((t[DEAD] == DEAD).all())
              and bool((t[ACC] == ACC).all())
              and bool(np.isin(t[:, d.eol_class], (DEAD, ACC)).all()))
        if not ok:
            raise ValueError(
                f"the DFA of {d.pattern!r} breaks the grep kernels' "
                f"contract (DEAD and ACC absorbing, EOL to DEAD or ACC)")


def check_flat_contract(np_tables: Dict[str, Optional[np.ndarray]],
                        k: int) -> None:
    """``check_contract`` on a stride-k table set alone (no DFAs): each
    rule's DEAD and ACC rows map to themselves, and every super-symbol
    that ends in the EOL class maps every state to DEAD or ACC."""
    flat = np_tables["trans_flat"]
    for r in range(flat.shape[0]):
        C, Ck = int(np_tables["C"][r]), int(np_tables["Ck"][r])
        eol = int(np_tables["eol_cls"][r])
        rows = flat[r, : flat.shape[1] // Ck * Ck].reshape(-1, Ck)
        ok = (rows.shape[0] > ACC and bool((rows[DEAD] == DEAD).all())
              and bool((rows[ACC] == ACC).all())
              and bool(np.isin(rows[:, eol::C], (DEAD, ACC)).all()))
        if not ok:
            raise ValueError(f"rule {r}'s stride-{k} table breaks the grep "
                             f"kernels' contract (DEAD and ACC absorbing, "
                             f"EOL to DEAD or ACC)")


def stride_for(dfa: DFA, k: int, budget: int,
               strides: Sequence[int] = (1, 2, 3, 4, 5, 6)) -> int:
    """The largest stride ``kp <= k`` of ``strides`` whose uint16 table
    (``S * C^kp * 2`` bytes, symbols below 65536) fits ``budget``; 0
    when none does."""
    kp = 0
    for s in range(1, k + 1):
        cols = dfa.n_classes ** s
        if cols > 65536 or dfa.n_states * cols * 2 > budget:
            break
        if s in strides:
            kp = s
    return kp


def build_stride_tables(dfas: Sequence[DFA], k: int, budget: int,
                        floor: int = 0,
                        strides: Sequence[int] = (1, 2, 3, 4, 5, 6)
                        ) -> Dict[str, np.ndarray]:
    """The kernels' own tables, beside the reference's (``build_tables``):
    ``tab16`` int16 ``[R, W]`` (read as uint16), rule r's table at its
    stride ``kp[r]`` (``stride_for``), symbol-major so that
    ``tab16[r, sym * n_states[r] + s]`` is the state after super-symbol
    ``sym`` from state s; W is a multiple of 8 (16 B rows for the bulk
    copy), at the largest of ``strides`` that fits; a rule that fits
    ``budget`` at no stride takes stride 1 if its table fits ``floor``.
    Empty when some rule fits at no stride: K3 then reads
    ``trans_flat``."""
    kps = [stride_for(d, k, budget, strides) or stride_for(d, 1, floor)
           for d in dfas]
    if not kps or min(kps) == 0:
        return {}
    tabs = [np.ascontiguousarray(compose_supersteps(d.trans, kp).T)
            for d, kp in zip(dfas, kps)]
    width = -(-max(t.size for t in tabs) // 8) * 8
    tab = np.zeros((len(dfas), width), dtype=np.uint16)
    for r, t in enumerate(tabs):
        tab[r, : t.size] = t.reshape(-1)
    return {"tab16": tab.view(np.int16),
            "kp": np.asarray(kps, dtype=np.int32)}


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


def _symbols(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
             k: int) -> torch.Tensor:
    """K2's symbols where the pair tables exist, else K1's (the
    reference's ``_super_symbols`` dispatch)."""
    if "pair_maps" in t:
        return super_symbols_pairs_plain(t, batch, lengths, k)
    return super_symbols_plain(t, batch, lengths, k)


def match_plain(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                k: int) -> torch.Tensor:
    """K3 (``GrepProgram._match_impl``) over K1/K2's symbols: the scan
    ``state ← trans_flat[r, state·Ck[r] + sym]`` as a loop of gathers;
    ``(final == ACC) & (lengths >= 0)``."""
    R, B, _ = batch.shape
    comb = _symbols(t, batch, lengths, k)
    state = t["starts"][:, None].expand(R, B)
    Ck = t["Ck"][:, None]
    for step in range(comb.shape[2]):
        idx = state * Ck + comb[:, :, step]
        state = torch.gather(t["trans_flat"], 1, idx.long())
    return (state == ACC) & (lengths >= 0)


def segment_grid(Lk: int, segment: int) -> Tuple[int, int]:
    """(G, G2): the segments of ``segment`` super-symbols that cover Lk,
    and G rounded up to a power of two (the composition tree's width)."""
    G = -(-Lk // segment)
    G2 = 1
    while G2 < G:
        G2 *= 2
    return G, G2


def match_assoc_plain(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                      k: int, S: int, segment: int) -> torch.Tensor:
    """K4 (``GrepProgram._match_assoc_impl``): the line's symbols as
    transition functions. Each segment of ``segment`` super-symbols is
    walked from all S states (``[R, B, G2, S]``), the segments compose
    in a log2(G2)-deep tree ``(f∘g)[s] = g[f[s]]``, and the whole-line
    function is read at ``starts``; ``& (lengths >= 0)``.

    States ``s >= n_states[r]`` of a rule with fewer states than S index
    past its ``trans_flat`` row; the index is clamped into the row as
    JAX clamps an out-of-range gather. Those states are unreachable from
    ``starts[r]``, so the verdict does not depend on what they read."""
    R, B, _ = batch.shape
    m = segment
    comb = _symbols(t, batch, lengths, k)  # [R, B, Lk]
    Lk = comb.shape[2]
    _, G2 = segment_grid(Lk, m)
    pad = G2 * m - Lk
    if pad:
        # super-symbol of k EOL classes: eol * (C^{k-1}+...+C+1)
        radix = torch.ones_like(t["C"])
        eol_super = torch.zeros_like(t["eol_cls"])
        for _ in range(k):
            eol_super = eol_super + t["eol_cls"] * radix
            radix = radix * t["C"]
        comb = torch.cat([comb, eol_super[:, None, None].expand(R, B, pad)],
                         dim=2)
    comb = comb.reshape(R, B, G2, m)
    tf = t["trans_flat"]
    last = tf.shape[1] - 1
    Ck = t["Ck"][:, None, None, None]

    def step(F: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        idx = (F * Ck + c[..., None]).clamp(max=last).long()
        return torch.gather(tf, 1, idx.reshape(R, -1)).reshape(idx.shape)

    states = torch.arange(S, dtype=torch.int32, device=batch.device)
    F = states[None, None, None, :].expand(R, B, G2, S)
    for j in range(m):
        F = step(F, comb[..., j])
    while F.shape[2] > 1:  # the tree: the width halves each round
        f, g = F[:, :, 0::2], F[:, :, 1::2]
        F = torch.gather(g, 3, f.long())
    start = t["starts"][:, None, None].expand(R, B, 1).long()
    final = torch.gather(F[:, :, 0, :], 2, start)[..., 0]
    return (final == ACC) & (lengths >= 0)


def _rule_walk(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
               k: int, r: int):
    """Rule r's side of the kernels' stop rule: its table as int32, the
    index of a step (``(state, sym) -> position``), and per
    row the super-symbols ``[B, J]`` and their count ``n_sym`` =
    min(len, L) // stride + 1 (the last symbol holds the EOL class:
    bytes from the length on read as EOL, and never as data)."""
    B, L = batch.shape[1:]
    C, eol = int(t["C"][r]), int(t["eol_cls"][r])
    if "tab16" in t:  # K3's shared half and K4: the stride table
        ks, S = int(t["kp"][r]), int(t["n_states"][r])
        tab = t["tab16"][r].int() & 0xFFFF

        def index(state, sym):
            return sym * S + state
    else:  # K3's global half: trans_flat at the program's k
        ks, Ck = k, int(t["Ck"][r])
        tab = t["trans_flat"][r]

        def index(state, sym):
            return state * Ck + sym
    lim = lengths[r].clamp(min=0, max=L)
    n_sym = lim // ks + 1
    J = int(n_sym.max()) if B else 0
    pos = torch.arange(J * ks, device=batch.device)
    src = batch[r][:, pos.clamp(max=max(L - 1, 0))] if L else \
        batch.new_zeros((B, J * ks))
    cls = t["class_maps"][r][src.long()]
    cls = torch.where(pos[None, :] < lim[:, None], cls,
                      torch.full_like(cls, eol)).reshape(B, J, ks)
    sym = cls[..., 0]
    for j in range(1, ks):
        sym = sym * C + cls[..., j]
    return tab, index, sym, n_sym


def match_stop_plain(t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                     k: int) -> torch.Tensor:
    """K3 as ``csrc/grep_dfa.cu`` walks it, in plain torch: each row
    steps through its own ``n_sym`` super-symbols only (bytes up to its
    length, then the step holding EOL) and stops at DEAD or ACC; over
    ``tab16`` at the rule's stride where the table set has it (the
    shared half), else over ``trans_flat`` at k (the global half)."""
    R, B, _ = batch.shape
    out = torch.zeros((R, B), dtype=torch.bool, device=batch.device)
    for r in range(R):
        tab, index, sym, n_sym = _rule_walk(t, batch, lengths, k, r)
        state = torch.full((B,), int(t["starts"][r]), dtype=torch.int32,
                           device=batch.device)
        for j in range(sym.shape[1]):
            live = (j < n_sym) & (state > ACC)
            if not bool(live.any()):
                break
            nxt = tab[index(state, sym[:, j]).long()]
            state = torch.where(live, nxt, state)
        out[r] = (state == ACC) & (lengths[r] >= 0)
    return out


def match_assoc_cut_plain(t: Tables, batch: torch.Tensor,
                          lengths: torch.Tensor, S: int,
                          segment: int) -> torch.Tensor:
    """K4 as ``csrc/grep_assoc.cu`` walks it, in plain torch: per rule,
    over ``tab16`` at its stride, a row's ``n_sym`` super-symbols cut
    into ``ceil(n_sym / segment)`` segments, each walked from all S
    states (steps past ``n_sym``, and states past the rule's own, keep
    the identity), composed in a tree ``(f∘g)[s] = g[f[s]]`` and read at
    ``starts``. The segments past the one holding the first EOL class,
    which the reference composes too, are left out."""
    if "tab16" not in t:
        raise ValueError("the assoc walk reads the stride tables (tab16)")
    R, B, _ = batch.shape
    m = segment
    out = torch.zeros((R, B), dtype=torch.bool, device=batch.device)
    states = torch.arange(S, dtype=torch.int32, device=batch.device)
    for r in range(R):
        tab, index, sym, n_sym = _rule_walk(t, batch, lengths, 0, r)
        G = -(-sym.shape[1] // m)
        G2 = 1
        while G2 < G:
            G2 *= 2
        sym = torch.cat([sym, sym.new_zeros((B, G2 * m - sym.shape[1]))], 1)
        own = states < int(t["n_states"][r])
        F = states[None, None, :].expand(B, G2, S)
        for i in range(m):
            j = torch.arange(G2, device=batch.device) * m + i  # [G2]
            live = (j[None, :] < n_sym[:, None])[..., None] & own
            nxt = tab[index(F.clamp(max=int(t["n_states"][r]) - 1),
                            sym[:, j][..., None]).long()]
            F = torch.where(live, nxt, F)
        while F.shape[1] > 1:  # the tree: the width halves each round
            F = torch.gather(F[:, 1::2], 2, F[:, 0::2].long())
        final = F[:, 0, int(t["starts"][r])]
        out[r] = (final == ACC) & (lengths[r] >= 0)
    return out


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

#: the tables the kernels read, with their ranks — what a CUDA program
#: uploads (pair_maps neither kernel reads): the reference's, and the
#: stride tables (``tab16``, int16, and ``kp``) with ``n_states``
_TABLE_DIMS = {"trans_flat": 2, "class_maps": 2, "C": 1, "Ck": 1,
               "eol_cls": 1, "starts": 1, "n_states": 1, "tab16": 2,
               "kp": 1}
_SCAN_TABLES = ("trans_flat", "class_maps", "C", "Ck", "eol_cls", "starts")
_STRIDE_TABLES = ("n_states", "tab16", "kp")
_ASSOC_TABLES = ("class_maps", "C", "eol_cls", "starts") + _STRIDE_TABLES

#: K4's warps per block (``csrc/grep_assoc.cu`` kWarps)
_ASSOC_WARPS = 8
#: K4's symbols a row staged at once: 8 segments at the default 32, one
#: chunk of the walk's registers
_ASSOC_WINDOW = 256


def _check_launch(kernel: str, t: Tables, batch: torch.Tensor,
                  lengths: torch.Tensor, k: int, names: Sequence[str]):
    """Raise ValueError unless the tensors are what the kernels take:
    contiguous, on one CUDA device, of the right types and shapes."""
    dev = batch.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    if batch.dtype != torch.uint8 or batch.dim() != 3:
        raise ValueError(f"{kernel}: batch must be uint8 [R, B, L]")
    R, B, _ = batch.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (R, B):
        raise ValueError(f"{kernel}: lengths must be int32 [R, B]")
    if not 1 <= k <= 6 or R > 65535:
        raise ValueError(f"{kernel}: unsupported k={k} or R={R}")
    for name in names:
        x = t.get(name)
        dtype = torch.int16 if name == "tab16" else torch.int32
        if (x is None or x.dtype != dtype or x.device != dev
                or x.dim() != _TABLE_DIMS[name] or x.shape[0] != R
                or not x.is_contiguous()):
            raise ValueError(f"{kernel}: table {name} must be a contiguous "
                             f"{dtype} [{R}, ...] tensor on {dev}")
    if "tab16" in names and t["tab16"].shape[1] % 8:
        raise ValueError(f"{kernel}: tab16 rows must hold a multiple of 8")
    if t["class_maps"].shape[1] != 257:
        raise ValueError(f"{kernel}: class_maps must be [R, 257]")
    for name, x in (("batch", batch), ("lengths", lengths)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous on {dev}")


def _counts_ptr(kernel: str, counts: Optional[torch.Tensor],
                batch: torch.Tensor) -> Optional[int]:
    """The device pointer of the counts epilogue's int32 [R] output
    (None: the kernel counts nothing)."""
    if counts is None:
        return None
    R = batch.shape[0]
    if (counts.dtype != torch.int32 or tuple(counts.shape) != (R,)
            or counts.device != batch.device or not counts.is_contiguous()):
        raise ValueError(f"{kernel}: counts must be a contiguous int32 "
                         f"[{R}] tensor on {batch.device}")
    return counts.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: Tables, name: str) -> Optional[int]:
    return t[name].data_ptr() if name in t else None


#: guards the launch counters: inputs under grep append in parallel
_COUNT_LOCK = threading.Lock()


class _Kernel:
    """A ctypes-bound launcher of ``csrc/<source>.cu`` with a launch
    count (a plain integer a caller may reset)."""

    source = ""
    symbol = ""
    argtypes: list = []

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            lib = cuda_build.libraries.load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, dev: torch.device, *args) -> None:
        """Launch on ``dev``'s current stream; raise DeviceError on a
        CUDA error."""
        fn = self._launcher()
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise DeviceError(f"{self.symbol} failed: CUDA error {rc}")
        with _COUNT_LOCK:
            self.launches += 1


def scan_block(R: int, B: int, n_sm: int) -> int:
    """Threads (rows) of one K3 block: a row per thread, 4 warps a
    block (each block stages its table: fewer, fuller blocks were
    faster on the card than one warp a block, PERF.md §6), 8 where
    4 would need more than two blocks per SM."""
    return 32 * (4 if R * B <= 4 * 32 * 2 * n_sm else 8)


class GrepDfaKernel(_Kernel):
    """Wrapper of ``csrc/grep_dfa.cu`` (K1–K3): checks the tensors,
    allocates the output, launches on the current stream. Where the
    table set holds ``tab16`` the kernel stages it in shared memory (its
    shared half), else it reads ``trans_flat`` (its global half). With
    ``counts`` (int32 [R] on the same device) the kernel also adds each
    rule's matched rows into it."""

    source, symbol = "grep_dfa", "grep_dfa_launch"
    argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])

    def __call__(self, t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                 k: int, counts: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        shared = "tab16" in t
        _check_launch("grep_dfa", t, batch, lengths, k,
                      _SCAN_TABLES + (_STRIDE_TABLES if shared else ()))
        counts_ptr = _counts_ptr("grep_dfa", counts, batch)
        R, B, L = batch.shape
        width = t["tab16"].shape[1] if shared else 0
        smem = _SMEM_HEAD + 2 * width
        if smem > _MAX_SMEM:
            raise ValueError(f"grep_dfa: a {2 * width} B table passes a "
                             f"block's shared memory ({_MAX_SMEM} B)")
        out = torch.empty((R, B), dtype=torch.bool, device=batch.device)
        if R * B == 0:
            return out
        threads = scan_block(R, B, _sm_count(batch.device.index or 0))
        vec16 = int(L % 16 == 0 and batch.data_ptr() % 16 == 0)
        self._launch(batch.device, batch.data_ptr(), lengths.data_ptr(),
                     t["trans_flat"].data_ptr(), _ptr(t, "tab16"),
                     t["class_maps"].data_ptr(), t["C"].data_ptr(),
                     t["Ck"].data_ptr(), t["eol_cls"].data_ptr(),
                     t["starts"].data_ptr(), _ptr(t, "n_states"),
                     _ptr(t, "kp"), out.data_ptr(), counts_ptr, R, B, L, k,
                     t["trans_flat"].shape[1], width, threads, smem, vec16)
        return out


def assoc_block(R: int, B: int, S: int, width: int, segment: int,
                n_sm: int) -> Tuple[int, int, int, int, int]:
    """(P, win, ngw, blocks a rule, shared bytes) of one K4 launch: P
    lanes a row (S rounded up to 8, 16 or 32; 32 above 32 states, two
    states a lane up to 64), so a warp walks 32 / P rows at once; a
    row's slot holds the symbols of one window of W segments of
    ``segment`` (``win`` = W x segment symbols; W the largest power of
    two with ``win`` <= ``_ASSOC_WINDOW``, 1 for longer segments, halved
    until the block fits), whatever the row's width; above 64 states one
    row a warp, its ``ngw`` = min(W, 8) segment functions of S entries
    in shared memory too; blocks of 8 warps, at most 8 per SM over the R
    rules (warps loop over the rest); the class map, the ``width``-entry
    table and every warp's slots in shared memory. The shared bytes pass
    ``_MAX_SMEM`` when not even one segment fits."""
    P = 8 if S <= 8 else 16 if S <= 16 else 32
    Q = 32 // P
    groups = -(-B // Q)
    gx = min(-(-groups // _ASSOC_WARPS), max(1, -(-8 * n_sm // max(R, 1))))
    wide = S > _ASSOC_MAX_STATES
    w = 1
    while 2 * w * segment <= _ASSOC_WINDOW:
        w *= 2
    while True:
        ngw = min(w, 8) if wide else 0
        slot = Q * w * segment + ngw * S  # a warp's uint16 entries
        smem = _SMEM_HEAD + 2 * width + _ASSOC_WARPS * 2 * slot
        if smem <= _MAX_SMEM or w == 1:
            return P, w * segment, ngw, max(gx, 1), smem
        w //= 2


def _check_assoc_strides(kp: torch.Tensor) -> None:
    """Raise ValueError unless every rule's stride is one K4 packs (1, 2
    or 4: ``_ASSOC_STRIDES``, the strides TorchGrepProgram builds its
    tables at). Read from the card once per tensor (and again after a
    write to it), not at every launch."""
    if getattr(kp, "_assoc_checked", None) == kp._version:
        return
    bad = sorted(set(kp.tolist()) - set(_ASSOC_STRIDES))
    if bad:
        raise ValueError(f"grep_assoc: strides {bad} in kp (the walk packs "
                         f"{_ASSOC_STRIDES} bytes a symbol)")
    kp._assoc_checked = kp._version


class GrepAssocKernel(_Kernel):
    """Wrapper of ``csrc/grep_assoc.cu`` (K4, the parallel-in-time walk):
    warps of rows over each rule's stride table in shared memory
    (``assoc_block``; a row's functions in registers up to 64 states, in
    shared memory above); checks the tensors, allocates the output,
    launches on the current stream. With ``counts`` (int32 [R] on the
    same device) the kernel also adds each rule's matched rows into it.
    ``k`` is the program's stride (checked; the walk runs at each rule's
    ``kp``, which must be 1, 2 or 4)."""

    source, symbol = "grep_assoc", "grep_assoc_launch"
    argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] + [ctypes.c_int] * 6
                + [ctypes.c_void_p])

    def __call__(self, t: Tables, batch: torch.Tensor, lengths: torch.Tensor,
                 k: int, S: int, segment: int,
                 counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        _check_launch("grep_assoc", t, batch, lengths, k, _ASSOC_TABLES)
        counts_ptr = _counts_ptr("grep_assoc", counts, batch)
        R, B, L = batch.shape
        if not 1 <= S <= 65535 or segment < 2:
            raise ValueError(f"grep_assoc: unsupported S={S} or "
                             f"segment={segment}")
        width = t["tab16"].shape[1]
        if width > 65536:
            raise ValueError(f"grep_assoc: a {width}-entry table (the walk "
                             f"keeps sym * S in 16 bits: at most 65,536)")
        _check_assoc_strides(t["kp"])
        P, win, ngw, gx, smem = assoc_block(
            R, B, S, width, segment, _sm_count(batch.device.index or 0))
        if smem > _MAX_SMEM:
            raise ValueError(f"grep_assoc: {smem} B of shared memory for "
                             f"segment={segment}, S={S} and a {2 * width} B "
                             f"table (at most {_MAX_SMEM})")
        out = torch.empty((R, B), dtype=torch.bool, device=batch.device)
        if R * B == 0:
            return out
        self._launch(batch.device, batch.data_ptr(), lengths.data_ptr(),
                     t["tab16"].data_ptr(), t["class_maps"].data_ptr(),
                     t["C"].data_ptr(), t["eol_cls"].data_ptr(),
                     t["starts"].data_ptr(), t["n_states"].data_ptr(),
                     t["kp"].data_ptr(), out.data_ptr(), counts_ptr, R, B, L,
                     S, segment, width, P, win, ngw, gx, smem,
                     int(L % 16 == 0 and batch.data_ptr() % 16 == 0))
        return out


#: the process's kernel wrappers (one build, one launch count each)
grep_dfa = GrepDfaKernel()
grep_assoc = GrepAssocKernel()
grep_mesh = MeshLaunches()


def counts_plain(mask: torch.Tensor) -> torch.Tensor:
    """The counts epilogue's plain version: matched rows per rule."""
    return mask.sum(1, dtype=torch.int32)


def match_rows(t: Tables, batch: torch.Tensor, lengths: torch.Tensor, k: int,
               kernel: str = "scan", S: int = 0, segment: int = 32,
               counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bool[R, B]`` verdicts by ``kernel`` ("scan": K3, "assoc": K4
    over S states in segments of ``segment``): the plain version for CPU
    tensors, the CUDA kernel for everything else (which raises off
    CUDA). ``counts`` (int32 [R]), when given, gains each rule's matched
    rows. The failpoint site ``device.dispatch`` fires after the launch,
    on either route."""
    if batch.device.type == "cpu":
        if kernel == "assoc":
            mask = match_assoc_plain(t, batch, lengths, k, S, segment)
        else:
            mask = match_plain(t, batch, lengths, k)
        if counts is not None:
            counts += counts_plain(mask)
    elif kernel == "assoc":
        mask = grep_assoc(t, batch, lengths, k, S, segment, counts=counts)
    else:
        mask = grep_dfa(t, batch, lengths, k, counts=counts)
    dispatch_point("grep")
    return mask


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def kernel_for(kernel: str, device: torch.device, max_states: int) -> str:
    """The reference's ``_resolve_kernel`` on a torch device: an
    explicit kernel stays; "auto" is the scan on the CPU (where the
    tree's S× extra work is pure overhead) and assoc on CUDA when the
    program has at most 64 states, else the scan."""
    if kernel != "auto":
        return kernel
    if device.type == "cpu":
        return "scan"
    return "assoc" if max_states <= _ASSOC_MAX_STATES else "scan"


class TorchGrepProgram:
    """R compiled DFAs fused into one device program on ``device``.

    ``match(batch_u8[R,B,L], lengths[R,B]) -> bool[R,B]`` (numpy), with
    the surface of the reference's ``GrepProgram``: ``dispatch``,
    ``decision()``, the per-k child split when rules disagree on k, and
    the scan/assoc choice (``kernel``, ``segment``).
    """

    def __init__(self, dfas: Sequence[DFA], max_len: int = 512,
                 device: DeviceLike = None, kernel: str = "auto",
                 segment: int = 32):
        if kernel not in ("scan", "assoc", "auto"):
            raise ValueError(f"unknown grep kernel {kernel!r}")
        self.dfas = list(dfas)
        self.max_len = max_len
        self.device = resolve(device)
        self.kernel = kernel
        self.segment = max(2, int(segment))
        R = len(self.dfas)
        self.k_by_rule = [choose_k(d.n_states, d.n_classes) for d in self.dfas]
        self.max_states = max(d.n_states for d in self.dfas)
        self._children: Optional[List["TorchGrepProgram"]] = None
        self._child_idxs: Optional[List[torch.Tensor]] = None
        self._inv_perm: Optional[torch.Tensor] = None
        self._mesh_cache: dict = {}
        self.tables: Optional[Tables] = None
        distinct_ks = sorted(set(self.k_by_rule))
        min_shard_r = _env_int("FBTPU_MESH_RULE_SHARD_R", _RULE_SHARD_R)
        if len(distinct_ks) > 1 and R < min_shard_r:
            # rules disagree on k: one homogeneous child program per k,
            # merged back to rule order with the inverse permutation;
            # each child resolves its own kernel from its own states
            idxs = [np.asarray([i for i, kk in enumerate(self.k_by_rule)
                                if kk == k], dtype=np.int64)
                    for k in distinct_ks]
            self._children = [
                TorchGrepProgram([self.dfas[int(i)] for i in ix], max_len,
                                 self.device, kernel, self.segment)
                for ix in idxs
            ]
            self._child_idxs = [torch.from_numpy(ix).to(self.device)
                                for ix in idxs]
            self._inv_perm = torch.from_numpy(
                np.argsort(np.concatenate(idxs))).to(self.device)
            self.k = distinct_ks[0]
            resolved = {c.kernel_resolved for c in self._children}
            self.kernel_resolved = (resolved.pop() if len(resolved) == 1
                                    else "mixed")
            return
        self.k = min(self.k_by_rule)
        self.kernel_resolved = kernel_for(kernel, self.device, self.max_states)
        self._set_tables(build_tables(self.dfas, self.k))

    def _set_tables(self, np_tables: Dict[str, Optional[np.ndarray]]) -> None:
        """Upload the tables this device's route reads: all of them for
        the CPU plain versions, the kernels' (no ``pair_maps``) on CUDA,
        with the kernels' stride tables (``build_stride_tables``, at the
        resolved kernel's budget) where the DFAs are known. The DFAs'
        contract is checked first. ``table_bytes`` is the reference's
        table footprint (its leaves, ``pair_maps`` included where it
        builds them), which ``mesh_variant`` weighs."""
        self.table_bytes = replicated_table_bytes(
            {n: a for n, a in np_tables.items() if n != "n_states"})
        if self.dfas:
            check_contract(self.dfas)
            budget = ((_ASSOC_TABLE_BUDGET, _ASSOC_TABLE_FLOOR,
                       _ASSOC_STRIDES)
                      if self.kernel_resolved == "assoc"
                      else (_SCAN_TABLE_BUDGET, 0))
            np_tables = dict(np_tables, **build_stride_tables(
                self.dfas, self.k, *budget))
        else:
            check_flat_contract(np_tables, self.k)
        cpu = self.device.type == "cpu"
        self.tables = {
            name: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for name, a in np_tables.items()
            if a is not None and (cpu or name in _TABLE_DIMS)
        }

    def decision(self) -> dict:
        """The resolved compile/kernel decisions, per rule — the same
        dict as the reference's ``GrepProgram.decision()``; the port
        resolves ``kernel_resolved`` at construction (the reference at
        materialization), "mixed" when the children differ."""
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
            "assoc_eligible": self.max_states <= _ASSOC_MAX_STATES,
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
        return match_rows(self.tables, b, ln, self.k, self.kernel_resolved,
                          self.max_states, self.segment)

    def match(self, batch: ArrayLike, lengths: ArrayLike) -> np.ndarray:
        """Run the program; returns bool [R, B] (numpy)."""
        return self.dispatch(batch, lengths).cpu().numpy()

    # -- K5: the sharded dispatch over a mesh --

    def _merge_rule_axis(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Reassemble the children's rule rows in the caller's order."""
        merged = torch.cat(list(parts), dim=0)
        return merged.index_select(0, self._inv_perm.to(merged.device))

    def mesh_variant(self, mesh: Mesh) -> str:
        """Which axis of the ``[R, B, L]`` program shards across the mesh
        (the reference's ``mesh_variant``): "batch" (B splits, the tables
        replicate), or "rules" (R splits with its tables) once the
        replicated tables times the shard count pass
        ``FBTPU_MESH_TABLE_BUDGET`` or R reaches
        ``FBTPU_MESH_RULE_SHARD_R``, and only where the shard count
        divides R. A k-split program answers for its first child (the
        split happens only below the rule-shard count)."""
        if self._children is not None:
            return self._children[0].mesh_variant(mesh)
        R = len(self.k_by_rule)
        if R < 2 or R % mesh.size:
            return "batch"
        budget = _env_int("FBTPU_MESH_TABLE_BUDGET", _MESH_TABLE_BUDGET)
        min_r = _env_int("FBTPU_MESH_RULE_SHARD_R", _RULE_SHARD_R)
        if self.table_bytes * mesh.size > budget or R >= min_r:
            return "rules"
        return "batch"

    def _mesh_tables(self, mesh: Mesh, variant: str) -> List[Tables]:
        """Each shard's tables on its device, under the variant's
        partition rules; made once per mesh structure and variant. A
        replicated leaf already on a shard's device is that same tensor,
        not a copy."""
        key = (mesh_key(mesh), variant)
        shards = self._mesh_cache.get(key)
        if shards is None:
            axis = mesh.axis_names[0]
            rules = partition_rules(f"grep-{variant}", axis)
            shards = [{name: shard_leaf(rules, name, leaf, axis, mesh.size,
                                        i).to(dev).contiguous()
                       for name, leaf in self.tables.items()}
                      for i, dev in enumerate(mesh.devices)]
            self._mesh_cache[key] = shards
        return shards

    def _launch_shards(self, mesh: Mesh, b: torch.Tensor, ln: torch.Tensor,
                       variant: str, with_counts: bool):
        """K5's per-shard launches of a single-k program over rows ``b``
        ``[R, Bp, L]`` (``Bp`` divisible by the shard count for the batch
        variant): each shard's slice goes to its device and its kernel
        launches there, all before any result is read. Returns the
        merged ``(mask bool [R, Bp], counts int32 [R] | None)`` on the
        mesh's first device, without waiting."""
        n = mesh.size
        axis = 1 if variant == "batch" else 0
        step = b.shape[axis] // n
        tables = self._mesh_tables(mesh, variant)
        masks, counts = [], []
        for i, (dev, t) in enumerate(zip(mesh.devices, tables)):
            bs = to_device(b.narrow(axis, i * step, step), torch.uint8, dev)
            ls = to_device(ln.narrow(axis, i * step, step), torch.int32, dev)
            c = (torch.zeros(bs.shape[0], dtype=torch.int32, device=dev)
                 if with_counts else None)
            masks.append(match_rows(t, bs, ls, self.k, self.kernel_resolved,
                                    self.max_states, self.segment, counts=c))
            counts.append(c)
            if dev.type == "cuda" and bs.shape[0] * bs.shape[1]:
                with _COUNT_LOCK:
                    grep_mesh.launches += 1
        dev0 = mesh.devices[0]
        mask = torch.cat([m.to(dev0) for m in masks], dim=axis)
        if not with_counts:
            return mask, None
        if variant == "batch":  # every shard saw every rule: the psum
            total = torch.stack([c.to(dev0) for c in counts]).sum(
                0, dtype=torch.int32)
        else:
            total = torch.cat([c.to(dev0) for c in counts])
        return mask, total

    def dispatch_mesh(self, mesh: Mesh, batch: ArrayLike, lengths: ArrayLike,
                      with_counts: bool = True, variant: Optional[str] = None):
        """K5: launch the program sharded over ``mesh`` without waiting.
        The batch variant pads B to a multiple of the shard count (pad
        rows: zero bytes, length -1, so they never match or count); the
        rules variant takes B as it is. Returns ``(mask bool [R, Bp],
        counts int32 [R] | None, B, Bp)`` on the mesh's first device;
        ``counts[r]`` is rule r's matched rows over all Bp rows (overflow
        rows at -2 count as the kernels saw them, before any host
        re-check). ``with_counts=False``, the engine's call, computes no
        count at all. ``variant`` pins the axis (``match_sharded``); by
        default ``mesh_variant`` picks it."""
        b = torch.from_numpy(batch) if isinstance(batch, np.ndarray) else batch
        ln = (torch.from_numpy(lengths) if isinstance(lengths, np.ndarray)
              else lengths)
        R, B, L = b.shape
        if self._children is not None:
            # every child launches before the merge touches a result;
            # children that padded B differently are cut back to B
            parts, count_parts, bps = [], [], []
            for c, ix in zip(self._children, self._child_idxs):
                ix = ix.to(b.device)
                m, ct, _b, bp = c.dispatch_mesh(
                    mesh, b.index_select(0, ix), ln.index_select(0, ix),
                    with_counts, variant)
                parts.append(m)
                count_parts.append(ct)
                bps.append(bp)
            if len(set(bps)) == 1:
                Bp = bps[0]
            else:
                parts = [p[:, :B] for p in parts]
                Bp = B
            counts = (self._merge_rule_axis(count_parts)
                      if with_counts else None)
            return self._merge_rule_axis(parts), counts, B, Bp
        variant = variant or self.mesh_variant(mesh)
        Bp = pad_to_devices(B, mesh.size) if variant == "batch" else B
        if Bp != B:
            b = torch.cat([b, b.new_zeros((R, Bp - B, L))], dim=1)
            ln = torch.cat([ln, ln.new_full((R, Bp - B), -1)], dim=1)
        mask, counts = self._launch_shards(mesh, b, ln, variant, with_counts)
        return mask, counts, B, Bp

    def match_mesh(self, mesh: Mesh, batch: ArrayLike, lengths: ArrayLike):
        """Run the sharded program and read it back: ``(mask bool [R, B],
        counts int32 [R], Bp)`` (numpy)."""
        mask, counts, B, Bp = self.dispatch_mesh(mesh, batch, lengths)
        return mask[:, :B].cpu().numpy(), counts.cpu().numpy(), Bp

    def match_sharded(self, mesh: Mesh, batch: ArrayLike, lengths: ArrayLike):
        """The batch-sharded matcher whatever ``mesh_variant`` says (the
        reference's ``match_sharded``): ``(mask bool [R, B], counts int32
        [R], Bp)`` (numpy)."""
        mask, counts, B, Bp = self.dispatch_mesh(mesh, batch, lengths,
                                                 variant="batch")
        return mask[:, :B].cpu().numpy(), counts.cpu().numpy(), Bp


def from_jax_tables(np_tables: Dict[str, Optional[np.ndarray]], k: int,
                    max_len: int = 512, device: DeviceLike = None,
                    dfas: Sequence[DFA] = (), kernel: str = "auto",
                    segment: int = 32) -> TorchGrepProgram:
    """A single-k program over a table set carried across from the
    reference package (``GrepProgram._np``: trans_flat, C, Ck,
    class_maps, eol_cls, starts, pair_maps or None). Read ``_np`` before
    the reference program materializes: materializing frees it.
    ``dfas`` feeds ``decision()``, the per-rule state counts that K4
    needs and the kernels' stride tables (``build_stride_tables`` builds
    them from the DFAs, as for a program built here), so they must be
    the DFAs the set was built from: a leaf the kernels or the plain
    versions read that differs from ``build_tables(dfas, k)``'s raises
    ValueError. Without them the program takes the scan over the
    carried ``trans_flat``."""
    if kernel not in ("scan", "assoc", "auto"):
        raise ValueError(f"unknown grep kernel {kernel!r}")
    prog = TorchGrepProgram.__new__(TorchGrepProgram)
    prog.dfas = list(dfas)
    prog.max_len = max_len
    prog.device = resolve(device)
    prog.kernel = kernel
    prog.segment = max(2, int(segment))
    prog.k = int(k)
    prog.k_by_rule = [prog.k] * int(np_tables["starts"].shape[0])
    prog.max_states = max((d.n_states for d in prog.dfas), default=0)
    prog._children = prog._child_idxs = prog._inv_perm = None
    prog._mesh_cache = {}
    if prog.dfas:
        own = build_tables(prog.dfas, prog.k)
        for name in _SCAN_TABLES:
            if not np.array_equal(own[name], np_tables[name]):
                raise ValueError(f"the carried table {name} differs from "
                                 f"the one the DFAs give at k={prog.k}")
        np_tables = dict(np_tables, n_states=own["n_states"])
        prog.kernel_resolved = kernel_for(kernel, prog.device,
                                          prog.max_states)
    elif kernel == "assoc":
        raise ValueError("the assoc kernel needs each rule's state count: "
                         "pass dfas")
    else:
        prog.kernel_resolved = "scan"
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

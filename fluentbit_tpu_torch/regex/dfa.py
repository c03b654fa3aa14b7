"""NFA construction + subset-construction DFA over byte classes.

The port's own copy of ``fluentbit_tpu/regex/dfa.py``: the same tables
(trans, class_map, start, S, C) come out of both (tests/test_torch_regex.py).

The TPU regex execution model (replacing Onigmo, lib/onigmo — the thing
the north star re-expresses as a vectorized automaton kernel):

- Thompson NFA over a 258-symbol alphabet: bytes 0..255, EOL (end of
  input), BOS (begin of input).
- Ruby-syntax zero-width anchors become *constraint epsilon edges*:
  ``^`` crossable only when the previously consumed symbol ∈ {BOS, \\n},
  ``$`` crossable only when the next symbol ∈ {EOL, \\n}, \\A/\\z/\\Z
  analogous. This gives exact ONIG_SYNTAX_RUBY line-anchor semantics
  (src/flb_regex.c:146) without lookaround machinery.
- Unanchored search is a scan self-loop state with an epsilon into the
  pattern (RE2-style), so one pass answers "match anywhere".
- The accept NFA state is absorbing (self-loop on every symbol): a DFA
  run needs NO per-position accept check — feed bytes then EOL(s);
  matched ⟺ final state == ACC. Padding positions map to the EOL class,
  which makes fixed-shape ``[B, L]`` batches trivially correct on device.
- Subset construction compresses 258 symbols into equivalence classes;
  the kernel table is ``trans[S, C] : int32`` + ``class_map[257] : uint8``
  (entry 256 = EOL class, used for padding).

DFA state ids: 0 = DEAD (absorbing reject), 1 = ACC (absorbing accept),
2 = start (after BOS folded in).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from .parser import (
    ALL_BYTES,
    Alt,
    Anchor,
    Group,
    Lit,
    Node,
    ParsedRegex,
    Rep,
    Seq,
    UnsupportedRegex,
    parse,
)

EOL = 256
BOS = 257
EOL_BIT = 1 << EOL
BOS_BIT = 1 << BOS
NL_BIT = 1 << 10
ALL_SYMS = (1 << 258) - 1

DEAD = 0
ACC = 1
START = 2


class _NFA:
    """Mutable NFA being built. Edge kinds:
    byte edges: consume a symbol in mask; eps edges: zero-width, with an
    optional ('prev'|'next', mask) constraint."""

    def __init__(self) -> None:
        self.byte_edges: List[List[Tuple[int, int]]] = []  # state -> [(mask, dst)]
        self.eps_edges: List[List[Tuple[Optional[str], int, int]]] = []  # (kind, mask, dst)

    def new_state(self) -> int:
        self.byte_edges.append([])
        self.eps_edges.append([])
        return len(self.byte_edges) - 1

    def add_byte(self, src: int, mask: int, dst: int) -> None:
        self.byte_edges[src].append((mask, dst))

    def add_eps(self, src: int, dst: int, kind: Optional[str] = None, mask: int = 0) -> None:
        self.eps_edges[src].append((kind, mask, dst))


def _build(nfa: _NFA, node: Node, start: int) -> int:
    """Thompson construction; returns the fragment's end state."""
    if isinstance(node, Lit):
        end = nfa.new_state()
        nfa.add_byte(start, node.mask, end)
        return end
    if isinstance(node, Seq):
        cur = start
        for item in node.items:
            cur = _build(nfa, item, cur)
        return cur
    if isinstance(node, Group):
        return _build(nfa, node.node, start)
    if isinstance(node, Alt):
        end = nfa.new_state()
        for item in node.items:
            b_start = nfa.new_state()
            nfa.add_eps(start, b_start)
            b_end = _build(nfa, item, b_start)
            nfa.add_eps(b_end, end)
        return end
    if isinstance(node, Rep):
        cur = start
        for _ in range(node.min):
            cur = _build(nfa, node.node, cur)
        if node.max is None:
            # star/plus tail: loop state
            loop = nfa.new_state()
            nfa.add_eps(cur, loop)
            inner_start = nfa.new_state()
            nfa.add_eps(loop, inner_start)
            inner_end = _build(nfa, node.node, inner_start)
            nfa.add_eps(inner_end, loop)
            return loop
        else:
            # up to (max-min) optional copies
            ends = [cur]
            for _ in range(node.max - node.min):
                cur = _build(nfa, node.node, cur)
                ends.append(cur)
            end = nfa.new_state()
            for e in ends:
                nfa.add_eps(e, end)
            return end
    if isinstance(node, Anchor):
        end = nfa.new_state()
        if node.kind == "bol":
            nfa.add_eps(start, end, "prev", BOS_BIT | NL_BIT)
        elif node.kind == "bos":
            nfa.add_eps(start, end, "prev", BOS_BIT)
        elif node.kind == "eol":
            nfa.add_eps(start, end, "next", EOL_BIT | NL_BIT)
        elif node.kind == "eos":
            nfa.add_eps(start, end, "next", EOL_BIT)
        elif node.kind == "eos_nl":
            # \Z: end of string, or before a final newline
            nfa.add_eps(start, end, "next", EOL_BIT)
            mid = nfa.new_state()
            nfa.add_eps(start, mid, "next", NL_BIT)
            mid2 = nfa.new_state()
            nfa.add_byte(mid, NL_BIT, mid2)
            nfa.add_eps(mid2, end, "next", EOL_BIT)
        else:
            raise UnsupportedRegex(f"anchor {node.kind}")
        return end
    raise TypeError(f"unknown AST node {node!r}")


@dataclass(frozen=True)
class ShrinkStats:
    """What the compile-path reduction pass did to this DFA (the
    fbtpu-shrink audit trail GrepProgram/GrepTables/bench report).

    ``s_raw``/``c_raw`` are the subset-construction shape, ``s``/``c``
    the shipped table's. ``minimized`` False means the pass was
    explicitly disabled (``minimize=False`` — the
    bench differential and the property tests' unminimized oracle).
    ``approx_of``/``approx_depth`` are set only on approximate
    reductions (the reference package's ``approx_reduce``, not ported
    yet): the exact machine's state count
    and the prefix depth the collapse kept."""

    s_raw: int
    c_raw: int
    s: int
    c: int
    minimized: bool
    approx_of: Optional[int] = None
    approx_depth: Optional[int] = None

    @property
    def states_eliminated(self) -> int:
        return max(self.s_raw - self.s, 0)

    @property
    def classes_eliminated(self) -> int:
        return max(self.c_raw - self.c, 0)


@dataclass
class DFA:
    """Compiled table-driven DFA (the kernel input).

    trans[S, C] int32, class_map[257] uint8 (index 256 = EOL class, used
    for padded positions), start id, ACC==1 absorbing accept, DEAD==0.
    """

    trans: np.ndarray
    class_map: np.ndarray
    start: int
    n_states: int
    n_classes: int
    pattern: str
    #: reduction audit trail (None only for hand-built tables — the
    #: grep-unminimized-dfa lint rule pins compile_dfa as the one
    #: constructor on the kernel path)
    shrink: Optional[ShrinkStats] = None

    @property
    def eol_class(self) -> int:
        return int(self.class_map[EOL])

    def match_bytes(self, data: bytes) -> bool:
        """CPU reference matcher (search semantics, like flb_regex_match)."""
        state = self.start
        trans = self.trans
        cmap = self.class_map
        for b in data:
            state = trans[state, cmap[b]]
            if state <= ACC:  # DEAD or ACC — both absorbing
                return state == ACC
        state = trans[state, cmap[EOL]]
        return state == ACC

    def match_batch_np(self, batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Vectorized numpy matcher over [B, L] uint8 padded batch
        (test oracle for the device kernel)."""
        B, L = batch.shape
        cls = self.class_map[batch]  # [B, L]
        pad = np.arange(L)[None, :] >= lengths[:, None]
        cls[pad] = self.eol_class
        state = np.full((B,), self.start, dtype=np.int32)
        trans = self.trans
        for i in range(L):
            state = trans[state, cls[:, i]]
        state = trans[state, np.full((B,), self.eol_class)]
        # negative lengths mark invalid rows (missing field -1 / overflow
        # -2) which must never match — same guard as the device kernel
        return (state == ACC) & (lengths >= 0)


def compose_supersteps(trans: np.ndarray, k: int) -> np.ndarray:
    """Pre-compose a [S, C] table to k-byte super-steps: [S, C^k] with
    T_k[s, c1*C^(k-1) + ... + ck] = T[...T[T[s, c1], c2]..., ck].

    The single source of the super-step index order — both the device
    kernel (ops/grep.py GrepProgram) and the native C++ twin
    (native/__init__.py GrepTables) build their tables here, keeping the
    bit-exact contract between them in one place."""
    S, C = trans.shape
    out = trans
    for _ in range(k - 1):
        # out[s, w] = state after word w; extend by one byte:
        # new[s, w*C + c] = trans[out[s, w], c]
        out = trans[out.reshape(-1)].reshape(S, -1)
    return out


def _renumber(trans: np.ndarray, start: int,
              part: np.ndarray) -> Tuple[np.ndarray, int]:
    """Collapse a state partition to a fresh table, keeping the
    DEAD=0 / ACC=1 absorbing-id contract (first-seen order for the
    rest, so equal inputs renumber deterministically)."""
    S, C = trans.shape
    remap = np.full(int(part.max()) + 1, -1, dtype=np.int64)
    remap[part[DEAD]] = DEAD
    remap[part[ACC]] = ACC
    nxt = 2
    for b in part:
        if remap[b] < 0:
            remap[b] = nxt
            nxt += 1
    new_ids = remap[part]
    new_trans = np.zeros((nxt, C), dtype=np.int32)
    # one representative per block suffices (blocks are equivalence classes)
    seen = np.zeros(nxt, dtype=bool)
    for s in range(S):
        ns = new_ids[s]
        if not seen[ns]:
            seen[ns] = True
            new_trans[ns] = new_ids[trans[s]]
    return new_trans, int(new_ids[start])


def _hopcroft_minimize(trans: np.ndarray, start: int
                       ) -> Tuple[np.ndarray, int]:
    """Hopcroft partition refinement over the [S, C] table.

    Subset construction leaves many equivalent states (every optional
    trailing group of a pattern forks the subsets), which (a) bloats
    the kernel tables S-fold — the parallel-in-time device kernel does
    S× work per position — and (b) hides the self-loop structure the
    native accel scan needs: a `[^ ]*` skeleton state only LOOKS like a
    self-loop after its clones are merged. Language is unchanged, so
    all verdict paths stay bit-identical.

    Classic smaller-half worklist (splitters are (block, class) pairs;
    a split enqueues the smaller fragment), with numpy doing the
    per-splitter preimage scan — O(C·S log S) splitter work instead of
    Moore's full-table fixpoint rounds, which is what keeps hot-reload
    recompiles of big parser DFAs (S≈1k) cheap.

    Keeps the DEAD=0 / ACC=1 contract: any state from which ACC is
    unreachable is never split from DEAD's block (both die on every
    suffix), so dead subtrees merge into DEAD; ACC (the only accepting
    state, absorbing) stays a singleton partition."""
    S, C = trans.shape
    block = np.zeros(S, dtype=np.int64)
    block[ACC] = 1
    members: Dict[int, np.ndarray] = {
        0: np.flatnonzero(block == 0),
        1: np.asarray([ACC], dtype=np.int64),
    }
    nb = 2
    # {ACC} is the smaller half of the initial split for every class
    work = deque((1, c) for c in range(C))
    in_work = {(1, c) for c in range(C)}
    while work:
        key = work.popleft()
        in_work.discard(key)
        a, c = key
        in_a = np.zeros(S, dtype=bool)
        in_a[members[a]] = True
        x = in_a[trans[:, c]]  # states whose c-step lands in block a
        for b in np.unique(block[x]):
            bm = members[int(b)]
            sel = x[bm]
            if sel.all() or not sel.any():
                continue
            b1, b2 = bm[sel], bm[~sel]
            if len(b1) <= len(b2):
                small, large = b1, b2
            else:
                small, large = b2, b1
            new_id = nb
            nb += 1
            block[small] = new_id
            members[int(b)] = large
            members[new_id] = small
            for cc in range(C):
                if (int(b), cc) in in_work:
                    # pending splitter stays valid for the shrunk block;
                    # the new fragment must also be processed
                    work.append((new_id, cc))
                    in_work.add((new_id, cc))
                elif (new_id, cc) not in in_work:
                    # smaller-half rule: either fragment refines the
                    # same, and new_id IS the smaller half by
                    # construction — the cheaper preimage scan
                    work.append((new_id, cc))
                    in_work.add((new_id, cc))
    return _renumber(trans, start, block)


def _prune_unreachable(trans: np.ndarray, start: int
                       ) -> Tuple[np.ndarray, int]:
    """Drop states unreachable from {start, DEAD, ACC} (dead-state
    pruning). Subset construction never emits them, but the approximate
    collapse does — a state whose every predecessor was redirected to
    ACC would otherwise survive minimization as its own block."""
    S, C = trans.shape
    reach = np.zeros(S, dtype=bool)
    reach[[DEAD, ACC, start]] = True
    frontier = np.asarray([start], dtype=np.int64)
    while frontier.size:
        nxt = np.unique(trans[frontier].reshape(-1))
        frontier = nxt[~reach[nxt]]
        reach[frontier] = True
    if reach.all():
        return trans, start
    remap = np.full(S, -1, dtype=np.int64)
    keep = np.flatnonzero(reach)
    remap[keep] = np.arange(len(keep))
    # DEAD/ACC sit at indices 0/1 of `keep` (reach pinned them), so the
    # id contract survives renumbering
    return remap[trans[keep]].astype(np.int32), int(remap[start])


def _remerge_classes(trans: np.ndarray, class_map: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Byte-class remerge after state minimization: classes whose
    transition COLUMNS became identical under the smaller state set
    collapse into one, and classes no byte/EOL maps to (the BOS column
    — consumed when the start state folded BOS in) drop entirely.
    Shrinks C, which compounds through every C^k super-step table (the
    stride budget is S × C^(k+1)).

    ``class_map`` is the 257-entry byte→class table; returns
    (trans[S, C'], class_map', C')."""
    used = np.unique(class_map)
    remap = np.full(trans.shape[1], -1, dtype=np.int64)
    col_ids: Dict[bytes, int] = {}
    rep_cols: List[int] = []
    for c in used:
        key = trans[:, c].tobytes()
        new_id = col_ids.setdefault(key, len(rep_cols))
        if new_id == len(rep_cols):
            rep_cols.append(int(c))
        remap[c] = new_id
    new_trans = np.ascontiguousarray(trans[:, rep_cols], dtype=np.int32)
    new_map = remap[class_map].astype(np.uint8)
    return new_trans, new_map, len(rep_cols)


def _shrink_tables(trans: np.ndarray, start: int, class_map: np.ndarray
                   ) -> Tuple[np.ndarray, int, np.ndarray, int]:
    """The full reduction pass: prune → Hopcroft → class remerge."""
    trans, start = _prune_unreachable(trans, start)
    trans, start = _hopcroft_minimize(trans, start)
    trans, class_map, n_classes = _remerge_classes(trans, class_map)
    return trans, start, class_map, n_classes


def compile_dfa(pattern, ignorecase: bool = False, dot_all: bool = False,
                max_states: int = 4096,
                minimize: bool = True) -> DFA:
    """Compile a pattern (str or ParsedRegex) to a scan DFA.

    Raises UnsupportedRegex for non-DFA-expressible constructs; callers
    fall back to the CPU engine (the same split the north star requires).

    Every DFA leaving here has passed the fbtpu-shrink reduction pass —
    unreachable-state pruning, Hopcroft minimization, byte-class
    remerging — unless ``minimize=False``
    explicitly pins the raw subset table for a differential (bench's
    on/off stage, the property tests' oracle). The language is
    unchanged either way; only table shape differs.
    """
    if isinstance(pattern, ParsedRegex):
        parsed = pattern
    else:
        parsed = parse(pattern, ignorecase=ignorecase, dot_all=dot_all)

    nfa = _NFA()
    pre = nfa.new_state()         # consumes the virtual BOS symbol
    scan = nfa.new_state()        # unanchored search loop
    nfa.add_byte(pre, BOS_BIT, scan)
    nfa.add_byte(scan, ALL_BYTES, scan)
    p_start = nfa.new_state()
    nfa.add_eps(scan, p_start)
    p_end = _build(nfa, parsed.root, p_start)
    accept = nfa.new_state()
    nfa.add_eps(p_end, accept)
    # absorbing accept: self-loop on every symbol incl. EOL/BOS
    nfa.add_byte(accept, ALL_SYMS, accept)

    n = len(nfa.byte_edges)

    # ---- symbol equivalence classes ----
    # refine {0..257} by every mask used anywhere (byte edges + constraints)
    masks = set()
    for st in range(n):
        for m, _ in nfa.byte_edges[st]:
            masks.add(m & ALL_SYMS)
        for kind, m, _ in nfa.eps_edges[st]:
            if kind is not None:
                masks.add(m & ALL_SYMS)
    masks.add(EOL_BIT)
    masks.add(BOS_BIT)
    sig_map: Dict[Tuple[bool, ...], int] = {}
    sym_class = np.zeros(258, dtype=np.int32)
    mask_list = sorted(masks)
    for sym in range(258):
        sig = tuple(bool(m >> sym & 1) for m in mask_list)
        cid = sig_map.setdefault(sig, len(sig_map))
        sym_class[sym] = cid
    n_classes = len(sig_map)
    # one representative symbol per class
    rep: List[int] = [0] * n_classes
    for sym in range(257, -1, -1):
        rep[sym_class[sym]] = sym

    # ---- closures ----
    def closure_plain(states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for kind, m, dst in nfa.eps_edges[s]:
                if kind is None and dst not in out:
                    out.add(dst)
                    stack.append(dst)
        return frozenset(out)

    def closure_after(states: set, sym: int) -> FrozenSet[int]:
        """Cross plain eps + prev-constraint eps (prev symbol = sym)."""
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for kind, m, dst in nfa.eps_edges[s]:
                if kind == "next":
                    continue
                if kind == "prev" and not (m >> sym & 1):
                    continue
                if dst not in out:
                    out.add(dst)
                    stack.append(dst)
        return frozenset(out)

    def pre_closure(states: FrozenSet[int], sym: int) -> set:
        """Cross plain eps + next-constraint eps (next symbol = sym)."""
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for kind, m, dst in nfa.eps_edges[s]:
                if kind == "prev":
                    continue
                if kind == "next" and not (m >> sym & 1):
                    continue
                if dst not in out:
                    out.add(dst)
                    stack.append(dst)
        return out

    def move(states: FrozenSet[int], sym: int) -> FrozenSet[int]:
        src = pre_closure(states, sym)
        stepped = set()
        for s in src:
            for m, dst in nfa.byte_edges[s]:
                if m >> sym & 1:
                    stepped.add(dst)
        return closure_after(stepped, sym)

    # ---- subset construction ----
    init = closure_plain(frozenset([pre]))
    start_set = move(init, BOS)  # fold BOS into the start state

    def canon(states: FrozenSet[int]) -> object:
        if accept in states:
            return "ACC"
        if not states:
            return "DEAD"
        return states

    dfa_ids: Dict[object, int] = {"DEAD": DEAD, "ACC": ACC}
    table: List[List[int]] = [[DEAD] * n_classes, [ACC] * n_classes]
    worklist: List[FrozenSet[int]] = []

    def get_id(states: FrozenSet[int]) -> int:
        key = canon(states)
        if key in dfa_ids:
            return dfa_ids[key]
        sid = len(table)
        if sid > max_states:
            raise UnsupportedRegex(
                f"DFA exceeds {max_states} states for pattern {parsed.pattern!r}"
            )
        dfa_ids[key] = sid
        table.append([DEAD] * n_classes)
        worklist.append(states)
        return sid

    start_id = get_id(start_set)
    while worklist:
        states = worklist.pop()
        sid = dfa_ids[canon(states)]
        for cid in range(n_classes):
            sym = rep[cid]
            if sym == BOS:
                continue  # BOS never appears mid-stream
            table[sid][cid] = get_id(move(states, sym))

    trans = np.asarray(table, dtype=np.int32)
    class_map = sym_class[:257].astype(np.uint8)
    s_raw, c_raw = trans.shape[0], n_classes
    if minimize:
        trans, start_id, class_map, n_classes = _shrink_tables(
            trans, start_id, class_map)
    return DFA(
        trans=trans,
        class_map=class_map,
        start=start_id,
        n_states=trans.shape[0],
        n_classes=n_classes,
        pattern=parsed.pattern,
        shrink=ShrinkStats(s_raw=s_raw, c_raw=c_raw, s=trans.shape[0],
                           c=n_classes, minimized=bool(minimize)),
    )

"""The port's grep DFA program against the reference package's.

``TorchGrepProgram(device="cpu")`` runs the plain torch versions of the
kernel (``super_symbols_plain``, ``super_symbols_pairs_plain``,
``match_plain``); they must equal ``GrepProgram`` on JAX's CPU backend
exactly — symbols are integers and verdicts booleans. The CUDA kernel
is held against the plain version in tests/test_torch_gpu.py.
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluentbit_tpu.ops.grep import GrepProgram, program_for as jax_program_for
from fluentbit_tpu.regex.dfa import compile_dfa as _jax_compile_dfa
from fluentbit_tpu_torch.ops import grep as tg
from fluentbit_tpu_torch.ops.batch import assemble, bucket_size
from fluentbit_tpu_torch.regex.dfa import compile_dfa as _compile_dfa

# compiled once per pattern: both compilers are deterministic, and
# tests/test_torch_regex.py holds their outputs equal
compile_dfa = functools.lru_cache(maxsize=None)(_compile_dfa)
jax_compile_dfa = functools.lru_cache(maxsize=None)(_jax_compile_dfa)

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
MIXED_K = [APACHE2, "GET", r"^\d+ GET"]  # k = 3, 6, 5: three children


def make_lines(n, seed):
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        kind = rng.randrange(5)
        if kind == 0:
            lines.append(
                f'10.0.{rng.randrange(256)}.{rng.randrange(256)} - user{i} '
                f'[10/Oct/2024:13:55:36 -0700] "GET /p{i} HTTP/1.1" '
                f'{rng.choice([200, 404, 500])} {rng.randrange(10000)}'.encode())
        elif kind == 1:
            lines.append(b"random junk line " + str(i).encode())
        elif kind == 2:
            lines.append(b"")
        elif kind == 3:
            lines.append(f'host{i} - ü [t] "POST /日本 Z" 201 7 "r" '
                         f'"agent {i}"'.encode())
        else:
            lines.append(f"{i} GET c".encode())
    return lines


def staged(lines, max_len, pad_to=None, rules=1):
    b = assemble(lines, max_len, pad_to)
    return (np.ascontiguousarray(np.stack([b.batch] * rules)),
            np.ascontiguousarray(np.stack([b.lengths] * rules)))


def random_rows(rng, R, B, L):
    """Seeded rows: random bytes (non-ASCII included), every length
    class: -1, -2, 0, odd/even, L-1 and L."""
    batch = rng.integers(0, 256, size=(R, B, L), dtype=np.uint8)
    lengths = rng.integers(-2, L + 1, size=(R, B)).astype(np.int32)
    special = np.array([-1, -2, 0, 1, L - 1, L], dtype=np.int32)
    lengths[:, : min(B, len(special))] = special[: min(B, len(special))]
    return batch, lengths


def jax_tables(patterns, max_len):
    """A reference program and its numpy tables, read before it
    materializes (materializing frees ``_np``)."""
    prog = GrepProgram([jax_compile_dfa(p) for p in patterns], max_len)
    return prog, {k: v for k, v in prog._np.items()}


def torch_tables(np_tables):
    return {k: torch.from_numpy(v) for k, v in np_tables.items()
            if v is not None}


# -- super-symbols (K1, K2) --

@pytest.mark.parametrize("pattern,L", [(APACHE2, 512), (APACHE2, 37),
                                       ("GET", 64), ("GET", 33),
                                       (r"^\d+ GET", 40)])
def test_super_symbols_equal_reference(pattern, L):
    prog, np_t = jax_tables([pattern], L)
    batch, lengths = random_rows(np.random.default_rng(L), 1, 29, L)
    prog._materialize()
    symbols = jax.jit(prog._super_symbols)
    ref = np.asarray(symbols(prog._tbl, jnp.asarray(batch),
                             jnp.asarray(lengths)))
    t = torch_tables(np_t)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lengths)
    if "pair_maps" in t:  # even k, R <= 32: the reference took K2
        got = tg.super_symbols_pairs_plain(t, bt, lt, prog.k)
    else:
        got = tg.super_symbols_plain(t, bt, lt, prog.k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # K1 without the pair tables: the reference's per-byte path
    t1 = {k: v for k, v in t.items() if k != "pair_maps"}
    tbl1 = {k: v for k, v in prog._tbl.items() if k != "pair_maps"}
    ref1 = np.asarray(symbols(tbl1, jnp.asarray(batch), jnp.asarray(lengths)))
    np.testing.assert_array_equal(
        tg.super_symbols_plain(t1, bt, lt, prog.k).numpy(), ref1)
    # K2 is only a faster route to K1's symbols
    np.testing.assert_array_equal(ref1, ref)


# -- verdicts (K3) over tests/test_ops_grep.py's cases and more --

@pytest.mark.parametrize("pattern", ["abc", r"^\d+ GET", APACHE2, r"a*b|c$"])
def test_match_vs_reference(pattern):
    lines = make_lines(64, seed=7)
    batch, lengths = staged(lines, 256)
    ref = GrepProgram([jax_compile_dfa(pattern)], max_len=256)
    dfa = compile_dfa(pattern)
    got = tg.TorchGrepProgram([dfa], 256, device="cpu").match(batch, lengths)
    np.testing.assert_array_equal(got, ref.match(batch, lengths))
    np.testing.assert_array_equal(
        got[0], np.array([dfa.match_bytes(ln) for ln in lines]))


def test_match_multi_rule_different_fields():
    patterns = ["GET", r"^\d", APACHE2]
    lines = make_lines(32, seed=9)
    a = assemble(lines, 128)
    b = assemble([ln[::-1] for ln in lines], 128)
    batch = np.stack([a.batch, b.batch, a.batch])
    lengths = np.stack([a.lengths, b.lengths, a.lengths])
    ref = GrepProgram([jax_compile_dfa(p) for p in patterns], 128)
    got = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], 128, "cpu")
    np.testing.assert_array_equal(got.match(batch, lengths),
                                  ref.match(batch, lengths))


def test_invalid_and_padded_rows():
    lines = [b"abc", None, b"x" * 999, b"", b"xx"]
    batch, lengths = staged(lines, 16, bucket_size(len(lines)))
    assert lengths.shape == (1, 256) and lengths[0, 2] == -2
    got = tg.TorchGrepProgram([compile_dfa("x*")], 16, "cpu").match(batch, lengths)
    ref = GrepProgram([jax_compile_dfa("x*")], 16).match(batch, lengths)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] and not got[0, 1] and not got[0, 2] and got[0, 3]
    assert not got[0, 5:].any()


@pytest.mark.parametrize("L", [45, 0])
@pytest.mark.parametrize("B", [0, 1, 17])
@pytest.mark.parametrize("patterns", [[APACHE2], ["GET"], MIXED_K])
def test_match_edge_shapes(B, patterns, L):
    """B in {0, 1, 17}; lengths -1/-2/0/max_len; non-ASCII bytes; odd
    and empty rows."""
    rng = np.random.default_rng(B)
    batch, lengths = random_rows(rng, len(patterns), B, L)
    got = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L,
                              "cpu").match(batch, lengths)
    assert got.shape == (len(patterns), B) and got.dtype == bool
    if B == 0:
        return  # nothing for the reference to compare
    ref = GrepProgram([jax_compile_dfa(p) for p in patterns], L)
    np.testing.assert_array_equal(got, ref.match(batch, lengths))


def test_apache2_bulk_4096():
    """apache2 at [1, 4096, 512], the shape of one 4096-record append."""
    lines = make_lines(4096, seed=1234)
    lines[5] = b"y" * 512  # a row of exactly max_len
    batch, lengths = staged(lines, 512)
    assert lengths[0, 5] == 512
    got = tg.program_for([APACHE2], 512, "cpu").match(batch, lengths)
    ref = jax_program_for([APACHE2], 512).match(batch, lengths)
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0 and (~got).sum() > 0


def test_mixed_k_child_split():
    lines = make_lines(50, seed=5)
    batch, lengths = staged(lines, 64, rules=3)
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in MIXED_K], 64, "cpu")
    assert prog.decision()["k_groups"] == [3, 5, 6]
    ref = GrepProgram([jax_compile_dfa(p) for p in MIXED_K], 64)
    np.testing.assert_array_equal(prog.match(batch, lengths),
                                  ref.match(batch, lengths))


# -- state carried across from the reference package --

@pytest.mark.parametrize("patterns", [[APACHE2], ["GET", "DENY"],
                                      [r"^\d+ GET"]])
def test_from_jax_tables(patterns):
    L = 96
    ref, np_t = jax_tables(patterns, L)
    dfas = [compile_dfa(p) for p in patterns]
    own = tg.build_tables(dfas, ref.k)
    # the reference's tables, plus the per-rule state counts K4 reads
    assert set(own) == {k for k, v in np_t.items() if v is not None} | {
        "n_states"}
    np.testing.assert_array_equal(own.pop("n_states"),
                                  [d.n_states for d in dfas])
    for name, arr in own.items():
        assert arr.dtype == np_t[name].dtype, name
        np.testing.assert_array_equal(arr, np_t[name], err_msg=name)
    # without the DFAs there are no state counts: the scan serves
    bare = tg.from_jax_tables(np_t, ref.k, L, device="cpu")
    assert "n_states" not in bare.tables
    assert bare.decision()["kernel_resolved"] == "scan"
    carried = tg.from_jax_tables(np_t, ref.k, L, device="cpu", dfas=dfas)
    native = tg.TorchGrepProgram(dfas, L, "cpu")
    for name, arr in native.tables.items():
        np.testing.assert_array_equal(carried.tables[name].numpy(),
                                      arr.numpy(), err_msg=name)
    batch, lengths = random_rows(np.random.default_rng(3), len(patterns), 33, L)
    for i, ln in enumerate(make_lines(20, seed=4)):
        batch[:, i, :] = 0
        batch[:, i, : len(ln)] = np.frombuffer(ln, np.uint8)
        lengths[:, i] = len(ln)
    got = carried.match(batch, lengths)
    np.testing.assert_array_equal(got, native.match(batch, lengths))
    np.testing.assert_array_equal(got, ref.match(batch, lengths))


def test_from_jax_tables_refuses_other_dfas():
    """The kernels' stride tables come from ``dfas``: a carried set that
    the DFAs do not give (another pattern's, or an edited table) raises
    instead of walking different tables on the card and the CPU."""
    L = 96
    ref, np_t = jax_tables(["GET", "DENY"], L)
    with pytest.raises(ValueError, match="differs"):
        tg.from_jax_tables(np_t, ref.k, L, device="cpu",
                           dfas=[compile_dfa(p) for p in ["GET", "DENX"]])
    edited = dict(np_t, trans_flat=np_t["trans_flat"].copy())
    edited["trans_flat"][0, 5] ^= 1
    with pytest.raises(ValueError, match="trans_flat"):
        tg.from_jax_tables(edited, ref.k, L, device="cpu",
                           dfas=[compile_dfa(p) for p in ["GET", "DENY"]])


@pytest.mark.parametrize("patterns", [[APACHE2], MIXED_K, ["GET", "DENY"]])
def test_decision_matches_reference(patterns):
    ref = GrepProgram([jax_compile_dfa(p) for p in patterns], 128)
    got = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], 128, "cpu")
    d_ref, d_got = ref.decision(), got.decision()
    assert d_got.pop("kernel_resolved") == "scan"
    d_ref.pop("kernel_resolved")
    assert d_got == d_ref


def test_kernel_choice_is_explicit():
    prog = tg.TorchGrepProgram([compile_dfa("GET")], 64, "cpu",
                               kernel="assoc")
    assert prog.decision()["kernel_resolved"] == "assoc"
    with pytest.raises(ValueError):
        tg.TorchGrepProgram([compile_dfa("GET")], 64, "cpu", kernel="bogus")


def test_kernel_wrapper_refuses_cpu_tensors():
    prog = tg.TorchGrepProgram([compile_dfa("GET")], 32, "cpu")
    batch, lengths = random_rows(np.random.default_rng(0), 1, 4, 32)
    with pytest.raises(ValueError):
        tg.grep_dfa(prog.tables, torch.from_numpy(batch),
                    torch.from_numpy(lengths), prog.k)


# -- the kernels' stop rule and stride tables (K3 since the redesign) --

#: conf/baseline3-rewrite.conf's rules (k = 4, 5, 6 children), config 1's
#: Exclude rule, and a k = 6 program whose rules differ widely in S and C
CONFIG3 = ["sshd", "kernel:", r"systemd\[1\]", "ERROR", "WARN", "nginx",
           r"cron\[\d+\]", ".*OOM.*"]
EXCLUDE = r'HTTP/1\.1" 500 '
OUT_OF_ROW = ["a{10}", "WARN", "x[0-9]+y"]
STOP_PROGRAMS = {"apache2": [APACHE2], "mixed_k": MIXED_K,
                 "config3": CONFIG3, "exclude": [EXCLUDE],
                 "out_of_row": OUT_OF_ROW}
STOP_L = 96


def leaves(prog):
    """(single-k program, its rule indices) for each k-group."""
    if prog._children is None:
        return [(prog, np.arange(len(prog.dfas)))]
    return [(c, ix.numpy()) for c, ix in zip(prog._children, prog._child_idxs)]


def stop_rows(prog, seed):
    """Seeded rows of STOP_L bytes for ``prog``: random bytes everywhere,
    so every row is dirty past its length; lengths of every class (-2,
    -1, 0, 1, each stride's k - 1, k, k + 1, L - 1, L, random); then
    text rows the rules match and miss."""
    R, B = len(prog.dfas), 96
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, size=(R, B, STOP_L), dtype=np.uint8)
    lengths = rng.integers(-2, STOP_L + 1, size=(R, B)).astype(np.int32)
    strides = {leaf.k for leaf, _ in leaves(prog)}
    for leaf, _ in leaves(prog):
        strides |= set(leaf.tables["kp"].tolist())
    special = [-2, -1, 0, 1, STOP_L - 1, STOP_L] + sorted(
        {v for s in strides for v in (s - 1, s, s + 1)})
    lengths[:, : len(special)] = special
    text = make_lines(40, seed) + [
        b"Oct 17 sshd[22]: WARN x", b"kernel: cron[7] OOM", b"aaaaaaaaaaaa x12y",
        b'10.0.0.2 - - [t] "GET /b HTTP/1.1" 500 7', b"12 GET",
        b"systemd[1]: nginx ERROR", b"x" * STOP_L]
    for i, ln in enumerate(text, start=len(special)):
        batch[:, i, : len(ln)] = np.frombuffer(ln[:STOP_L], np.uint8)
        lengths[:, i] = min(len(ln), STOP_L)
    return batch, lengths


@functools.lru_cache(maxsize=None)
def stop_case(name):
    """(port program on the CPU, rows, lengths, the reference's
    verdicts on JAX's CPU backend)."""
    patterns = STOP_PROGRAMS[name]
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], STOP_L,
                               "cpu", kernel="scan")
    batch, lengths = stop_rows(prog, seed=len(name))
    ref = GrepProgram([jax_compile_dfa(p) for p in patterns], STOP_L)
    return prog, batch, lengths, ref.match(batch, lengths)


@pytest.mark.parametrize("half", ["shared", "global"])
@pytest.mark.parametrize("name", sorted(STOP_PROGRAMS))
def test_stop_walk_equals_reference(name, half):
    """``match_stop_plain`` (K3's walk: a row's own super-symbols only,
    stopping at DEAD/ACC) over the stride table (the kernel's shared
    half) or over ``trans_flat`` at k (its global half) equals the
    reference's full-width scan, dirty bytes past the length included."""
    prog, batch, lengths, want = stop_case(name)
    got = np.zeros_like(want)
    for leaf, ix in leaves(prog):
        t = dict(leaf.tables)
        if half == "global":
            t = {n: v for n, v in t.items() if n not in ("tab16", "kp")}
        else:
            assert (t["kp"] >= 1).all() and (t["kp"] <= leaf.k).all()
        got[ix] = tg.match_stop_plain(t, torch.from_numpy(batch[ix]),
                                      torch.from_numpy(lengths[ix]),
                                      leaf.k).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_stride_tables_are_the_composed_dfa():
    """``tab16`` holds each rule's composed table at its stride,
    symbol-major, at the largest stride whose table fits the budget
    (apache2: 690 states, 8 classes: stride 2 within half an SM's 228 KB);
    none at all when a rule fits at no stride; and the reference's
    tables stay exactly as they were (``build_tables``)."""
    dfa = compile_dfa(APACHE2)
    prog = tg.TorchGrepProgram([dfa], 512, "cpu", kernel="scan")
    assert prog.tables["kp"].tolist() == [2]
    tab = prog.tables["tab16"][0].numpy().view(np.uint16)
    want = tg.compose_supersteps(dfa.trans, 2).T.reshape(-1)
    np.testing.assert_array_equal(tab[: want.size], want)
    assert tab.size % 8 == 0 and not tab[want.size:].any()
    assert tg.stride_for(dfa, 3, tg._SCAN_TABLE_BUDGET) == 2
    assert tg.stride_for(dfa, 3, 690 * 8 * 2 - 1) == 0
    assert tg.build_stride_tables([dfa], 3, 1000) == {}
    assoc = tg.TorchGrepProgram([compile_dfa(p) for p in CONFIG3], 512,
                                "cpu", kernel="assoc")
    # K4's 16 KB budget at strides dividing 16, rule by rule:
    # systemd\[1\] (12 states, 11 classes) and nginx (7, 6) fit at
    # stride 2, sshd (6, 5) at 4 (5 would fit, but does not divide 16)
    assert [c.tables["kp"].tolist() for c in assoc._children] == [
        [2], [2, 2], [4, 4, 4, 2, 4]]
    for c in assoc._children:
        assert c.tables["kp"].tolist() == [
            tg.stride_for(d, c.k, tg._ASSOC_TABLE_BUDGET, (1, 2, 4))
            for d in c.dfas]
    # past the budget at every stride, K4 keeps stride 1 under 65,536
    # entries (apache2: 690 x 8)
    assert tg.build_stride_tables([dfa], 3, 1000, tg._ASSOC_TABLE_FLOOR)[
        "kp"].tolist() == [1]
    assert tg.build_stride_tables([dfa], 3, 1000, 690 * 8 * 2 - 1) == {}
    assert set(tg.build_tables([dfa], 3)) == {
        "trans_flat", "C", "Ck", "class_maps", "eol_cls", "starts",
        "n_states"}
    assert prog.table_bytes == tg.replicated_table_bytes(
        {n: a for n, a in tg.build_tables([dfa], 3).items()
         if n != "n_states"})


#: every pattern the port's tests compile into grep programs
CONTRACT_PATTERNS = sorted(set(
    ["abc", r"^\d+ GET", APACHE2, r"a*b|c$", "GET", r"^\d", "x*", "a",
     r"^\d+$", "ab+c", "DENY", r"^$", "keepme", "^drop", r"^ERROR", ".*",
     r"([a-z]+)-(\d+)", r"(?<svc>[a-z]+)-(\d+)", EXCLUDE, "a{10}",
     "x[0-9]+y"] + CONFIG3))


@pytest.mark.parametrize("pattern", CONTRACT_PATTERNS)
def test_dfa_contract_holds(pattern):
    """DEAD and ACC absorb, the EOL class sends every state to DEAD or
    ACC — so a walk may stop at DEAD/ACC and after the first EOL class —
    for every pattern the tests compile; at the rule's stride, an all-EOL
    super-step maps DEAD and ACC to themselves."""
    dfa = compile_dfa(pattern)
    tg.check_contract([dfa])
    t = dfa.trans
    assert (t[tg.DEAD] == tg.DEAD).all() and (t[tg.ACC] == tg.ACC).all()
    assert np.isin(t[:, dfa.eol_class], (tg.DEAD, tg.ACC)).all()
    prog = tg.TorchGrepProgram([dfa], 64, "cpu")
    kp, S = int(prog.tables["kp"][0]), dfa.n_states
    tab = prog.tables["tab16"][0].numpy().view(np.uint16)
    eol_sym = sum(dfa.eol_class * dfa.n_classes ** i for i in range(kp))
    after = tab[eol_sym * S: eol_sym * S + S]
    assert np.isin(after, (tg.DEAD, tg.ACC)).all()
    assert after[tg.DEAD] == tg.DEAD and after[tg.ACC] == tg.ACC


def test_contract_breach_raises_by_name():
    """A hand-made table that breaks the contract is refused when the
    program builds its tables, naming the pattern; so is a carried-over
    stride-k table set that breaks it."""
    good = compile_dfa("GET")
    for breach in ("dead", "acc", "eol"):
        trans = good.trans.copy()
        if breach == "dead":
            trans[tg.DEAD, 0] = 2
        elif breach == "acc":
            trans[tg.ACC, -1] = tg.DEAD
        else:
            trans[2, good.eol_class] = 2
        bad = dataclasses.replace(good, trans=trans, pattern=f"bad-{breach}")
        with pytest.raises(ValueError, match=f"bad-{breach}"):
            tg.TorchGrepProgram([bad], 32, "cpu")
        with pytest.raises(ValueError, match="contract"):
            tg.check_flat_contract(tg.build_tables([bad], 1), 1)
    tg.check_flat_contract(tg.build_tables([good], 3), 3)

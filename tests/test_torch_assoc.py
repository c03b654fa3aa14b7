"""The port's parallel-in-time DFA walk (K4) against the reference package.

``match_assoc_plain`` (the plain torch version of
``GrepProgram._match_assoc_impl``, run by ``TorchGrepProgram`` on a CPU
tensor with ``kernel="assoc"``) must equal ``GrepProgram(kernel="assoc")``
on JAX's CPU backend and the scan, verdict for verdict (tolerance 0:
verdicts are booleans). Also: ``kernel="auto"`` resolves per program as
the reference's ``_resolve_kernel`` does, and ``decision()`` reports the
same resolution, "mixed" included. The CUDA kernel is held against the
plain version in tests/test_torch_gpu.py.
"""

import functools
import random

import numpy as np
import pytest
import torch

from fluentbit_tpu.ops import device as jax_device
from fluentbit_tpu.ops.grep import GrepProgram
from fluentbit_tpu.regex.dfa import compile_dfa as _jax_compile_dfa
from fluentbit_tpu_torch.ops import grep as tg
from fluentbit_tpu_torch.ops.batch import assemble
from fluentbit_tpu_torch.regex.dfa import compile_dfa as _compile_dfa

compile_dfa = functools.lru_cache(maxsize=None)(_compile_dfa)
jax_compile_dfa = functools.lru_cache(maxsize=None)(_jax_compile_dfa)

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
#: conf/baseline3-rewrite.conf's eight rule patterns: k = 6, 5, 4 groups
CONFIG3 = ["sshd", "kernel:", r"systemd\[1\]", "ERROR", "WARN", "nginx",
           r"cron\[\d+\]", ".*OOM.*"]
#: one k = 6 group whose rules differ widely in S and C: WARN has fewer
#: states than a{10} but more classes, so walking all 12 states indexes
#: past the end of WARN's trans_flat row
OUT_OF_ROW = ["a{10}", "WARN", "x[0-9]+y"]


def make_lines(n, rng):
    """tests/test_ops_grep.py's line kinds: apache lines, junk, empty
    lines, and apache-like lines that miss."""
    lines = []
    for i in range(n):
        kind = rng.randrange(4)
        if kind == 0:
            lines.append(
                f'10.0.{rng.randrange(256)}.{rng.randrange(256)} - user{i} '
                f'[10/Oct/2024:13:55:36 -0700] "GET /p{i} HTTP/1.1" '
                f'{rng.choice([200, 404, 500])} {rng.randrange(10000)}'
                .encode())
        elif kind == 1:
            lines.append(b"random junk line " + str(i).encode())
        elif kind == 2:
            lines.append(b"")
        else:
            lines.append(
                f'host{i} - u [t] "POST /x Z" 201 7 "r" "agent {i}"'.encode())
    return lines


def staged(lines, max_len, rules):
    b = assemble(lines, max_len)
    return (np.ascontiguousarray(np.stack([b.batch] * rules)),
            np.ascontiguousarray(np.stack([b.lengths] * rules)))


def port(patterns, max_len, **kw):
    return tg.TorchGrepProgram([compile_dfa(p) for p in patterns], max_len,
                               "cpu", **kw)


def reference(patterns, max_len, **kw):
    return GrepProgram([jax_compile_dfa(p) for p in patterns], max_len, **kw)


@pytest.mark.parametrize("segment", [2, 8, 32, 1024])
def test_assoc_plain_equals_reference(segment):
    """The input classes of tests/test_ops_grep.py::
    test_assoc_kernel_bit_exact_vs_scan: matches, misses, empty rows,
    pad-only rows, an overflow row (length -2) and a missing field
    (length -1); segment 1024 is a single segment."""
    patterns = ["GET", r"^\d+$", APACHE2]
    lines = make_lines(97, random.Random(4242)) + [b"", b"x" * 999, None]
    batch, lengths = staged(lines, 192, 3)
    got = port(patterns, 192, kernel="assoc", segment=segment)
    assert got.decision()["kernel_resolved"] == "assoc"
    verdicts = got.match(batch, lengths)
    ref = reference(patterns, 192, kernel="assoc", segment=segment)
    np.testing.assert_array_equal(verdicts, ref.match(batch, lengths))
    np.testing.assert_array_equal(
        verdicts, port(patterns, 192, kernel="scan").match(batch, lengths))
    expect = [compile_dfa("GET").match_bytes(ln)
              if isinstance(ln, bytes) and len(ln) <= 192 else False
              for ln in lines]
    np.testing.assert_array_equal(verdicts[0, :len(lines)], expect)


def syslog_lines(n, seed):
    rng = random.Random(seed)
    progs = ["sshd[22]: Accepted", "kernel: eth0 up", "systemd[1]: Started",
             "app: ERROR boom", "app: WARN slow", "nginx: GET / 200",
             "cron[811]: job", "oom: OOM killer", "cron[x]: no digits",
             "systemd[12]: not init", "plain message"]
    return [f"Oct 17 11:{i % 60:02d}:00 host{i % 7} {rng.choice(progs)} "
            f"{'z' * rng.randrange(40)}".encode() for i in range(n)]


@pytest.mark.parametrize("segment", [8, 32])
def test_config3_rules_through_the_per_k_split(segment):
    lines = syslog_lines(120, seed=segment)
    lines[5] = b""
    lines[6] = None
    batch, lengths = staged(lines, 512, len(CONFIG3))
    got = port(CONFIG3, 512, kernel="assoc", segment=segment)
    d = got.decision()
    assert d["k_groups"] == [4, 5, 6]
    assert [c.max_states for c in got._children] == [12, 9, 7]
    verdicts = got.match(batch, lengths)
    ref = reference(CONFIG3, 512, kernel="assoc", segment=segment)
    np.testing.assert_array_equal(verdicts, ref.match(batch, lengths))
    np.testing.assert_array_equal(
        verdicts, port(CONFIG3, 512, kernel="scan").match(batch, lengths))
    assert 0 < verdicts.sum() < verdicts.size


def test_out_of_row_program_is_exact():
    prog = port(OUT_OF_ROW, 64, kernel="assoc", segment=8)
    t = prog.tables
    assert prog._children is None and prog.max_states == 12
    # walking WARN from all 12 states passes the end of its row
    assert int((prog.max_states * t["Ck"]).max()) > t["trans_flat"].shape[1]
    assert t["n_states"].tolist() == [12, 6, 5]
    rng = np.random.default_rng(11)
    batch = rng.integers(0, 256, size=(3, 40, 64), dtype=np.uint8)
    lengths = rng.integers(-2, 65, size=(3, 40)).astype(np.int32)
    for i, s in enumerate([b"aaaaaaaaaaaa", b"xWARN", b"x12y",
                           b"aaaa WARN x1y", b"aaaaaaaaa"]):
        batch[:, i] = 0
        batch[:, i, :len(s)] = np.frombuffer(s, np.uint8)
        lengths[:, i] = len(s)
    verdicts = prog.match(batch, lengths)
    ref = reference(OUT_OF_ROW, 64, kernel="assoc", segment=8)
    np.testing.assert_array_equal(verdicts, ref.match(batch, lengths))
    np.testing.assert_array_equal(
        verdicts, port(OUT_OF_ROW, 64, kernel="scan").match(batch, lengths))
    np.testing.assert_array_equal(verdicts[:, :5], [[1, 0, 0, 0, 0],
                                                    [0, 1, 0, 1, 0],
                                                    [0, 0, 1, 1, 0]])


def test_assoc_plain_edge_shapes():
    """L = 0, B = 0 and one row; lengths -1/-2/0/L."""
    for L, B in ((0, 3), (45, 0), (45, 1), (45, 6)):
        rng = np.random.default_rng(L + B)
        batch = rng.integers(0, 256, size=(2, B, L), dtype=np.uint8)
        lengths = np.array([[-1, -2, 0, L, 3, 1][:B]] * 2, dtype=np.int32)
        got = port(["GET", r"^$"], L, kernel="assoc", segment=2)
        verdicts = got.match(batch, lengths.reshape(2, B))
        assert verdicts.shape == (2, B)
        if B:
            ref = reference(["GET", r"^$"], L, kernel="assoc", segment=2)
            np.testing.assert_array_equal(
                verdicts, ref.match(batch, lengths.reshape(2, B)))


PROGRAMS = {"even_k_literals": ["GET", "DENY"], "apache2": [APACHE2],
            "exclude": [r'HTTP/1\.1" 500 '], "config3": CONFIG3,
            "mixed": [APACHE2, "GET", r"^\d+ GET"]}


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_auto_resolution_equals_reference(monkeypatch, platform):
    """``kernel_for`` on a CUDA / CPU device against the reference's
    ``_resolve_kernel`` with the attached platform "gpu" / "cpu", over
    state counts on both sides of 64."""
    monkeypatch.setattr(jax_device, "platform", lambda: platform)
    dev = torch.device("cuda" if platform == "gpu" else "cpu")
    for patterns in PROGRAMS.values():
        ref = reference(patterns, 128)
        for leaf in ref._children or [ref]:
            assert tg.kernel_for("auto", dev, leaf.max_states) == \
                leaf._resolve_kernel(), leaf.max_states
    for kernel in ("scan", "assoc"):
        assert tg.kernel_for(kernel, dev, 5) == kernel
        assert tg.kernel_for(kernel, dev, 500) == kernel


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_decision_equals_reference(monkeypatch, platform, name):
    """``decision()`` of a program built as on a CUDA (or CPU) device
    equals the reference's once its programs materialize on a "gpu" (or
    "cpu") platform — "mixed" where the children resolve differently.
    The port's program is built on the CPU with ``kernel_for`` resolving
    as for the device under test, and its verdicts then take that route's
    plain versions."""
    patterns = PROGRAMS[name]
    monkeypatch.setattr(jax_device, "platform", lambda: platform)
    ref = reference(patterns, 128)
    for leaf in ref._children or [ref]:
        leaf._materialize()
    dev = torch.device("cuda" if platform == "gpu" else "cpu")
    resolve = tg.kernel_for
    monkeypatch.setattr(tg, "kernel_for",
                        lambda kernel, _device, s: resolve(kernel, dev, s))
    got = port(patterns, 128)
    assert got.decision() == ref.decision()
    if name == "mixed":
        want = "mixed" if platform == "gpu" else "scan"
        assert got.decision()["kernel_resolved"] == want
    lines = syslog_lines(30, seed=1) + make_lines(30, random.Random(2))
    batch, lengths = staged(lines, 128, len(patterns))
    np.testing.assert_array_equal(got.match(batch, lengths),
                                  ref.match(batch, lengths))


def test_segment_floor_and_inheritance():
    prog = port(CONFIG3, 64, kernel="assoc", segment=1)
    assert prog.segment == 2
    assert {(c.kernel, c.segment) for c in prog._children} == {("assoc", 2)}
    assert port(["GET"], 64).decision()["kernel_resolved"] == "scan"


# -- K4's cut walk (since the redesign) --

EXCLUDE = r'HTTP/1\.1" 500 '
CUT_PROGRAMS = {"apache2": [APACHE2], "mixed_k": [APACHE2, "GET", r"^\d+ GET"],
                "config3": CONFIG3, "exclude": [EXCLUDE],
                "out_of_row": OUT_OF_ROW}
CUT_L = 80


def cut_rows(prog, seed):
    """Seeded rows of CUT_L bytes for ``prog``: random bytes everywhere
    (dirty past every length), lengths of every class (-2, -1, 0, 1, each
    stride's k - 1, k, k + 1, L - 1, L, random), then syslog and apache
    lines the rules match and miss."""
    R, B = len(prog.dfas), 80
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, size=(R, B, CUT_L), dtype=np.uint8)
    lengths = rng.integers(-2, CUT_L + 1, size=(R, B)).astype(np.int32)
    strides = set()
    for leaf in prog._children or [prog]:
        strides |= {leaf.k} | set(leaf.tables["kp"].tolist())
    special = [-2, -1, 0, 1, CUT_L - 1, CUT_L] + sorted(
        {v for s in strides for v in (s - 1, s, s + 1)})
    lengths[:, : len(special)] = special
    text = (syslog_lines(20, seed) + make_lines(20, random.Random(seed))
            + [b"aaaaaaaaaaaa x12y", b"xWARN", b'x "GET /a HTTP/1.1" 500 7'])
    for i, ln in enumerate(text, start=len(special)):
        ln = ln[:CUT_L]
        batch[:, i, : len(ln)] = np.frombuffer(ln, np.uint8)
        lengths[:, i] = len(ln)
    return batch, lengths


@pytest.mark.parametrize("segment", [2, 8, 32])
@pytest.mark.parametrize("name", sorted(CUT_PROGRAMS))
def test_cut_walk_equals_reference(name, segment):
    """``match_assoc_cut_plain`` (K4's walk: a row's segments up to the
    one holding its first EOL class, over the stride table) equals the
    reference's parallel-in-time walk over every segment of the full
    width, dirty bytes past the length included. apache2 and the mixed
    program walk their 690 states in plain torch; the kernel takes at
    most 64."""
    patterns = CUT_PROGRAMS[name]
    prog = port(patterns, CUT_L, kernel="assoc", segment=segment)
    batch, lengths = cut_rows(prog, seed=segment + len(name))
    want = reference(patterns, CUT_L, kernel="assoc",
                     segment=segment).match(batch, lengths)
    got = np.zeros_like(want)
    pairs = ([(prog, np.arange(len(patterns)))] if prog._children is None
             else [(c, ix.numpy()) for c, ix in zip(prog._children,
                                                    prog._child_idxs)])
    for leaf, ix in pairs:
        got[ix] = tg.match_assoc_cut_plain(
            leaf.tables, torch.from_numpy(batch[ix]),
            torch.from_numpy(lengths[ix]), leaf.max_states,
            leaf.segment).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_segments_past_the_first_eol_are_left_out_exactly():
    """The argument of grep_assoc.cu's note, on config 3's programs at
    K4's strides: after the super-symbol holding the first EOL class
    every state is DEAD or ACC, and an all-EOL segment maps DEAD and ACC
    to themselves; so composing the later segments (the reference) or
    not (the cut walk) reads the same state at ``starts``."""
    prog = port(CONFIG3, 512, kernel="assoc", segment=32)
    for leaf in prog._children:
        t = leaf.tables
        for r, d in enumerate(leaf.dfas):
            kp, S = int(t["kp"][r]), d.n_states
            tab = t["tab16"][r].numpy().view(np.uint16)[
                : d.n_classes ** kp * S].reshape(-1, S)
            for tail in range(kp):  # 0..kp-1 byte classes, then EOL
                for first in range(d.n_classes ** tail):
                    sym = first
                    for _ in range(kp - tail):
                        sym = sym * d.n_classes + d.eol_class
                    assert np.isin(tab[sym], (tg.DEAD, tg.ACC)).all()
            eol_sym = sum(d.eol_class * d.n_classes ** i for i in range(kp))
            assert tab[eol_sym][tg.DEAD] == tg.DEAD
            assert tab[eol_sym][tg.ACC] == tg.ACC
    # and the cut walk at the full row width equals the reference there
    lines = syslog_lines(64, seed=3) + [b"x" * 511 + b"y", b"OOM" * 170]
    batch, lengths = staged(lines, 512, len(CONFIG3))
    got = prog.match(batch, lengths)
    cut = np.concatenate([tg.match_assoc_cut_plain(
        c.tables, torch.from_numpy(batch[ix.numpy()]),
        torch.from_numpy(lengths[ix.numpy()]), c.max_states, 32).numpy()
        for c, ix in zip(prog._children, prog._child_idxs)])
    order = np.concatenate([ix.numpy() for ix in prog._child_idxs])
    np.testing.assert_array_equal(cut[np.argsort(order)], got)


@pytest.mark.parametrize("segment", [2, 32, 1024])
@pytest.mark.parametrize("name", ["apache2", "config3", "exclude"])
def test_assoc_launch_shape_does_not_grow_with_width(name, segment):
    """K4's launch shape (``assoc_block``) for a program's own tables:
    a row's slot holds one window of a power of two segments, at most
    256 symbols unless one segment is longer, whatever the row's width,
    so the block's shared memory fits at any L; above 64 states up to 8
    segment functions fit beside it."""
    prog = port(CUT_PROGRAMS[name], 512, kernel="assoc", segment=segment)
    for leaf in prog._children or [prog]:
        width = leaf.tables["tab16"].shape[1]
        P, win, ngw, gx, smem = tg.assoc_block(
            len(leaf.dfas), 4096, leaf.max_states, width, segment, 132)
        assert smem <= tg._MAX_SMEM
        w = win // segment
        assert win == w * segment and w & (w - 1) == 0
        assert win <= max(256, segment)
        assert ngw == (min(w, 8) if leaf.max_states > 64 else 0)
        assert P >= min(leaf.max_states, 32) and gx >= 1


def test_assoc_wrapper_takes_only_its_strides():
    """K4 packs super-symbols of 1, 2 or 4 bytes: the check its wrapper
    makes refuses any other stride (again after a write to the tensor),
    and every program built for K4 keeps to them."""
    kp = torch.tensor([1, 2, 4], dtype=torch.int32)
    tg._check_assoc_strides(kp)
    tg._check_assoc_strides(kp)
    kp[0] = 3
    with pytest.raises(ValueError, match="strides"):
        tg._check_assoc_strides(kp)
    for patterns in CUT_PROGRAMS.values():
        prog = port(patterns, CUT_L, kernel="assoc")
        for leaf in prog._children or [prog]:
            tg._check_assoc_strides(leaf.tables["kp"])

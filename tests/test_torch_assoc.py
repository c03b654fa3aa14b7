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

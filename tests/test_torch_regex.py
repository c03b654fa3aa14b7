"""The port's regex → DFA compiler against the reference package's.

Same pattern in, the same minimized tables out (trans, class_map, start,
EOL class, S, C and the reduction audit), and the same FlbRegex verdicts
on the same lines — exact comparisons, the tables are integers.
"""

import random

import numpy as np
import pytest

from fluentbit_tpu.regex import FlbRegex as JaxFlbRegex
from fluentbit_tpu.regex.dfa import compile_dfa as jax_compile_dfa
from fluentbit_tpu_torch.regex import FlbRegex
from fluentbit_tpu_torch.regex.dfa import compile_dfa

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)

# every pattern of tests/test_ops_grep.py, apache2 and a literal
PATTERNS = ["abc", r"^\d+ GET", APACHE2, r"a*b|c$", "GET", r"^\d", "x*",
            "a", r"^\d+$", "ab+c", "DENY"]


def make_lines(n, seed):
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        kind = rng.randrange(5)
        if kind == 0:
            lines.append(
                f'10.0.{rng.randrange(256)}.{rng.randrange(256)} - user{i} '
                f'[10/Oct/2024:13:55:36 -0700] "GET /p{i} HTTP/1.1" '
                f'{rng.choice([200, 404, 500])} {rng.randrange(10000)}')
        elif kind == 1:
            lines.append(f"random junk line {i} abbbc DENY")
        elif kind == 2:
            lines.append("")
        elif kind == 3:
            lines.append(f'host{i} - ü [t] "POST /日本 Z" 201 7 "r" "agent {i}"')
        else:
            lines.append(f"{i} GET c\nab")
    return lines


@pytest.mark.parametrize("pattern", PATTERNS)
def test_compile_dfa_tables_equal(pattern):
    ref = jax_compile_dfa(pattern)
    got = compile_dfa(pattern)
    np.testing.assert_array_equal(got.trans, ref.trans)
    np.testing.assert_array_equal(got.class_map, ref.class_map)
    assert got.trans.dtype == ref.trans.dtype
    assert got.class_map.dtype == ref.class_map.dtype
    assert (got.start, got.eol_class, got.n_states, got.n_classes) == \
        (ref.start, ref.eol_class, ref.n_states, ref.n_classes)
    assert (got.shrink.s_raw, got.shrink.c_raw, got.shrink.s,
            got.shrink.c, got.shrink.minimized) == \
        (ref.shrink.s_raw, ref.shrink.c_raw, ref.shrink.s, ref.shrink.c,
         ref.shrink.minimized)


def test_compile_dfa_unminimized_tables_equal():
    ref = jax_compile_dfa(APACHE2, minimize=False)
    got = compile_dfa(APACHE2, minimize=False)
    np.testing.assert_array_equal(got.trans, ref.trans)
    np.testing.assert_array_equal(got.class_map, ref.class_map)
    assert got.start == ref.start


def test_apache2_shape():
    # the shape PERF.md's table sizes rest on
    d = compile_dfa(APACHE2)
    assert (d.n_states, d.n_classes) == (690, 8)


# a back-reference cannot be a DFA: both packages take Python's re
@pytest.mark.parametrize("pattern", PATTERNS + [r"(a)\1", r"(?<w>b+)c\1"])
def test_flbregex_match_agrees(pattern):
    ref, got = JaxFlbRegex(pattern), FlbRegex(pattern)
    assert got.dfa_capable == ref.dfa_capable
    for line in make_lines(60, seed=len(pattern)) + ["aa", "bbbb", "abc"]:
        assert got.match(line) == ref.match(line), (pattern, line)
        raw = line.encode("utf-8")
        assert got.match(raw) == ref.match(raw), (pattern, line)

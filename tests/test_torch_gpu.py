"""The port's CUDA kernels against their plain torch versions (needs a card).

``grep_dfa`` (K1-K3) against ``match_plain``; ``grep_assoc`` (K4)
against ``match_assoc_plain`` and the scan, and its launches across a
config 3 append (the own-emitter re-entry adds none); ``hll_update`` (K6) and
``cms_update`` (K7) against ``hll_update_plain`` / ``cms_update_plain``;
the flux plane's ``fused_absorb`` (K10) and ``segment_counts`` (K9)
against ``fused_absorb_plain`` / ``segment_counts_plain``, and K10's
launch count across a pipeline append. Registers, stacks, tables and
counts equal exactly (integer atomics are order-free); K7 where every
row is one value (weights negative, or an int64 sum past 2^32).
``utf8_validate`` (K11) against ``utf8_validate_plain`` and
``utf8_validate_pieces_plain``, verdict for verdict, over random rows
(L up to 4096: several 512 B windows), multi-byte sequences across
every 16 B piece and window boundary, each kind of invalid byte at
every offset of a piece, and the edge cases (L = 0, rows at -1 / -2,
full ASCII rows, invalid first bytes, unaligned and strided views);
filter_parser on
``cuda`` against ``cpu`` for json and apache2, and K3's launches on
config 2r (tail → parser apache2: one per append of >= 64 records).
K6's grouped form (``hll_update_groups``) against
``hll_update_groups_plain``, and both sketch kernels and K10 where
atomics collide (one group, one value, one composite, Zipf groups).
The raw chunk path and K5: K3's and K4's counts epilogue against
``mask.sum``, verdicts over rows whose bytes past the length are dirty
(0xFF, random) against zeroed rows, the sharded dispatch over
``Mesh((cuda:0,) * n)`` against the sharded plain version, and a
65,536-record chunk (16 double-buffered segments) on cuda against cpu.
The mesh programs of the sketches and the flux plane: ``shard_merge``
against ``shard_merge_plain`` (max and add, int32 and int64, an int32
add that wraps), and K8 (``sharded_hll_registers`` /
``sharded_cms_table``), K9's and K10's mesh halves over
``Mesh((cuda:0,) * n)`` against the unsharded kernels, with their shard
and merge launches counted. Config 5: K4 on the ``health-check``
Exclude program (14 states) at [1, 4096, 512] and [1, 37, 512] against
its plain version, the CPU program and the scan, and a forward message
through forward → kubernetes → grep on cuda (one K4 launch) against cpu.

Every test here is marked ``gpu`` and skips itself, in the
``cuda_device`` fixture, where ``torch.cuda.is_available()`` is false: a
CUDA kernel has no CPU mode. This file imports neither JAX nor the
reference package, so it runs on a GPU host that has only the port's
dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import random
import time

import numpy as np
import pytest
import torch

import json

import fluentbit_tpu_torch
from fluentbit_tpu_torch.codec.events import decode_events
from fluentbit_tpu_torch.flux import kernels as tfk
from fluentbit_tpu_torch.ops import grep as tg
from fluentbit_tpu_torch.ops import sketch as tsk
from fluentbit_tpu_torch.ops import utf8 as tu
from fluentbit_tpu_torch.ops.batch import assemble
from fluentbit_tpu_torch.regex.dfa import compile_dfa

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
MIXED_K = [APACHE2, "GET", r"^\d+ GET"]  # k = 3, 6, 5: three children
#: conf/baseline3-rewrite.conf's rule patterns: k = 4, 5, 6 children
CONFIG3 = ["sshd", "kernel:", r"systemd\[1\]", "ERROR", "WARN", "nginx",
           r"cron\[\d+\]", ".*OOM.*"]
#: one k = 6 program where walking all 12 states passes WARN's row end
OUT_OF_ROW = ["a{10}", "WARN", "x[0-9]+y"]


def make_lines(n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.6:
            out.append(f'10.0.0.{i} - u{i} [10/Oct/2024:13:55:36 -0700] '
                       f'"GET /p/ü{i} HTTP/1.1" 200 {rng.randrange(999)}'
                       .encode())
        else:
            out.append(f"{i} GET junk 日本".encode())
    return out


def random_rows(rng, R, B, L):
    """Seeded rows: random bytes (non-ASCII included), every length
    class: -1, -2, 0, odd/even, L-1 and L."""
    batch = rng.integers(0, 256, size=(R, B, L), dtype=np.uint8)
    lengths = rng.integers(-2, L + 1, size=(R, B)).astype(np.int32)
    special = np.array([-1, -2, 0, 1, L - 1, L], dtype=np.int32)
    lengths[:, : min(B, len(special))] = special[: min(B, len(special))]
    return batch, lengths


def full_tables(prog, device):
    """Every table of ``prog``'s rules on ``device``, ``pair_maps`` too."""
    return {name: torch.from_numpy(a).to(device)
            for name, a in tg.build_tables(prog.dfas, prog.k).items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def early_stop_rows(batch, lengths, first):
    """Rows from ``first`` on that reach ACC or DEAD within their first
    bytes (a literal at the front, a byte that kills an anchored
    pattern), their bytes past that random and their length anything up
    to L: the walk must stop there, or walk on to the same state."""
    R, B, L = batch.shape
    heads = [b"GET", b"DENY", b"12 GET", b"x", b"\xff", b" ",
             b"sshd", b"kernel:", b"OOM", b"aaaaaaaaaa", b"x1y", b"WARN",
             b"a" * 45, b"b" * 75,
             b'1.2.3.4 - u [t] "GET / HTTP/1.1" 200 5']
    for i, head in enumerate(heads):
        row = first + i
        if row >= B or len(head) > L:
            continue
        batch[:, row, : len(head)] = np.frombuffer(head, np.uint8)
        # every other row ends at its head, the rest run on
        lengths[:, row] = len(head) + (i % 2) * ((row * 7) % (L - len(head)
                                                              + 1))
    return batch, lengths


def leaves_of(prog):
    """(single-k program, its rule indices on the card) per k-group."""
    if prog._children is None:
        return [(prog, torch.arange(len(prog.dfas)))]
    return list(zip(prog._children, prog._child_idxs))


def tables_half(t, half):
    """K3's shared half reads ``tab16``; without it, its global half."""
    if half == "shared":
        return t
    return {n: v for n, v in t.items() if n not in ("tab16", "kp")}


@pytest.mark.gpu
@pytest.mark.parametrize("half", ["shared", "global"])
@pytest.mark.parametrize("patterns,L", [([APACHE2], 512), ([APACHE2], 45),
                                        (["GET", "DENY"], 64),
                                        (MIXED_K, 128), (MIXED_K, 0),
                                        (OUT_OF_ROW, 100)])
@pytest.mark.parametrize("B", [1, 17, 300])
def test_cuda_kernel_equals_plain(cuda_device, patterns, L, B, half):
    """K3 against its plain version on the card and the CPU program,
    through both halves of its table branch, over every length class,
    rows that stop early, bytes past the length left dirty and L off a
    multiple of 16; its counts epilogue against ``mask.sum``."""
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L,
                               cuda_device, kernel="scan")
    batch, lengths = random_rows(np.random.default_rng(B + L), len(patterns),
                                 B, L)
    lines = make_lines(min(B, 40), seed=B)
    for i, ln in enumerate(lines):
        if len(ln) <= L:
            batch[:, i, :] = 0
            batch[:, i, : len(ln)] = np.frombuffer(ln, np.uint8)
            lengths[:, i] = len(ln)
    batch, lengths = early_stop_rows(batch, lengths, 40)
    before = tg.grep_dfa.launches
    got = prog.match(batch, lengths)
    assert tg.grep_dfa.launches - before == len(prog.decision()["k_groups"])
    cpu = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L, "cpu",
                              kernel="scan")
    np.testing.assert_array_equal(got, cpu.match(batch, lengths))
    b = torch.from_numpy(batch).cuda()
    ln = torch.from_numpy(lengths).cuda()
    for leaf, ix in leaves_of(prog):
        # the device program holds only the kernels' tables; the plain
        # version gets the full set, so even k takes K2's pair tables
        assert "pair_maps" not in leaf.tables and "tab16" in leaf.tables
        ix = ix.to(cuda_device)
        bb = b.index_select(0, ix).contiguous()
        ll = ln.index_select(0, ix).contiguous()
        t = tables_half(leaf.tables, half)
        counts = torch.full((bb.shape[0],), 3, dtype=torch.int32,
                            device=cuda_device)
        mask = tg.grep_dfa(t, bb, ll, leaf.k, counts=counts)
        plain = tg.match_plain(full_tables(leaf, cuda_device), bb, ll, leaf.k)
        assert torch.equal(mask, plain)
        assert torch.equal(mask, tg.match_stop_plain(t, bb, ll, leaf.k))
        assert torch.equal(counts - 3, tg.counts_plain(plain))
        assert torch.equal(mask, torch.from_numpy(got).cuda().index_select(
            0, ix))


@pytest.mark.gpu
@pytest.mark.parametrize("half", ["shared", "global"])
@pytest.mark.parametrize("B", [50, 40000])
def test_cuda_kernel_unaligned_batch(cuda_device, half, B):
    """A batch view at an odd offset takes the byte-load path; blocks of
    4 warps (50 rows) and of 8 (40,000 rows, more than two blocks an SM
    at 4) give the same verdicts and counts."""
    prog = tg.TorchGrepProgram([compile_dfa(APACHE2)], 64, cuda_device)
    batch, lengths = random_rows(np.random.default_rng(1), 1, B, 64)
    batch, lengths = early_stop_rows(batch, lengths, 6)
    flat = torch.zeros(1 + batch.size, dtype=torch.uint8, device=cuda_device)
    view = flat[1:].view(1, B, 64)
    view.copy_(torch.from_numpy(batch))
    lt = torch.from_numpy(lengths).cuda()
    t = tables_half(prog.tables, half)
    counts = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = tg.grep_dfa(t, view, lt, prog.k, counts=counts)
    plain = tg.match_plain(prog.tables, view, lt, prog.k)
    assert torch.equal(got, plain)
    assert torch.equal(counts, tg.counts_plain(plain))


def syslog_rows(R, B, L, seed):
    """Random rows with every length class, the first 60 replaced by
    syslog lines that config 3's rules match and miss."""
    batch, lengths = random_rows(np.random.default_rng(seed), R, B, L)
    progs = ["sshd[22]: Accepted", "kernel: eth0 up", "systemd[1]: Started",
             "app: ERROR boom", "app: WARN slow", "nginx: GET / 200",
             "cron[811]: job", "oom: OOM killer", "cron[x]: job", "plain"]
    lines = [f"Oct 17 11:00:{i % 60:02d} h {progs[i % 10]} x{i}".encode()
             for i in range(6, min(B, 66))]
    # and a line for each of the other programs
    lines += [b'x "GET /a HTTP/1.1" 500 7', b"GET /a DENY", b"xWARN"]
    for i, line in enumerate(lines[: max(0, B - 6)], start=6):
        if len(line) <= L:
            batch[:, i, :] = 0
            batch[:, i, : len(line)] = np.frombuffer(line, np.uint8)
            lengths[:, i] = len(line)
    return batch, lengths


def assoc_plain_on_card(prog, b, ln):
    """``prog.dispatch`` with ``match_assoc_plain`` in place of K4."""
    leaves = ([(prog, b, ln)] if prog._children is None else
              [(c, b.index_select(0, ix), ln.index_select(0, ix))
               for c, ix in zip(prog._children, prog._child_idxs)])
    parts = [tg.match_assoc_plain(leaf.tables, bb, ll, leaf.k,
                                  leaf.max_states, leaf.segment)
             for leaf, bb, ll in leaves]
    if prog._children is None:
        return parts[0]
    return torch.cat(parts, dim=0).index_select(0, prog._inv_perm)


@pytest.mark.gpu
@pytest.mark.parametrize("segment", [2, 32, 1024])
@pytest.mark.parametrize("patterns,L,B", [
    (CONFIG3, 512, 300), (CONFIG3, 512, 1), (CONFIG3, 0, 17),
    (OUT_OF_ROW, 64, 300), (["GET", "DENY"], 64, 300),
    ([r'HTTP/1\.1" 500 '], 45, 300), (CONFIG3, 100, 300),
    ([APACHE2], 200, 300), (["a{40}"], 100, 300),
    (["a{40}", "b{70}"], 100, 300)])
def test_assoc_kernel_equals_plain(cuda_device, patterns, L, B, segment):
    """K4 against its plain version on the card, the CPU program and the
    scan, over every length class, rows that stop early, bytes past the
    length left dirty and L off a multiple of 16; its counts epilogue
    against ``mask.sum``; the cut walk's plain version agrees."""
    dfas = [compile_dfa(p) for p in patterns]
    prog = tg.TorchGrepProgram(dfas, L, cuda_device, kernel="assoc",
                               segment=segment)
    batch, lengths = syslog_rows(len(patterns), B, L, seed=B + L + segment)
    if patterns == OUT_OF_ROW:
        for i, s in enumerate([b"aaaaaaaaaaaa", b"xWARN", b"x12y"]):
            batch[:, 6 + i, :] = 0
            batch[:, 6 + i, : len(s)] = np.frombuffer(s, np.uint8)
            lengths[:, 6 + i] = len(s)
    batch, lengths = early_stop_rows(batch, lengths, 70)
    groups = len(prog.decision()["k_groups"])
    before = (tg.grep_assoc.launches, tg.grep_dfa.launches)
    got = prog.match(batch, lengths)
    assert (tg.grep_assoc.launches - before[0],
            tg.grep_dfa.launches - before[1]) == (groups, 0)
    b = torch.from_numpy(batch).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    np.testing.assert_array_equal(
        got, assoc_plain_on_card(prog, b, ln).cpu().numpy())
    cpu = tg.TorchGrepProgram(dfas, L, "cpu", kernel="assoc",
                              segment=segment)
    np.testing.assert_array_equal(got, cpu.match(batch, lengths))
    scan = tg.TorchGrepProgram(dfas, L, cuda_device, kernel="scan")
    np.testing.assert_array_equal(got, scan.match(batch, lengths))
    for leaf, ix in leaves_of(prog):
        ix = ix.to(cuda_device)
        bb = b.index_select(0, ix).contiguous()
        ll = ln.index_select(0, ix).contiguous()
        counts = torch.full((bb.shape[0],), 3, dtype=torch.int32,
                            device=cuda_device)
        mask = tg.grep_assoc(leaf.tables, bb, ll, leaf.k, leaf.max_states,
                             leaf.segment, counts=counts)
        assert torch.equal(counts - 3, tg.counts_plain(mask))
        assert torch.equal(mask, tg.match_assoc_cut_plain(
            leaf.tables, bb, ll, leaf.max_states, leaf.segment))
    if B > 60 and L:
        assert 0 < got.sum() < got.size


@pytest.mark.gpu
@pytest.mark.parametrize("patterns", [["GET", "DENY"], CONFIG3,
                                      [r'HTTP/1\.1" 500 ']])
def test_assoc_kernel_unaligned_batch(cuda_device, patterns):
    """A batch view at an odd offset (K4 reads bytes one by one)."""
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], 64,
                               cuda_device, kernel="assoc", segment=8)
    R = len(patterns)
    batch, lengths = syslog_rows(R, 70, 64, seed=5)
    batch, lengths = early_stop_rows(batch, lengths, 50)
    flat = torch.zeros(1 + batch.size, dtype=torch.uint8, device=cuda_device)
    view = flat[1:].view(R, 70, 64)
    view.copy_(torch.from_numpy(batch))
    lt = torch.from_numpy(lengths).cuda()
    for leaf, ix in leaves_of(prog):
        ix = ix.to(cuda_device)
        rows = torch.zeros(1 + len(ix) * 70 * 64, dtype=torch.uint8,
                           device=cuda_device)[1:].view(len(ix), 70, 64)
        rows.copy_(view.index_select(0, ix))
        ll = lt.index_select(0, ix).contiguous()
        got = tg.grep_assoc(leaf.tables, rows, ll, leaf.k, leaf.max_states, 8)
        want = tg.match_assoc_plain(full_tables(leaf, cuda_device), rows, ll,
                                    leaf.k, leaf.max_states, 8)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [512, 45])
def test_assoc_wrapper_refuses_other_strides(cuda_device, L):
    """K4 packs super-symbols of 1, 2 or 4 bytes only: table sets built
    for the scan, at strides that do not divide 16 (Exclude at 3, WARN
    and nginx at 5), raise before any launch."""
    for patterns in ([r'HTTP/1\.1" 500 '], ["WARN", "nginx"]):
        prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L,
                                   cuda_device, kernel="scan")
        assert any(kp not in (1, 2, 4) for kp in prog.tables["kp"].tolist())
        batch, lengths = syslog_rows(len(patterns), 300, L, seed=L)
        b = torch.from_numpy(batch).cuda()
        ln = torch.from_numpy(lengths).cuda()
        before = tg.grep_assoc.launches
        with pytest.raises(ValueError, match="strides"):
            tg.grep_assoc(prog.tables, b, ln, prog.k, prog.max_states, 32)
        assert tg.grep_assoc.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("segment", [2, 32, 1024])
@pytest.mark.parametrize("L", [4096, 40000])
def test_assoc_kernel_wide_rows(cuda_device, L, segment):
    """Config 3's rules over rows of a user-set ``tpu_max_record_len``
    (4096, 40000): K4's shared memory does not grow with L, and its
    verdicts and counts equal the plain version's, the scan's and the
    CPU program's, with the rules' words pushed deep into the rows."""
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in CONFIG3], L,
                               cuda_device, kernel="assoc", segment=segment)
    batch, lengths = syslog_rows(len(CONFIG3), 96, L, seed=L + segment)
    batch, lengths = early_stop_rows(batch, lengths, 70)
    for i in range(6, 66, 2):  # the line after a long run of filler
        n = int(lengths[0, i])
        pad = (i * 997) % (L - n)
        line = batch[:, i, :n].copy()
        batch[:, i, :pad] = ord(".")
        batch[:, i, pad:pad + n] = line
        lengths[:, i] = pad + n
    before = tg.grep_assoc.launches
    got = prog.match(batch, lengths)
    assert tg.grep_assoc.launches - before == len(prog.decision()["k_groups"])
    b = torch.from_numpy(batch).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    np.testing.assert_array_equal(
        got, assoc_plain_on_card(prog, b, ln).cpu().numpy())
    scan = tg.TorchGrepProgram([compile_dfa(p) for p in CONFIG3], L,
                               cuda_device, kernel="scan")
    np.testing.assert_array_equal(got, scan.match(batch, lengths))
    cpu = tg.TorchGrepProgram([compile_dfa(p) for p in CONFIG3], L, "cpu")
    np.testing.assert_array_equal(got, cpu.match(batch, lengths))
    for leaf, ix in leaves_of(prog):
        ix = ix.to(cuda_device)
        bb = b.index_select(0, ix).contiguous()
        ll = ln.index_select(0, ix).contiguous()
        counts = torch.zeros(bb.shape[0], dtype=torch.int32,
                             device=cuda_device)
        mask = tg.grep_assoc(leaf.tables, bb, ll, leaf.k, leaf.max_states,
                             segment, counts=counts)
        assert torch.equal(counts, tg.counts_plain(mask))
    assert 0 < got[:, 6:66:2].sum() < got[:, 6:66:2].size


@pytest.mark.gpu
def test_auto_takes_assoc_on_the_card(cuda_device):
    """"auto" resolves as the reference's _resolve_kernel: assoc up to
    64 states, the scan above, "mixed" across children."""
    def resolved(patterns):
        return tg.TorchGrepProgram([compile_dfa(p) for p in patterns], 64,
                                   cuda_device).decision()["kernel_resolved"]

    assert resolved(CONFIG3) == "assoc"
    assert resolved([APACHE2]) == "scan"
    assert resolved(MIXED_K) == "mixed"


@pytest.mark.gpu
def test_assoc_wrapper_rejects_bad_tensors(cuda_device):
    prog = tg.TorchGrepProgram([compile_dfa("GET")], 32, cuda_device,
                               kernel="assoc")
    batch, lengths = random_rows(np.random.default_rng(0), 1, 4, 32)
    b, ln = torch.from_numpy(batch), torch.from_numpy(lengths)
    with pytest.raises(ValueError, match="CUDA"):
        tg.grep_assoc(prog.tables, b, ln, prog.k, prog.max_states, 32)
    with pytest.raises(ValueError, match="lengths"):
        tg.grep_assoc(prog.tables, b.cuda(), ln.cuda().long(), prog.k,
                      prog.max_states, 32)
    with pytest.raises(ValueError, match="shared memory"):
        tg.grep_assoc(prog.tables, b.cuda(), ln.cuda(), prog.k, 60000, 2)
    with pytest.raises(ValueError, match="shared memory"):
        tg.grep_assoc(prog.tables, b.cuda(), ln.cuda(), prog.k,
                      prog.max_states, 1 << 20)
    with pytest.raises(ValueError, match="tab16"):
        tg.grep_assoc({n: v for n, v in prog.tables.items() if n != "tab16"},
                      b.cuda(), ln.cuda(), prog.k, prog.max_states, 32)


@pytest.mark.gpu
def test_config3_append_launches_k4_per_k_group(cuda_device, monkeypatch):
    """One config 3 append through create(device="cuda") on the decoded
    path (the batch hook off) is 3 K4 launches (one per k-group, none
    for the re-emitted records that pass the own-emitter guard under
    Match *) and no scan launch; on the raw path rewrite_tag's batch
    hook takes it with no launch. The tags and bodies of every run
    equal the same append on the CPU."""
    from fluentbit_tpu_torch.plugins.filter_rewrite_tag import \
        RewriteTagFilter

    rules = [f"$log {p} {t} false" for p, t in zip(CONFIG3, [
        "sec.ssh", "sys.kernel", "sys.init", "app.error", "app.warn",
        "web.nginx", "sys.cron", "sys.oom"])]
    recs = [{"log": line.decode()} for line in
            (f"h{i} {p} msg".encode() for i, p in enumerate(
                ["sshd[1]:", "kernel:", "systemd[1]:", "ERROR", "WARN",
                 "nginx", "cron[5]", "OOM", "quiet", "sshd ERROR"] * 30))]
    out = {}
    for path, device in (("raw", "cuda"), ("raw", "cpu"),
                         ("decoded", "cuda"), ("decoded", "cpu")):
        if path == "decoded":
            monkeypatch.setattr(RewriteTagFilter, "can_process_batch",
                                lambda self: False)
        got = out[path, device] = {}
        ctx = fluentbit_tpu_torch.create(device=device, flush="50ms",
                                         grace="1")
        in_ffd = ctx.input("lib", tag="syslog")
        f = ctx.filter("rewrite_tag", match="*")
        for r in rules:
            ctx.set(f, rule=r)
        ctx.output("null", match="*")
        ctx.output("lib", match="*", callback=lambda d, t, got=got:
                   got.setdefault(t, []).extend(
                       ev.body for ev in decode_events(d)))
        ctx.start()
        before = (tg.grep_assoc.launches, tg.grep_dfa.launches)
        try:
            assert ctx.push(in_ffd, json.dumps(recs)) == 30
            ctx.flush_now()
        finally:
            ctx.stop()
        launches = (tg.grep_assoc.launches - before[0],
                    tg.grep_dfa.launches - before[1])
        assert launches == ((3, 0) if (path, device) == ("decoded", "cuda")
                            else (0, 0))
        # the raw path: the original append and each re-emitted group
        assert ctx.engine.filters[0].batch_taken == (
            1 + len(set(got) - {"syslog"}) if path == "raw" else 0)
    assert out["raw", "cuda"] == out["raw", "cpu"] == out[
        "decoded", "cuda"] == out["decoded", "cpu"]
    assert len(out["raw", "cuda"]["sec.ssh"]) == 60


def sketch_rows(seed, B, L):
    """Seeded sketch rows: random bytes, lengths -2/-1/0/1/L and random,
    all-0xFF rows, and a Zipf-like repeat of a few values so that
    atomics collide."""
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(-2, L + 1, size=(B,)).astype(np.int32)
    special = np.array([-2, -1, 0, min(1, L), L, L], dtype=np.int32)
    lengths[: min(B, 6)] = special[: min(B, 6)]
    batch[4:6] = 0xFF
    hot = np.minimum(rng.zipf(1.3, size=B), min(B, 8)) - 1  # the first rows, repeated
    pick = rng.random(B) < 0.5
    batch[pick] = batch[hot[pick]]
    lengths[pick] = lengths[hot[pick]]
    return torch.from_numpy(batch), torch.from_numpy(lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [4, 10, 14])
@pytest.mark.parametrize("B,L", [(1, 0), (17, 1), (300, 17), (4096, 256)])
def test_hll_kernel_equals_plain(cuda_device, p, B, L):
    batch, lengths = sketch_rows(p + B + L, B, L)
    start = torch.randint(0, 34 - p, (1 << p,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(p))
    start[: (1 << p) // 2] = 0
    regs = start.to(cuda_device, copy=True)
    before = tsk.hll_update.launches
    tsk.hll_update(regs, batch.to(cuda_device), lengths.to(cuda_device), p)
    assert tsk.hll_update.launches - before == 1
    want = start.clone()
    tsk.hll_update_plain(want, batch, lengths, p)
    plain = start.to(cuda_device, copy=True)  # the plain version on the card
    tsk.hll_update_plain(plain, batch.to(cuda_device),
                         lengths.to(cuda_device), p)
    torch.cuda.synchronize()
    assert torch.equal(regs.cpu(), want)
    assert torch.equal(plain.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,w,dtype", [(4, 512, torch.int32),
                                       (4, 16384, torch.int32),
                                       (4, 512, torch.int64),
                                       (3, 1000, torch.int64)])
@pytest.mark.parametrize("B,L", [(1, 0), (17, 1), (300, 17), (4096, 256)])
@pytest.mark.parametrize("weighted", [False, True])
def test_cms_kernel_equals_plain(cuda_device, d, w, dtype, B, L, weighted):
    batch, lengths = sketch_rows(d * w + B + L, B, L)
    gen = torch.Generator().manual_seed(w + B)
    start = torch.randint(0, 1 << 20, (d, w), generator=gen).to(dtype)
    if dtype == torch.int64:
        start += 1 << 40
    weights = (torch.randint(-3, 1 << 24, (B,), dtype=torch.int32,
                             generator=gen) if weighted else None)
    table = start.to(cuda_device, copy=True)
    before = tsk.cms_update.launches
    tsk.cms_update(table, batch.to(cuda_device), lengths.to(cuda_device),
                   None if weights is None else weights.to(cuda_device))
    assert tsk.cms_update.launches - before == 1
    want = start.clone()
    tsk.cms_update_plain(want, batch, lengths, weights)
    torch.cuda.synchronize()
    assert torch.equal(table.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,weights", [(torch.int32, None),
                                           (torch.int32, "negative"),
                                           (torch.int64, "negative"),
                                           (torch.int64, "past_2_32")])
@pytest.mark.parametrize("B", [4096, 65536])
def test_cms_kernel_one_value_contended(cuda_device, dtype, weights, B):
    """Every row one value: every live lane of every warp on one word of
    each depth row, folded in the warp (from 16384 rows by
    ``__match_any_sync``). Weights mostly negative, or (int64) large
    enough that the sum on that word passes 2^32: the warp's sum is
    exact in 64 bits."""
    batch, lengths = sketch_rows(B, B, 64)
    batch[:] = batch[7]
    lengths[:] = 40
    lengths[::7] = -1
    gen = torch.Generator().manual_seed(B)
    wts = None
    if weights == "negative":
        wts = torch.randint(-(1 << 12), 1 << 8, (B,), dtype=torch.int32,
                            generator=gen)
    elif weights == "past_2_32":
        wts = torch.randint(1 << 20, 1 << 23, (B,), dtype=torch.int32,
                            generator=gen)
        wts[::5] = -(1 << 21)
    start = torch.zeros((4, 16384), dtype=dtype)
    table = start.to(cuda_device)
    tsk.cms_update(table, batch.to(cuda_device), lengths.to(cuda_device),
                   None if wts is None else wts.to(cuda_device))
    want = start.clone()
    tsk.cms_update_plain(want, batch, lengths, wts)
    torch.cuda.synchronize()
    assert torch.equal(table.cpu(), want)
    assert int((want != 0).sum()) == 4  # one word in each depth row
    if weights == "past_2_32":
        assert int(want.max()) > 1 << 32
    elif weights == "negative":
        assert int(want.min()) < 0


def group_regs(G, p, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 3, (1 << p,), dtype=torch.int32, generator=gen)
            for _ in range(G)]


@pytest.mark.gpu
@pytest.mark.parametrize("G,B,L,seg_kind", [
    (1, 4096, 256, "zeros"), (600, 4096, 256, "cycle"),  # the wide append
    (600, 65536, 256, "cycle"), (7, 300, 17, "out_of_range"),
    (2000, 4096, 64, "cycle"),          # pointers from a device array
    (5, 200, 600, "random"),            # three windows of a row
    (3, 100, 0, "random"), (600, 4096, 256, "one_group")])
def test_hll_groups_kernel_equals_plain(cuda_device, G, B, L, seg_kind):
    """K6's grouped form against hll_update_groups_plain, bit for bit:
    one launch for every group; a segment id outside [0, G) changes
    nothing; one group taking every row is the contended case."""
    p = 12
    batch, lengths = sketch_rows(G + B + L, B, L)
    rng = np.random.default_rng(B + G)
    seg = {"zeros": np.zeros(B), "cycle": np.arange(B) % G,
           "out_of_range": rng.integers(-3, G + 3, size=B),
           "random": rng.integers(0, G, size=B),
           "one_group": np.full(B, G // 2)}[seg_kind]
    seg = torch.from_numpy(seg.astype(np.int32))
    start = group_regs(G, p, B)
    want = [r.clone() for r in start]
    tsk.hll_update_groups_plain(want, batch, lengths, seg, p)
    got = [r.to(cuda_device) for r in start]
    before = tsk.hll_update_groups.launches
    tsk.hll_update_groups(got, batch.to(cuda_device),
                          lengths.to(cuda_device), seg.to(cuda_device), p)
    assert tsk.hll_update_groups.launches - before == 1
    plain = [r.to(cuda_device) for r in start]  # the plain version on the card
    tsk.hll_update_groups_plain(plain, batch.to(cuda_device),
                                lengths.to(cuda_device),
                                seg.to(cuda_device), p)
    torch.cuda.synchronize()
    for g, w, q in zip(got, want, plain):
        assert torch.equal(g.cpu(), w)
        assert torch.equal(q.cpu(), w)
    if L:  # (at L = 0 every row is the empty value, often below the start)
        assert any(not torch.equal(w, s) for w, s in zip(want, start))


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(4096, 256), (65536, 256), (300, 40)])
def test_hll_kernels_one_value_contended(cuda_device, B, L):
    """Every row the same value: every live lane of a warp targets one
    register (K6 makes one atomic per lane). The one-array
    and grouped forms (one group, G = 1) both equal the plain version."""
    batch, lengths = sketch_rows(B, B, L)
    batch[:] = batch[7]
    lengths[:] = L // 2
    lengths[::5] = -1
    for p in (4, 14):
        start = torch.zeros(1 << p, dtype=torch.int32)
        want = start.clone()
        tsk.hll_update_plain(want, batch, lengths, p)
        one = start.to(cuda_device)
        tsk.hll_update(one, batch.to(cuda_device), lengths.to(cuda_device), p)
        grouped = [start.to(cuda_device)]
        tsk.hll_update_groups(grouped, batch.to(cuda_device),
                              lengths.to(cuda_device),
                              torch.zeros(B, dtype=torch.int32,
                                          device=cuda_device), p)
        torch.cuda.synchronize()
        assert torch.equal(one.cpu(), want)
        assert torch.equal(grouped[0].cpu(), want)
        assert int(want.max()) > 0


@pytest.mark.gpu
def test_hll_groups_wrapper_rejects_bad_tensors(cuda_device):
    batch, lengths = sketch_rows(4, 8, 16)
    b, ln = batch.to(cuda_device), lengths.to(cuda_device)
    seg = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    regs = [torch.zeros(1 << 10, dtype=torch.int32, device=cuda_device)]
    with pytest.raises(ValueError, match="registers"):
        tsk.hll_update_groups(regs + [torch.zeros(100, dtype=torch.int32,
                                                  device=cuda_device)],
                              b, ln, seg, 10)
    with pytest.raises(ValueError, match="seg"):
        tsk.hll_update_groups(regs, b, ln, seg.long(), 10)
    with pytest.raises(ValueError, match="precision"):
        tsk.hll_update_groups(regs, b, ln, seg, 30)


@pytest.mark.gpu
def test_sketch_kernels_unaligned_batch(cuda_device):
    """A batch view at an odd offset takes the byte-load path."""
    batch, lengths = sketch_rows(3, 200, 64)
    flat = torch.zeros(1 + batch.numel(), dtype=torch.uint8,
                       device=cuda_device)
    view = flat[1:].view(200, 64)
    view.copy_(batch)
    lt = lengths.to(cuda_device)
    regs = torch.zeros(1 << 10, dtype=torch.int32, device=cuda_device)
    table = torch.zeros((4, 512), dtype=torch.int32, device=cuda_device)
    tsk.hll_update(regs, view, lt, 10)
    tsk.cms_update(table, view, lt)
    want_regs = torch.zeros(1 << 10, dtype=torch.int32)
    want_table = torch.zeros((4, 512), dtype=torch.int32)
    tsk.hll_update_plain(want_regs, batch, lengths, 10)
    tsk.cms_update_plain(want_table, batch, lengths)
    assert torch.equal(regs.cpu(), want_regs)
    assert torch.equal(table.cpu(), want_table)


@pytest.mark.gpu
def test_sketch_wrappers_reject_bad_tensors(cuda_device):
    batch, lengths = sketch_rows(4, 8, 16)
    b, ln = batch.to(cuda_device), lengths.to(cuda_device)
    with pytest.raises(ValueError, match="registers"):
        tsk.hll_update(torch.zeros(100, dtype=torch.int32,
                                   device=cuda_device), b, ln, 10)
    with pytest.raises(ValueError, match="table"):
        tsk.cms_update(torch.zeros((4, 512), dtype=torch.float32,
                                   device=cuda_device), b, ln)
    with pytest.raises(ValueError, match="lengths"):
        tsk.cms_update(torch.zeros((4, 512), dtype=torch.int32,
                                   device=cuda_device), b, ln.long())


def flux_case(seed, F, G, comp, B, L, invalid=False):
    """Seeded flux absorb inputs on the CPU: segment ids with pad rows
    (segment 0, valid 0, length -1), F fields of sketch rows, register
    stacks with random starts, composites and a table."""
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy(rng.integers(0, G, size=B).astype(np.int32))
    valid = torch.ones(B, dtype=torch.int32)
    pad = min(B, 5)
    seg[B - pad:] = 0
    valid[B - pad:] = 0
    fields = []
    for f in range(F):
        batch, lengths = sketch_rows(seed + f, B, L)
        lengths[B - pad:] = -1
        if invalid:
            lengths[:] = -1
        fields.append((batch, lengths))
    stacks = [torch.from_numpy(rng.integers(0, 4, size=(G, 1 << 12))
                               .astype(np.int32)) for _ in range(F)]
    c = cl = table = None
    if comp:
        c, cl = sketch_rows(seed + 99, B + 3, L)
        if invalid:
            cl[:] = -1
        table = torch.from_numpy(rng.integers(0, 1 << 20, size=(4, 16384))
                                 .astype(np.int32))
    return seg, valid, fields, stacks, c, cl, table


def to(dev, x):
    return None if x is None else x.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("F,G,comp,B,L,invalid", [
    (1, 200, True, 4096, 256, False),   # the main path's shape
    (1, 512, True, 65536, 256, False),
    (2, 7, True, 300, 64, False),
    (1, 7, True, 300, 0, False),        # L = 0
    (1, 7, True, 300, 64, True),        # all rows invalid
    (0, 7, True, 17, 16, False),        # composites and counts only
    (1, 1, False, 1, 16, False)])
def test_fused_absorb_kernel_equals_plain(cuda_device, F, G, comp, B, L,
                                          invalid):
    seg, valid, fields, stacks, c, cl, table = flux_case(
        F * 7 + G + B + L, F, G, comp, B, L, invalid)
    want_stacks = [s.clone() for s in stacks]
    want_table = None if table is None else table.clone()
    want = tfk.fused_absorb_plain(seg, valid, fields, want_stacks, c, cl,
                                  want_table, hll_p=12, n_seg=G)
    got_stacks = [s.to(cuda_device) for s in stacks]
    got_table = to(cuda_device, table)
    before = tfk.fused_absorb.launches
    got = tfk.fused_absorb(
        seg.to(cuda_device), valid.to(cuda_device),
        [(b.to(cuda_device), ln.to(cuda_device)) for b, ln in fields],
        got_stacks, to(cuda_device, c), to(cuda_device, cl), got_table,
        hll_p=12, n_seg=G)
    assert tfk.fused_absorb.launches - before == 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for g, w in zip(got_stacks, want_stacks):
        assert torch.equal(g.cpu(), w)
    if table is not None:
        assert torch.equal(got_table.cpu(), want_table)


@pytest.mark.gpu
def test_fused_absorb_kernel_unaligned_batch(cuda_device):
    """Field and composite views at an odd offset take the byte-load
    path."""
    seg, valid, fields, stacks, c, cl, table = flux_case(5, 1, 9, True,
                                                         200, 64)
    views = []
    for x in (fields[0][0], c):
        flat = torch.zeros(1 + x.numel(), dtype=torch.uint8,
                           device=cuda_device)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        views.append(view)
    want_stacks = [s.clone() for s in stacks]
    want_table = table.clone()
    want = tfk.fused_absorb_plain(seg, valid, fields, want_stacks, c, cl,
                                  want_table, hll_p=12, n_seg=9)
    got_stacks = [s.to(cuda_device) for s in stacks]
    got_table = table.to(cuda_device)
    got = tfk.fused_absorb(seg.to(cuda_device), valid.to(cuda_device),
                           [(views[0], fields[0][1].to(cuda_device))],
                           got_stacks, views[1], cl.to(cuda_device),
                           got_table, hll_p=12, n_seg=9)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_stacks[0].cpu(), want_stacks[0])
    assert torch.equal(got_table.cpu(), want_table)


def zipf_seg(rng, B, G):
    """Segment ids Zipf(1.1) over G groups, as flux's tenants."""
    prob = np.arange(1, G + 1, dtype=np.float64) ** -1.1
    return rng.choice(G, size=B, p=prob / prob.sum()).astype(np.int32)


CONTENDED = ["zipf", "one_group", "one_value", "one_composite", "zipf_wide",
             "ten_fields", "two_windows"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CONTENDED)
def test_fused_absorb_kernel_contended(cuda_device, case):
    """K10 against its plain version where atomics collide: Zipf(1.1)
    segment ids (flux's tenants), every row in one group (the counts
    combined per warp), every row one value (one register per group),
    every composite one value (one counter per depth row); ten fields
    (a second launch for the fields past the first eight); rows of two
    staging windows."""
    B, G, F, L = 4096, 200, 1, 256
    if case == "zipf_wide":
        B, G = 65536, 512
    if case == "ten_fields":
        B, F, L = 1000, 10, 64
    if case == "two_windows":
        B, L = 1000, 400
    seg, valid, fields, stacks, c, cl, table = flux_case(
        CONTENDED.index(case), F, G, True, B, L)
    rng = np.random.default_rng(B + G)
    seg = torch.from_numpy(zipf_seg(rng, B, G))
    valid[:] = 1
    valid[::7] = 0
    if case == "one_group":
        seg[:] = 3
    if case == "one_value":
        for b, ln in fields:
            b[:] = b[9]
            ln[:] = 40
    if case == "one_composite":
        c[:] = c[9]
        cl[:] = 40
    want_stacks = [s.clone() for s in stacks]
    want_table = table.clone()
    want = tfk.fused_absorb_plain(seg, valid, fields, want_stacks, c, cl,
                                  want_table, hll_p=12, n_seg=G)
    got_stacks = [s.to(cuda_device) for s in stacks]
    got_table = table.to(cuda_device)
    before = tfk.fused_absorb.launches
    got = tfk.fused_absorb(
        seg.to(cuda_device), valid.to(cuda_device),
        [(b.to(cuda_device), ln.to(cuda_device)) for b, ln in fields],
        got_stacks, c.to(cuda_device), cl.to(cuda_device), got_table,
        hll_p=12, n_seg=G)
    assert tfk.fused_absorb.launches - before == (2 if F > 8 else 1)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for g, w in zip(got_stacks, want_stacks):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got_table.cpu(), want_table)
    if case == "one_composite":
        assert int((want_table - table).max()) == int((cl >= 0).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_seg", [(1, 1), (4096, 200), (65536, 512)])
def test_segment_counts_kernel_equals_plain(cuda_device, B, n_seg):
    seg, valid, *_ = flux_case(B, 0, n_seg, False, B, 0)
    valid[: B // 3] = torch.arange(B // 3, dtype=torch.int32) % 5 - 2
    before = tfk.segment_counts.launches
    got = tfk.segment_counts(seg.to(cuda_device), valid.to(cuda_device),
                             n_seg)
    assert tfk.segment_counts.launches - before == 1
    assert torch.equal(got.cpu(), tfk.segment_counts_plain(seg, valid,
                                                           n_seg))


@pytest.mark.gpu
def test_flux_pipeline_append_launches_the_kernel_once(cuda_device):
    """One append through create(device="cuda") is one K10 launch, and
    the state equals the same append on the CPU."""
    recs = [{"tenant": f"t{i % 13}", "user": f"u{i % 97}",
             "endpoint": f"/e/{i % 7}", "latency_ms": i % 50}
            for i in range(500)]
    states = []
    for device in ("cuda", "cpu"):
        ctx = fluentbit_tpu_torch.create(device=device, flush="50ms",
                                         grace="1")
        in_ffd = ctx.input("lib", tag="app.web")
        ctx.filter("flux", match="app.*", group_by="tenant",
                   distinct_field="user", aggregate_field="latency_ms",
                   topk_field="endpoint", window="tumbling 60")
        ctx.start()
        before = tfk.fused_absorb.launches
        try:
            assert ctx.push(in_ffd, json.dumps(recs)) == 500
        finally:
            ctx.stop()
        launches = tfk.fused_absorb.launches - before
        assert launches == (1 if device == "cuda" else 0)
        states.append(ctx.engine.filters[0].plugin.state.snapshot())
    gpu, cpu = states
    assert gpu["counters"] == cpu["counters"]
    assert np.array_equal(gpu["cms"], cpu["cms"])
    for a, b in zip(gpu["groups"], cpu["groups"]):
        assert a["key"] == b["key"] and a["count"] == b["count"]
        assert a["cols"] == b["cols"]
        assert np.array_equal(a["hlls"]["user"], b["hlls"]["user"])


# ------------------------------------------------------------------ K11

def utf8_rows(seed, B, L):
    """Seeded [B, L] rows: valid text of 1-4 byte sequences, the same
    with one random byte spliced in, random bytes, and every length class
    (-1, -2, 0, L) at the front."""
    rng = random.Random(seed)
    vals = []
    for i in range(B):
        text = "".join(rng.choice("aé日🎉") for _ in range(rng.randrange(40)))
        raw = bytearray(text.encode()[:L])
        kind = i % 3
        if kind == 1 and raw:
            raw[rng.randrange(len(raw))] = rng.randrange(256)
        elif kind == 2:
            raw = bytearray(rng.randrange(256) for _ in range(min(L, 20)))
        vals.append(bytes(raw))
    for i, v in enumerate([None, b"x" * (L + 1), b"", b"a" * L][:B]):
        vals[i] = v
    staged = assemble(vals, L)
    return staged.batch, staged.lengths, vals


def utf8_both(dev, batch, lengths):
    """The kernel's verdicts, held against both plain versions (the
    column scan and the kernel's piece maps) on the card."""
    v = tu.Utf8Validator(dev)
    b = batch if isinstance(batch, torch.Tensor) else \
        torch.from_numpy(batch).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    before = tu.utf8_validate.launches
    got = tu.utf8_validate(v.class_map, v.trans, b, ln)
    assert tu.utf8_validate.launches - before == (1 if b.shape[0] else 0)
    plain = tu.utf8_validate_plain(v.class_map, v.trans, b, ln)
    pieces = tu.utf8_validate_pieces_plain(v.class_map, v.trans, b, ln)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), pieces.cpu().numpy())
    return got.cpu().numpy()


# strict_utf8 and straddle_rows are shared with tests/test_torch_utf8.py,
# which imports them from here: this file runs on the card, where JAX is
# not installed


def strict_utf8(v):
    try:
        v.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


#: 2-, 3- and 4-byte valid sequences, a surrogate, an overlong and a code
#: point above U+10FFFF
STRADDLE_SEQS = ("é".encode(), "日".encode(), "🎉".encode(), b"\xed\xa0\x80",
                 b"\xe0\x80\x80", b"\xf4\x90\x80\x80")


def straddle_rows(width):
    """ASCII rows, each with one sequence split j bytes before a 16 B
    piece boundary (every split), at every boundary of the row or at the
    512 B window boundary alone (the middle boundary of a narrower row),
    at lengths: full, cut at that boundary, just after the sequence, 512,
    past the width, 0, -1 and -2."""
    rows, lengths = [], []
    middle = 512 if width > 512 else (width // 32) * 16
    for seq in STRADDLE_SEQS:
        for j in range(1, len(seq)):
            for every in (True, False):
                row = np.full(width, ord("a"), np.uint8)
                bounds = range(16, width, 16) if every else [middle]
                placed = [b for b in bounds
                          if b >= j and b - j + len(seq) <= width]
                for b in placed:
                    row[b - j:b - j + len(seq)] = np.frombuffer(seq, np.uint8)
                cut = placed[0] if placed else 0
                for n in (width, cut, cut - j + len(seq), 512, width + 5, 0,
                          -1, -2):
                    rows.append(row)
                    lengths.append(n)
    return np.stack(rows), np.array(lengths, np.int32)


def oracle(batch, lengths):
    L = batch.shape[1]
    return np.array([n >= 0 and strict_utf8(bytes(r[:min(n, L)]))
                     for r, n in zip(batch, lengths)])


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(1, 0), (17, 1), (300, 17), (300, 512),
                                 (4096, 512), (300, 1024), (64, 4096)])
def test_utf8_kernel_equals_plain(cuda_device, B, L):
    batch, lengths, vals = utf8_rows(B + L, B, L)
    got = utf8_both(cuda_device, batch, lengths)
    want = [v is not None and len(v) <= L and strict_utf8(v) for v in vals]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tu.Utf8Validator("cpu").validate(batch, lengths))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [17, 300, 512, 1024, 4096])
def test_utf8_kernel_straddle_rows(cuda_device, L):
    """Sequences across every piece boundary and the window boundary, cut
    by the length at a boundary: the 16 B path (L % 16 == 0) and the
    byte path."""
    batch, lengths = straddle_rows(L)
    got = utf8_both(cuda_device, batch, lengths)
    want = oracle(batch, lengths)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


#: an invalid byte of each kind: a lone continuation, C0/C1, F5-FF, and a
#: surrogate's ED A0
INVALID = (b"\x80", b"\xc0\xaf", b"\xc1\xbf", b"\xf5", b"\xff",
           b"\xed\xa0")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [512, 1024, 300])
def test_utf8_kernel_invalid_byte_at_every_offset(cuda_device, L):
    """Each kind of invalid byte at every offset mod 16 of a piece, in
    pieces all along the row (both windows at L = 1024), after valid
    2- to 4-byte text; and the same rows cut just before it (valid)."""
    text = ("aé日🎉" * 4).encode()
    rows, lengths = [], []
    for kind in INVALID:
        for piece in range(0, (L - len(text) - 2) // 16):
            for m in range(16):
                at = 16 * piece + m
                if at < len(text) or at + len(kind) > L:
                    continue
                row = np.full(L, ord("b"), np.uint8)
                row[:len(text)] = np.frombuffer(text, np.uint8)
                row[at:at + len(kind)] = np.frombuffer(kind, np.uint8)
                rows += [row, row]
                lengths += [L, at]
    batch, lengths = np.stack(rows), np.array(lengths, np.int32)
    got = utf8_both(cuda_device, batch, lengths)
    want = oracle(batch, lengths)
    np.testing.assert_array_equal(got, want)
    assert not want[0::2].any() and want[1::2].all()


@pytest.mark.gpu
def test_utf8_kernel_edge_cases(cuda_device):
    L = 512
    batch = np.full((64, L), ord("a"), dtype=np.uint8)  # full ASCII rows
    lengths = np.full(64, L, dtype=np.int32)
    batch[8:16, 0] = 0x80           # invalid at byte 0
    batch[16:24, L - 1] = 0xE6      # a sequence cut at the row's end
    lengths[24:32] = -1
    lengths[32:40] = -2
    lengths[40:48] = 0
    batch[48:56, :3] = np.frombuffer("日".encode(), np.uint8)
    lengths[48:56] = 2              # cut by the length: invalid
    got = utf8_both(cuda_device, batch, lengths)
    want = np.ones(64, dtype=bool)
    want[8:40] = False
    want[48:56] = False
    np.testing.assert_array_equal(got, want)
    # every row at -1 / -2
    np.testing.assert_array_equal(
        utf8_both(cuda_device, batch[:4], np.array([-1, -2, -1, -2],
                                                   dtype=np.int32)),
        np.zeros(4, dtype=bool))
    # unaligned and strided views take the copy in the wrapper
    flat = torch.zeros(1 + batch.size, dtype=torch.uint8, device=cuda_device)
    unaligned = flat[1:].view(batch.shape)
    unaligned.copy_(torch.from_numpy(batch))
    np.testing.assert_array_equal(utf8_both(cuda_device, unaligned, lengths),
                                  want)
    wide = torch.zeros((64, 2 * L), dtype=torch.uint8, device=cuda_device)
    wide[:, ::2] = torch.from_numpy(batch).to(cuda_device)
    np.testing.assert_array_equal(
        utf8_both(cuda_device, wide[:, ::2], lengths), want)


@pytest.mark.gpu
def test_utf8_wrapper_rejects_bad_tensors(cuda_device):
    v = tu.Utf8Validator(cuda_device)
    b = torch.zeros((4, 16), dtype=torch.uint8, device=cuda_device)
    ln = torch.zeros((4,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        tu.utf8_validate(v.class_map.cpu(), v.trans.cpu(), b.cpu(), ln.cpu())
    with pytest.raises(ValueError, match="lengths"):
        tu.utf8_validate(v.class_map, v.trans, b, ln.long())
    with pytest.raises(ValueError, match="trans"):
        tu.utf8_validate(v.class_map, v.trans[:10], b, ln)


# ------------------------------------------------- filter_parser, K3

PARSERS = {
    "apache2": dict(Format="regex", Regex=APACHE2, Time_Key="time",
                    Time_Format="%d/%b/%Y:%H:%M:%S %z",
                    Types="code:integer size:integer"),
    "json": dict(Format="json", Time_Key="time",
                 Time_Format="%d/%b/%Y:%H:%M:%S %z"),
}


def parser_records(parser, n):
    rng = random.Random(n)
    recs = []
    for i in range(n):
        t = f"{rng.randrange(1, 29):02d}/Oct/2000:13:55:{i % 60:02d} -0700"
        if parser == "json":
            log = json.dumps({"time": t if i % 4 else "bad", "i": i,
                              "msg": "é🎉" * (i % 3)}) if i % 5 else "x{"
        else:
            log = (f'10.0.0.{i % 256} - u{i} [{t}] "GET /p/ü{i} HTTP/1.1" '
                   f'200 {i}' + (' "r" "' + "a" * 600 + '"' if i % 17 == 0
                                 else "")) if i % 3 else f"junk {i}"
        recs.append({"log": log, "i": i})
    return recs


def run_parser_push(device, parser, recs):
    """(records, (K3, K4) launches, appends the batch hook took)."""
    got = []
    ctx = fluentbit_tpu_torch.create(device=device, flush="50ms", grace="1")
    ctx.parser(parser, **PARSERS[parser])
    ffd = ctx.input("lib", tag="t")
    ctx.filter("parser", match="t", key_name="log", parser=parser,
               reserve_data="true")
    ctx.output("lib", match="*", callback=lambda d, t: got.extend(
        (ev.timestamp if isinstance(ev.timestamp, float) else None,
         json.dumps(ev.body)) for ev in decode_events(d)))
    ctx.start()
    before = (tg.grep_dfa.launches, tg.grep_assoc.launches)
    try:
        assert ctx.push(ffd, json.dumps(recs)) == len(recs)
        ctx.flush_now()
    finally:
        ctx.stop()
    return got, (tg.grep_dfa.launches - before[0],
                 tg.grep_assoc.launches - before[1]), \
        ctx.engine.filters[0].batch_taken


@pytest.mark.gpu
@pytest.mark.parametrize("parser", ["json", "apache2"])
def test_filter_parser_cuda_equals_cpu(cuda_device, parser, monkeypatch):
    """As configured, apache2 takes the parser's batch hook (the host DFA
    twin, no launch) and json the decoded path; with the hook off,
    apache2's decoded path launches K3 once. Records equal throughout."""
    from fluentbit_tpu_torch.plugins.filter_parser import ParserFilter

    recs = parser_records(parser, 300)
    gpu, launches, taken = run_parser_push("cuda", parser, recs)
    cpu, cpu_launches, _ = run_parser_push("cpu", parser, recs)
    assert gpu == cpu and len(gpu) == 300
    assert sum(ts is not None for ts, _ in gpu) > 100
    assert launches == cpu_launches == (0, 0)
    assert taken == (1 if parser == "apache2" else 0)
    monkeypatch.setattr(ParserFilter, "can_process_batch",
                        lambda self: False)
    dec, launches, taken = run_parser_push("cuda", parser, recs)
    dec_cpu, cpu_launches, _ = run_parser_push("cpu", parser, recs)
    assert dec == dec_cpu == gpu and taken == 0
    # apache2 (690 states) resolves to the scan: one K3 launch
    assert launches == ((1, 0) if parser == "apache2" else (0, 0))
    assert cpu_launches == (0, 0)


@pytest.mark.gpu
def test_config2r_tail_launches_k3_per_append(cuda_device, tmp_path,
                                              monkeypatch):
    """Config 2r on the decoded path (the batch hook off): tail over an
    Apache log → parser apache2 → null; K3 launches once per tail append
    of >= 64 records, K4 never."""
    from fluentbit_tpu_torch.plugins.filter_parser import ParserFilter

    monkeypatch.setattr(ParserFilter, "can_process_batch",
                        lambda self: False)
    lines = [r["log"].encode() for r in parser_records("apache2", 3000)]
    data = b"\n".join(lines) + b"\n"
    path = str(tmp_path / "access.log")
    with open(path, "wb") as fh:
        fh.write(data)
    sizes, pending = [], b""
    for off in range(0, len(data), 65536):
        split = (pending + data[off:off + 65536]).split(b"\n")
        pending = split.pop()
        sizes.append(sum(1 for ln in split if ln))
    ctx = fluentbit_tpu_torch.create(device="cuda", flush="50ms", grace="1")
    ctx.parser("apache2", **PARSERS["apache2"])
    ctx.input("tail", tag="access", path=path, read_from_head="true")
    ctx.filter("parser", match="access", key_name="log", parser="apache2",
               reserve_data="true")
    ctx.output("null", match="*")
    tail = ctx.engine.inputs[0].plugin
    before = (tg.grep_dfa.launches, tg.grep_assoc.launches)
    ctx.start()
    try:
        deadline = time.time() + 60
        while True:
            tf = tail._files.get(path)
            if tf is not None and tf.offset == len(data) and not tf.pending:
                break
            assert time.time() < deadline
            time.sleep(0.01)
        ctx.flush_now()
    finally:
        ctx.stop()
    f = ctx.engine.filters[0].plugin
    assert f._prefilter.decision()["kernel_resolved"] == "scan"
    device_appends = sum(n >= 64 for n in sizes)
    assert device_appends >= 2
    assert len(f.step_seconds) == device_appends
    assert (tg.grep_dfa.launches - before[0],
            tg.grep_assoc.launches - before[1]) == (device_appends, 0)


# -- the raw chunk path and K5 ------------------------------------------

EXCLUDE = r'HTTP/1\.1" 500 '


def dirty_past_length(rng, batch, lengths):
    """The same rows with every byte past a row's length replaced by
    0xFF (first copy) and by random bytes (second copy)."""
    L = batch.shape[2]
    past = np.arange(L)[None, None, :] >= np.maximum(lengths, 0)[:, :, None]
    ones = np.where(past, 0xFF, batch).astype(np.uint8)
    noise = rng.integers(0, 256, size=batch.shape, dtype=np.uint8)
    return ones, np.where(past, noise, batch).astype(np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["scan", "assoc"])
@pytest.mark.parametrize("patterns,L,B", [([APACHE2], 512, 4096),
                                          (CONFIG3, 512, 300),
                                          (MIXED_K, 64, 1000),
                                          ([EXCLUDE], 45, 77)])
def test_counts_epilogue_and_dirty_rows(cuda_device, kernel, patterns, L, B):
    """K3's and K4's counts epilogue adds each rule's matched rows
    (``mask.sum``, the plain version) into ``counts``; verdicts over rows
    whose bytes past the length are 0xFF or random equal the zeroed
    rows'."""
    rng = np.random.default_rng(B + L)
    batch, lengths = random_rows(rng, len(patterns), B, L)
    lines = make_lines(min(B, 400), seed=B)
    for i, ln in enumerate(lines):
        if len(ln) <= L:
            batch[:, i, : len(ln)] = np.frombuffer(ln, np.uint8)
            lengths[:, i] = len(ln)
    past = np.arange(L)[None, None, :] >= np.maximum(lengths, 0)[:, :, None]
    zeroed = np.where(past, 0, batch).astype(np.uint8)
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L,
                               cuda_device, kernel=kernel)
    ln_d = torch.from_numpy(lengths).cuda()
    want = prog.dispatch(torch.from_numpy(zeroed).cuda(), ln_d)
    for dirty in dirty_past_length(rng, zeroed, lengths):
        got = prog.dispatch(torch.from_numpy(dirty).cuda(), ln_d)
        assert torch.equal(got, want)
    for leaf, ix in zip(prog._children or [prog],
                        prog._child_idxs or [torch.arange(len(patterns))]):
        ix = ix.to(cuda_device)
        b = torch.from_numpy(batch).cuda().index_select(0, ix).contiguous()
        ln = ln_d.index_select(0, ix).contiguous()
        counts = torch.full((b.shape[0],), 5, dtype=torch.int32,
                            device=cuda_device)
        mask = tg.match_rows(leaf.tables, b, ln, leaf.k, leaf.kernel_resolved,
                             leaf.max_states, leaf.segment, counts=counts)
        torch.cuda.synchronize()
        assert torch.equal(counts - 5, tg.counts_plain(mask))
        assert torch.equal(mask, want.index_select(0, ix))


@pytest.mark.gpu
def test_counts_wrappers_reject_bad_tensors(cuda_device):
    prog = tg.TorchGrepProgram([compile_dfa(EXCLUDE)], 16, cuda_device)
    b = torch.zeros((1, 4, 16), dtype=torch.uint8, device=cuda_device)
    ln = torch.zeros((1, 4), dtype=torch.int32, device=cuda_device)
    for counts in (torch.zeros(2, dtype=torch.int32, device=cuda_device),
                   torch.zeros(1, dtype=torch.int64, device=cuda_device),
                   torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="counts"):
            tg.grep_dfa(prog.tables, b, ln, prog.k, counts=counts)
        with pytest.raises(ValueError, match="counts"):
            tg.grep_assoc(prog.tables, b, ln, prog.k, prog.max_states, 32,
                          counts=counts)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("patterns,rule_shard_r", [([APACHE2], None),
                                                   ([APACHE2, EXCLUDE], None),
                                                   (CONFIG3, "2")])
def test_mesh_dispatch_equals_plain(cuda_device, monkeypatch, n, patterns,
                                    rule_shard_r):
    """K5 over ``Mesh((cuda:0,) * n)``: masks, counts and Bp equal the
    sharded plain version over ``Mesh((cpu,) * n)``, the unsharded kernel
    and ``mask.sum``; every shard launches its kernel."""
    from fluentbit_tpu_torch.ops.mesh import Mesh

    if rule_shard_r:
        monkeypatch.setenv("FBTPU_MESH_RULE_SHARD_R", rule_shard_r)
    dfas = [compile_dfa(p) for p in patterns]
    prog = tg.TorchGrepProgram(dfas, 512, cuda_device)
    plain = tg.TorchGrepProgram(dfas, 512, "cpu")
    mesh = Mesh((cuda_device,) * n)
    variant = prog.mesh_variant(mesh)
    assert variant == ("rules" if rule_shard_r else "batch")
    lines = make_lines(1001, seed=n)
    staged = assemble(lines, 512)
    batch = np.stack([staged.batch] * len(patterns))
    lengths = np.stack([staged.lengths] * len(patterns))
    before = tg.grep_dfa.launches + tg.grep_assoc.launches
    mask, counts, Bp = prog.match_mesh(mesh, batch, lengths)
    launches = tg.grep_dfa.launches + tg.grep_assoc.launches - before
    assert launches == n * len(prog._children or [prog])
    pmask, pcounts, pBp = plain.match_mesh(Mesh(("cpu",) * n), batch,
                                           lengths)
    np.testing.assert_array_equal(mask, pmask)
    np.testing.assert_array_equal(counts, pcounts)
    assert Bp == pBp == (1001 if variant == "rules" else -(-1001 // n) * n)
    np.testing.assert_array_equal(mask, prog.match(batch, lengths))
    np.testing.assert_array_equal(counts, mask.sum(axis=1))
    m, c, B, bp = prog.dispatch_mesh(mesh, batch, lengths, with_counts=False)
    assert c is None and (B, bp) == (1001, Bp)
    np.testing.assert_array_equal(m[:, :B].cpu().numpy(), mask)


def _grep_ctx(device, exclude):
    out = []
    ctx = fluentbit_tpu_torch.create(device=device, flush="50ms", grace="1")
    ctx.input("lib", tag="app.log")
    f = ctx.filter("grep", match="app.*")
    if exclude:
        ctx.set(f, exclude="log " + EXCLUDE)
    ctx.set(f, regex="log " + APACHE2)
    ctx.output("lib", match="*", callback=lambda d, t: out.append(d))
    return ctx, out


@pytest.mark.gpu
@pytest.mark.parametrize("exclude", [False, True])
def test_raw_chunk_of_16_segments_cuda_equals_cpu(cuda_device, exclude):
    """One pre-encoded chunk of 65,536 records (16 segments of 4096,
    double-buffered: each segment stages into pinned buffers of its own
    while the previous segment's copy and kernel run) gives the bytes of
    the cpu run, one launch per segment and k-group."""
    from fluentbit_tpu_torch.codec.events import encode_event
    from fluentbit_tpu_torch.codec.msgpack import EventTime

    lines = make_lines(65536, seed=16)
    data = b"".join(encode_event({"log": ln.decode()}, EventTime(i, 0))
                    for i, ln in enumerate(lines))
    results = {}
    for device in ("cuda", "cpu"):
        ctx, out = _grep_ctx(device, exclude)
        ctx.start()
        before = (tg.grep_dfa.launches, tg.grep_assoc.launches)
        try:
            ins = ctx.engine.inputs[0]
            kept = ctx.engine.input_log_append(ins, "app.log", data, 65536)
            ctx.flush_now()
        finally:
            ctx.stop()
        grep = ctx.engine.filters[0].plugin
        assert grep.raw_timings["records"] == 65536
        assert not grep.match_seconds
        results[device] = (b"".join(out), kept,
                           tg.grep_dfa.launches - before[0],
                           tg.grep_assoc.launches - before[1])
    gpu, cpu = results["cuda"], results["cpu"]
    assert gpu[:2] == cpu[:2] and 0 < gpu[1] < 65536
    # apache2 takes K3; the Exclude rule (16 states) K4
    assert gpu[2:] == ((16, 16) if exclude else (16, 0))
    assert cpu[2:] == (0, 0)
    assert len(decode_events(gpu[0])) == gpu[1]


# ---------------------------------------------------------------------------
# the shard merge, K8, and the mesh halves of K9 and K10
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["max", "add"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,shape", [(1, (7,)), (8, (512, 4096)),
                                     (3, (4, 16384)), (2, (0,))])
def test_shard_merge_kernel_equals_plain(cuda_device, op, dtype, n, shape):
    gen = torch.Generator().manual_seed(n)
    parts = torch.randint(-50, 50, (n, *shape), dtype=dtype, generator=gen)
    base = torch.randint(-50, 50, shape, dtype=dtype, generator=gen)
    if base.numel():
        base.view(-1)[0] = torch.iinfo(dtype).max - 3  # an add wraps
        parts.view(n, -1)[:, 0] = 2
    want = base.clone()
    tsk.shard_merge_plain(parts, want, op)
    got = base.to(cuda_device)
    before = tsk.shard_merge.launches
    tsk.shard_merge(parts.to(cuda_device), got, op)
    torch.cuda.synchronize()
    assert tsk.shard_merge.launches - before == (1 if base.numel() else 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_shard_merge_rejects_bad_tensors(cuda_device):
    base = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="op"):
        tsk.shard_merge(torch.zeros((2, 8), dtype=torch.int32,
                                    device=cuda_device), base, "min")
    with pytest.raises(ValueError, match="parts"):
        tsk.shard_merge(torch.zeros((2, 8), dtype=torch.int64,
                                    device=cuda_device), base, "max")
    with pytest.raises(ValueError, match="contiguous"):
        tsk.shard_merge(torch.zeros((2, 8), dtype=torch.int32), base, "max")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("B", [3, 4096])
def test_sharded_sketches_equal_unsharded(cuda_device, n, B):
    """K8 over ``Mesh((cuda:0,) * n)``: registers and tables (int32 near
    2^31 - 1, and int64) equal K6 / K7 over the whole batch; n shard
    launches and one merge each; snapshots unmutated."""
    from fluentbit_tpu_torch.ops.mesh import Mesh

    mesh = Mesh((cuda_device,) * n)
    batch, lengths = sketch_rows(n + B, B, 256)
    hll = tsk.HyperLogLog(14, cuda_device)
    hll.registers.random_(0, 5)
    snap = hll.registers.clone()
    before = (tsk.hll_mesh.launches, tsk.hll_update.launches,
              tsk.shard_merge.launches)
    got = tsk.sharded_hll_registers(hll, mesh, batch, lengths)
    shards = n  # the rows pad to a multiple of n: every shard has some
    assert (tsk.hll_mesh.launches - before[0],
            tsk.hll_update.launches - before[1],
            tsk.shard_merge.launches - before[2]) == (shards, shards, 1)
    want = snap.clone()
    tsk.hll_update(want, batch.to(cuda_device), lengths.to(cuda_device), 14)
    assert torch.equal(got, want) and torch.equal(hll.registers, snap)
    for dtype in (torch.int32, torch.int64):
        cms = tsk.CountMin(4, 16384, cuda_device, dtype)
        cms.table.fill_(torch.iinfo(torch.int32).max - 2)
        before = tsk.cms_mesh.launches
        got = tsk.sharded_cms_table(cms, mesh, batch, lengths)
        assert tsk.cms_mesh.launches - before == shards
        want = cms.table.clone()
        tsk.cms_update(want, batch.to(cuda_device), lengths.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert int(cms.table.min()) == torch.iinfo(torch.int32).max - 2


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("F,G,comp,B,L", [(1, 200, True, 4096, 256),
                                          (2, 7, True, 300, 64),
                                          (1, 7, False, 5, 16)])
def test_flux_mesh_halves_equal_unsharded(cuda_device, n, F, G, comp, B, L):
    """K10's mesh half over ``Mesh((cuda:0,) * n)``: counts, stacks and
    table equal the unsharded K10, with n K10 launches and 1 + F (+1 with
    composites) merges; K9's mesh half equals the unsharded K9."""
    from fluentbit_tpu_torch.ops.mesh import Mesh

    mesh = Mesh((cuda_device,) * n, "flux")
    seg, valid, fields, stacks, c, cl, table = flux_case(
        n * 10 + F + B, F, G, comp, B, L)
    dev = cuda_device
    args = (seg.to(dev), valid.to(dev),
            [(b.to(dev), ln.to(dev)) for b, ln in fields])
    want_st = [s.to(dev) for s in stacks]
    want_tb = to(dev, table)
    want = tfk.fused_absorb(*args, want_st, to(dev, c), to(dev, cl), want_tb,
                            hll_p=12, n_seg=G)
    got_st = [s.to(dev) for s in stacks]
    got_tb = to(dev, table)
    before = (tfk.fused_absorb.launches, tfk.flux_mesh_launches.launches,
              tsk.shard_merge.launches)
    got = tfk.sharded_fused_absorb(mesh, *args, got_st, to(dev, c),
                                   to(dev, cl), got_tb, hll_p=12, n_seg=G)
    torch.cuda.synchronize()
    assert (tfk.fused_absorb.launches - before[0],
            tfk.flux_mesh_launches.launches - before[1],
            tsk.shard_merge.launches - before[2]) == (n, n, 1 + F + comp)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_st, want_st))
    if comp:
        assert torch.equal(got_tb, want_tb)
    counts = tfk.sharded_segment_counts(mesh, args[0], args[1], G)
    assert torch.equal(counts, tfk.segment_counts(args[0], args[1], G))


# config 5: forward → kubernetes → grep Exclude log health-check (K4)

K8S_EXCLUDE = "health-check"


def k8s_log_rows(B, L, seed):
    """Staged ``log`` values of k8s container logs: JSON lines, plain
    text, kubelet probes with ``health-check`` (some at the row's end,
    some cut by the length) and stack traces past ``L`` (overflow)."""
    rng = random.Random(seed)
    vals = []
    for i in range(B):
        r = rng.random()
        if r < 0.5:
            v = json.dumps({"level": "info", "n": i,
                            "msg": "m" * rng.randrange(40, 300)})
        elif r < 0.85:
            v = f"I0501 controller.go:{i}] synced " + "w" * rng.randrange(200)
        elif r < 0.95:
            v = ("x" * rng.randrange(0, L - 12)) + "health-check"
        else:
            v = "panic:\n" + "\tat frame\n" * rng.randrange(60, 90)
        vals.append((v + "\n").encode())
    staged = assemble(vals, L)
    b = staged.batch[None].copy()
    ln = staged.lengths[None].copy()
    # rows whose length cuts "health-check" short must not match
    for i in range(3, B, 17):
        if b"health-check" in vals[i] and 0 < ln[0, i]:
            ln[0, i] -= 1 + i % 5
    return b, ln


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4096, 37])
def test_config5_exclude_k4_equals_plain(cuda_device, B):
    """K4 on config 5's Exclude program (14 states: "auto" takes it) at
    [1, 4096, 512] and [1, 37, 512], against its plain version on the
    card, the CPU program and the scan: one launch, verdicts equal."""
    dfa = compile_dfa(K8S_EXCLUDE)
    prog = tg.TorchGrepProgram([dfa], 512, cuda_device)
    assert prog.decision()["kernel_resolved"] == "assoc"
    assert prog.max_states == 14
    batch, lengths = k8s_log_rows(B, 512, seed=B)
    before = (tg.grep_assoc.launches, tg.grep_dfa.launches)
    got = prog.match(batch, lengths)
    assert (tg.grep_assoc.launches - before[0],
            tg.grep_dfa.launches - before[1]) == (1, 0)
    b = torch.from_numpy(batch).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    np.testing.assert_array_equal(
        got, assoc_plain_on_card(prog, b, ln).cpu().numpy())
    cpu = tg.TorchGrepProgram([dfa], 512, "cpu", kernel="assoc")
    np.testing.assert_array_equal(got, cpu.match(batch, lengths))
    scan = tg.TorchGrepProgram([dfa], 512, cuda_device, kernel="scan")
    np.testing.assert_array_equal(got, scan.match(batch, lengths))
    want = [ln >= 0 and b"health-check" in bytes(batch[0, i, :ln])
            for i, ln in enumerate(lengths[0])]
    assert got[0].tolist() == want
    assert 0 < got.sum() < B


@pytest.mark.gpu
def test_config5_forward_append_launches_k4_once(cuda_device, tmp_path):
    """One forward message of 300 records and one of 5 through config
    5's chain on cuda: one K4 launch (the small append takes the host
    regex), no scan; the records equal the same messages on the CPU."""
    import socket

    from fluentbit_tpu_torch.codec.msgpack import EventTime, Unpacker, packb

    tag = ("kube.var.log.containers.web-1_prod_app-"
           + "ab" * 32 + ".log")
    (tmp_path / "prod_web-1.meta").write_text(json.dumps(
        {"metadata": {"uid": "u", "labels": {"a": "b"}},
         "spec": {"nodeName": "n"}}))
    batch, lengths = k8s_log_rows(305, 512, seed=5)
    logs = [bytes(batch[0, i, :max(n, 0)]).decode("utf-8", "replace")
            for i, n in enumerate(lengths[0])]
    ents = [[EventTime(1700000000 + i, i), {"log": v, "stream": "stdout"}]
            for i, v in enumerate(logs)]
    msgs = [packb([tag, b"".join(packb(e) for e in ents[:300]),
                   {"chunk": "a"}]),
            packb([tag, ents[300:], {"chunk": "b"}])]
    out = {}
    for device in ("cuda", "cpu"):
        got = out[device] = []
        ctx = fluentbit_tpu_torch.create(device=device, flush="50ms",
                                         grace="1")
        ffd = ctx.input("forward", port="0", listen="127.0.0.1")
        ctx.filter("kubernetes", match="kube.*", merge_log="on",
                   kube_meta_preload_cache_dir=str(tmp_path))
        ctx.filter("grep", match="kube.*", exclude=f"log {K8S_EXCLUDE}")
        ctx.output("lib", match="*", callback=lambda d, t, got=got:
                   got.append(d))
        ctx.start()
        before = (tg.grep_assoc.launches, tg.grep_dfa.launches)
        try:
            s = socket.create_connection(("127.0.0.1", ctx.bound_port(ffd)))
            u = Unpacker()
            for data, ack in zip(msgs, ("a", "b")):
                s.sendall(data)
                while True:
                    reply = next(iter(u), None)
                    if reply is not None:
                        break
                    u.feed(s.recv(4096))
                assert reply == {"ack": ack}
            s.close()
            ctx.flush_now()
        finally:
            ctx.stop()
        launches = (tg.grep_assoc.launches - before[0],
                    tg.grep_dfa.launches - before[1])
        assert launches == ((1, 0) if device == "cuda" else (0, 0))
    assert out["cuda"] == out["cpu"]
    bodies = [ev.body for d in out["cuda"] for ev in decode_events(d)]
    assert 0 < len(bodies) < 305
    assert not any("health-check" in b["log"] for b in bodies)
    assert all(b["kubernetes"]["pod_id"] == "u" for b in bodies)

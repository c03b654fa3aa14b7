#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fluentbit_tpu_torch``) on one GPU.

Run from the repository root on a host with a CUDA card:

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. environment: the interpreter's C header directory and whether it
   holds ``Python.h`` (printed before anything builds), torch/CUDA/nvcc/
   triton versions, the card's name and power limit;
2. build: every library of ``fluentbit_tpu_torch/csrc`` (the kernels
   ``grep_dfa``, ``grep_assoc``, ``sketch``, ``utf8`` with ``nvcc``, the
   host codec ``codec_host`` and the event codec extension ``codec_py``
   with ``g++``), one compiler each, started together, with ptxas'
   report (in full for ``sketch`` and ``utf8``); a host without
   ``Python.h`` fails here, by name;
3. kernel against plain: the ``grep_dfa`` kernel against its plain torch
   version on the card, bool for bool, on three programs (apache2 k=3, an
   even-k literal set, a mixed-k 3-rule set) at [R, 65536, 512] and the
   main path's [R, 4096, 512], with CUDA-event times of both, and of
   the kernel through the global half of its table branch;
4. pipeline: BASELINE config 1 (lib input → grep apache2 → lib output),
   64 appends of 4096 records, through
   ``fluentbit_tpu_torch.create(device="cuda")``, then again with
   an Exclude rule in front; each run's output bytes must equal the same
   pipeline on ``device="cpu"``, the kept records must equal a Python
   ``re`` filter over the input, the kernel's launch count must show
   every append of >= 32 records went through it, and on both devices
   every such append must have taken the raw chunk path (the filter's
   raw record count, and no append through the decoded path's device
   match);
4b. pipeline: config 1 on pre-encoded msgpack chunks handed straight to
   ``engine.input_log_append`` (the form in_forward delivers): the same
   64 appends as chunks of 4096 records, then one chunk of 65,536 (16
   segments, double-buffered), regex and regex + Exclude, on cuda and
   cpu: bytes equal between the devices and to Python ``re``, one launch
   per segment and k-group, lines/s and the p50 raw steps (extract,
   kernel, the overflow rows' host re-check, compact) per append;
4c. K5, the sharded dispatch: ``dispatch_mesh`` / ``match_mesh`` over
   ``Mesh((cuda:0,) * n)``, n in {1, 2, 8}, for apache2 and apache2 +
   Exclude (batch variant, two children) and config 3's 8 rules (rules
   variant, ``FBTPU_MESH_RULE_SHARD_R=2``) at [R, 4096, 512]: masks and
   counts equal to the unsharded kernel, the plain version and
   ``mask.sum``, with CUDA-event times beside the unsharded kernel's and
   n times one shard's; the grep filter's mesh staging branch over the
   65,536-record chunk against its unsharded branch (K5's main path: its
   shard launches counted from 0); K3's and K4's times with and
   without the counts epilogue; and K3 (apache2) and K4 (Exclude) on
   config 1's own rows, its first append staged as the raw path stages
   it, against their plain versions, with times;
4d. delivery: (a) config 1's raw path at full width (the 64 appends of
   4096 records through ``ctx.push`` on cuda) to two outputs, ``file``
   (``workers 2``, ``retry_limit 5``, ``format plain``, its directory
   made only once the output's ``retries_total`` reaches 1) and
   ``retry`` (``retry_limit 1``), with ``scheduler.base`` 0.05 and
   ``scheduler.cap`` 0.1: the file's lines, as a multiset, must be the
   Python ``re`` filter's bodies, ``proc_records_total`` the kept
   records, ``retries_total`` >= 1 and ``dropped_records_total`` 0 for
   the file; one retry, one exhausted retry and one error a chunk and
   every kept record dropped for ``retry``; K3 launched once an append,
   as in phase 4; (b) the same appends with a second lib output under
   ``route_condition`` ``$log regex`` ``ROUTE_5XX`` (a 5xx status
   between blanks), which sends them down the decoded path (K3 through
   ``_match_matrix_device``, once an append): the conditional output's
   records equal to Python ``re`` on the kept records' ``log`` strings,
   the unconditional one every kept record; lines/s and the p50
   delivery latency of each;
5. sketch kernels against plain: ``hll_update`` (p = 14, 10) and
   ``cms_update`` (4 x 16384 int32, 4 x 512 int64, 4 x 16384 int32 with
   weights) against their plain torch versions on the card at the main
   path's [4096, 256] and at [65536, 256], registers and tables exactly
   equal, with CUDA-event times of both; and K6's grouped form
   (``hll_update_groups``, one launch for every group) against
   ``hll_update_groups_plain`` at the flux wide append's shape (4096 rows
   of 256 B, 600 groups, p = 12), at G = 1, at 65536 rows, at 2000
   groups (pointers from a device array), and where
   atomics collide (every row in one group, every row one value) or a
   segment id names no group, with times, host enqueue and bound; and
   ``cms_update`` (4 x 16384) on config 4's own ``path`` rows,
   unweighted and weighted, on one value in every row (unweighted and
   weighted, int32) and on an int64 table whose sum on one word passes
   2^32, with times, host enqueue and bound;
6. pipeline: BASELINE config 4 (http input → log_to_metrics cardinality
   over ``user`` and frequency over ``path`` → prometheus_exporter), 64
   POSTs of 4096 records, on ``device="cuda"`` and then ``"cpu"``: the
   rendered text, registers and table must be equal between the devices
   and agree with a check computed here from Python ints (registers,
   the estimate within 3% of the exact distinct count, the exact top-10
   paths within count-min's error), and each sketch kernel must have
   launched once per POST;
7. flux kernels against plain: ``fused_absorb`` (K10) at the main path's
   shape (4096 rows x 256 B, one distinct field plus composites, 200
   groups, p = 12, count-min 4 x 16384 int32) and at 65536 rows with 512
   groups, plus edge cases (all rows invalid, L = 0, an unaligned batch,
   two fields, ten fields: two launches) and the contended cases (every
   row in one group, every field row one value, every composite one
   value), and ``segment_counts`` (K9) at 4096 and 65536 rows,
   against their plain torch versions on the card, counts, stacks and
   tables exactly equal, with CUDA-event times of both and of
   ``torch.bincount`` beside K9;
8. pipeline: the flux plane (FLUX.md's per-tenant example: lib input →
   ``flux`` group_by tenant, distinct user, aggregate latency_ms, top-10
   endpoint, tumbling 60 s → closed-window rows through the hidden
   emitter → lib output), 64 appends of 4096 records plus one append of
   600 tenants (the unfused route), under an injected clock that steps
   15 s per append, on ``device="cuda"`` and then ``"cpu"``, every
   append through the filter's batch hook on the raw path (the host
   codec stages the columns, then one ``absorb_batch``; no decline):
   rows, states and the ``fluentbit_flux_*`` exposition must be equal
   between the devices, agree with a check computed here from Python (window folds,
   HLL registers, estimates within 3 sigma, top-k within count-min's
   bound), and K10 must have launched once per append of <= 512 groups
   and K6's grouped form once per distinct field on the wide append (the
   one-array form never), whose host steps are reported; then the cuda run again
   with the state's ``_mesh`` set to ``Mesh((cuda:0,) * 8)`` (the
   filter's ``mesh`` key on one card): rows and states equal to the
   unsharded run, 8 K10 shard launches and 3 shard merges per append;
9. K4 against plain: ``grep_assoc`` against ``match_assoc_plain`` and
   against K3 (``kernel="scan"``) on the card, bool for bool: config 3's
   three child programs at [8, 512, 512], the staged bucket of one tail
   read [8, 1024, 512] and [8, 65536, 512], segments 2, 8, 32 and 1024;
   the GET/DENY and Exclude programs at [R, 4096, 512]; a program whose
   rules differ widely in states and classes (the out-of-row case); an
   L = 0 batch, an unaligned view and config 3's rules at [8, 256, 4096];
   with CUDA-event times of K4, its plain version and K3 on the same rows;
10. pipeline: BASELINE config 3 (tail ``read_from_head`` → rewrite_tag
   with the conf's 8 rules → null, plus lib to capture the records) over
   a 131,072-line syslog corpus made from the seed, on ``device="cuda"``
   and then ``"cpu"``, as written: rewrite_tag's batch hook (the host
   DFA twin) takes every tail append with no decline and no kernel;
   every tag's bodies must be equal between the devices and to a Python
   ``re`` first-match routing of the file's lines, the emit counter must
   count the rerouted lines; then on cuda over 16,384 lines with an
   exact stream-processor task on the tag (``SELECT COUNT(*)``), which
   sends the appends down the decoded path: the tags equal to the
   Python routing, the task's counts to the kept lines, and K4 launched
   3 times per tail append of >= 64 records and the scan never;
11. K11 against plain: ``utf8_validate`` against ``utf8_validate_plain``
   and ``utf8_validate_pieces_plain`` on the card, verdict for verdict,
   over config 2's raw lines at the main path's [4096, 512] and at
   [65536, 512], wide rows of several 512 B windows at [1024, 4096], an
   odd width on the byte path at [4096, 300], multi-byte sequences
   across every 16 B piece boundary and the window boundary (cut by the
   length there too), every row empty (the launch's floor), and the
   edge cases (L = 0, every row at -1 / -2, full 512-byte ASCII rows,
   rows invalid at byte 0, an unaligned view), with CUDA-event times;
12. pipeline: BASELINE config 2 (``conf/baseline2-parser.yaml``: tail
   ``read_from_head`` over an NDJSON file → parser json with
   reserve_data → null, plus lib) over 131,072 lines made from the seed,
   on ``device="cuda"`` and then ``"cpu"``: the records (bodies, and the
   times the parser set) must be equal between the devices and to a
   Python fold (``json``, ``datetime.strptime``); then K11 through
   ``Utf8Validator("cuda")`` over the file's raw lines staged at
   [4096, 512] (32 launches) must equal plain and strict
   ``bytes.decode("utf-8")``;
12b. pipeline: config 2's NDJSON through ``parser json`` with no
   Time_Format and no reserve_data, on cuda and then cpu: the parser's
   batch hook (the codec extension's ``parser_json_batch``) takes every
   tail append with no decline and no kernel; bodies equal between the
   devices and to Python's ``json.loads``;
12c. the event codec: encode, decode and re-encode 16,384 records each
   of config 2 (the tail's lines and the parsed objects) and config 5
   (after kubernetes) with the extension and with the plain Python
   versions, bytes equal, microseconds a record of each;
13. pipeline: config 2r, the same filter with parsers.conf's apache2
   parser over a 131,072-line access log, on ``device="cuda"`` and then
   ``"cpu"``, as written: the parser's batch hook (the host DFA twin)
   takes every tail append with no decline and no kernel; records equal
   between the devices and to Python ``re`` with the apache2 pattern,
   ``datetime.strptime`` and the integer casts; then on cuda over 16,384
   lines with an exact ``SELECT COUNT(*)`` task on the tag (the decoded
   path): records equal to the Python fold, and K3 (apache2 has > 64
   states, so "auto" takes the scan) launched once per tail append of
   >= 64 records and K4 never;
   K3 is timed at one tail read, [1, 1024, 512], against plain (both
   halves of its table branch);
14. the shard merge (``shard_merge``, max and add) against its plain
   version, the same function from PyTorch calls
   (``torch.maximum(base, parts.amax(0), out=base)``, or ``torch.add``)
   and the partials' reduction alone (``amax`` / ``sum``) at its largest
   operand, [8, 512, 4096] int32;
15. the mesh programs over ``Mesh((cuda:0,) * n)``, n in {1, 2, 8}: K8
   (``sharded_hll_registers`` at p = 14 over 4096 of config 4's
   ``user`` rows, ``sharded_cms_table`` at 4 x 16384 int32 over its
   ``path`` rows), K9's mesh half over [4096] and [65536] rows of 200
   segments, K10's mesh half at [4096, 256] with 200 groups and
   [65536, 256] with 512, one field and composites: each equal, bit for
   bit, to the same sharded call with the plain versions on the card
   and to the unsharded kernel, its shard and merge launches counted,
   with CUDA-event times of all three;
16. pipeline: flux's SQL mode, FLUX.md's per-tenant query through
   ``ctx.sp_task`` over phase 8's 64 appends under the same clock: (a)
   flux-backed on cuda, (b) the same with ``FBTPU_FLUX_MESH=1`` and the
   state on a hand-built ``Mesh((cuda:0,) * 8)``, (c) flux-backed on
   cpu, (d) the exact path (``WITH (flux='off')``) on cuda: rows and
   states of (a), (b) and (c) equal; COUNT(*) and AVG equal to (d) and
   to Python folds; ``uniq`` equal to the estimate of registers built
   from scratch and within max(3, 10%) of (d)'s exact count; K10 once
   per append in (a), 8 times plus 2 merges per append in (b); the
   hidden flux filter's batch hook takes every append in (a)-(c);
17. pipeline: BASELINE config 5 (forward → kubernetes with Merge_Log On
   and Buffer_Size 0 → grep Exclude ``log health-check`` → null) over
   262,144 records of k8s container logs made from the seed (256 pods
   in 16 namespaces, a ``.meta`` preload cache for 90% of them,
   PackedForward messages of 256-4096 entries, half gzip, ~1% of the
   records in Message / Forward mode and messages below 32 records, ~1%
   of the chunks resent), sent over loopback TCP by four client
   processes that await every ack: (a) ``conf/baseline5-k8s.conf``
   loaded as written through the port's loader, only its Port set to 0,
   on cuda; (b) the same chain with the cache and a lib output on cuda
   and then cpu. The records of (b) must be equal between the devices
   and to a check computed here (Python ``re`` on the tag, the
   ``.meta`` JSON, ``json.loads`` of the trimmed ``log`` with the
   record's keys winning, ``"health-check"`` searched in ``log``);
   every resent chunk must be absorbed once; K4 (the Exclude rule has
   14 states, so "auto" takes it) must have launched once per append of
   >= 32 records in (a) and (b) and K3 never; lines/s, the p50 steps of
   kubernetes and of grep's device match, and K4 at config 5's own
   [1, Bp, 512] rows against its plain version, with times and bound.

Phases 3 and 4 pin K3: phase 3 builds its programs with
``kernel="scan"``; in phase 4 config 1's Exclude rule (16 states) takes
K4 under ``"auto"``, as in the reference, and each kernel's launches are
counted.

The card's name and power limit (as ``nvidia-smi`` gives them) come
before the kernels JSON line, which is the line before the last; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import gzip
import json
import logging
import math
import os
import random
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
# the same pattern in Python's syntax, for the independent check: ASCII
# classes (\S is byte-level in the DFA), ^/$ as line anchors (Ruby)
APACHE2_PY = re.compile(APACHE2.replace("(?<", "(?P<"), re.ASCII | re.MULTILINE)
EXCLUDE = r'HTTP/1\.1" 500 '
EXCLUDE_PY = re.compile(EXCLUDE, re.ASCII | re.MULTILINE)

# config 4 (conf/baseline4-metrics.yaml): the two log_to_metrics filters
CARDINALITY = dict(match="firehose", metric_mode="cardinality",
                   metric_name="unique_users",
                   metric_description="distinct user ids (HLL estimate)",
                   value_field="user", tag="metrics")
FREQUENCY = dict(match="firehose", metric_mode="frequency",
                 metric_name="hot_paths",
                 metric_description="hottest request paths (count-min "
                                    "estimate)",
                 value_field="path", frequency_top_k="10", tag="metrics")
SKETCH_L = 256     # log_to_metrics' tpu_max_record_len
HLL_P = 14         # its sketch_precision
CMS_D, CMS_W = 4, 16384  # its sketch_depth x sketch_width
USER_IDS = 120_000  # ~106k distinct users in 262,144 draws
PATHS = 10_000
PATH_ZIPF_S = 1.1

EVEN_K = ["GET", "DENY"]             # literal rules: k = 6, pair tables
MIXED_K = [APACHE2, "GET", r"^\d+ GET"]  # k = 3, 6, 5: three child programs

# config 3 (conf/baseline3-rewrite.conf): the eight rewrite_tag rules, in
# order, and their Python twins for the independent routing check (ASCII
# \d, as the DFA's byte classes)
CONFIG3_RULES = [("sshd", "sec.ssh"), ("kernel:", "sys.kernel"),
                 (r"systemd\[1\]", "sys.init"), ("ERROR", "app.error"),
                 ("WARN", "app.warn"), ("nginx", "web.nginx"),
                 (r"cron\[\d+\]", "sys.cron"), (r".*OOM.*", "sys.oom")]
CONFIG3 = [p for p, _ in CONFIG3_RULES]  # k = 6, 5, 4: three child programs
CONFIG3_PY = [re.compile(p, re.ASCII) for p in CONFIG3]
# a k = 6 program whose rules differ widely in states and classes: walking
# WARN over all 12 states would pass the end of its trans_flat row
OUT_OF_ROW = ["a{10}", "WARN", r"x[0-9]+y"]
# the conf names a 1M-line corpus; cut to fit the run (262,144 until the
# mesh and SQL phases came in; the smoke then ran 559 s on one call)
SYSLOG_LINES = 131_072
TAIL_BUCKET = 1024      # staged rows of one 64 KiB tail read (~360 lines)
# configs 3 and 2r once more on the decoded path (an exact SP task on the
# tag), at this depth: where their device programs (K4, K3) run
DECODED_LINES = 16_384

L = 512
APPENDS = 64     # the main path: 64 appends of 4096 records
RECORDS = 4096
# H100 SXM peaks at 700 W: HBM3 bytes/s (NVIDIA data sheet), and int32
# operations/s outside the tensor cores: an SM has 64 INT32 lanes beside
# its 128 FP32 lanes (H100 architecture whitepaper), so half the data
# sheet's 67 TFLOP/s float32 rate, a multiply-add counting as two
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def environment(torch) -> dict:
    from fluentbit_tpu_torch.ops import cuda_build

    nvcc = subprocess.run([cuda_build.nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    m = re.search(r"release ([\d.]+)", nvcc)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "nvcc_release": m.group(1) if m else None,
            "triton": triton_version, "card": card_line()}


def apache_line(rng: random.Random, i: int) -> str:
    code = rng.choice(["200", "404", "500"])
    line = (f'10.{rng.randrange(256)}.{rng.randrange(256)}.{i % 256} - '
            f'user{i} [10/Oct/2000:13:55:36 -0700] '
            f'"{rng.choice(["GET", "POST", "PUT"])} /p/{i}?q=ü HTTP/1.1" '
            f'{code} {rng.randrange(100000)}')
    if rng.random() < 0.5:
        line += f' "http://ref/{i}" "curl/8.{i % 10} 日本"'
    return line


def bad_line(rng: random.Random, i: int) -> str:
    kind = rng.randrange(4)
    if kind == 0:
        return f"GET junk line {i} DENY"
    if kind == 1:  # apache-like but broken: missing the size field
        return '10.0.0.1 - u [10/Oct/2000:13:55:36 -0700] "GET /x" 200'
    if kind == 2:
        return f"{i} GET ünïcödé {'x' * rng.randrange(80)}"
    return ""


def make_rows(np, seed: int, R: int, B: int):
    """[R, B, L] uint8 rows and lengths from a seed: random bytes
    (non-ASCII included), matching and non-matching apache lines, and
    every length class (-1, -2, 0, L)."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    batch = nrng.integers(0, 256, size=(R, B, L), dtype=np.uint8)
    lengths = nrng.integers(0, L + 1, size=(R, B)).astype(np.int32)
    for r in range(R):
        for b in range(0, B, 2):  # every other row is text
            text = (apache_line(rng, b) if rng.random() < 0.7
                    else bad_line(rng, b)).encode()[:L]
            batch[r, b, : len(text)] = np.frombuffer(text, np.uint8)
            lengths[r, b] = len(text)
    special = np.array([-1, -2, 0, L, -1, -2, 0, L], dtype=np.int32)
    lengths[:, : len(special)] = special
    lengths[:, 100::997] = -1
    lengths[:, 101::997] = -2
    lengths[:, 102::997] = L
    return batch, lengths


def host_ms(torch, fn, iters: int) -> float:
    """Mean host ms to enqueue one call of ``fn`` (no synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, warmed, by CUDA
    events. A sleep kernel first holds the stream for longer than the
    host takes to enqueue the calls, so the events time the device's
    back-to-back work and not the host's launch rate (a stream queue
    that fills up still lets the host's rate in)."""
    for _ in range(3):
        fn()
    enqueue_s = host_ms(torch, fn, iters) * iters / 1e3
    # ~2e9 SM cycles a second (H100 SXM boost 1.98 GHz)
    torch.cuda._sleep(int(min(1.5 * enqueue_s + 1e-3, 2.0) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_tables(torch, tg, prog) -> list:
    """Each k-group's full table set on the card, ``pair_maps`` included
    (a CUDA program holds only the kernel's tables), so the plain version
    of an even-k group takes K2's route."""
    return [{n: torch.from_numpy(a).to(leaf.device)
             for n, a in tg.build_tables(leaf.dfas, leaf.k).items()}
            for leaf in prog._children or [prog]]


def plain_dispatch(torch, tg, prog, tables, b, ln):
    """``prog.dispatch`` with the plain torch version in place of the
    kernel (same child split and merge), over ``plain_tables``."""
    parts = [tg.match_plain(t, bb, ll, leaf.k)
             for t, (leaf, bb, ll) in zip(tables, leaves(prog, b, ln))]
    if prog._children is None:
        return parts[0]
    return torch.cat(parts, dim=0).index_select(0, prog._inv_perm)


def leaves(prog, b, ln):
    """(single-k program, its rows, its lengths) for each k-group."""
    if prog._children is None:
        return [(prog, b, ln)]
    return [(c, b.index_select(0, ix), ln.index_select(0, ix))
            for c, ix in zip(prog._children, prog._child_idxs)]


def scan_global(torch, tg, prog, b, ln, plain, iters: int) -> dict:
    """K3's global half (``trans_flat`` read from L2: the table set
    without ``tab16``), one call per k-group on its own rows, against
    the plain version, bool for bool, with its CUDA-event time."""
    calls = []
    for leaf, bb, ll in leaves(prog, b, ln):
        t = {n: v for n, v in leaf.tables.items() if n not in ("tab16", "kp")}
        calls.append(lambda t=t, bb=bb.contiguous(), ll=ll.contiguous(),
                     k=leaf.k: tg.grep_dfa(t, bb, ll, k))
    got = merged(torch, prog, [c() for c in calls])
    torch.cuda.synchronize()
    return {"kp": [leaf.tables["kp"].tolist() for leaf in prog._children
                   or [prog]],
            "global_mismatches": int((got != plain).sum()),
            "global_ms": cuda_ms(torch, lambda: [c() for c in calls], iters)}


def table_bytes_read(torch, tg, prog, b, ln) -> int:
    """Table bytes these rows need: the class maps and per-rule scalars,
    plus each distinct ``trans_flat`` entry the walk visits, once."""
    total = 0
    for leaf, bb, ll in leaves(prog, b, ln):
        t = leaf.tables
        R = bb.shape[0]
        total += (t["class_maps"].numel() + 4 * R) * 4
        comb = tg.super_symbols_plain(t, bb, ll, leaf.k)
        row0 = (torch.arange(R, device=bb.device, dtype=torch.int64)
                * t["trans_flat"].shape[1])[:, None]
        state = t["starts"][:, None].expand(R, bb.shape[1])
        seen = []
        for step in range(comb.shape[2]):
            idx = (state * t["Ck"][:, None] + comb[:, :, step]).long()
            seen.append(torch.unique(idx + row0))
            state = torch.gather(t["trans_flat"], 1, idx)
        total += int(torch.unique(torch.cat(seen)).numel()) * 4
    return total


def bound_ms(torch, prog, b, ln, table_bytes: int) -> tuple:
    """Least time for one verdict pass over these rows, counting what
    their data needs. Bytes: each row's bytes before its length (none
    for a negative length), every length and verdict once, plus the
    table bytes the rows need, over HBM's rate. Operations: a row with
    a length needs the super-steps over its bytes and then one full EOL
    step (EOL is absorbing), each a multiply-add per class plus one for
    the table index, over the int32 peak; a negative length needs none.
    The larger of the two bounds it."""
    nbytes = table_bytes
    ops = 0
    for leaf, _bb, ll in leaves(prog, b, ln):
        used = ll.clamp(min=0, max=L).long()
        nbytes += int(used.sum()) + ll.numel() * (4 + 1)
        steps = torch.where(ll >= 0, (used + leaf.k - 1) // leaf.k + 1, 0)
        ops += int(steps.sum()) * (2 * leaf.k + 2)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_kernels(np, torch, tg, compile_dfa, seed: int) -> list:
    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    # the card's floor for one launch: a one-element PyTorch kernel
    log("launch_floor: " + json.dumps({"ms": cuda_ms(
        torch, lambda: one.add_(1), 200), "op": "torch.add_ on 1 float"}))
    results = []
    programs = [("apache2", [APACHE2]), ("even_k_literals", EVEN_K),
                ("mixed_k", MIXED_K)]
    for name, patterns in programs:
        # these cases hold K3 against its plain version: "auto" would take
        # K4 on the card for the literal and mixed programs
        prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L, dev,
                                   kernel="scan")
        tables = plain_tables(torch, tg, prog)
        for B in (65536, 4096):
            R = len(patterns)
            batch, lengths = make_rows(np, seed + B + R, R, B)
            b = torch.from_numpy(batch).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            before = tg.grep_dfa.launches
            got = prog.dispatch(b, ln)
            launches = tg.grep_dfa.launches - before
            plain = plain_dispatch(torch, tg, prog, tables, b, ln)
            torch.cuda.synchronize()
            mism = int((got != plain).sum())
            err = int((got.int() - plain.int()).abs().max())
            iters = 50 if B == 4096 else 20
            k_ms = cuda_ms(torch, lambda: prog.dispatch(b, ln), iters)
            k_host_ms = host_ms(torch, lambda: prog.dispatch(b, ln), iters)
            p_ms = cuda_ms(torch, lambda: plain_dispatch(torch, tg, prog,
                                                         tables, b, ln), 3)
            bms, by = bound_ms(torch, prog, b, ln,
                               table_bytes_read(torch, tg, prog, b, ln))
            res = {"program": name, "shape": [R, B, L],
                   "k_groups": prog.decision()["k_groups"],
                   "launches": launches, "mismatches": mism, "max_abs_err": err,
                   "matched_rows": int(got.sum()), "ms": k_ms,
                   "host_enqueue_ms": k_host_ms, "plain_ms": p_ms,
                   "bound_ms": bms, "bound_by": by}
            res.update(scan_global(torch, tg, prog, b, ln, plain, iters))
            log("kernel-vs-plain: " + json.dumps(res))
            if mism or res["global_mismatches"]:
                raise SystemExit(f"grep_dfa disagrees with match_plain on "
                                 f"{name} {[R, B, L]}: {mism} rows")
            if launches != len(res["k_groups"]):
                raise SystemExit(f"{name}: {launches} launches for "
                                 f"{len(res['k_groups'])} k-groups")
            if not 0 < res["matched_rows"] < R * B:
                raise SystemExit(f"degenerate verdicts on {name}: {res}")
            results.append(res)
    return results


def make_appends(seed: int, n_appends: int, n_records: int) -> list:
    """Lib-input appends of [ts, body] pairs with fixed timestamps:
    ~70% well-formed apache lines, the rest malformed, longer than 512 B,
    or without ``log``."""
    rng = random.Random(seed)
    appends = []
    i = 0
    for _ in range(n_appends):
        recs = []
        for _ in range(n_records):
            x = rng.random()
            if x < 0.70:
                body = {"log": apache_line(rng, i)}
            elif x < 0.85:
                body = {"log": bad_line(rng, i)}
            elif x < 0.93:
                body = {"log": apache_line(rng, i) + ' "' + "z" * 520 + '"'}
            elif x < 0.97:
                body = {"msg": "no log field", "n": i}
            else:
                body = {"log": i}  # not a string: never matches
            recs.append([1700000000 + i // 1000 + (i % 1000) / 1000.0, body])
            i += 1
        appends.append([recs, json.dumps(recs)])
    return appends


def config1_ctx(flb, device: str, exclude: bool) -> tuple:
    """Config 1's context: lib input → grep (the Exclude rule first, when
    asked) → lib output collecting the bytes."""
    out = []
    ctx = flb.create(device=device, flush="50ms", grace="2")
    in_ffd = ctx.input("lib", tag="bench.apache")
    f = ctx.filter("grep", match="bench.*")
    if exclude:
        ctx.set(f, exclude="log " + EXCLUDE)
    ctx.set(f, regex="log " + APACHE2)
    ctx.output("lib", match="*", callback=lambda data, tag: out.append(data))
    return ctx, in_ffd, out


def run_pipeline(flb, device: str, appends: list, exclude: bool) -> tuple:
    """Config 1 through ``ctx.push`` (JSON, as a lib user pushes)."""
    ctx, in_ffd, out = config1_ctx(flb, device, exclude)
    ctx.start()
    t0 = time.perf_counter()
    try:
        for _recs, text in appends:
            ctx.push(in_ffd, text)
        ctx.flush_now()
        wall = time.perf_counter() - t0
    finally:
        ctx.stop()
    return b"".join(out), wall, ctx.engine.filters[0].plugin


def run_chunks(flb, device: str, chunks: list, exclude: bool) -> tuple:
    """Config 1 on pre-encoded msgpack chunks handed straight to
    ``input_log_append``, the form in_forward delivers."""
    ctx, _in_ffd, out = config1_ctx(flb, device, exclude)
    ctx.start()
    ins = ctx.engine.inputs[0]
    t0 = time.perf_counter()
    try:
        for data, n in chunks:
            ctx.engine.input_log_append(ins, "bench.apache", data, n)
        ctx.flush_now()
        wall = time.perf_counter() - t0
    finally:
        ctx.stop()
    return b"".join(out), wall, ctx.engine.filters[0].plugin


RAW_STEPS = ("extract", "kernel", "overflow", "compact")


def raw_p50(grep) -> dict:
    """p50 ms of each raw step over the filter's raw appends."""
    steps = list(grep.raw_step_seconds)
    return {f"{name}_ms": statistics.median(s[i] for s in steps) * 1e3
            for i, name in enumerate(RAW_STEPS)} if steps else {}


def expected_bodies(appends: list, exclude: bool) -> list:
    kept = []
    for recs, _text in appends:
        for _ts, body in recs:
            v = body.get("log")
            if not isinstance(v, str):
                continue
            if exclude and EXCLUDE_PY.search(v):
                continue
            if APACHE2_PY.search(v):
                kept.append(body)
    return kept


def launches_per_dispatch(prog) -> dict:
    """Launches of each grep kernel that one dispatch of ``prog`` makes:
    one per k-group, by the kernel that group resolved to."""
    count = {"grep_dfa": 0, "grep_assoc": 0}
    for leaf in prog._children or [prog]:
        count["grep_assoc" if leaf.kernel_resolved == "assoc"
              else "grep_dfa"] += 1
    return count


def raw_route(grep, sizes: list) -> dict:
    """What shows that config 1 took the raw chunk path: the filter's
    raw record count against the records of every append (of ``sizes``
    records each) of at least ``tpu_batch_records``, and the decoded
    path's device match unused."""
    raw_records = sum(n for n in sizes if n >= grep.tpu_batch_records)
    return {"raw_records": grep.raw_timings["records"],
            "expected_raw_records": raw_records,
            "decoded_device_appends": len(grep.match_seconds),
            "raw": (grep.raw_timings["records"] == raw_records > 0
                    and not grep.match_seconds)}


def phase_pipeline(tg, flb, decode_events, appends: list, card: str) -> dict:
    """Config 1 through ``ctx.push``: the appends of 4096 records take
    the raw chunk path (one segment each) on both devices."""
    n_records = APPENDS * RECORDS
    device_appends = sum(len(r) >= 32 for r, _ in appends)
    report = {}
    for exclude in (False, True):
        label = "regex+exclude" if exclude else "regex"
        tg.grep_dfa.launches = tg.grep_assoc.launches = 0
        got, wall, grep = run_pipeline(flb, "cuda", appends, exclude)
        # apache2 (690 states) takes the scan; the Exclude rule (16
        # states) resolves to K4 on the card, as the reference's "auto"
        launches = {"grep_dfa": tg.grep_dfa.launches,
                    "grep_assoc": tg.grep_assoc.launches}
        prog = grep._program
        expected = {name: device_appends * n for name, n in
                    launches_per_dispatch(prog).items()}
        ref, cpu_wall, cpu_grep = run_pipeline(flb, "cpu", appends, exclude)
        bodies = [ev.body for ev in decode_events(got)]
        want = expected_bodies(appends, exclude)
        sizes = [len(r) for r, _ in appends]
        route, cpu_route = raw_route(grep, sizes), raw_route(cpu_grep, sizes)
        res = {"rules": label, "records": n_records, "appends": len(appends),
               "kept": len(bodies), "bytes_equal_cpu": got == ref,
               "kept_equals_python_re": bodies == want,
               "kernel_resolved": prog.decision()["kernel_resolved"],
               "launches": launches, "expected_launches": expected,
               "route": route, "cpu_route": cpu_route,
               "lines_per_s": n_records / wall,
               "p50_append_raw": raw_p50(grep),
               "cpu_lines_per_s": n_records / cpu_wall,
               "cpu_p50_append_raw": raw_p50(cpu_grep), "card": card}
        log("pipeline: " + json.dumps(res))
        if not res["bytes_equal_cpu"]:
            raise SystemExit(f"{label}: cuda output bytes differ from cpu")
        if not res["kept_equals_python_re"]:
            raise SystemExit(f"{label}: kept records differ from Python re "
                             f"({len(bodies)} vs {len(want)})")
        if launches != expected or launches["grep_dfa"] == 0:
            raise SystemExit(f"{label}: {launches} kernel launches, expected "
                             f"{expected}")
        if not (route["raw"] and cpu_route["raw"]):
            raise SystemExit(f"{label}: not the raw chunk path: {route} "
                             f"{cpu_route}")
        report[label] = res
    return report


ROUTE_5XX = r"\s5[0-9][0-9]\s"
ROUTE_5XX_PY = re.compile(ROUTE_5XX, re.ASCII)


def hist_p50(metric, name: str):
    """The median of a latency histogram's series, interpolated within
    its bucket as Prometheus' ``histogram_quantile`` does."""
    counts, _sum = metric.hist_samples()[(name,)]
    total, seen, lower = sum(counts), 0, 0.0
    for upper, n in zip(list(metric.buckets) + [math.inf], counts):
        if n and seen + n >= total / 2:
            if upper == math.inf:
                return lower
            return lower + (upper - lower) * (total / 2 - seen) / n
        seen += n
        lower = upper
    return None


def wait_for(cond, timeout: float, what: str) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise SystemExit(f"delivery: timed out waiting for {what}")
        time.sleep(0.005)


def body_key(body) -> str:
    return json.dumps(body, sort_keys=True)


def phase_delivery(tg, flb, decode_events, appends: list, card: str,
                   k3_launches: int) -> dict:
    """Config 1's appends through the delivery core: retries to a file
    whose directory comes late, an output that always retries, worker
    threads, and conditional routing on the decoded path."""
    n_records = sum(len(r) for r, _ in appends)
    kept = expected_bodies(appends, exclude=False)
    logging.getLogger("flb.engine").setLevel(logging.ERROR)  # 64 drops
    base = tempfile.mkdtemp(prefix="fbtpu-delivery-")
    report = {"records": n_records, "kept": len(kept), "card": card}
    try:
        # (a) the raw path, a file that answers RETRY until its directory
        # exists, and out_retry
        target = os.path.join(base, "out")
        ctx = flb.create(device="cuda", flush="50ms", grace="2",
                         **{"scheduler.base": "0.05",
                            "scheduler.cap": "0.1"})
        in_ffd = ctx.input("lib", tag="bench.apache")
        ctx.filter("grep", match="bench.*", regex="log " + APACHE2)
        ctx.output("file", match="*", path=target, file="delivered.txt",
                   format="plain", workers="2", retry_limit="5")
        ctx.output("retry", match="*", retry_limit="1")
        e = ctx.engine
        fname, rname = (o.display_name for o in e.outputs)

        def make_dir():
            # the directory comes once the file output has retried
            deadline = time.perf_counter() + 60
            while e.m_out_retries.get((fname,)) < 1 \
                    and time.perf_counter() < deadline:
                time.sleep(0.002)
            os.makedirs(target)

        watcher = threading.Thread(target=make_dir, daemon=True)
        tg.grep_dfa.launches = tg.grep_assoc.launches = 0
        ctx.start()
        try:
            watcher.start()
            t0 = time.perf_counter()
            for _recs, text in appends:
                ctx.push(in_ffd, text)
            push_wall = time.perf_counter() - t0
            watcher.join(timeout=60)
            wait_for(lambda: e.m_out_proc_records.get((fname,))
                     + e.m_out_dropped.get((fname,)) >= len(kept)
                     and e.m_out_dropped.get((rname,)) >= len(kept), 60,
                     "every kept record delivered or dropped")
            wall = time.perf_counter() - t0
        finally:
            ctx.stop()
        launches = {"grep_dfa": tg.grep_dfa.launches,
                    "grep_assoc": tg.grep_assoc.launches}
        with open(os.path.join(target, "delivered.txt"),
                  encoding="utf-8") as f:
            lines = f.read().splitlines()
        chunks = e.m_latency.get((fname,))
        counts = {name: {fam: m.get((name,)) for fam, m in (
            ("proc_records", e.m_out_proc_records),
            ("retries", e.m_out_retries),
            ("retries_failed", e.m_out_retries_failed),
            ("errors", e.m_out_errors),
            ("dropped_records", e.m_out_dropped))}
            for name in (fname, rname)}
        raw = {"launches": launches, "counters": counts, "chunks": chunks,
               "worker_pool_threads": e.outputs[0].workers,
               "file_lines_equal_python_re": collections.Counter(lines)
               == collections.Counter(json.dumps(b) for b in kept),
               "lines_per_s": n_records / wall,
               "ingest_lines_per_s": n_records / push_wall,
               "p50_latency_s": hist_p50(e.m_latency, fname)}
        report["raw"] = raw
        log("delivery: " + json.dumps(raw))
        f, r = counts[fname], counts[rname]
        if not raw["file_lines_equal_python_re"]:
            raise SystemExit(f"delivery: the file's {len(lines)} lines are "
                             f"not the {len(kept)} kept bodies")
        if f["proc_records"] != len(kept) or f["retries"] < 1 \
                or f["dropped_records"] or f["errors"]:
            raise SystemExit(f"delivery: file output counters {f}")
        if not (r["retries"] == r["retries_failed"] == r["errors"]
                == chunks > 0) or r["dropped_records"] != len(kept) \
                or r["proc_records"]:
            raise SystemExit(f"delivery: retry output counters {r}, "
                             f"{chunks} chunks")
        if launches != {"grep_dfa": k3_launches, "grep_assoc": 0}:
            raise SystemExit(f"delivery: {launches} launches, expected "
                             f"{k3_launches} of grep_dfa")

        # (b) conditional routing: the decoded path
        outs = ([], [])
        ctx = flb.create(device="cuda", flush="50ms", grace="2")
        in_ffd = ctx.input("lib", tag="bench.apache")
        ctx.filter("grep", match="bench.*", regex="log " + APACHE2)
        ctx.output("lib", match="*",
                   callback=lambda data, tag: outs[0].append(data))
        ctx.output("lib", match="*", route_condition="$log regex "
                   + ROUTE_5XX, callback=lambda data, tag:
                   outs[1].append(data))
        e = ctx.engine
        names = [o.display_name for o in e.outputs]
        tg.grep_dfa.launches = tg.grep_assoc.launches = 0
        ctx.start()
        try:
            t0 = time.perf_counter()
            for _recs, text in appends:
                ctx.push(in_ffd, text)
            want_5xx = [b for b in kept if isinstance(b.get("log"), str)
                        and ROUTE_5XX_PY.search(b["log"])]
            wait_for(lambda: e.m_out_proc_records.get((names[0],))
                     >= len(kept) and e.m_out_proc_records.get(
                         (names[1],)) >= len(want_5xx), 60,
                     "the routed records")
            wall = time.perf_counter() - t0
        finally:
            ctx.stop()
        grep = e.filters[0].plugin
        got = [[ev.body for d in o for ev in decode_events(d)]
               for o in outs]
        routed = {
            "launches": {"grep_dfa": tg.grep_dfa.launches,
                         "grep_assoc": tg.grep_assoc.launches},
            "decoded_device_appends": len(grep.match_seconds),
            "raw_records": grep.raw_timings["records"],
            "all": len(got[0]), "routed_5xx": len(got[1]),
            "all_equal_python_re": collections.Counter(map(body_key, got[0]))
            == collections.Counter(map(body_key, kept)),
            "routed_equal_python_re": collections.Counter(
                map(body_key, got[1]))
            == collections.Counter(map(body_key, want_5xx)),
            "lines_per_s": n_records / wall,
            "p50_latency_s": hist_p50(e.m_latency, names[0]),
            "routed_p50_latency_s": hist_p50(e.m_latency, names[1])}
        report["routed"] = routed
        log("delivery routed: " + json.dumps(routed))
        if not (routed["all_equal_python_re"]
                and routed["routed_equal_python_re"]):
            raise SystemExit("delivery: routed records differ from Python "
                             f"re ({len(got[0])}, {len(got[1])} of "
                             f"{len(kept)}, {len(want_5xx)})")
        if routed["raw_records"] or routed["decoded_device_appends"] != \
                len(appends) or routed["launches"] != {
                    "grep_dfa": len(appends), "grep_assoc": 0}:
            raise SystemExit(f"delivery: not the decoded path: {routed}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
        logging.getLogger("flb.engine").setLevel(logging.NOTSET)
    return report


def encode_chunks(encode_event, EventTime, appends: list) -> list:
    """Each append's records as one msgpack chunk: (bytes, records)."""
    return [(b"".join(encode_event(body, EventTime.from_float(ts))
                      for ts, body in recs), len(recs))
            for recs, _text in appends]


def phase_raw_chunks(tg, flb, decode_events, chunks: list, appends: list,
                     card: str) -> dict:
    """Config 1 on pre-encoded chunks: the 64 chunks of 4096 records,
    then one chunk of 65,536 (the first 16 again, concatenated: 16
    segments, double-buffered), handed to ``input_log_append`` on cuda
    and cpu; output bytes against cpu and against Python ``re``."""
    big = (b"".join(c for c, _ in chunks[:16]),
           sum(n for _, n in chunks[:16]))
    runs = chunks + [big]
    all_appends = appends + appends[:16]
    n_records = sum(n for _, n in runs)
    segments = sum(-(-n // RECORDS) for _, n in runs)
    report = {}
    for exclude in (False, True):
        label = "regex+exclude" if exclude else "regex"
        tg.grep_dfa.launches = tg.grep_assoc.launches = 0
        got, wall, grep = run_chunks(flb, "cuda", runs, exclude)
        launches = {"grep_dfa": tg.grep_dfa.launches,
                    "grep_assoc": tg.grep_assoc.launches}
        prog = grep._program
        per_dispatch = launches_per_dispatch(prog)
        expected = {k: segments * v for k, v in per_dispatch.items()}
        ref, cpu_wall, cpu_grep = run_chunks(flb, "cpu", runs, exclude)
        bodies = [ev.body for ev in decode_events(got)]
        want = expected_bodies(all_appends, exclude)
        sizes = [n for _, n in runs]
        route, cpu_route = raw_route(grep, sizes), raw_route(cpu_grep, sizes)
        k_groups = prog.decision()["k_groups"]
        total = sum(launches.values())
        big_steps = grep.raw_step_seconds[-1]
        res = {"rules": label, "records": n_records, "chunks": len(runs),
               "segments": segments, "k_groups": k_groups,
               "kept": len(bodies), "bytes_equal_cpu": got == ref,
               "kept_equals_python_re": bodies == want,
               "launches": launches, "expected_launches": expected,
               "launches_per_segment": total / segments,
               "launches_per_k_group": total / len(k_groups),
               "route": route, "cpu_route": cpu_route,
               "lines_per_s": n_records / wall,
               "cpu_lines_per_s": n_records / cpu_wall,
               "p50_append_raw": raw_p50(grep),
               "cpu_p50_append_raw": raw_p50(cpu_grep),
               "chunk_65536_ms": {f"{name}_ms": big_steps[i] * 1e3
                                  for i, name in enumerate(RAW_STEPS)},
               "card": card}
        log("raw_chunks: " + json.dumps(res))
        failed = [k for k in ("bytes_equal_cpu", "kept_equals_python_re")
                  if not res[k]]
        if launches != expected or not route["raw"] or not cpu_route["raw"]:
            failed.append("route")
        if failed:
            raise SystemExit(f"raw chunks {label} failed {failed}: {res}")
        report[label] = res
    return report


def shard_call(tg, prog, mesh, variant: str, b, ln):
    """One call of K5's first shard alone: the batch variant's first
    B / n rows through ``dispatch``, or the rules variant's first R / n
    rules over every row on that shard's tables."""
    n = mesh.size
    if variant == "batch":
        step = b.shape[1] // n
        bs, ls = b[:, :step].contiguous(), ln[:, :step].contiguous()
        return lambda: prog.dispatch(bs, ls)
    step = b.shape[0] // n
    t = prog._mesh_tables(mesh, variant)[0]
    bs, ls = b[:step].contiguous(), ln[:step].contiguous()
    return lambda: tg.match_rows(t, bs, ls, prog.k, prog.kernel_resolved,
                                 prog.max_states, prog.segment)


def mesh_case(np, torch, tg, tmesh, compile_dfa, name: str, patterns: list,
              want_variant: str, dev, seed: int, card: str) -> list:
    """One program of the K5 phase over 1, 2 and 8 shards of ``dev``."""
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L, dev)
    R = len(patterns)
    results = []
    if patterns == CONFIG3:
        batch, lengths = syslog_rows(np, seed + 5, R, RECORDS)
    else:
        batch, lengths = make_rows(np, seed + 5 + R, R, RECORDS)
    b = torch.from_numpy(batch).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    unsharded = prog.dispatch(b, ln)
    tables = plain_tables(torch, tg, prog)
    plain = plain_dispatch(torch, tg, prog, tables, b, ln)
    torch.cuda.synchronize()
    bms, by = bound_ms(torch, prog, b, ln,
                       table_bytes_read(torch, tg, prog, b, ln))
    k3_ms = cuda_ms(torch, lambda: prog.dispatch(b, ln), 30)
    plain_ms = cuda_ms(torch, lambda: plain_dispatch(
        torch, tg, prog, tables, b, ln), 2)
    for n in (1, 2, 8):
        mesh = tmesh.Mesh((dev,) * n)
        variant = prog.mesh_variant(mesh)
        before = tg.grep_mesh.launches
        mask, counts, B, Bp = prog.dispatch_mesh(mesh, b, ln)
        shard_launches = tg.grep_mesh.launches - before
        mask2, counts2, _, _ = prog.dispatch_mesh(mesh, b, ln,
                                                  with_counts=False)
        torch.cuda.synchronize()
        m = mask[:, :B]
        res = {"program": name, "shape": [R, RECORDS, L], "shards": n,
               "variant": variant, "Bp": Bp,
               "k_groups": prog.decision()["k_groups"],
               "shard_launches": shard_launches,
               "mismatches_unsharded": int((m != unsharded).sum()),
               "mismatches_plain": int((m != plain).sum()),
               "max_abs_err": int((m.int() - plain.int()).abs().max()),
               "counts_equal_mask_sum": torch.equal(
                   counts, tg.counts_plain(plain)),
               "no_counts_equal": (counts2 is None and torch.equal(
                   mask2[:, :B], m)),
               "matched_rows": int(m.sum()),
               "ms": cuda_ms(torch, lambda: prog.dispatch_mesh(
                   mesh, b, ln, with_counts=False), 20),
               "counts_ms": cuda_ms(torch, lambda: prog.dispatch_mesh(
                   mesh, b, ln), 20),
               "unsharded_ms": k3_ms,
               "n_x_shard_ms": n * cuda_ms(torch, shard_call(
                   tg, prog, mesh, variant, b, ln), 30),
               "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
               "card": card}
        log("mesh: " + json.dumps(res))
        if (res["mismatches_unsharded"] or res["mismatches_plain"]
                or not res["counts_equal_mask_sum"]
                or not res["no_counts_equal"] or variant != want_variant
                or shard_launches != n * len(res["k_groups"])
                or not 0 < res["matched_rows"] < R * RECORDS):
            raise SystemExit(f"grep_mesh failed on {name}: {res}")
        results.append(res)
    return results


def phase_mesh(np, torch, tg, tmesh, compile_dfa, flb, chunks: list,
               seed: int, card: str) -> dict:
    """K5 over ``Mesh((cuda:0,) * n)``, n in {1, 2, 8}: the batch variant
    for apache2 and apache2 + Exclude (two children), the rules variant
    for config 3's 8 rules (``FBTPU_MESH_RULE_SHARD_R=2``), at [R, 4096,
    512]. Masks and counts must equal the unsharded kernel, the plain
    version and ``mask.sum``; ``with_counts=False`` the same masks. Then
    the grep filter's mesh staging branch over the 65,536-record chunk
    (the K5 main path, counts reset before and read after) against its
    unsharded branch, and the counts epilogue's cost on K3 and K4."""
    dev = torch.device("cuda", 0)
    cases = [("apache2", [APACHE2], None), ("apache2+exclude",
                                            [APACHE2, EXCLUDE], None),
             ("config3_rules", CONFIG3, "2")]
    results = []
    for name, patterns, shard_r in cases:
        # the rule-shard count is read when the program is built (no k
        # split) and when a mesh picks its variant
        if shard_r:
            os.environ["FBTPU_MESH_RULE_SHARD_R"] = shard_r
        try:
            results += mesh_case(np, torch, tg, tmesh, compile_dfa, name,
                                 patterns, "rules" if shard_r else "batch",
                                 dev, seed, card)
        finally:
            os.environ.pop("FBTPU_MESH_RULE_SHARD_R", None)

    # the filter's mesh staging branch: the K5 main path

    data, n_big = (b"".join(c for c, _ in chunks[:16]),
                   sum(n for _, n in chunks[:16]))
    ctx, _in_ffd, _out = config1_ctx(flb, "cuda", exclude=True)
    grep_ins = ctx.engine.filters[0]
    grep_ins.configure()
    grep_ins.plugin.init(grep_ins, ctx.engine)
    grep = grep_ins.plugin
    mesh = tmesh.Mesh((dev,) * 8)
    grep._device_match_raw(data, n_big, mesh=mesh)  # warm: tables, pinned
    tg.grep_dfa.launches = tg.grep_assoc.launches = 0
    tg.grep_mesh.launches = 0
    t0 = time.perf_counter()
    m_mesh, o_mesh, n_mesh = grep._device_match_raw(data, n_big, mesh=mesh)
    mesh_wall = time.perf_counter() - t0
    launches = {"grep_mesh": tg.grep_mesh.launches,
                "grep_dfa": tg.grep_dfa.launches,
                "grep_assoc": tg.grep_assoc.launches}
    t0 = time.perf_counter()
    m_one, o_one, n_one = grep._device_match_raw(data, n_big)
    one_wall = time.perf_counter() - t0
    segments = -(-n_big // RECORDS)
    expected = {"grep_mesh": segments * 8 * 2, "grep_dfa": segments * 8,
                "grep_assoc": segments * 8}
    branch = {"records": n_big, "segments": segments, "shards": 8,
              "launches": launches, "expected_launches": expected,
              "mask_equal_unsharded": bool(np.array_equal(m_mesh, m_one)),
              "offsets_equal": bool(np.array_equal(o_mesh, o_one)),
              "mesh_ms": mesh_wall * 1e3, "unsharded_ms": one_wall * 1e3,
              "card": card}
    log("mesh_filter_branch: " + json.dumps(branch))
    if (launches != expected or not branch["mask_equal_unsharded"]
            or not branch["offsets_equal"]
            or not n_mesh == n_one == n_big):
        raise SystemExit(f"the filter's mesh branch failed: {branch}")

    # the counts epilogue's cost: K3 at config 1's [1, 4096, 512], K4 at
    # config 3's tail read [8, 1024, 512]
    epilogue = []
    k3 = tg.TorchGrepProgram([compile_dfa(APACHE2)], L, dev)
    batch, lengths = make_rows(np, seed + 11, 1, RECORDS)
    k4 = tg.TorchGrepProgram([compile_dfa(p) for p in CONFIG3], L, dev)
    sb, sl = syslog_rows(np, seed + 12, len(CONFIG3), TAIL_BUCKET)
    for name, prog, bb, ll in (("grep_dfa", k3, batch, lengths),
                               ("grep_assoc", k4, sb, sl)):
        b = torch.from_numpy(bb).to(dev)
        ln = torch.from_numpy(ll).to(dev)
        parts = leaves(prog, b, ln)
        cnts = [torch.zeros(bl.shape[0], dtype=torch.int32, device=dev)
                for _, bl, _ in parts]

        def run(with_counts, parts=parts, cnts=cnts):
            return [tg.match_rows(lf.tables, bl, ll_, lf.k, lf.kernel_resolved,
                                  lf.max_states, lf.segment,
                                  counts=c if with_counts else None)
                    for (lf, bl, ll_), c in zip(parts, cnts)]

        for c in cnts:
            c.zero_()
        masks = run(True)
        torch.cuda.synchronize()
        ok = all(torch.equal(c, tg.counts_plain(m))
                 for c, m in zip(cnts, masks))
        row = {"kernel": name, "shape": list(bb.shape),
               "k_groups": prog.decision()["k_groups"],
               "kernel_resolved": prog.decision()["kernel_resolved"],
               "counts_equal_mask_sum": ok,
               "ms": cuda_ms(torch, lambda: run(False), 30),
               "counts_ms": cuda_ms(torch, lambda: run(True), 30),
               "card": card}
        log("counts_epilogue: " + json.dumps(row))
        if not ok or row["kernel_resolved"] != {"grep_dfa": "scan",
                                                "grep_assoc": "assoc"}[name]:
            raise SystemExit(f"counts epilogue failed: {row}")
        epilogue.append(row)
    main_rows = config1_rows(np, torch, tg, compile_dfa, chunks, dev, card)
    return {"cases": results, "filter_branch": branch, "epilogue": epilogue,
            "main_rows": main_rows}


def raw_staged(np, data: bytes, n: int):
    """One append's ``log`` field staged as the raw path stages a
    segment: the host codec writes the rows unzeroed (bytes past a
    length are whatever the buffer held), lengths -1 / -2 for a missing
    / overflowing value, at the bucket of the longest value."""
    from fluentbit_tpu_torch import native
    from fluentbit_tpu_torch.ops.batch import len_bucket

    rows = np.empty((RECORDS, L), dtype=np.uint8)
    lens = np.full((RECORDS,), -1, dtype=np.int32)
    if native.stage_field_into(data, b"log", rows, lens, n_hint=n) != n:
        raise SystemExit("the host codec did not stage the append")
    width = len_bucket(max(1, int(lens.max())), L)
    return np.ascontiguousarray(rows[None, :, :width]), lens[None]


def config1_rows(np, torch, tg, compile_dfa, chunks: list, dev,
                 card: str) -> list:
    """K3 (apache2) and K4 (the Exclude rule, 16 states: "auto" takes
    assoc) on config 1's own rows: its first append staged as the raw
    path stages it, [1, 4096, width]. Each bool for bool against its
    plain version, counts against ``mask.sum``, with CUDA-event times;
    K3 also through its global half."""
    data, n = chunks[0]
    batch, lengths = raw_staged(np, data, n)
    b = torch.from_numpy(batch).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    out = []
    for name, patterns in (("grep_dfa", [APACHE2]), ("grep_assoc", [EXCLUDE])):
        prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns],
                                   batch.shape[2], dev)
        counts = torch.zeros(1, dtype=torch.int32, device=dev)
        before = (tg.grep_dfa.launches, tg.grep_assoc.launches)
        got = tg.match_rows(prog.tables, b, ln, prog.k, prog.kernel_resolved,
                            prog.max_states, prog.segment, counts=counts)
        launched = (tg.grep_dfa.launches - before[0],
                    tg.grep_assoc.launches - before[1])
        if name == "grep_assoc":
            plain_calls = leaf_calls(tg, prog, b, ln, "plain")
        else:
            tables = plain_tables(torch, tg, prog)
            plain_calls = [lambda: plain_dispatch(torch, tg, prog, tables, b,
                                                  ln)]

        def run_plain(calls=plain_calls):
            return merged(torch, prog, [c() for c in calls])

        plain = run_plain()
        torch.cuda.synchronize()
        bms, by = bound_ms(torch, prog, b, ln,
                           table_bytes_read(torch, tg, prog, b, ln))
        row = {"kernel": name, "rows": "config1_raw_append",
               "shape": list(batch.shape), "kernel_resolved":
               prog.kernel_resolved, "launches": launched,
               "mismatches": int((got != plain).sum()),
               "max_abs_err": int((got.int() - plain.int()).abs().max()),
               "counts_equal_mask_sum": torch.equal(counts,
                                                    tg.counts_plain(plain)),
               "matched_rows": int(got.sum()),
               "overflow_rows": int((ln == -2).sum()),
               "ms": cuda_ms(torch, lambda: prog.dispatch(b, ln), 50),
               "plain_ms": cuda_ms(torch, run_plain, 3),
               "bound_ms": bms, "bound_by": by, "card": card}
        # every length -1: the launch, the table's staging and the
        # verdict writes, with no step of the walk
        none = torch.full_like(ln, -1)
        row["empty_ms"] = cuda_ms(torch, lambda: prog.dispatch(b, none), 50)
        if name == "grep_dfa":
            row.update(scan_global(torch, tg, prog, b, ln, plain, 50))
        else:
            row["kp"] = prog.tables["kp"].tolist()
        log("main_path_rows: " + json.dumps(row))
        want = (1, 0) if name == "grep_dfa" else (0, 1)
        if (row["mismatches"] or row.get("global_mismatches")
                or launched != want
                or not row["counts_equal_mask_sum"]
                or not 0 < row["matched_rows"] < n):
            raise SystemExit(f"{name} failed on config 1's rows: {row}")
        out.append(row)
    return out


def sketch_rows(np, seed: int, B: int):
    """[B, 256] rows from a seed: values drawn Zipf-like (s = 1.1) from a
    vocabulary of 8192 random byte strings of length 0-256 (the first 64
    all-0xFF), so that atomics collide; pad bytes past a length are left
    random, and ~2% of rows each get length -1 and -2."""
    rng = np.random.default_rng(seed)
    vocab = rng.integers(0, 256, size=(8192, SKETCH_L), dtype=np.uint8)
    vlen = rng.integers(0, SKETCH_L + 1, size=8192).astype(np.int32)
    vocab[:64] = 0xFF
    idx = (rng.zipf(1.1, size=B) - 1) % 8192
    lengths = vlen[idx]
    lengths[rng.random(B) < 0.02] = -1
    lengths[rng.random(B) < 0.02] = -2
    return vocab[idx], lengths


def sketch_bound_ms(torch, tsk, b, ln, state, weights, p=None,
                    extra_bytes: int = 0, seg=None, groups: int = 1) -> tuple:
    """Least time for one sketch update of these rows. Bytes: each row's
    bytes before its length, every length (and weight) once, and each
    state word the rows touch read once and written once (plus
    ``extra_bytes``: a sharded call's merge), over HBM's rate; K6's
    grouped form (``seg``) also reads the segment ids and the ``groups``
    array pointers once, and its rows count only where their segment
    names a group. Operations, for a row with a length: an xor and a
    multiply per byte, the finaliser (8), and for HLL index and rank
    (5), for count-min the second hash (9) and per depth row a multiply,
    an add and a modulo (3), over the int32 peak. The larger bounds
    it."""
    valid = ln >= 0
    if seg is not None:
        valid = valid & (seg >= 0) & (seg < groups)
        extra_bytes += 4 * seg.numel() + 8 * groups
    used = torch.where(valid, ln, 0).clamp(max=b.shape[1]).long()
    n_valid = int(valid.sum())
    if p is not None:
        idx, _ = tsk.hll_index_rank_plain(b, ln, p)
        if seg is not None:  # a word is a (group, register) pair
            idx = idx + (seg.long() << p)
        words = int(torch.unique(idx[valid]).numel())
        per_row = 8 + 5
    else:
        d, w = state.shape
        cols = tsk.cms_cols_plain(b, ln, d, w)
        flat = cols + (torch.arange(d, device=b.device) * w)[:, None]
        words = int(torch.unique(flat[:, valid]).numel())
        per_row = 8 + 9 + 3 * d
    nbytes = (int(used.sum()) + ln.numel() * 4
              + (0 if weights is None else weights.numel() * 4)
              + 2 * words * state.element_size() + extra_bytes)
    ops = 2 * int(used.sum()) + per_row * n_valid
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_sketch_kernels(np, torch, tsk, assemble, seed: int) -> list:
    dev = torch.device("cuda")
    cases = [("hll_update", {"p": HLL_P}), ("hll_update", {"p": 10}),
             ("cms_update", {"d": CMS_D, "w": CMS_W, "dtype": torch.int32}),
             ("cms_update", {"d": 4, "w": 512, "dtype": torch.int64}),
             ("cms_update", {"d": CMS_D, "w": CMS_W, "dtype": torch.int32,
                             "weights": True})]
    results = []
    for name, cfg in cases:
        for B in (RECORDS, 65536):
            batch, lengths = sketch_rows(np, seed + B + len(results), B)
            b = torch.from_numpy(batch).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            weights = None
            if cfg.get("weights"):
                wts = np.random.default_rng(seed).integers(-3, 1 << 16, size=B)
                weights = torch.from_numpy(wts.astype(np.int32)).to(dev)
            if name == "hll_update":
                p = cfg["p"]
                state = torch.zeros(1 << p, dtype=torch.int32, device=dev)
                kernel, plain = tsk.hll_update, tsk.hll_update_plain
                args = (b, ln, p)
                label = {"p": p}
            else:
                p = None
                state = torch.zeros((cfg["d"], cfg["w"]), dtype=cfg["dtype"],
                                    device=dev)
                kernel, plain = tsk.cms_update, tsk.cms_update_plain
                args = (b, ln, weights)
                label = {"d": cfg["d"], "w": cfg["w"],
                         "dtype": str(cfg["dtype"]).split(".")[-1],
                         "weighted": weights is not None}
            got, want = state.clone(), state.clone()
            before = kernel.launches
            kernel(got, *args)
            launches = kernel.launches - before
            plain(want, *args)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            k_ms = cuda_ms(torch, lambda: kernel(got, *args), 200)
            k_host_ms = host_ms(torch, lambda: kernel(got, *args), 200)
            p_ms = cuda_ms(torch, lambda: plain(want, *args), 5)
            bms, by = sketch_bound_ms(torch, tsk, b, ln, state, weights, p)
            res = {"kernel": name, **label, "shape": [B, SKETCH_L],
                   "launches": launches, "max_abs_err": err,
                   "rows_counted": int((ln >= 0).sum()),
                   "state_nonzero": int((want != 0).sum()), "ms": k_ms,
                   "host_enqueue_ms": k_host_ms, "plain_ms": p_ms,
                   "bound_ms": bms, "bound_by": by}
            log("sketch-vs-plain: " + json.dumps(res))
            if err != 0:
                raise SystemExit(f"{name} disagrees with its plain version: "
                                 f"{res}")
            if launches != 1 or res["state_nonzero"] == 0:
                raise SystemExit(f"{name}: bad launch or empty state: {res}")
            results.append(res)
    return (results + hll_groups_cases(np, torch, tsk, seed)
            + cms_cases(np, torch, tsk, assemble, seed))


def cms_cases(np, torch, tsk, assemble, seed: int) -> list:
    """K7 against ``cms_update_plain`` on the card, table for table, at
    4 x 16384: config 4's own ``path`` rows (its first POST, staged at
    256 B as the frequency filter stages them), unweighted and weighted;
    one value in every row, the most contended case (every live lane of
    a warp on one word of each depth row), unweighted and with weights
    from -3 up; and an int64 table whose weighted sum on that one word
    passes 2^32. With CUDA-event times, host enqueue and bound."""
    dev = torch.device("cuda")
    _bodies, _users, paths = make_posts(np, seed)
    staged = assemble(paths[:RECORDS], SKETCH_L)
    one, one_len = sketch_rows(np, seed + 11, RECORDS)
    one[:] = one[3]
    one_len[:] = 77
    one_len[::9] = -1
    rng = np.random.default_rng(seed + 7)
    small = rng.integers(-3, 1 << 16, size=RECORDS)
    large = rng.integers(-(1 << 21), 1 << 23, size=RECORDS)
    cases = [("path", staged.batch, staged.lengths, None, torch.int32),
             ("path_weighted", staged.batch, staged.lengths, small,
              torch.int32),
             ("one_value", one, one_len, None, torch.int32),
             ("one_value_weighted", one, one_len, small, torch.int32),
             ("int64_past_2_32", one, one_len, large, torch.int64)]
    results = []
    for label, batch, lengths, wts, dtype in cases:
        b = torch.from_numpy(batch).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        weights = (None if wts is None
                   else torch.from_numpy(wts.astype(np.int32)).to(dev))
        state = torch.zeros((CMS_D, CMS_W), dtype=dtype, device=dev)
        got, want = state.clone(), state.clone()
        before = tsk.cms_update.launches
        tsk.cms_update(got, b, ln, weights)
        launches = tsk.cms_update.launches - before
        tsk.cms_update_plain(want, b, ln, weights)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        bms, by = sketch_bound_ms(torch, tsk, b, ln, state, weights)
        res = {"kernel": "cms_update", "case": label, "d": CMS_D,
               "w": CMS_W, "dtype": str(dtype).split(".")[-1],
               "weighted": weights is not None, "shape": list(batch.shape),
               "launches": launches, "max_abs_err": err,
               "rows_counted": int((ln >= 0).sum()),
               "state_nonzero": int((want != 0).sum()),
               "state_max": int(want.max()),
               "ms": cuda_ms(torch, lambda: tsk.cms_update(got, b, ln,
                                                           weights), 200),
               "host_enqueue_ms": host_ms(torch, lambda: tsk.cms_update(
                   got, b, ln, weights), 200),
               "plain_ms": cuda_ms(torch, lambda: tsk.cms_update_plain(
                   want, b, ln, weights), 5),
               "bound_ms": bms, "bound_by": by}
        log("sketch-vs-plain: " + json.dumps(res))
        if err != 0 or launches != 1 or res["state_nonzero"] == 0:
            raise SystemExit(f"cms_update on {label} disagrees with its "
                             f"plain version, did not launch once or set "
                             f"nothing: {res}")
        if label == "int64_past_2_32" and res["state_max"] < 1 << 32:
            raise SystemExit(f"cms_update on {label}: no word passed 2^32: "
                             f"{res}")
        results.append(res)
    return results


def hll_groups_cases(np, torch, tsk, seed: int) -> list:
    """K6's grouped form (``hll_update_groups``) against
    ``hll_update_groups_plain`` on the card, register for register: at
    the flux wide append's shape (4096 rows of 256 B, 600 groups, p =
    12), at G = 1 (the same rows into one array), at 65536 rows, and the
    contended cases (every row in one group of 600; every row one value),
    with CUDA-event times, host enqueue and bound for the timed ones."""
    dev = torch.device("cuda")
    cases = [("wide", RECORDS, FLUX_WIDE, "cycle", True),
             ("g1", RECORDS, 1, "zeros", True),
             ("wide_65536", 65536, FLUX_WIDE, "cycle", True),
             # more groups than the kernel takes by value: a device array
             ("g2000", RECORDS, 2000, "cycle", True),
             ("one_group", RECORDS, FLUX_WIDE, "one_group", False),
             ("one_value", RECORDS, FLUX_WIDE, "one_value", False),
             ("out_of_range", RECORDS, 7, "out_of_range", False)]
    results = []
    for i, (label, B, G, kind, timed) in enumerate(cases):
        batch, lengths = sketch_rows(np, seed + 31 * i + 5, B)
        if kind == "one_value":
            batch[:] = batch[3]
            lengths[:] = 77
        rng = np.random.default_rng(seed + i)
        seg = (np.arange(B) % G if kind in ("cycle", "one_value")
               else np.zeros(B) if kind == "zeros"
               else np.full(B, G // 2) if kind == "one_group"
               else rng.integers(-3, G + 3, size=B))
        b = torch.from_numpy(batch).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        sg = torch.from_numpy(seg.astype(np.int32)).to(dev)
        start = [torch.zeros(1 << FLUX_P, dtype=torch.int32, device=dev)
                 for _ in range(G)]
        got = [r.clone() for r in start]
        want = [r.clone() for r in start]
        before = tsk.hll_update_groups.launches
        tsk.hll_update_groups(got, b, ln, sg, FLUX_P)
        launches = tsk.hll_update_groups.launches - before
        tsk.hll_update_groups_plain(want, b, ln, sg, FLUX_P)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        res = {"kernel": "hll_update_groups", "case": label, "p": FLUX_P,
               "groups": G, "shape": [B, SKETCH_L], "launches": launches,
               "max_abs_err": err, "rows_counted": int((ln >= 0).sum()),
               "state_nonzero": sum(int((w != 0).sum()) for w in want)}
        if timed:
            res["ms"] = cuda_ms(torch, lambda: tsk.hll_update_groups(
                got, b, ln, sg, FLUX_P), 200)
            res["host_enqueue_ms"] = host_ms(
                torch, lambda: tsk.hll_update_groups(got, b, ln, sg, FLUX_P),
                200)
            res["plain_ms"] = cuda_ms(torch, lambda: tsk.hll_update_groups_plain(
                want, b, ln, sg, FLUX_P), 3)
            res["bound_ms"], res["bound_by"] = sketch_bound_ms(
                torch, tsk, b, ln, start[0], None, FLUX_P, seg=sg, groups=G)
        log("sketch-vs-plain: " + json.dumps(res))
        if err != 0 or launches != 1 or res["state_nonzero"] == 0:
            raise SystemExit(f"hll_update_groups disagrees with its plain "
                             f"version, did not launch once or set nothing: "
                             f"{res}")
        results.append(res)
    return results


def zipf_choice(np, rng, n_items: int, s: float, size: int):
    """``size`` draws of an item index in [0, n_items), Zipf(s) by rank."""
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    prob = ranks ** -s
    return rng.choice(n_items, size=size, p=prob / prob.sum())


def make_posts(np, seed: int) -> tuple:
    """64 JSON-array bodies of 4096 records from a seed: ``user`` drawn
    from 120k ids, ``path`` Zipf(1.1) over 10k paths, ~2% of each value
    longer than 256 B (host-hashed overflow rows), ~3% of records
    without each field. Returns (bodies, users, paths), the field values
    as the filters see them (UTF-8 bytes, missing ones left out)."""
    rng = np.random.default_rng(seed)
    n = APPENDS * RECORDS
    users = rng.integers(0, USER_IDS, size=n)
    paths = zipf_choice(np, rng, PATHS, PATH_ZIPF_S, n)
    long_user = rng.random(n) < 0.02
    long_path = rng.random(n) < 0.02
    no_user = rng.random(n) < 0.03
    no_path = rng.random(n) < 0.03
    status = rng.choice([200, 200, 200, 304, 404, 500], size=n)
    bodies, user_vals, path_vals = [], [], []
    for a in range(APPENDS):
        recs = []
        for i in range(a * RECORDS, (a + 1) * RECORDS):
            rec = {"status": int(status[i])}
            if not no_user[i]:
                u = f"user-{users[i]:06d}"
                rec["user"] = u + "-" + "u" * 300 if long_user[i] else u
                user_vals.append(rec["user"].encode())
            if not no_path[i]:
                pth = f"/api/v1/items/{paths[i]}"
                rec["path"] = (pth + "/" + "p" * 300 + f"/{i}" if long_path[i]
                               else pth)
                path_vals.append(rec["path"].encode())
            recs.append(rec)
        bodies.append(json.dumps(recs).encode())
    return bodies, user_vals, path_vals


def run_config4(flb, device: str, bodies: list) -> dict:
    import http.client

    ctx = flb.create(device=device, flush="50ms", grace="2")
    ctx.input("http", tag="firehose", port=0, listen="127.0.0.1")
    ctx.filter("log_to_metrics", **CARDINALITY)
    ctx.filter("log_to_metrics", **FREQUENCY)
    ctx.output("prometheus_exporter", match="metrics")
    ctx.start()
    try:
        port = ctx.engine.inputs[0].plugin.bound_port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        t0 = time.perf_counter()
        for body in bodies:
            conn.request("POST", "/", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 201:
                raise SystemExit(f"config 4 on {device}: POST answered "
                                 f"{resp.status}")
        ctx.flush_now()
        wall = time.perf_counter() - t0
        conn.close()
    finally:
        ctx.stop()
    hll, cms = (f.plugin for f in ctx.engine.filters)
    return {"text": ctx.engine.outputs[0].plugin.render(), "wall": wall,
            "hll": hll, "cms": cms}


def fnv1a_mix(value: bytes) -> int:
    """FNV-1a 32 then murmur3 fmix32, from Python ints (independent of
    the port's code)."""
    h = 0x811C9DC5
    for byte in value:
        h = ((h ^ byte) * 0x01000193) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def independent_check(np, users: list, paths: list, hll, cms) -> dict:
    """The HLL registers from scratch, the estimate against the exact
    distinct count, and the count-min top 10 against the exact top 10."""
    regs = np.zeros(1 << HLL_P, dtype=np.int32)
    for v in set(users):
        h = fnv1a_mix(v)
        rest = (h << HLL_P) & 0xFFFFFFFF
        rank = min(32 - rest.bit_length() + 1, 33 - HLL_P)
        i = h >> (32 - HLL_P)
        regs[i] = max(regs[i], rank)
    distinct = len(set(users))
    est = hll.hll.estimate()
    counts = collections.Counter(paths)
    exact = counts.most_common(11)
    top = [(int(v), labels[-1].encode())
           for labels, v in cms.metric.samples()]
    slack = math.e * len(paths) / CMS_W
    res = {"registers_equal_python": bool(np.array_equal(
               regs, hll.hll.registers.cpu().numpy())),
           "distinct_users": distinct, "hll_estimate": est,
           "hll_rel_err": abs(est - distinct) / distinct,
           "top10_set_equal": ({k for _, k in top}
                               == {k for k, _ in exact[:10]}),
           "top10_exact_margin": exact[9][1] - exact[10][1],
           "top10_within_cms_bound": all(
               counts[k] <= est_k <= counts[k] + slack for est_k, k in top),
           "cms_slack": slack}
    return res


def phase_config4(np, torch, tsk, flb, seed: int, card: str,
                  sketch_results: list) -> dict:
    bodies, users, paths = make_posts(np, seed)
    n_records = APPENDS * RECORDS
    tsk.hll_update.launches = tsk.cms_update.launches = 0
    gpu = run_config4(flb, "cuda", bodies)
    launches = {"hll_update": tsk.hll_update.launches,
                "cms_update": tsk.cms_update.launches}
    cpu = run_config4(flb, "cpu", bodies)
    check = independent_check(np, users, paths, gpu["hll"], gpu["cms"])

    def p50_ms(f) -> dict:
        return {step: statistics.median(s[i] for s in f.step_seconds) * 1e3
                for i, step in enumerate(("stage", "launch", "readback"))}

    # each kernel at this path's own rows: K6 at [4096, 256], K7 on the
    # first POST's path rows
    main_ms = {"hll_update": next(
        r["ms"] for r in sketch_results if r["kernel"] == "hll_update"
        and r["shape"][0] == RECORDS and r["p"] == HLL_P),
        "cms_update": next(r["ms"] for r in sketch_results
                           if r.get("case") == "path")}
    busy_ms = sum(main_ms[k] * launches[k] for k in launches)
    res = {"records": n_records, "posts": len(bodies),
           "render_equal_cpu": gpu["text"] == cpu["text"],
           "registers_equal_cpu": torch.equal(gpu["hll"].hll.registers.cpu(),
                                              cpu["hll"].hll.registers),
           "table_equal_cpu": torch.equal(gpu["cms"].cms.table.cpu(),
                                          cpu["cms"].cms.table),
           "launches": launches, **check,
           "lines_per_s": n_records / gpu["wall"],
           "cpu_lines_per_s": n_records / cpu["wall"],
           "p50_ms_cardinality": p50_ms(gpu["hll"]),
           "p50_ms_frequency": p50_ms(gpu["cms"]),
           "cpu_p50_ms_cardinality": p50_ms(cpu["hll"]),
           "cpu_p50_ms_frequency": p50_ms(cpu["cms"]),
           "device_busy_share": busy_ms / (gpu["wall"] * 1e3), "card": card}
    log("config4: " + json.dumps(res))
    log("config4 render (cuda):\n" + gpu["text"])
    failed = [k for k in ("render_equal_cpu", "registers_equal_cpu",
                          "table_equal_cpu", "registers_equal_python",
                          "top10_set_equal", "top10_within_cms_bound")
              if not res[k]]
    if res["hll_rel_err"] > 0.03:
        failed.append("hll_rel_err")
    if res["top10_exact_margin"] <= 0:
        failed.append("top10_exact_margin")
    if launches != {"hll_update": APPENDS, "cms_update": APPENDS}:
        failed.append("launches")
    if failed:
        raise SystemExit(f"config 4 failed {failed}: {res}")
    return res


# the flux plane (FLUX.md "Worked per-tenant example"), filter defaults
FLUX_PROPS = dict(match="app.*", group_by="tenant", distinct_field="user",
                  aggregate_field="latency_ms", topk_field="endpoint",
                  topk="10", window="tumbling 60", tag="flux.tenants",
                  tick_interval_sec="3600")
FLUX_P = 12        # sketch_precision
FLUX_L = 256       # max_field_len
FLUX_TENANTS = 200
FLUX_WIDE = 600    # tenants of the extra append: above the 512-group cap
ENDPOINTS = 10_000
WINDOW_S, STEP_S = 60.0, 15.0  # one window closes every 4 appends
CLOCK0 = 1_000_000.0


def flux_case(np, torch, seed: int, B: int, G: int, F: int, comp: bool,
              L: int = FLUX_L, invalid: bool = False,
              unaligned: bool = False, contend: str = "") -> dict:
    """Flux absorb inputs on the card from a seed: segment ids Zipf(1.1)
    over G groups, F fields and the composites of ``sketch_rows`` (cut to
    width L), register stacks starting at zero. ``contend`` puts every
    row in one group ("one_group"), makes every field row one value
    ("one_value") or every composite one value ("one_composite")."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    seg = zipf_choice(np, rng, G, 1.1, B).astype(np.int32)
    if contend == "one_group":
        seg[:] = 0

    def rows(k):
        batch, lengths = sketch_rows(np, seed + k, B)
        if contend == ("one_composite" if k == 99 else "one_value"):
            batch[:] = batch[3]
            lengths[:] = 77
        if invalid:
            lengths[:] = -1
        b = torch.from_numpy(np.ascontiguousarray(batch[:, :L])).to(dev)
        if unaligned:
            flat = torch.zeros(1 + b.numel(), dtype=torch.uint8, device=dev)
            view = flat[1:].view(b.shape)
            view.copy_(b)
            b = view
        return b, torch.from_numpy(lengths).to(dev)

    fields = [rows(f + 1) for f in range(F)]
    c = cl = table = None
    if comp:
        c, cl = rows(99)
        table = torch.zeros((CMS_D, CMS_W), dtype=torch.int32, device=dev)
    return {"seg": torch.from_numpy(seg).to(dev),
            "valid": torch.ones(B, dtype=torch.int32, device=dev),
            "fields": fields, "G": G, "comp": c, "comp_len": cl,
            "table": table,
            "stacks": [torch.zeros((G, 1 << FLUX_P), dtype=torch.int32,
                                   device=dev) for _ in range(F)]}


def flux_call(fn, case: dict, stacks, table):
    return fn(case["seg"], case["valid"], case["fields"], stacks,
              case["comp"], case["comp_len"], table, hll_p=FLUX_P,
              n_seg=case["G"])


def flux_bound_ms(torch, tsk, case: dict, extra_bytes: int = 0) -> tuple:
    """Least time for one fused absorb of these rows. Bytes: each field
    and composite row's bytes before its length, every length, ``seg`` and
    ``valid`` once, the counts written once, and each register and table
    word the rows touch read once and written once (plus ``extra_bytes``:
    a sharded call's merges). Operations: per byte
    an xor and a multiply; per valid field row the finaliser and index and
    rank (13); per valid composite row the finaliser, the second hash and
    per depth row a multiply, an add and a modulo (17 + 3d); one add per
    counted row. The larger bounds it."""
    seg = case["seg"].long()
    B = seg.numel()
    nbytes = 8 * B + 4 * case["G"] + extra_bytes
    ops = int((case["valid"] != 0).sum())
    for b, ln in case["fields"]:
        ok = ln >= 0
        used = ln.clamp(min=0, max=b.shape[1]).long()
        idx, _ = tsk.hll_index_rank_plain(b, ln, FLUX_P)
        words = int(torch.unique((seg << FLUX_P)[ok] + idx[ok]).numel())
        nbytes += int(used.sum()) + 4 * B + 2 * 4 * words
        ops += 2 * int(used.sum()) + 13 * int(ok.sum())
    if case["comp"] is not None:
        c, cl = case["comp"], case["comp_len"]
        ok = cl >= 0
        used = cl.clamp(min=0, max=c.shape[1]).long()
        cols = tsk.cms_cols_plain(c, cl, CMS_D, CMS_W)
        flat = cols + (torch.arange(CMS_D, device=c.device) * CMS_W)[:, None]
        words = int(torch.unique(flat[:, ok]).numel())
        nbytes += int(used.sum()) + 4 * cl.numel() + 2 * 4 * words
        ops += 2 * int(used.sum()) + (17 + 3 * CMS_D) * int(ok.sum())
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_flux_kernels(np, torch, tsk, tfk, seed: int) -> list:
    cases = [("main", dict(B=RECORDS, G=FLUX_TENANTS, F=1, comp=True)),
             ("wide", dict(B=65536, G=512, F=1, comp=True)),
             ("all_invalid", dict(B=RECORDS, G=FLUX_TENANTS, F=1, comp=True,
                                  invalid=True)),
             ("L0", dict(B=RECORDS, G=FLUX_TENANTS, F=1, comp=True, L=0)),
             ("unaligned", dict(B=RECORDS - 3, G=FLUX_TENANTS, F=1,
                                comp=True, unaligned=True)),
             ("two_fields", dict(B=RECORDS, G=FLUX_TENANTS, F=2, comp=True)),
             ("one_group", dict(B=RECORDS, G=FLUX_TENANTS, F=1, comp=True,
                                contend="one_group")),
             ("one_value", dict(B=RECORDS, G=FLUX_TENANTS, F=1, comp=True,
                                contend="one_value")),
             ("one_composite", dict(B=RECORDS, G=FLUX_TENANTS, F=1,
                                    comp=True, contend="one_composite")),
             ("ten_fields", dict(B=RECORDS, G=FLUX_TENANTS, F=10, comp=True))]
    results = []
    for i, (label, cfg) in enumerate(cases):
        case = flux_case(np, torch, seed + 7 * i, **cfg)
        got_st = [s.clone() for s in case["stacks"]]
        want_st = [s.clone() for s in case["stacks"]]
        got_tb, want_tb = case["table"].clone(), case["table"].clone()
        before = tfk.fused_absorb.launches
        got = flux_call(tfk.fused_absorb, case, got_st, got_tb)
        launches = tfk.fused_absorb.launches - before
        want = flux_call(tfk.fused_absorb_plain, case, want_st, want_tb)
        torch.cuda.synchronize()
        err = max([int((got - want).abs().max())]
                  + [int((a - b).abs().max()) for a, b in zip(got_st, want_st)]
                  + [int((got_tb - want_tb).abs().max())])
        res = {"kernel": "fused_absorb", "case": label,
               "shape": [cfg["B"], cfg.get("L", FLUX_L)], "groups": cfg["G"],
               "fields": cfg["F"], "launches": launches, "max_abs_err": err,
               "rows_counted": int(want.sum()),
               "registers_set": sum(int((s != 0).sum()) for s in want_st),
               "table_total": int(want_tb.sum())}
        if label in ("main", "wide"):
            st, tb = [s.clone() for s in case["stacks"]], case["table"].clone()
            res["ms"] = cuda_ms(torch, lambda: flux_call(
                tfk.fused_absorb, case, st, tb), 200)
            res["host_enqueue_ms"] = host_ms(torch, lambda: flux_call(
                tfk.fused_absorb, case, st, tb), 200)
            res["plain_ms"] = cuda_ms(torch, lambda: flux_call(
                tfk.fused_absorb_plain, case, st, tb), 3)
            res["bound_ms"], res["bound_by"] = flux_bound_ms(torch, tsk, case)
        log("flux-vs-plain: " + json.dumps(res))
        # eight fields a launch: a further launch for each next eight
        want_launches = max(1, -(-cfg["F"] // tfk.FIELDS_PER_LAUNCH))
        if err != 0 or launches != want_launches:
            raise SystemExit(f"fused_absorb disagrees with its plain version "
                             f"or did not launch {want_launches} time(s): "
                             f"{res}")
        if not cfg.get("invalid") and (res["registers_set"] == 0
                                       or res["table_total"] == 0):
            raise SystemExit(f"fused_absorb: empty state: {res}")
        results.append(res)
    for i, B in enumerate((RECORDS, 65536)):
        case = flux_case(np, torch, seed + 100 + i, B, 512 if i else
                         FLUX_TENANTS, 0, False)
        seg, valid, n = case["seg"], case["valid"], case["G"]
        valid[: B // 4] = 0
        before = tfk.segment_counts.launches
        got = tfk.segment_counts(seg, valid, n)
        launches = tfk.segment_counts.launches - before
        want = tfk.segment_counts_plain(seg, valid, n)
        valid_f = valid.to(torch.float32)
        lib = torch.bincount(seg, weights=valid_f, minlength=n)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        lib_err = int((lib.to(torch.int64) - want.long()).abs().max())
        used = 8 * B + 4 * n
        bytes_ms = used / PEAK_BYTES_PER_S * 1e3
        ops_ms = int((valid != 0).sum()) / PEAK_INT32_OPS_PER_S * 1e3
        res = {"kernel": "segment_counts", "shape": [B], "groups": n,
               "launches": launches, "max_abs_err": err,
               "library_max_abs_err": lib_err,
               "ms": cuda_ms(torch, lambda: tfk.segment_counts(seg, valid, n),
                             200),
               "host_enqueue_ms": host_ms(
                   torch, lambda: tfk.segment_counts(seg, valid, n), 200),
               "plain_ms": cuda_ms(torch, lambda: tfk.segment_counts_plain(
                   seg, valid, n), 20),
               "library_ms": cuda_ms(torch, lambda: torch.bincount(
                   seg, weights=valid_f, minlength=n), 20),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        log("flux-vs-plain: " + json.dumps(res))
        if err != 0 or lib_err != 0 or launches != 1:
            raise SystemExit(f"segment_counts disagrees: {res}")
        results.append(res)
    return results


def make_flux_appends(np, seed: int) -> list:
    """64 appends of 4096 [ts, body] records from a seed, then one of 4096
    records over 600 tenants. ``tenant`` Zipf(1.1) over 200 tenants,
    ``user`` from 120k ids, ``endpoint`` Zipf(1.1) over 10k paths,
    ``latency_ms`` ~78% ints, ~20% floats, ~2% non-numeric; ~3% of records
    lack each field, ~2% of users and endpoints are longer than 256 B."""
    rng = np.random.default_rng(seed + 3)
    n = (APPENDS + 1) * RECORDS
    tenants = zipf_choice(np, rng, FLUX_TENANTS, 1.1, n)
    tenants[APPENDS * RECORDS:] = FLUX_TENANTS + np.arange(RECORDS) % FLUX_WIDE
    users = rng.integers(0, USER_IDS, size=n)
    endpoints = zipf_choice(np, rng, ENDPOINTS, 1.1, n)
    lat_kind = rng.random(n)
    lat_int = rng.integers(0, 5000, size=n)
    lat_float = rng.random(n) * 1000.0
    missing = rng.random((4, n)) < 0.03
    missing[0, APPENDS * RECORDS:] = False  # every wide record has a tenant
    long_user = rng.random(n) < 0.02
    long_endpoint = rng.random(n) < 0.02
    appends = []
    for a in range(APPENDS + 1):
        recs = []
        for i in range(a * RECORDS, (a + 1) * RECORDS):
            body = {}
            if not missing[0, i]:
                body["tenant"] = (f"tenant-{tenants[i]:03d}"
                                  if tenants[i] < FLUX_TENANTS
                                  else f"wide-{tenants[i] - FLUX_TENANTS:03d}")
            if not missing[1, i]:
                body["user"] = f"user-{users[i]:06d}" + (
                    "-" + "u" * 300 if long_user[i] else "")
            if not missing[2, i]:
                body["endpoint"] = f"/api/v1/items/{endpoints[i]}" + (
                    "/" + "p" * 300 + f"/{i}" if long_endpoint[i] else "")
            if not missing[3, i]:
                x = lat_kind[i]
                body["latency_ms"] = (int(lat_int[i]) if x < 0.78 else
                                      float(lat_float[i]) if x < 0.98
                                      else "n/a")
            recs.append([1700000000 + i * 0.001, body])
        appends.append([recs, json.dumps(recs)])
    return appends


def flux_snapshot_print(np, snap: dict) -> tuple:
    """A flux snapshot in comparable form (registers and table as bytes)."""
    def pane(items):
        return [(it["key"], it["count"], it["cols"],
                 {f: np.asarray(r).tobytes() for f, r in it["hlls"].items()})
                for it in items]
    return (pane(snap["groups"]), [pane(p) for p in snap["panes"]],
            np.asarray(snap["cms"]).tobytes(), snap["candidates"],
            snap["counters"], snap["window_start"])


def run_flux(np, torch, flb, device: str, appends: list, mesh=None) -> dict:
    """The flux pipeline on ``device``. Before append k the injected window
    clock reads CLOCK0 + 15 s * k and the filter's own tick runs (the tick
    collector waits an hour); the open window's state is snapshotted
    before each tick that closes it. ``mesh`` (a hand-built
    ``Mesh``) shards the state's absorbs."""
    out = []
    ctx = flb.create(device=device, flush="50ms", grace="2")
    in_ffd = ctx.input("lib", tag="app.web")
    ctx.filter("flux", **FLUX_PROPS)
    ctx.output("lib", match="*", callback=lambda data, tag: out.append(
        (tag, data)))
    ctx.start()
    engine = ctx.engine
    plug = engine.filters[0].plugin
    clock = [CLOCK0]
    with engine._ingest_lock:
        plug.state._now = lambda: clock[0]
        plug.state._window_start = CLOCK0
        if mesh is not None:
            plug.state._mesh = mesh
    snaps, close_s = [], []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        for k, (recs, text) in enumerate(appends):
            clock[0] = CLOCK0 + STEP_S * k
            closes = k and k % int(WINDOW_S / STEP_S) == 0
            if closes:
                with engine._ingest_lock:
                    snaps.append(plug.state.snapshot())
            t1 = time.perf_counter()
            plug._on_tick(engine)
            if closes:  # render + emit of the closed window's rows
                close_s.append(time.perf_counter() - t1)
            if ctx.push(in_ffd, text) != len(recs):
                raise SystemExit(f"flux on {device}: append {k} dropped "
                                 f"records")
        ctx.flush_now()
        wall = time.perf_counter() - t0
        plug.exporter.refresh()
        text = engine.metrics.to_prometheus()
        with engine._ingest_lock:
            snaps.append(plug.state.snapshot())
    finally:
        ctx.stop()
    drained = [c.get_bytes() for c in plug._emitter_ins.pool.drain()]
    return {"out": out, "drained": drained, "wall": wall, "snaps": snaps,
            "close": close_s, "distinct": list(plug.state.spec.distinct),
            "peak_device_mib": (torch.cuda.max_memory_allocated() / 2**20
                                if device == "cuda" else None),
            "exposition": [ln for ln in text.splitlines()
                           if "fluentbit_flux_" in ln],
            "steps": list(plug.state.step_seconds),
            "refresh": list(plug.refresh_seconds),
            "hook": hook_stats(engine, engine.filters[0])}


def hll_registers_python(np, values) -> "np.ndarray":
    regs = np.zeros(1 << FLUX_P, dtype=np.int32)
    for v in values:
        h = fnv1a_mix(v)
        rest = (h << FLUX_P) & 0xFFFFFFFF
        i = h >> (32 - FLUX_P)
        regs[i] = max(regs[i], min(32 - rest.bit_length() + 1, 33 - FLUX_P))
    return regs


def flux_independent_check(np, appends: list, windows: list, snaps: list
                           ) -> dict:
    """Each closed window's rows against plain Python folds of its records
    in record order (count, latency sum/min/max per tenant); the 5 largest
    tenants' registers against a from-scratch HLL and their estimates
    within 3 sigma of the exact distinct count; every listed top-k
    estimate between the exact cumulative count and that plus e*N/w."""
    per = int(WINDOW_S / STEP_S)
    sigma = 1.04 / math.sqrt(1 << FLUX_P)
    pair_counts: collections.Counter = collections.Counter()
    n_comp = 0
    bad, worst_z, topk_checked, fold_checked = [], 0.0, 0, 0
    for w, rows in enumerate(windows):
        recs = [body for recs, _ in appends[w * per:(w + 1) * per]
                for _ts, body in recs]
        fold: dict = {}
        users: dict = collections.defaultdict(set)
        for body in recs:
            t = body.get("tenant")
            f = fold.setdefault(t, {"count": 0, "has": False, "sum": 0.0,
                                    "min": None, "max": None})
            f["count"] += 1
            v = body.get("latency_ms")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                if not f["has"]:
                    f["has"], f["sum"], f["min"], f["max"] = True, 0.0 + v, v, v
                else:
                    f["sum"] += v
                    f["min"] = v if v < f["min"] else f["min"]
                    f["max"] = v if v > f["max"] else f["max"]
            u = body.get("user")
            if isinstance(u, str) and len(u.encode()) <= FLUX_L:
                users[t].add(u.encode())
            e = body.get("endpoint")
            if isinstance(e, str) and len(e.encode()) <= FLUX_L:
                prefix = (b"\x00" if t is None else t.encode()) + b"\x1f"
                if len(prefix) + len(e.encode()) <= FLUX_L:
                    pair_counts[(t, e)] += 1
                    n_comp += 1
        got = {r["tenant"]: r for r in rows}
        if set(got) != set(fold):
            bad.append(f"window {w}: tenants differ")
            continue
        for t, f in fold.items():
            r = got[t]
            want = (f["count"], f["sum"] if f["has"] else 0.0, f["min"],
                    f["max"])
            have = (r["count"], r["latency_ms_sum"], r["latency_ms_min"],
                    r["latency_ms_max"])
            if want != have or [type(x) for x in want] != [type(x) for x in
                                                           have]:
                bad.append(f"window {w} tenant {t}: {have} != {want}")
            fold_checked += 1
        top5 = sorted(fold, key=lambda t: -fold[t]["count"])[:5]
        regs = {it["key"]: it["hlls"]["user"] for it in snaps[w]["groups"]}
        for t in top5:
            key = (None if t is None else t.encode(),)
            if not np.array_equal(regs[key], hll_registers_python(np, users[t])):
                bad.append(f"window {w} tenant {t}: registers differ")
            exact = len(users[t])
            z = abs(got[t]["user_distinct"] - exact) / (sigma * exact)
            worst_z = max(worst_z, z)
            if z > 3:
                bad.append(f"window {w} tenant {t}: estimate "
                           f"{got[t]['user_distinct']} vs {exact} distinct")
        slack = math.e * n_comp / CMS_W
        for t, r in got.items():
            for item in r["topk"]:
                exact = pair_counts[(t, item["value"])]
                topk_checked += 1
                if not exact <= item["estimate"] <= exact + slack:
                    bad.append(f"window {w} tenant {t} {item}: exact {exact}")
    return {"windows_checked": len(windows), "groups_folded": fold_checked,
            "topk_checked": topk_checked, "worst_top5_z": worst_z,
            "failures": bad[:10], "n_failures": len(bad)}


def phase_flux(np, torch, tsk, tfk, tmesh, flb, decode_events,
               appends: list, card: str, kernel_results: list,
               sketch_results: list) -> dict:
    n_records = sum(len(r) for r, _ in appends)
    tfk.fused_absorb.launches = tfk.segment_counts.launches = 0
    tsk.hll_update.launches = tsk.cms_update.launches = 0
    tsk.hll_update_groups.launches = 0
    gpu = run_flux(np, torch, flb, "cuda", appends)
    launches = {"flux_absorb": tfk.fused_absorb.launches,
                "segment_counts": tfk.segment_counts.launches,
                "hll_update": tsk.hll_update.launches,
                "hll_update_groups": tsk.hll_update_groups.launches,
                "cms_update": tsk.cms_update.launches}
    cpu = run_flux(np, torch, flb, "cpu", appends)
    # the filter's mesh key on a hand-built 8-shard mesh of the one card
    # (flux_mesh() is None below two devices)
    tfk.fused_absorb.launches = tfk.flux_mesh_launches.launches = 0
    tsk.shard_merge.launches = 0
    meshed = run_flux(np, torch, flb, "cuda", appends, tmesh.Mesh(
        (torch.device("cuda", 0),) * MESH_N, "flux"))
    mesh_launches = {"flux_absorb": tfk.fused_absorb.launches,
                     "flux_absorb_mesh": tfk.flux_mesh_launches.launches,
                     "shard_merge": tsk.shard_merge.launches}

    def rows(run, drained=False):
        chunks = run["drained"] if drained else [
            d for t, d in run["out"] if t == "flux.tenants"]
        return [ev.body for d in chunks for ev in decode_events(d)]

    gpu_rows = rows(gpu)
    per = int(WINDOW_S / STEP_S)
    windows, i = [], 0
    for w in range(APPENDS // per):  # closed windows, in emission order
        n = len({b.get("tenant") for recs, _ in appends[w * per:(w + 1) * per]
                 for _ts, b in recs})
        windows.append(gpu_rows[i:i + n])
        i += n
    drained = rows(gpu, True)
    windows.append(drained)
    check = flux_independent_check(np, appends, windows, gpu["snaps"])
    wide_groups = len({b["tenant"] for _ts, b in appends[-1][0]})

    def p50(run) -> dict:
        keys = ("columns", "grouping", "composites", "stage", "launch",
                "commit", "numeric")
        out = {k: statistics.median(s.get(k, 0.0) for s in run["steps"]) * 1e3
               for k in keys}
        ref = run["refresh"]
        out["exporter_refresh"] = statistics.median(ref) * 1e3
        out["exporter_refresh_max"] = max(ref) * 1e3
        out["exporter_refreshes"] = len(ref)
        out["window_close_tick"] = statistics.median(run["close"]) * 1e3
        return out

    main_k10 = next(r for r in kernel_results if r.get("case") == "main")
    main_k6 = next(r for r in sketch_results if r["kernel"] == "hll_update"
                   and r["shape"][0] == RECORDS and r.get("p") == 10)
    main_k7 = next(r for r in sketch_results if r["kernel"] == "cms_update"
                   and r["shape"][0] == RECORDS and r.get("w") == CMS_W
                   and not r.get("weighted"))
    wide_k6 = next(r for r in sketch_results
                   if r["kernel"] == "hll_update_groups"
                   and r["case"] == "wide")
    busy_ms = (main_k10["ms"] * launches["flux_absorb"]
               + main_k6["ms"] * launches["hll_update"]
               + wide_k6["ms"] * launches["hll_update_groups"]
               + main_k7["ms"] * launches["cms_update"])
    # the wide append is the last absorb: its host steps, in ms
    wide_steps = {k: v * 1e3 for k, v in gpu["steps"][-1].items()}
    n_distinct = len(gpu["distinct"])
    snaps_equal = (len(gpu["snaps"]) == len(cpu["snaps"]) and all(
        flux_snapshot_print(np, a) == flux_snapshot_print(np, b)
        for a, b in zip(gpu["snaps"], cpu["snaps"])))
    mesh_snaps_equal = (len(gpu["snaps"]) == len(meshed["snaps"]) and all(
        flux_snapshot_print(np, a) == flux_snapshot_print(np, b)
        for a, b in zip(gpu["snaps"], meshed["snaps"])))
    res = {"records": n_records, "appends": len(appends),
           "windows_closed": len(windows) - 1,
           "rows": len(gpu_rows), "drained_rows": len(drained),
           "rows_equal_cpu": gpu_rows == rows(cpu),
           "drained_equal_cpu": drained == rows(cpu, True),
           "states_equal_cpu": snaps_equal,
           "exposition_equal_cpu": gpu["exposition"] == cpu["exposition"],
           "mesh_rows_equal": gpu_rows == rows(meshed),
           "mesh_drained_equal": drained == rows(meshed, True),
           "mesh_states_equal": mesh_snaps_equal,
           "mesh_launches": mesh_launches,
           "mesh_expected_launches": {
               "flux_absorb": MESH_N * APPENDS,
               "flux_absorb_mesh": MESH_N * APPENDS,
               "shard_merge": 3 * APPENDS},
           "mesh_lines_per_s": n_records / meshed["wall"],
           "exposition_lines": len(gpu["exposition"]),
           "hook": gpu["hook"], "cpu_hook": cpu["hook"],
           "mesh_hook": meshed["hook"],
           # K10 on flux's raw path: the hook's absorb_batch launches it
           "launches": launches,
           "expected_launches": {"flux_absorb": APPENDS, "hll_update": 0,
                                 "hll_update_groups": n_distinct,
                                 "cms_update": 1},
           "wide_groups": wide_groups, "wide_append_steps_ms": wide_steps,
           "cpu_wide_append_steps_ms": {
               k: v * 1e3 for k, v in cpu["steps"][-1].items()},
           **check,
           "lines_per_s": n_records / gpu["wall"],
           "cpu_lines_per_s": n_records / cpu["wall"],
           "p50_ms": p50(gpu), "cpu_p50_ms": p50(cpu),
           "peak_device_mib": gpu["peak_device_mib"],
           "device_busy_share": busy_ms / (gpu["wall"] * 1e3),
           "k10_busy_share": (main_k10["ms"] * launches["flux_absorb"]
                              / (gpu["wall"] * 1e3)), "card": card}
    log("flux: " + json.dumps(res))
    failed = [k for k in ("rows_equal_cpu", "drained_equal_cpu",
                          "states_equal_cpu", "exposition_equal_cpu",
                          "mesh_rows_equal", "mesh_drained_equal",
                          "mesh_states_equal")
              if not res[k]]
    if mesh_launches != res["mesh_expected_launches"]:
        failed.append("mesh_launches")
    # every append (the 600-tenant one included) takes the batch hook
    for h in (res["hook"], res["cpu_hook"], res["mesh_hook"]):
        if h["taken"] != len(appends) or h["declines"]:
            failed.append("hook")
    if check["n_failures"]:
        failed.append("independent_check")
    # the wide append (600 groups) takes one grouped K6 per distinct
    # field, never the one-array form
    if (launches["flux_absorb"] != APPENDS
            or launches["hll_update"] != 0
            or launches["hll_update_groups"] != n_distinct
            or n_distinct < 1
            or launches["cms_update"] != 1 or wide_groups <= 512):
        failed.append("launches")
    if failed:
        raise SystemExit(f"flux failed {failed}: {res}")
    return res


# ---------------------------------------------------------------------------
# phases 14-16: the mesh programs (the shard merge, K8, the mesh halves
# of K9 and K10) and flux's SQL mode through the stream processor
# ---------------------------------------------------------------------------

MESH_N = 8  # the hand-built mesh of the SQL and flux-filter mesh runs
MESH_SHARDS = (1, 2, MESH_N)
SQL = ("CREATE STREAM tenants WITH (tag='flux.tenants'{opts}) AS "
       "SELECT tenant, COUNT(*), COUNT(DISTINCT user) AS uniq, "
       "AVG(latency_ms) FROM TAG:'app.*' WINDOW TUMBLING (60 SECOND) "
       "GROUP BY tenant;")


@contextlib.contextmanager
def plain_versions(tsk, tfk):
    """The sharded programs with every kernel they call swapped for its
    plain version, on the same card tensors, while the block runs."""
    saved = [(m, name, getattr(m, name)) for m, name in (
        (tsk, "hll_update"), (tsk, "cms_update"), (tsk, "shard_merge"),
        (tfk, "fused_absorb"), (tfk, "segment_counts"),
        (tfk, "shard_merge"))]
    tsk.hll_update = tsk.hll_update_plain
    tsk.cms_update = tsk.cms_update_plain
    tsk.shard_merge = tfk.shard_merge = tsk.shard_merge_plain
    tfk.fused_absorb = tfk.fused_absorb_plain
    tfk.segment_counts = tfk.segment_counts_plain
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def merge_bytes(n: int, base) -> int:
    """One merge's bytes: the n partials and the base read once, the base
    written once."""
    return (n + 2) * base.numel() * base.element_size()


def max_err(got: list, want: list) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def sharded_case(torch, tsk, tfk, program: str, n: int, shape: list, calls,
              counters: dict, expected: dict, bound: tuple,
              iters: int = 50) -> dict:
    """One sharded program at n shards: ``calls`` gives (sharded, unsharded,
    timed_unsharded), the first two returning fresh result tensors. The
    sharded result must equal the same sharded call with the plain
    versions on the card and the unsharded kernel, bit for bit; its
    launches are counted; the three are timed with CUDA events."""
    sharded, unsharded, timed_unsharded = calls
    before = {k: c.launches for k, c in counters.items()}
    got = sharded()
    torch.cuda.synchronize()
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    with plain_versions(tsk, tfk):
        plain = sharded()
        plain_ms = cuda_ms(torch, sharded, 3)
    want = unsharded()
    torch.cuda.synchronize()
    res = {"program": program, "shards": n, "shape": shape,
           "launches": launches, "expected_launches": expected,
           "max_abs_err": max(max_err(got, plain), max_err(got, want)),
           "max_abs_err_plain": max_err(got, plain),
           "max_abs_err_unsharded": max_err(got, want),
           "ms": cuda_ms(torch, sharded, iters),
           "host_enqueue_ms": host_ms(torch, sharded, iters),
           "plain_ms": plain_ms,
           "unsharded_ms": cuda_ms(torch, timed_unsharded, 200),
           "bound_ms": bound[0], "bound_by": bound[1]}
    log("mesh-sketch: " + json.dumps(res))
    if res["max_abs_err"] != 0 or launches != expected:
        raise SystemExit(f"{program} over {n} shards disagrees or launched "
                         f"wrongly: {res}")
    return res


def phase_merge_kernel(torch, tsk, seed: int) -> list:
    """The shard merge alone at its largest operand, 8 partial register
    stacks of 512 groups x 4096 int32, against its plain version and one
    PyTorch call over the partials (``amax`` / ``sum``)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    parts = torch.randint(0, 30, (MESH_N, 512, 1 << FLUX_P), generator=gen,
                          dtype=torch.int32, device=dev)
    base = torch.randint(0, 30, (512, 1 << FLUX_P), generator=gen,
                         dtype=torch.int32, device=dev)
    results = []
    for op, library in (("max", lambda: parts.amax(0)),
                        ("add", lambda: parts.sum(0, dtype=torch.int32))):
        got, want = base.clone(), base.clone()
        before = tsk.shard_merge.launches
        tsk.shard_merge(parts, got, op)
        launches = tsk.shard_merge.launches - before
        tsk.shard_merge_plain(parts, want, op)
        lib = (torch.maximum(base, library()) if op == "max"
               else base + library())

        def same_function(out, op=op, library=library):
            """The merge's own function from PyTorch calls, in place: no
            single call computes it (``amax`` / ``sum`` leave the base
            out), so this is the yardstick, two calls."""
            if op == "max":
                return torch.maximum(out, library(), out=out)
            return torch.add(out, library(), out=out)

        yard = base.clone()
        same_function(yard)
        torch.cuda.synchronize()
        res_yard_err = max_err([yard], [want])
        res = {"kernel": "shard_merge", "op": op,
               "shape": [MESH_N, 512, 1 << FLUX_P], "launches": launches,
               "max_abs_err": max_err([got], [want]),
               "library_max_abs_err": max_err([lib], [want]),
               "ms": cuda_ms(torch, lambda: tsk.shard_merge(parts, got, op),
                             200),
               "host_enqueue_ms": host_ms(
                   torch, lambda: tsk.shard_merge(parts, got, op), 200),
               "plain_ms": cuda_ms(
                   torch, lambda: tsk.shard_merge_plain(parts, want, op), 20),
               "partials_only_ms": cuda_ms(torch, library, 200),
               "same_function_ms": cuda_ms(torch, lambda: same_function(
                   yard), 200),
               "bound_ms": merge_bytes(MESH_N, base) / PEAK_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        res["same_function_max_abs_err"] = res_yard_err
        log("merge-vs-plain: " + json.dumps(res))
        if (res["max_abs_err"] or res["library_max_abs_err"] or res_yard_err
                or launches != 1):
            raise SystemExit(f"shard_merge disagrees: {res}")
        results.append(res)
    return results


def phase_mesh_sketch(np, torch, tsk, tfk, tmesh, assemble, seed: int) -> list:
    """K8 at config 4's widths (HLL p = 14 over 4096 ``user`` rows,
    count-min 4 x 16384 int32 over 4096 ``path`` rows), K9's mesh half
    over [4096] and [65536] rows of 200 segments, and K10's mesh half at
    flux's [4096, 256] (200 groups) and [65536, 256] (512 groups), one
    field plus composites, each over ``Mesh((cuda:0,) * n)``, n = 1, 2,
    8."""
    dev = torch.device("cuda", 0)
    torch.manual_seed(seed)
    _bodies, users, paths = make_posts(np, seed)
    rows = {}
    for name, vals in (("user", users), ("path", paths)):
        st = assemble(vals[:RECORDS], SKETCH_L)
        rows[name] = (torch.from_numpy(st.batch).to(dev),
                      torch.from_numpy(st.lengths).to(dev))
    hll = tsk.HyperLogLog(HLL_P, dev)
    hll.registers.random_(0, 4)
    cms = tsk.CountMin(CMS_D, CMS_W, dev)
    cms.table.random_(0, 1 << 20)
    k10 = {B: flux_case(np, torch, seed + B, B, G, 1, True)
           for B, G in ((RECORDS, FLUX_TENANTS), (65536, 512))}
    k9 = {}
    for B in (RECORDS, 65536):
        case = flux_case(np, torch, seed + 1 + B, B, FLUX_TENANTS, 0, False)
        case["valid"][: B // 4] = 0
        k9[B] = case
    results = []
    for n in MESH_SHARDS:
        mesh = tmesh.Mesh((dev,) * n, "flux")
        b, ln = rows["user"]

        def hll_once():
            r = hll.registers.clone()
            tsk.hll_update(r, b, ln, HLL_P)
            return [r]

        results.append(sharded_case(
            torch, tsk, tfk, "hll", n, [RECORDS, SKETCH_L],
            (lambda: [tsk.sharded_hll_registers(hll, mesh, b, ln)], hll_once,
             lambda: tsk.hll_update(hll.registers.clone(), b, ln, HLL_P)),
            {"hll_mesh": tsk.hll_mesh, "hll_update": tsk.hll_update,
             "shard_merge": tsk.shard_merge},
            {"hll_mesh": n, "hll_update": n, "shard_merge": 1},
            sketch_bound_ms(torch, tsk, b, ln, hll.registers, None, HLL_P,
                            merge_bytes(n, hll.registers))))
        pb, pln = rows["path"]

        def cms_once():
            t = cms.table.clone()
            tsk.cms_update(t, pb, pln)
            return [t]

        results.append(sharded_case(
            torch, tsk, tfk, "cms", n, [RECORDS, SKETCH_L],
            (lambda: [tsk.sharded_cms_table(cms, mesh, pb, pln)], cms_once,
             lambda: tsk.cms_update(cms.table.clone(), pb, pln)),
            {"cms_mesh": tsk.cms_mesh, "cms_update": tsk.cms_update,
             "shard_merge": tsk.shard_merge},
            {"cms_mesh": n, "cms_update": n, "shard_merge": 1},
            sketch_bound_ms(torch, tsk, pb, pln, cms.table, None, None,
                            merge_bytes(n, cms.table))))
        for B, case in k9.items():
            seg, valid, G = case["seg"], case["valid"], case["G"]
            counts0 = torch.zeros(G, dtype=torch.int32, device=dev)
            nbytes = 8 * B + 4 * G + merge_bytes(n, counts0)
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = int((valid != 0).sum()) / PEAK_INT32_OPS_PER_S * 1e3
            res = sharded_case(
                torch, tsk, tfk, "segment_counts", n, [B],
                (lambda: [tfk.sharded_segment_counts(mesh, seg, valid, G)],
                 lambda: [tfk.segment_counts(seg, valid, G)],
                 lambda: tfk.segment_counts(seg, valid, G)),
                {"flux_mesh": tfk.flux_mesh_launches,
                 "segment_counts": tfk.segment_counts,
                 "shard_merge": tsk.shard_merge},
                {"flux_mesh": n, "segment_counts": n, "shard_merge": 1},
                (max(bytes_ms, ops_ms),
                 "bytes" if bytes_ms >= ops_ms else "operations"))
            valid_f = valid.to(torch.float32)
            res["library_ms"] = cuda_ms(torch, lambda: torch.bincount(
                seg, weights=valid_f, minlength=G), 20)
            results.append(res)
        for B, case in k10.items():
            G = case["G"]

            def fresh(case=case):
                return ([s.clone() for s in case["stacks"]],
                        case["table"].clone())

            def sharded(case=case):
                st, tb = fresh()
                counts = tfk.sharded_fused_absorb(
                    mesh, case["seg"], case["valid"], case["fields"], st,
                    case["comp"], case["comp_len"], tb, hll_p=FLUX_P,
                    n_seg=case["G"])
                return [counts, *st, tb]

            def unsharded(case=case):
                st, tb = fresh()
                return [flux_call(tfk.fused_absorb, case, st, tb), *st, tb]

            st_t, tb_t = fresh()
            extra = (merge_bytes(n, torch.empty(G, dtype=torch.int32))
                     + merge_bytes(n, case["stacks"][0])
                     + merge_bytes(n, case["table"]))
            results.append(sharded_case(
                torch, tsk, tfk, "fused_absorb", n, [B, FLUX_L],
                (sharded, unsharded,
                 lambda case=case: flux_call(tfk.fused_absorb, case, st_t,
                                             tb_t)),
                {"flux_mesh": tfk.flux_mesh_launches,
                 "fused_absorb": tfk.fused_absorb,
                 "shard_merge": tsk.shard_merge},
                {"flux_mesh": n, "fused_absorb": n, "shard_merge": 3},
                flux_bound_ms(torch, tsk, case, extra), iters=20))
            results[-1]["groups"] = G
    return results


def run_sql(np, torch, flb, decode_events, device: str, appends: list,
            exact: bool = False, mesh=None) -> dict:
    """FLUX.md's per-tenant SQL through ``ctx.sp_task`` on ``device`` (lib
    input under ``app.web`` → the stream processor → its rows under
    ``flux.tenants`` → lib output). ``exact`` pins the exact path
    (``WITH (flux='off')``); ``mesh`` shards the state's absorbs. Before
    append k the injected window clock reads CLOCK0 + 15 s * k and the
    task ticks (the SP's own collector waits an hour); the state is
    snapshotted before each tick that closes a window."""
    out = []
    ctx = flb.create(device=device, flush="50ms", grace="2")
    in_ffd = ctx.input("lib", tag="app.web")
    ctx.output("lib", match="flux.tenants",
               callback=lambda data, tag: out.append(data))
    task = ctx.sp_task(SQL.format(opts=", flux='off'" if exact else ""))
    engine = ctx.engine
    engine.sp.emitter_instance.plugin.collect_interval = 3600
    clock = [CLOCK0]
    task._now = lambda: clock[0]
    task._window_start = CLOCK0
    state = None if task.flux is None else task.flux.state
    if state is not None:
        state._now = task._now
        state._window_start = CLOCK0
        if mesh is not None:
            state._mesh = mesh
    per = int(WINDOW_S / STEP_S)
    snaps = []
    ctx.start()
    try:
        t0 = time.perf_counter()
        for k, (recs, text) in enumerate(appends):
            clock[0] = CLOCK0 + STEP_S * k
            with engine._ingest_lock:
                if k and k % per == 0 and state is not None:
                    snaps.append(state.snapshot())
                task.tick()
            if ctx.push(in_ffd, text) != len(recs):
                raise SystemExit(f"sql on {device}: append {k} dropped "
                                 f"records")
        ctx.flush_now()
        wall = time.perf_counter() - t0
        if state is not None:
            with engine._ingest_lock:
                snaps.append(state.snapshot())
    finally:
        ctx.stop()  # drains the open window through the pipeline
    hidden = [f for f in engine.filters
              if getattr(f, "_flux_sql_hidden", False)]
    return {"rows": [ev.body for d in out for ev in decode_events(d)],
            "wall": wall, "snaps": snaps,
            "spec_mesh": None if state is None else state.spec.mesh,
            "hook": hook_stats(engine, hidden[0]) if hidden else None}


def sql_check(np, tsk, appends: list, flux_rows: list, exact_rows: list
              ) -> dict:
    """Each window's flux-backed rows against plain Python folds of its
    records in record order (COUNT(*), AVG(latency_ms): the sum of the
    numeric values from 0.0 over the group's count) and against the
    exact path's rows. The exact path's ``uniq`` must be the fold's
    distinct user count. The flux-backed ``uniq`` must equal the
    estimate of registers built from scratch over the tenant's users of
    <= 256 B, and lie within max(3, 10%) of the exact distinct count of
    those users: values longer than ``flux_max_len`` are missing to the
    flux plane by design (FLUX.md), while the exact path counts them
    (~2% of users here)."""
    per = int(WINDOW_S / STEP_S)
    bad, i, j, checked, worst = [], 0, 0, 0, 0.0
    for w in range(len(appends) // per):
        fold, users = {}, collections.defaultdict(set)
        every_user = collections.defaultdict(set)
        for recs, _ in appends[w * per:(w + 1) * per]:
            for _ts, body in recs:
                t = body.get("tenant")
                f = fold.setdefault(t, [0, 0.0])
                f[0] += 1
                v = body.get("latency_ms")
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    f[1] = f[1] + v
                u = body.get("user")
                if u is not None:
                    every_user[t].add(u)
                if isinstance(u, str) and len(u.encode()) <= FLUX_L:
                    users[t].add(u.encode())
        got = flux_rows[i:i + len(fold)]
        exact = exact_rows[j:j + len(fold)]
        i += len(fold)
        j += len(fold)
        if [r["tenant"] for r in got] != list(fold) or \
                [r["tenant"] for r in exact] != list(fold):
            bad.append(f"window {w}: tenants differ")
            continue
        for r, e in zip(got, exact):
            t = r["tenant"]
            count, total = fold[t]
            want = (count, total / count)
            have = (r["COUNT(*)"], r["AVG(latency_ms)"])
            if have != want or (e["COUNT(*)"], e["AVG(latency_ms)"]) != want \
                    or type(have[1]) is not float:
                bad.append(f"window {w} tenant {t}: {have} / "
                           f"{e['COUNT(*)']}, {e['AVG(latency_ms)']} != "
                           f"{want}")
            est = int(round(tsk.estimate_registers(
                hll_registers_python(np, users[t]))))
            if r["uniq"] != est:
                bad.append(f"window {w} tenant {t}: uniq {r['uniq']} != "
                           f"from-scratch {est}")
            if e["uniq"] != len(every_user[t]):
                bad.append(f"window {w} tenant {t}: exact uniq {e['uniq']} "
                           f"!= {len(every_user[t])}")
            exact = len(users[t])
            dev = abs(r["uniq"] - exact)
            worst = max(worst, dev / max(1, exact))
            if dev > max(3.0, 0.10 * exact):
                bad.append(f"window {w} tenant {t}: uniq {r['uniq']} vs "
                           f"exact {exact} of <= {FLUX_L} B")
            checked += 1
    complete = i == len(flux_rows) and j == len(exact_rows)
    if not complete:
        bad.append(f"rows left over: {len(flux_rows) - i} flux, "
                   f"{len(exact_rows) - j} exact")
    return {"windows_checked": len(appends) // per, "groups_checked": checked,
            "worst_uniq_rel_dev": worst, "failures": bad[:10],
            "n_failures": len(bad)}


def phase_sql(np, torch, tsk, tfk, tmesh, flb, decode_events,
              appends: list, card: str) -> dict:
    """Flux's SQL mode: (a) flux-backed on cuda, (b) the same with
    ``FBTPU_FLUX_MESH=1`` and the state on a hand-built 8-shard mesh of
    the card, (c) flux-backed on cpu, (d) the exact path on cuda."""
    n_records = sum(len(r) for r, _ in appends)
    counters = {"flux_absorb": tfk.fused_absorb,
                "flux_absorb_mesh": tfk.flux_mesh_launches,
                "shard_merge": tsk.shard_merge}
    runs, launches = {}, {}
    for name, device, exact, mesh in (
            ("cuda", "cuda", False, None),
            ("cuda_mesh", "cuda", False,
             tmesh.Mesh((torch.device("cuda", 0),) * MESH_N, "flux")),
            ("cpu", "cpu", False, None), ("exact", "cuda", True, None)):
        for c in counters.values():
            c.launches = 0
        if mesh is not None:
            os.environ["FBTPU_FLUX_MESH"] = "1"
        try:
            runs[name] = run_sql(np, torch, flb, decode_events, device,
                                 appends, exact, mesh)
        finally:
            os.environ.pop("FBTPU_FLUX_MESH", None)
        launches[name] = {k: c.launches for k, c in counters.items()}
    expected = {"cuda": {"flux_absorb": APPENDS, "flux_absorb_mesh": 0,
                         "shard_merge": 0},
                # the query has no top-k: merges of the counts and the
                # one register stack
                "cuda_mesh": {"flux_absorb": MESH_N * APPENDS,
                              "flux_absorb_mesh": MESH_N * APPENDS,
                              "shard_merge": 2 * APPENDS},
                "cpu": dict.fromkeys(counters, 0),
                "exact": dict.fromkeys(counters, 0)}
    prints = {name: [flux_snapshot_print(np, s) for s in runs[name]["snaps"]]
              for name in ("cuda", "cuda_mesh", "cpu")}
    check = sql_check(np, tsk, appends, runs["cuda"]["rows"],
                      runs["exact"]["rows"])
    res = {"records": n_records, "appends": len(appends),
           "rows": len(runs["cuda"]["rows"]),
           "rows_equal_mesh": runs["cuda"]["rows"] == runs["cuda_mesh"]["rows"],
           "rows_equal_cpu": runs["cuda"]["rows"] == runs["cpu"]["rows"],
           "states_equal_mesh": prints["cuda"] == prints["cuda_mesh"],
           "states_equal_cpu": prints["cuda"] == prints["cpu"],
           "snapshots": len(prints["cuda"]),
           "mesh_spec": runs["cuda_mesh"]["spec_mesh"],
           "launches": launches, "expected_launches": expected, **check,
           # the hidden flux filter's batch hook (the exact run has none)
           "hooks": {name: run["hook"] for name, run in runs.items()},
           **{f"{name}_lines_per_s": n_records / run["wall"]
              for name, run in runs.items()}, "card": card}
    log("sql: " + json.dumps(res))
    failed = [k for k in ("rows_equal_mesh", "rows_equal_cpu",
                          "states_equal_mesh", "states_equal_cpu",
                          "mesh_spec") if not res[k]]
    if check["n_failures"]:
        failed.append("check")
    if launches != expected:
        failed.append("launches")
    if res["hooks"]["exact"] is not None or any(
            h["taken"] != len(appends) or h["declines"]
            for name, h in res["hooks"].items() if name != "exact"):
        failed.append("hooks")
    if failed:
        raise SystemExit(f"sql failed {failed}: {res}")
    return res


# ---------------------------------------------------------------------------
# phases 9 and 10: K4 and config 3
# ---------------------------------------------------------------------------

MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec"]
# programs and messages that no config 3 rule matches (CRON and
# systemd-logind are near misses of the cron[N] and systemd[1] rules)
QUIET = [("dhclient", "DHCPACK from 10.0.{a}.{b} (xid=0x{x:08x})"),
         ("postfix/qmgr", "{x:X}: from=<u{a}@example.org>, size={b}, "
                          "nrcpt=1 (queue active)"),
         ("systemd-logind", "New session {a} of user u{b}."),
         ("CRON", "pam_unix(cron:session): session opened for user root"),
         ("dbus-daemon", "[system] Successfully activated service "
                         "'org.freedesktop.u{a}'"),
         ("rsyslogd", "action 'action-{a}' resumed (module "
                      "'builtin:omfwd')")]
# (share, program, message): the rules' traffic, then lines two rules
# match (the first rule in order wins)
LOUD = [(0.12, "sshd", "Accepted publickey for u{a} from 10.1.{b}.7 port "
                       "{x} ssh2"),
        (0.10, "kernel", "[{x}.{a:03d}] eth{b}: link up"),
        (0.08, "systemd", "Started Session {a} of user u{b}."),
        (0.05, "app", "ERROR request {x} failed: upstream reset"),
        (0.06, "app", "WARN slow request {x} took {a} ms"),
        (0.10, "nginx", "10.2.{a}.{b} GET /api/v{b}/items/{x} 200"),
        (0.06, "cron", "(root) CMD (run-parts /etc/cron.hourly)"),
        (0.01, "oomd", "memory pressure: OOM score of {x} adjusted"),
        (0.005, "sshd", "error: ERROR reading from socket {x}"),
        (0.005, "nginx", "WARN upstream 10.3.{a}.{b} timed out"),
        (0.005, "kernel", "Out of memory: OOM killer took pid {x}"),
        (0.005, "cron", "ERROR job {x} exited 1")]


def syslog_line(rng: random.Random, i: int) -> bytes:
    """``Mon dd HH:MM:SS host prog[pid]: msg``, 60-300 B (~1% longer than
    512 B), ~0.5% with invalid UTF-8, ~3% ending in CR (a CRLF file)."""
    x = rng.random()
    prog, msg = None, None
    for share, p, m in LOUD:
        if x < share:
            prog, msg = p, m
            break
        x -= share
    if prog is None:
        prog, msg = rng.choice(QUIET)
    a, b, big = rng.randrange(1000), rng.randrange(256), rng.randrange(1 << 31)
    msg = msg.format(a=a, b=b, x=big)
    tag = {"systemd": "systemd[1]", "kernel": "kernel"}.get(
        prog, f"{prog}[{rng.randrange(2, 65536)}]")
    line = (f"{MONTHS[i // 22000 % 12]} {1 + i // 1000 % 28:2d} "
            f"{i // 3600 % 24:02d}:{i // 60 % 60:02d}:{i % 60:02d} "
            f"host{rng.randrange(40):02d} {tag}: {msg}").encode()
    target = (rng.randrange(520, 900) if rng.random() < 0.01
              else rng.randrange(60, 301))
    while len(line) < target:
        line += f" k{rng.randrange(100)}=v{rng.randrange(10 ** 6)}".encode()
    if rng.random() < 0.005:
        cut = rng.randrange(40, len(line))
        line = line[:cut] + rng.choice([b"\xff\xfe", b"\xc3", b"\xed\xa0\x80"]) \
            + line[cut:]
    if rng.random() < 0.03:
        line += b"\r"
    return line


def syslog_corpus(seed: int, n: int) -> bytes:
    rng = random.Random(seed)
    return b"\n".join(syslog_line(rng, i) for i in range(n)) + b"\n"


def tail_texts(data: bytes) -> list:
    """The record texts in_tail makes of a file: lines without CR,
    UTF-8 decoded with replacement, empty lines skipped."""
    out = []
    for raw in data.split(b"\n"):
        text = raw.rstrip(b"\r").decode("utf-8", "replace")
        if text:
            out.append(text)
    return out


def tail_append_sizes(data: bytes) -> list:
    """Records of each in_tail append of this file read from the head:
    one append per 64 KiB read, of the lines that read completes."""
    sizes, pending = [], b""
    for off in range(0, len(data), 65536):
        lines = (pending + data[off:off + 65536]).split(b"\n")
        pending = lines.pop()
        n = sum(1 for ln in lines if ln.rstrip(b"\r"))
        if n:
            sizes.append(n)
    return sizes


def config3_routing(texts: list) -> dict:
    """tag -> bodies: each line under the tag of the first rule whose
    Python regex finds it, else under ``syslog``, in file order."""
    out: dict = {}
    for text in texts:
        tag = next((t for (_, t), rx in zip(CONFIG3_RULES, CONFIG3_PY)
                    if rx.search(text)), "syslog")
        out.setdefault(tag, []).append({"log": text})
    return out


def syslog_rows(np, seed: int, R: int, B: int, width: int = L):
    """[R, B, width] rows of syslog lines as rewrite_tag stages them (the
    same field for every rule), with every length class (-1, -2, 0,
    width) at the front and scattered."""
    rng = random.Random(seed)
    batch = np.zeros((B, width), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for b in range(B):
        text = tail_texts(syslog_line(rng, b))[0].encode()
        if len(text) > width:
            lengths[b] = -2
            continue
        batch[b, :len(text)] = np.frombuffer(text, np.uint8)
        lengths[b] = len(text)
    special = np.array([-1, -2, 0, width], dtype=np.int32)
    lengths[:len(special)] = special[:B]
    lengths[100::997] = -1
    lengths[101::997] = 0
    if width >= 16:
        batch[3, :width] = np.frombuffer((b"sshd WARN " * width)[:width],
                                         np.uint8)
    return np.stack([batch] * R), np.stack([lengths] * R)


def leaf_calls(tg, prog, b, ln, kernel: str) -> list:
    """One call per k-group of ``prog`` on its own rows: K4's wrapper,
    K3's wrapper on the same tables, or K4's plain version."""
    calls = []
    for leaf, bb, ll in leaves(prog, b, ln):
        if kernel == "assoc":
            calls.append(lambda lf=leaf, bb=bb, ll=ll: tg.grep_assoc(
                lf.tables, bb, ll, lf.k, lf.max_states, lf.segment))
        elif kernel == "scan":
            calls.append(lambda lf=leaf, bb=bb, ll=ll: tg.grep_dfa(
                lf.tables, bb, ll, lf.k))
        else:
            calls.append(lambda lf=leaf, bb=bb, ll=ll: tg.match_assoc_plain(
                lf.tables, bb, ll, lf.k, lf.max_states, lf.segment))
    return calls


def merged(torch, prog, parts):
    if prog._children is None:
        return parts[0]
    return torch.cat(parts, dim=0).index_select(0, prog._inv_perm)


def phase_assoc_kernels(np, torch, tg, compile_dfa, seed: int) -> list:
    """K4 against its plain version and K3 on the card: config 3's three
    child programs at one tail read ([8, 512, 512] and the staged bucket
    [8, 1024, 512]) and at [8, 65536, 512], segments 2, 8, 32 and 1024;
    the GET/DENY and Exclude programs; the out-of-row program; an L = 0
    batch, an unaligned view, and rows to 4096 B (a user's
    ``tpu_max_record_len``; K4's shared memory does not grow with L)."""
    dev = torch.device("cuda")
    cases = [("config3", CONFIG3, 512, L, 32),
             ("config3", CONFIG3, TAIL_BUCKET, L, 32),
             ("config3", CONFIG3, 65536, L, 32),
             ("config3", CONFIG3, TAIL_BUCKET, L, 2),
             ("config3", CONFIG3, TAIL_BUCKET, L, 8),
             ("config3", CONFIG3, TAIL_BUCKET, L, 1024),
             ("even_k_literals", EVEN_K, RECORDS, L, 32),
             ("exclude", [EXCLUDE], RECORDS, L, 32),
             ("out_of_row", OUT_OF_ROW, RECORDS, L, 32),
             ("config3_L0", CONFIG3, 300, 0, 32),
             ("config3_unaligned", CONFIG3, 300, L, 8),
             ("config3_wide", CONFIG3, 256, 4096, 32)]
    results = []
    for name, patterns, B, width, segment in cases:
        dfas = [compile_dfa(p) for p in patterns]
        R = len(patterns)
        prog = tg.TorchGrepProgram(dfas, width, dev, kernel="assoc",
                                   segment=segment)
        scan = tg.TorchGrepProgram(dfas, width, dev, kernel="scan")
        if patterns in (EVEN_K, [EXCLUDE]):
            batch, lengths = make_rows(np, seed + B + R, R, B)
        else:
            batch, lengths = syslog_rows(np, seed + B + segment, R, B, width)
        if name == "out_of_row":
            for i, text in enumerate([b"aaaaaaaaaaaa x12y", b"xWARN",
                                      b"x7y aaaaaaaaa"] * 20):
                batch[:, 200 + i] = 0
                batch[:, 200 + i, :len(text)] = np.frombuffer(text, np.uint8)
                lengths[:, 200 + i] = len(text)
        if name == "config3_wide":
            # the lines pushed far into the row: the rules' words fall in
            # the walk's later windows
            for i in range(8, B, 3):
                n = int(lengths[0, i])
                if n > 0:
                    pad = (i * 37) % (width - n)
                    line = batch[:, i, :n].copy()
                    batch[:, i, :pad] = ord(".")
                    batch[:, i, pad:pad + n] = line
                    lengths[:, i] = pad + n
        b = torch.from_numpy(batch).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        if name == "config3_unaligned":
            flat = torch.zeros(1 + b.numel(), dtype=torch.uint8, device=dev)
            b = flat[1:].view(b.shape)
            b.copy_(torch.from_numpy(batch))
        before = (tg.grep_assoc.launches, tg.grep_dfa.launches)
        got = prog.dispatch(b, ln)
        launches = tg.grep_assoc.launches - before[0]
        scan_launches = tg.grep_dfa.launches - before[1]
        plain = merged(torch, prog,
                       [c() for c in leaf_calls(tg, prog, b, ln, "plain")])
        k3 = scan.dispatch(b, ln)
        torch.cuda.synchronize()
        mism = int((got != plain).sum())
        err = int((got.int() - plain.int()).abs().max()) if got.numel() else 0
        k3_mism = int((got != k3).sum())
        k4 = leaf_calls(tg, prog, b, ln, "assoc")
        k3c = leaf_calls(tg, scan, b, ln, "scan")
        pl = leaf_calls(tg, prog, b, ln, "plain")
        iters = 5 if B >= 65536 else 30
        res = {"program": name, "shape": [R, B, width], "segment": segment,
               "k_groups": prog.decision()["k_groups"],
               "max_states": [leaf.max_states for leaf in
                              prog._children or [prog]],
               "launches": launches, "scan_launches": scan_launches,
               "mismatches": mism, "max_abs_err": err,
               "k3_mismatches": k3_mism, "matched_rows": int(got.sum())}
        if name in ("config3_L0",):
            res.update(ms=None, host_enqueue_ms=None, plain_ms=None,
                       k3_ms=None, bound_ms=None, bound_by=None)
        else:
            res["ms"] = cuda_ms(torch, lambda: [c() for c in k4], iters)
            res["host_enqueue_ms"] = host_ms(torch, lambda: [c() for c in k4],
                                             iters)
            res["plain_ms"] = cuda_ms(torch, lambda: [c() for c in pl], 2)
            res["k3_ms"] = cuda_ms(torch, lambda: [c() for c in k3c], iters)
            none = torch.full_like(ln, -1)
            k4_none = leaf_calls(tg, prog, b, none, "assoc")
            res["empty_ms"] = cuda_ms(torch, lambda: [c() for c in k4_none],
                                      iters)
            res["kp"] = [leaf.tables["kp"].tolist()
                         for leaf in prog._children or [prog]]
            res["bound_ms"], res["bound_by"] = bound_ms(
                torch, prog, b, ln, table_bytes_read(torch, tg, prog, b, ln))
        log("assoc-vs-plain: " + json.dumps(res))
        if mism or k3_mism:
            raise SystemExit(f"grep_assoc disagrees on {name} {[R, B, width]}"
                             f" segment {segment}: {mism} rows vs plain, "
                             f"{k3_mism} vs the scan")
        if launches != len(res["k_groups"]) or scan_launches:
            raise SystemExit(f"{name}: {launches} K4 and {scan_launches} K3 "
                             f"launches for {len(res['k_groups'])} k-groups")
        if width and not 0 < res["matched_rows"] < R * B:
            raise SystemExit(f"degenerate verdicts on {name}: {res}")
        results.append(res)
    return results


def hook_stats(engine, fi) -> dict:
    """The raw path's batch hook of filter instance ``fi``: the appends it
    took, the declines counted against it, the p50 of its per-append wall
    in ms (``FilterInstance.batch_seconds``)."""
    key = f'fluentbit_filter_batch_declines_total{{name="{fi.display_name}"}} '
    declines = sum(float(ln[len(key):])
                   for ln in engine.metrics.to_prometheus().splitlines()
                   if ln.startswith(key))
    secs = list(fi.batch_seconds)
    return {"taken": fi.batch_taken, "declines": declines,
            "p50_ms": statistics.median(secs) * 1e3 if secs else None}


def sp_count_sql(tag: str) -> str:
    """An exact stream-processor task on ``tag``: the engine's gate then
    sends the tag's appends down the decoded path, as the reference's
    does (its ``raw_ok``), so the filters' device programs run."""
    return f"SELECT COUNT(*) FROM TAG:'{tag}';"


def sp_counted(decode_events, chunks: list) -> int:
    """The records the COUNT(*) task's rows (tag ``sp.results``) count."""
    return sum(int(ev.body["COUNT(*)"]) for tag, data in chunks
               if tag == "sp.results" for ev in decode_events(data))


def run_config3(flb, device: str, path: str, sql=None) -> dict:
    """Config 3's pipeline over ``path``: tail (read_from_head) →
    rewrite_tag with the conf's eight rules → null, plus lib to capture
    the records; ``sql`` adds an exact stream-processor task. Waits until
    the tail's offset reaches the file's size with nothing pending, then
    flushes and stops."""
    chunks = []
    ctx = flb.create(device=device, flush="50ms", grace="2")
    ctx.input("tail", tag="syslog", path=path, read_from_head="true")
    f = ctx.filter("rewrite_tag", match="syslog")
    for pattern, tag in CONFIG3_RULES:
        ctx.set(f, rule=f"$log {pattern} {tag} false")
    ctx.output("null", match="*")
    ctx.output("lib", match="*",
               callback=lambda data, tag: chunks.append((tag, data)))
    if sql:
        ctx.engine.sp_task(sql, allow_flux=False)
    size = os.path.getsize(path)
    tail = ctx.engine.inputs[0].plugin
    t0 = time.perf_counter()
    ctx.start()
    try:
        while True:
            tf = tail._files.get(path)
            if tf is not None and tf.offset == size and not tf.pending:
                break
            if time.perf_counter() - t0 > 600:
                raise SystemExit(f"config 3 ({device}): the tail did not "
                                 f"reach the end of the file")
            time.sleep(0.01)
        # runs on the engine loop after the collect that read the last
        # bytes has returned, so every append is in the pools
        ctx.flush_now()
        wall = time.perf_counter() - t0
    finally:
        ctx.stop()
    fi = ctx.engine.filters[0]
    rt = fi.plugin
    return {"chunks": chunks, "wall": wall, "steps": list(rt.step_seconds),
            "program": rt._program, "hook": hook_stats(ctx.engine, fi),
            "emitted": ctx.engine.metrics.to_prometheus()}


def emit_count(exposition: str) -> int:
    """``fluentbit_filter_emit_records_total`` of rewrite_tag.0."""
    m = re.search(r'^fluentbit_filter_emit_records_total\{name="rewrite_tag'
                  r'\.0"\} (\d+)', exposition, re.M)
    return int(m.group(1)) if m else 0


def phase_config3(tg, flb, decode_events, seed: int, card: str,
                  assoc_results: list) -> dict:
    """Config 3 as written on cuda and cpu: rewrite_tag's batch hook takes
    every tail append (the host DFA twin, no kernel); then on cuda over
    DECODED_LINES lines with an exact SP task on the tag, the decoded
    path, where K4 runs 3 launches per append of >= 64 records."""
    import tempfile

    data = syslog_corpus(seed, SYSLOG_LINES)
    texts = tail_texts(data)
    want = config3_routing(texts)
    sizes = tail_append_sizes(data)
    small = syslog_corpus(seed + 1, DECODED_LINES)
    small_texts = tail_texts(small)
    small_want = config3_routing(small_texts)
    device_appends = sum(n >= 64 for n in tail_append_sizes(small))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "syslog_corpus.log")
        with open(path, "wb") as fh:
            fh.write(data)
        tg.grep_assoc.launches = tg.grep_dfa.launches = 0
        gpu = run_config3(flb, "cuda", path)
        raw_launches = {"grep_assoc": tg.grep_assoc.launches,
                        "grep_dfa": tg.grep_dfa.launches}
        cpu = run_config3(flb, "cpu", path)
        small_path = os.path.join(tmp, "syslog_small.log")
        with open(small_path, "wb") as fh:
            fh.write(small)
        tg.grep_assoc.launches = tg.grep_dfa.launches = 0
        dec = run_config3(flb, "cuda", small_path, sp_count_sql("syslog"))
        launches = {"grep_assoc": tg.grep_assoc.launches,
                    "grep_dfa": tg.grep_dfa.launches}

    def routed(run) -> dict:
        out: dict = {}
        for tag, chunk in run["chunks"]:
            if tag != "sp.results":
                out.setdefault(tag, []).extend(
                    ev.body for ev in decode_events(chunk))
        return out

    got, ref = routed(gpu), routed(cpu)
    per_dispatch = launches_per_dispatch(dec["program"])

    def p50(run) -> dict:
        steps = run["steps"]
        return {k: statistics.median(s[i] for s in steps) * 1e3
                for i, k in enumerate(("staging", "launch_readback",
                                       "overflow_regex",
                                       "captures_render_emit"))}

    main = next(r for r in assoc_results if r["program"] == "config3"
                and r["shape"][1] == TAIL_BUCKET and r["segment"] == 32)
    res = {"lines": len(texts), "file_bytes": len(data),
           "appends": len(sizes), "hook": gpu["hook"],
           "cpu_hook": cpu["hook"],
           "tags": {t: len(v) for t, v in sorted(got.items())},
           "tags_equal_cpu": got == ref,
           "tags_equal_python_re": got == want,
           "raw_launches": raw_launches,
           "raw_device_appends": len(gpu["steps"]) + len(cpu["steps"]),
           "emit_counter": emit_count(gpu["emitted"]),
           "rerouted": sum(len(v) for t, v in want.items() if t != "syslog"),
           "lines_per_s": len(texts) / gpu["wall"],
           "cpu_lines_per_s": len(texts) / cpu["wall"],
           "decoded": {
               "lines": len(small_texts), "device_appends": device_appends,
               "filter_device_appends": len(dec["steps"]),
               "hook_taken": dec["hook"]["taken"],
               "kernel_resolved":
                   dec["program"].decision()["kernel_resolved"],
               "k_groups": dec["program"].decision()["k_groups"],
               "tags_equal_python_re": routed(dec) == small_want,
               "sp_counted": sp_counted(decode_events, dec["chunks"]),
               "sp_expected": len(small_want.get("syslog", [])),
               "launches": launches,
               "expected_launches": {
                   "grep_assoc": per_dispatch["grep_assoc"]
                   * device_appends, "grep_dfa": 0},
               "lines_per_s": len(small_texts) / dec["wall"],
               "p50_ms": p50(dec),
               # main["ms"]: one append's three launches
               "k4_busy_share": main["ms"] * device_appends
               / (dec["wall"] * 1e3)},
           "card": card}
    log("config3: " + json.dumps(res))
    failed = [k for k in ("tags_equal_cpu", "tags_equal_python_re")
              if not res[k]]
    if res["emit_counter"] != res["rerouted"]:
        failed.append("emit_counter")
    # as written, every append takes the hook: no decline, no kernel
    for h in (res["hook"], res["cpu_hook"]):
        if h["taken"] != len(sizes) or h["declines"]:
            failed.append("hook")
    if raw_launches != {"grep_assoc": 0, "grep_dfa": 0} \
            or res["raw_device_appends"]:
        failed.append("raw_launches")
    d = res["decoded"]
    if not d["tags_equal_python_re"] or d["sp_counted"] != d["sp_expected"]:
        failed.append("decoded_records")
    if (launches != d["expected_launches"] or device_appends == 0
            or d["filter_device_appends"] != device_appends
            or d["hook_taken"]
            or per_dispatch != {"grep_assoc": 3, "grep_dfa": 0}):
        failed.append("launches")
    if failed:
        raise SystemExit(f"config 3 failed {failed}: {res}")
    return res


# config 2 (conf/baseline2-parser.yaml: tail NDJSON → parser json with
# reserve_data → null) and its regex form, config 2r (the same filter
# with conf/parsers.conf's apache2); both parsers as parsers.conf has them
TIME_FORMAT = "%d/%b/%Y:%H:%M:%S %z"
PARSERS_CONF = {
    "json": dict(Format="json", Time_Key="time", Time_Format=TIME_FORMAT),
    # the json parser the raw path's hook takes: no Time_Format (and the
    # filter without reserve_data or preserve_key)
    "json_plain": dict(Format="json"),
    "apache2": dict(Format="regex", Regex=APACHE2, Time_Key="time",
                    Time_Format=TIME_FORMAT,
                    Types="code:integer size:integer"),
}
CONFIG2_LINES = 131_072   # as config 3's file; Fluent Bit's own
# utf8_surrogate_bench corpus is not in the repo. Config 2r is cut to the
# same size to keep the whole smoke near 450 s
CONFIG2R_LINES = 131_072
UTF8_B = 4096             # K11's staged rows per launch: 32 over the file
MSG_WORDS = {  # the msg text of a config 2 line, by kind
    "ascii": ["request", "served", "from", "cache", "in", "ms", "user",
              "login", "ok", "retry"],
    "utf8_23": ["héllo", "wörld", "naïve", "Ωμέγα", "данные", "日本語",
                "テキスト", "한국어", "ü", "€"],
    "utf8_4": ["🎉", "🚀", "😀", "𝄞", "🐍", "𠜎", "🇩🇪", "👍🏽"],
}
INVALID_UTF8 = [b"\xc0\xaf", b"\xed\xa0\x80", b"\xf4\x90\x80\x80",
                b"\xe6\x97", b"\x80"]


def ndjson_line(rng: random.Random, i: int) -> bytes:
    """One line of config 2's file, 80-400 B (~1% over 512 B): a JSON
    object with ``time`` in parsers.conf's format (~70%), malformed
    (~5%, the parser drops the field) or absent, ``level``, ``user``,
    ``msg`` and a nested object (~10%). The msg is ASCII (~40%), raw
    2/3-byte UTF-8 (~25%), raw 4-byte UTF-8 (~15%), paired surrogate
    escapes (~10%), BMP escapes (~5%) or a raw mix. Besides: malformed
    JSON (~2%) and top-level non-objects (~1%), both passed through
    untouched; raw invalid UTF-8 inside the msg string (~1%: in_tail
    decodes it to U+FFFD, K11 sees it raw); CRLF (~3%). Lone surrogate
    escapes stay out: ``json.loads`` yields a lone surrogate that the
    msgpack encoder refuses, and the raise would stop the tail's collect
    (the reference package's behaviour, in both packages)."""
    x = rng.random()
    if x < 0.02:
        line = rng.choice(['{"level": "info", "msg": "cut short #',
                           '{"a": #,}', "not json { #", '{"k" "v#"}'])
        line = line.replace("#", str(i)).encode()
    elif x < 0.03:
        line = rng.choice(['[#, 2, "x"]', '"a string #"', "#", "null",
                           "true"]).replace("#", str(i)).encode()
    else:
        head = []
        t = rng.random()
        if t < 0.70:
            head.append('"time": "{:02d}/{}/20{:02d}:{:02d}:{:02d}:{:02d} '
                        '{}"'.format(rng.randrange(1, 29), rng.choice(MONTHS),
                                     rng.randrange(10, 30), rng.randrange(24),
                                     rng.randrange(60), rng.randrange(60),
                                     rng.choice(["+0000", "-0700", "+0530",
                                                 "+0100"])))
        elif t < 0.75:
            head.append('"time": ' + json.dumps(rng.choice(
                ["2026-10-17T15:12:32Z", "32/Oct/2026:10:00:00 +0000",
                 "17/Foo/2026:10:00:00 +0000", "yesterday", ""])))
        head.append('"level": ' + json.dumps(rng.choice(
            ["debug", "info", "warn", "error"])))
        head.append(f'"user": "u{rng.randrange(100000)}"')
        m = rng.random()
        kind, escape = (("ascii", False) if m < 0.40 else
                        ("utf8_23", False) if m < 0.65 else
                        ("utf8_4", False) if m < 0.80 else
                        ("utf8_4", True) if m < 0.90 else
                        ("utf8_23", True) if m < 0.95 else ("mix", False))
        words = (MSG_WORDS["ascii"] + MSG_WORDS["utf8_23"]
                 + MSG_WORDS["utf8_4"] if kind == "mix" else MSG_WORDS[kind])
        tail = ""
        if rng.random() < 0.10:
            tail = (', "ctx": {"req": {"id": %d, "tags": ["a", "b"]}, '
                    '"ok": true, "ratio": %s}' % (i, rng.randrange(100) / 8))
        target = (rng.randrange(520, 900) if rng.random() < 0.01
                  else rng.randrange(80, 401))
        msg = f"#{i}"
        while True:
            body = ("{" + ", ".join(head) + ', "msg": '
                    + json.dumps(msg, ensure_ascii=escape) + tail + "}")
            if len(body.encode()) >= target:
                break
            msg += " " + rng.choice(words)
        line = body.encode()
        if rng.random() < 0.01:  # raw invalid bytes before the msg's quote
            at = line.rindex(b'"', 0, len(line) - len(tail.encode()) - 1)
            line = line[:at] + rng.choice(INVALID_UTF8) + line[at:]
    if rng.random() < 0.03:
        line += b"\r"
    return line


def ndjson_corpus(seed: int, n: int) -> bytes:
    rng = random.Random(seed)
    return b"\n".join(ndjson_line(rng, i) for i in range(n)) + b"\n"


def config2r_corpus(seed: int, n: int) -> bytes:
    """Config 2r's access log: ~70% apache lines (``apache_line`` with
    the time varied, ~3% of them malformed), the rest ``bad_line``,
    and ~1% of lines over 512 B."""
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        if rng.random() < 0.70:
            stamp = ("99/Oct/2000:13:55:36 -0700" if rng.random() < 0.03
                     else "{:02d}/{}/20{:02d}:{:02d}:{:02d}:{:02d} {}".format(
                         rng.randrange(1, 29), rng.choice(MONTHS),
                         rng.randrange(10, 30), rng.randrange(24),
                         rng.randrange(60), rng.randrange(60),
                         rng.choice(["+0000", "-0700", "+0530"])))
            line = apache_line(rng, i).replace("10/Oct/2000:13:55:36 -0700",
                                               stamp)
        else:
            line = bad_line(rng, i)
        if rng.random() < 0.01:
            line += ' "' + "z" * rng.randrange(520, 700) + '"'
        lines.append(line.encode())
    return b"\n".join(lines) + b"\n"


def strptime_epoch(value: str):
    """parsers.conf's Time_Format through Python's ``datetime``; None
    where it does not parse."""
    from datetime import datetime

    try:
        return datetime.strptime(value, TIME_FORMAT).timestamp()
    except ValueError:
        return None


def config2_fold(texts: list) -> list:
    """(parsed time or None, body as JSON text) per line, from Python's
    ``json`` and ``datetime``: an object replaces the record (reserve_data
    keeps no other field: ``log`` is the parsed key), its string ``time``
    popped and parsed; anything else stays ``{"log": text}``."""
    out = []
    for text in texts:
        try:
            obj = json.loads(text)
        except ValueError:
            obj = None
        if not isinstance(obj, dict):
            out.append((None, json.dumps({"log": text})))
            continue
        ts = None
        if isinstance(obj.get("time"), str):
            ts = strptime_epoch(obj.pop("time"))
        out.append((ts, json.dumps(obj)))
    return out


def cast_integer(v: str):
    """parsers.conf's ``Types ... :integer`` cast."""
    try:
        return int(float(v)) if "." in v else int(v, 10)
    except ValueError:
        return v


def config2r_fold(texts: list) -> list:
    """(parsed time or None, body as JSON text) per line, from Python's
    ``re`` with the apache2 pattern: the named captures that are not
    empty, code and size cast to integers, ``time`` popped and parsed;
    a line the pattern misses stays ``{"log": text}``."""
    out = []
    for text in texts:
        m = APACHE2_PY.search(text)
        fields = ({k: v for k, v in m.groupdict().items() if v}
                  if m is not None else {})
        if not fields:
            out.append((None, json.dumps({"log": text})))
            continue
        for k in ("code", "size"):
            if k in fields:
                fields[k] = cast_integer(fields[k])
        ts = strptime_epoch(fields.pop("time")) if "time" in fields else None
        out.append((ts, json.dumps(fields)))
    return out


def run_config2(flb, device: str, path: str, parser: str,
                sql=None, reserve: bool = True) -> dict:
    """Config 2's pipeline (``parser`` json) or 2r's (apache2) over
    ``path``: tail (read_from_head) → parser (key_name log, reserve_data
    unless ``reserve`` is False) → null, plus lib to capture the records;
    ``sql`` adds an exact stream-processor task. Waits until the tail's
    offset reaches the file's size with nothing pending, then flushes
    and stops."""
    tagged = []
    ctx = flb.create(device=device, flush="50ms", grace="2")
    ctx.parser(parser, **PARSERS_CONF[parser])
    ctx.input("tail", tag="ndjson", path=path, read_from_head="true",
              refresh_interval="1")
    ctx.filter("parser", match="ndjson", key_name="log", parser=parser,
               reserve_data="true" if reserve else "false")
    ctx.output("null", match="*")
    ctx.output("lib", match="*",
               callback=lambda data, tag: tagged.append((tag, data)))
    if sql:
        ctx.engine.sp_task(sql, allow_flux=False)
    size = os.path.getsize(path)
    tail = ctx.engine.inputs[0].plugin
    t0 = time.perf_counter()
    ctx.start()
    try:
        while True:
            tf = tail._files.get(path)
            if tf is not None and tf.offset == size and not tf.pending:
                break
            if time.perf_counter() - t0 > 600:
                raise SystemExit(f"config 2 ({parser}, {device}): the tail "
                                 f"did not reach the end of the file")
            time.sleep(0.01)
        ctx.flush_now()
        wall = time.perf_counter() - t0
    finally:
        ctx.stop()
    fi = ctx.engine.filters[0]
    return {"chunks": [d for t, d in tagged if t != "sp.results"],
            "tagged": tagged, "wall": wall,
            "steps": list(fi.plugin.step_seconds),
            "program": fi.plugin._prefilter,
            "hook": hook_stats(ctx.engine, fi)}


def parsed_records(decode_events, chunks: list) -> list:
    """(time if the parser set it, else None; body as JSON text)."""
    return [(ev.timestamp if isinstance(ev.timestamp, float) else None,
             json.dumps(ev.body))
            for chunk in chunks for ev in decode_events(chunk)]


PARSER_STEPS = ("values_staging", "launch_readback", "overflow_regex",
                "parse_apply")


def step_p50(steps: list) -> dict:
    if not steps:
        return {k: None for k in PARSER_STEPS}
    return {k: statistics.median(s[i] for s in steps) * 1e3
            for i, k in enumerate(PARSER_STEPS)}


def utf8_walked(np, tu, batch, lengths) -> int:
    """Bytes K11 needs to walk on these rows: each row's bytes up to its
    length or its first invalid byte (DEAD is absorbing), none for a
    negative length."""
    B, width = batch.shape
    state = np.zeros(B, dtype=np.int64)
    n = np.clip(lengths, 0, width).astype(np.int64)
    stop = n.copy()
    for t in range(width):
        live = (t < n) & (state != tu.DEAD)
        if not live.any():
            break
        state = np.where(live, tu._TRANS[state, tu._CLS[batch[:, t]]], state)
        stop = np.where(live & (state == tu.DEAD), t + 1, stop)
    return int(np.where(lengths >= 0, stop, 0).sum())


def utf8_bound_ms(np, tu, batch, lengths) -> tuple:
    """Least time for one K11 pass, counting what these rows need: the
    bytes walked, every length (4 B) and verdict (1 B) once, over HBM's
    rate; two lookups and an index multiply-add per byte walked over the
    int32 peak. Also the staged bound ``B * L + 4B + B`` bytes."""
    walked = utf8_walked(np, tu, batch, lengths)
    B, width = batch.shape
    bytes_ms = (walked + 5 * B) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4 * walked / PEAK_INT32_OPS_PER_S * 1e3
    staged_ms = (B * width + 5 * B) / PEAK_BYTES_PER_S * 1e3
    bound = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")
    return bound + (staged_ms, walked)


#: multi-byte sequences the straddle rows place across piece boundaries:
#: 2-, 3- and 4-byte valid ones, a UTF-16 surrogate, an overlong and a
#: code point above U+10FFFF
STRADDLE_SEQS = ("\u00e9".encode(), "\u65e5".encode(), "\U0001f389".encode(),
                 b"\xed\xa0\x80", b"\xe0\x80\x80", b"\xf4\x90\x80\x80")


def straddle_rows(np, width: int):
    """[R, width] ASCII rows and their lengths, each with one sequence of
    ``STRADDLE_SEQS`` split j bytes before a 16 B piece boundary (every
    split): at every boundary of the row, or at the 512 B window
    boundary (the middle piece boundary where the row is narrower) alone;
    each row at its full length, cut at that boundary (inside the
    sequence), just after the sequence, at 512, past the width, 0, -1
    and -2 (the copy in tests/test_torch_gpu.py makes the same rows; the
    smoke imports nothing from tests/)."""
    rows, lengths = [], []
    middle = 512 if width > 512 else (width // 32) * 16
    for seq in STRADDLE_SEQS:
        for j in range(1, len(seq)):
            for every in (True, False):
                row = np.full(width, ord("a"), np.uint8)
                bounds = (range(16, width, 16) if every else [middle])
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


def wide_rows(np, raw_lines: list, B: int, width: int):
    """[B, width] rows of config 2's raw lines joined by spaces, each cut
    at a length drawn in [0, width] (inside a multi-byte sequence at
    times), so that rows end in every window."""
    rng = np.random.default_rng(width)
    batch = np.full((B, width), ord(" "), np.uint8)
    lengths = rng.integers(0, width + 1, size=B).astype(np.int32)
    text = b" ".join(raw_lines[:4 * B])
    starts = rng.integers(0, max(len(text) - width, 1), size=B)
    for i, at in enumerate(starts):
        chunk = text[at:at + width]
        batch[i, :len(chunk)] = np.frombuffer(chunk, np.uint8)
    lengths[:4] = [width, -1, -2, 0]
    return batch, lengths


def utf8_cases(np, assemble, raw_lines: list) -> list:
    """(case, batch, lengths, view, timed): config 2's raw lines at
    [4096, 512] (the main path's shape) and [65536, 512], wide rows of
    several windows at [1024, 4096], an odd width on the byte path at
    [4096, 300], the straddle rows at widths 1024 and 300, every row
    empty (K11's floor), and the edge cases."""
    cases = []
    for B in (UTF8_B, 65536):
        staged = assemble(raw_lines[:B], L)
        cases.append(("config2_lines", staged.batch, staged.lengths, None,
                      True))
    batch, lengths = wide_rows(np, raw_lines, 1024, 4096)
    cases.append(("wide_rows", batch, lengths, None, True))
    staged = assemble(raw_lines[:4096], 300)
    cases.append(("odd_width", staged.batch, staged.lengths, None, True))
    for width in (1024, 300):
        batch, lengths = straddle_rows(np, width)
        cases.append(("straddle", batch, lengths, None, False))
    cases.append(("empty_rows", np.full((4096, L), 0x61, np.uint8),
                  np.zeros(4096, np.int32), None, True))
    cases.append(("L0", np.zeros((300, 0), np.uint8),
                  np.array([0, -1, -2] * 100, np.int32), None, False))
    cases.append(("negative_lengths", np.full((4096, L), 0x41, np.uint8),
                  np.array([-1, -2] * 2048, np.int32), None, False))
    cases.append(("full_ascii", np.full((4096, L), 0x61, np.uint8),
                  np.full(4096, L, np.int32), None, True))
    bad = np.full((4096, L), 0x61, np.uint8)
    bad[:, 0] = np.array([0x80, 0xC0, 0xFF, 0xF5] * 1024, np.uint8)
    cases.append(("invalid_at_byte_0", bad, np.full(4096, L, np.int32),
                  None, False))
    staged = assemble(raw_lines[:4096], L)
    cases.append(("unaligned", staged.batch, staged.lengths, "unaligned",
                  False))
    return cases


def phase_utf8_kernels(np, torch, tu, assemble, raw_lines: list) -> list:
    """K11 against ``utf8_validate_plain`` (the reference's column scan)
    and ``utf8_validate_pieces_plain`` (the kernel's piece maps and
    windows) on the card, verdict for verdict: every case of
    ``utf8_cases``, with CUDA-event times of the kernel and the column
    scan for the timed ones."""
    dev = torch.device("cuda")
    v = tu.Utf8Validator(dev)
    results = []
    for case, batch, lengths, view, timed in utf8_cases(np, assemble,
                                                         raw_lines):
        b = torch.from_numpy(batch).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        if view == "unaligned":
            flat = torch.zeros(1 + b.numel(), dtype=torch.uint8, device=dev)
            b = flat[1:].view(b.shape)
            b.copy_(torch.from_numpy(batch))
        before = tu.utf8_validate.launches
        got = tu.utf8_validate(v.class_map, v.trans, b, ln)
        launches = tu.utf8_validate.launches - before
        plain = tu.utf8_validate_plain(v.class_map, v.trans, b, ln)
        by_pieces = tu.utf8_validate_pieces_plain(v.class_map, v.trans, b,
                                                  ln)
        torch.cuda.synchronize()
        mism = int((got != plain).sum())
        mism_pieces = int((got != by_pieces).sum())
        B, width = batch.shape
        bms, by, staged_ms, walked = utf8_bound_ms(np, tu, batch, lengths)
        res = {"case": case, "shape": [B, width], "launches": launches,
               "mismatches": mism, "mismatches_pieces_plain": mism_pieces,
               "max_abs_err": int((got.int() - plain.int()).abs().max()),
               "valid_rows": int(got.sum()), "bytes_walked": walked,
               "bound_ms": bms, "bound_by": by,
               "bound_staged_bytes_ms": staged_ms}
        if timed:
            iters = 20 if B >= 65536 else 100
            call = lambda: tu.utf8_validate(v.class_map, v.trans, b, ln)
            res["ms"] = cuda_ms(torch, call, iters)
            res["host_enqueue_ms"] = host_ms(torch, call, iters)
            res["plain_ms"] = cuda_ms(torch, lambda: tu.utf8_validate_plain(
                v.class_map, v.trans, b, ln), 2)
        else:
            res.update(ms=None, host_enqueue_ms=None, plain_ms=None)
        log("utf8-vs-plain: " + json.dumps(res))
        if mism or mism_pieces or launches != 1:
            raise SystemExit(f"utf8_validate on {case} {[B, width]}: {mism} "
                             f"rows differ from plain, {mism_pieces} from "
                             f"the pieces plain, {launches} launches")
        want = {"negative_lengths": 0, "invalid_at_byte_0": 0,
                "full_ascii": B, "empty_rows": B}.get(case)
        if want is not None and res["valid_rows"] != want:
            raise SystemExit(f"utf8_validate on {case}: {res['valid_rows']} "
                             f"valid rows, expected {want}")
        if (case in ("config2_lines", "wide_rows", "odd_width", "straddle")
                and not 0 < res["valid_rows"] < B):
            raise SystemExit(f"degenerate verdicts on {case}: {res}")
        results.append(res)
    return results


def strict_utf8(line: bytes) -> bool:
    try:
        line.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def phase_config2(np, torch, tu, assemble, flb, decode_events, data: bytes,
                  card: str) -> dict:
    """Config 2 on cuda and cpu over ``data`` (the NDJSON file), against
    the Python fold; then K11 through ``Utf8Validator("cuda")`` over the
    file's raw lines, staged [4096, 512], against plain and strict
    ``bytes.decode``."""
    import tempfile

    raw = data.split(b"\n")[:-1]  # the lines' bytes before in_tail decodes
    texts = tail_texts(data)
    want = config2_fold(texts)
    sizes = tail_append_sizes(data)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "utf8_corpus.ndjson")
        with open(path, "wb") as fh:
            fh.write(data)
        gpu = run_config2(flb, "cuda", path, "json")
        cpu = run_config2(flb, "cpu", path, "json")
    got, ref = (parsed_records(decode_events, r["chunks"]) for r in (gpu, cpu))
    # the K11 path: 32 launches of [4096, 512] over the raw lines
    v = tu.Utf8Validator("cuda")
    tu.utf8_validate.launches = 0
    t0 = time.perf_counter()
    verdicts, staged_all = [], []
    for off in range(0, len(raw), UTF8_B):
        staged = assemble(raw[off:off + UTF8_B], L)
        verdicts.append(v.validate(staged.batch, staged.lengths))
        staged_all.append(staged)
    k11_wall = time.perf_counter() - t0
    launches = tu.utf8_validate.launches
    mism = 0
    for staged, verdict in zip(staged_all, verdicts):
        plain = tu.utf8_validate_plain(
            v.class_map, v.trans, torch.from_numpy(staged.batch).cuda(),
            torch.from_numpy(staged.lengths).cuda())
        mism += int((plain.cpu().numpy() != verdict).sum())
    valid = np.concatenate(verdicts)
    overflow = [off * UTF8_B + i for off, s in enumerate(staged_all)
                for i in s.overflow]
    for i in overflow:  # rows past 512 B: the host oracle, as filters do
        valid[i] = tu.validate_bytes(raw[i])
    strict = np.array([strict_utf8(x) for x in raw])
    res = {"lines": len(texts), "file_bytes": len(data),
           "appends": len(sizes),
           "records_equal_cpu": got == ref,
           "records_equal_python_fold": got == want,
           "parsed_times": sum(ts is not None for ts, _ in got),
           "untouched": sum(body.startswith('{"log": ')
                            for _, body in got),
           "lines_per_s": len(texts) / gpu["wall"],
           "cpu_lines_per_s": len(texts) / cpu["wall"],
           "device_appends": len(gpu["steps"]),
           "hook": gpu["hook"],
           "utf8": {"launches": launches, "expected_launches":
                    -(-len(raw) // UTF8_B),
                    "mismatches_vs_plain": mism,
                    "equals_strict_decode": bool((valid == strict).all()),
                    "invalid_lines": int((~strict).sum()),
                    "overflow_rows": len(overflow),
                    "lines_per_s": len(raw) / k11_wall},
           "card": card}
    log("config2: " + json.dumps(res))
    failed = [k for k in ("records_equal_cpu", "records_equal_python_fold")
              if not res[k]]
    u = res["utf8"]
    if (u["launches"] != u["expected_launches"] or u["mismatches_vs_plain"]
            or not u["equals_strict_decode"] or not u["invalid_lines"]):
        failed.append("utf8")
    if (res["device_appends"] or not res["parsed_times"]
            or res["hook"]["taken"] or res["hook"]["declines"]):
        failed.append("shape")
    if failed:
        raise SystemExit(f"config 2 failed {failed}: {res}")
    return res


def config2j_fold(texts: list) -> list:
    """Each line's body from Python's ``json``: an object replaces the
    record (its ``time`` kept: the parser has no Time_Format); anything
    else stays ``{"log": text}``."""
    out = []
    for text in texts:
        try:
            obj = json.loads(text)
        except ValueError:
            obj = None
        out.append(json.dumps(obj if isinstance(obj, dict)
                              else {"log": text}))
    return out


def phase_config2j(flb, decode_events, data: bytes, card: str) -> dict:
    """Config 2's NDJSON through ``parser json`` with no Time_Format and
    no reserve_data, on cuda and cpu: the parser's batch hook (the codec
    extension's ``parser_json_batch``) must take every tail append with
    no decline and no kernel, and the bodies must equal the cpu run's and
    Python's ``json.loads`` fold."""
    import tempfile

    texts = tail_texts(data)
    want = config2j_fold(texts)
    sizes = tail_append_sizes(data)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config2.ndjson")
        with open(path, "wb") as fh:
            fh.write(data)
        gpu = run_config2(flb, "cuda", path, "json_plain", reserve=False)
        cpu = run_config2(flb, "cpu", path, "json_plain", reserve=False)
    got, ref = ([body for _, body in parsed_records(decode_events,
                                                    r["chunks"])]
                for r in (gpu, cpu))
    res = {"lines": len(texts), "appends": len(sizes),
           "records_equal_cpu": got == ref,
           "records_equal_python_json": got == want,
           "parsed": sum(not body.startswith('{"log": ') for body in got),
           "lines_per_s": len(texts) / gpu["wall"],
           "cpu_lines_per_s": len(texts) / cpu["wall"],
           "hook": gpu["hook"], "cpu_hook": cpu["hook"],
           "device_appends": len(gpu["steps"]) + len(cpu["steps"]),
           "card": card}
    log("config2j: " + json.dumps(res))
    failed = [k for k in ("records_equal_cpu", "records_equal_python_json")
              if not res[k]]
    for h in (res["hook"], res["cpu_hook"]):
        if h["taken"] != len(sizes) or h["declines"]:
            failed.append("hook")
    if res["device_appends"] or not res["parsed"]:
        failed.append("shape")
    if failed:
        raise SystemExit(f"config 2j failed {failed}: {res}")
    return res


CODEC_RECORDS = 16_384  # records of each set the codec phase times


def k8s_records(seed: int, n: int) -> list:
    """(timestamp, body) of config 5's records as the kubernetes filter
    leaves them: the record's own keys over the merged JSON of ``log``
    and a ``kubernetes`` map (pod, namespace, ids, host, labels,
    annotations), EventTime stamps."""
    from fluentbit_tpu_torch.codec.msgpack import EventTime

    rng = random.Random(seed)
    out = []
    for i in range(n):
        log_text = k8s_log(rng, i)
        rec = {"log": log_text, "stream": rng.choice(["stdout", "stderr"]),
               "time": f"2024-05-01T12:00:{i % 60:02d}.{i:09d}Z"}
        try:
            merged = json.loads(log_text)
        except ValueError:
            merged = None
        body = {**merged, **rec} if isinstance(merged, dict) else rec
        p = rng.randrange(K8S_PODS)
        body["kubernetes"] = {
            "pod_name": f"svc{p // 4}-{p * 7919 % 16 ** 9:09x}-x{p:04d}",
            "namespace_name": f"team-{p % K8S_NAMESPACES:02d}",
            "pod_id": f"{p * 104729:032x}",
            "labels": {f"app.kubernetes.io/l{k}": f"v{(p + k) % 99}"
                       for k in range(2 + p % 7)},
            "annotations": {f"note/{k}": "x" * (1 + (p * k) % 29)
                            for k in range(p % 5)},
            "host": f"node-{p % K8S_NODES:02d}",
            "container_name": ["app", "sidecar", "log_shipper"][p % 3],
            "docker_id": f"{p * 2654435761:064x}"}
        out.append((EventTime(1714560000 + i // 64, (i * 7919) % 10 ** 9),
                    body))
    return out


def codec_set(tev, packb, records: list) -> dict:
    """Encode, decode and re-encode ``records`` with the codec extension
    and with the plain Python versions: bytes equal (decoded events
    compared by re-packing them with the plain packer), and the
    microseconds a record of each, timed with the garbage collector
    paused (a collection of the smoke's whole heap would otherwise land
    in whichever side allocates past its threshold)."""
    def per_record_us(fn):
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e6 / len(records)
        finally:
            gc.enable()

    enc, enc_us = per_record_us(lambda: [tev.encode_event(b, ts)
                                         for ts, b in records])
    plain, plain_enc_us = per_record_us(lambda: [
        tev.pack_event_plain(ts, {}, b) for ts, b in records])
    buf = b"".join(enc)
    evs, dec_us = per_record_us(lambda: tev.decode_events(buf))
    pevs, plain_dec_us = per_record_us(lambda: tev.decode_events_plain(buf))
    re_ext, re_us = per_record_us(lambda: [tev.reencode_event(ev)
                                           for ev in evs])
    re_plain, plain_re_us = per_record_us(lambda: [
        tev.pack_event_plain(ev.timestamp, ev.metadata, ev.body)
        for ev in pevs])

    def canon(events):
        return [(packb([[ev.timestamp, ev.metadata], ev.body]), ev.raw)
                for ev in events]

    return {"records": len(records), "bytes": len(buf),
            "encode_equal": enc == plain,
            "decode_equal": canon(evs) == canon(pevs),
            "reencode_equal": re_ext == re_plain == enc,
            "encode_us": enc_us, "plain_encode_us": plain_enc_us,
            "decode_us": dec_us, "plain_decode_us": plain_dec_us,
            "reencode_us": re_us, "plain_reencode_us": plain_re_us}


def phase_codec(seed: int, ndjson: bytes, card: str) -> dict:
    """The event codec extension (``csrc/codec_py.cpp``) against the
    plain Python codec on config 2's records (the tail's ``{"log":
    line}`` and the parsed objects) and config 5's (after kubernetes),
    CODEC_RECORDS of each: encode, decode and re-encode bytes equal,
    microseconds a record of each; and a buffer whose strings hold
    invalid UTF-8 decoded equal by both."""
    from fluentbit_tpu_torch.codec import events as tev
    from fluentbit_tpu_torch.codec.msgpack import EventTime, packb

    texts = tail_texts(ndjson)[:CODEC_RECORDS]
    stamps = [EventTime(1700000000 + i // 100, i * 997 % 10 ** 9)
              for i in range(len(texts))]
    parsed = []
    for ts, text in zip(stamps, texts):
        try:
            obj = json.loads(text)
        except ValueError:
            obj = None
        parsed.append((ts, obj if isinstance(obj, dict) else {"log": text}))
    sets = {"config2_lines": [(ts, {"log": t}) for ts, t in
                              zip(stamps, texts)],
            "config2_parsed": parsed,
            "config5": k8s_records(seed, CODEC_RECORDS)}
    res = {name: codec_set(tev, packb, recs) for name, recs in sets.items()}
    bad = b"".join(tev.encode_event({"log": K8S_INVALID + str(i)}, float(i))
                   for i in range(64)).replace(K8S_INVALID.encode(),
                                               K8S_INVALID_BYTES)
    canon = [[(packb([[ev.timestamp, ev.metadata], ev.body]), ev.raw)
              for ev in decode(bad)]
             for decode in (tev.decode_events, tev.decode_events_plain)]
    res["invalid_utf8_decode_equal"] = canon[0] == canon[1]
    res["card"] = card
    log("codec: " + json.dumps(res))
    failed = [f"{name}.{k}" for name in sets
              for k in ("encode_equal", "decode_equal", "reencode_equal")
              if not res[name][k]]
    if not res["invalid_utf8_decode_equal"]:
        failed.append("invalid_utf8")
    if failed:
        raise SystemExit(f"codec failed {failed}: {res}")
    return res


def phase_config2r(np, torch, tg, assemble, flb, decode_events, seed: int,
                   card: str) -> dict:
    """Config 2r as written on cuda and cpu over an Apache access log,
    against the Python ``re`` fold: the parser's batch hook takes every
    tail append (the host DFA twin, no kernel). Then on cuda over
    DECODED_LINES lines with an exact SP task on the tag, the decoded
    path: K3 must launch once per tail append of >= 64 records (apache2
    has > 64 states: "auto" takes the scan), K4 never. K3 is then timed
    at one tail read, [1, 1024, 512], against plain."""
    import tempfile

    data = config2r_corpus(seed, CONFIG2R_LINES)
    texts = tail_texts(data)
    want = config2r_fold(texts)
    sizes = tail_append_sizes(data)
    small = config2r_corpus(seed + 1, DECODED_LINES)
    small_texts = tail_texts(small)
    device_appends = sum(n >= 64 for n in tail_append_sizes(small))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "access.log")
        with open(path, "wb") as fh:
            fh.write(data)
        tg.grep_dfa.launches = tg.grep_assoc.launches = 0
        gpu = run_config2(flb, "cuda", path, "apache2")
        raw_launches = {"grep_dfa": tg.grep_dfa.launches,
                        "grep_assoc": tg.grep_assoc.launches}
        cpu = run_config2(flb, "cpu", path, "apache2")
        small_path = os.path.join(tmp, "access_small.log")
        with open(small_path, "wb") as fh:
            fh.write(small)
        tg.grep_dfa.launches = tg.grep_assoc.launches = 0
        dec = run_config2(flb, "cuda", small_path, "apache2",
                          sp_count_sql("ndjson"))
        launches = {"grep_dfa": tg.grep_dfa.launches,
                    "grep_assoc": tg.grep_assoc.launches}
    got, ref = (parsed_records(decode_events, r["chunks"]) for r in (gpu, cpu))
    dec_got = parsed_records(decode_events, dec["chunks"])
    prog = gpu["program"]
    rows = [t.encode() for t in texts[:TAIL_BUCKET]]
    staged = assemble(rows, L)
    b = torch.from_numpy(staged.batch[None]).cuda()
    ln = torch.from_numpy(staged.lengths[None]).cuda()
    k3 = prog.dispatch(b, ln)
    tables = plain_tables(torch, tg, prog)
    plain = plain_dispatch(torch, tg, prog, tables, b, ln)
    torch.cuda.synchronize()
    k3_bound, k3_by = bound_ms(torch, prog, b, ln,
                               table_bytes_read(torch, tg, prog, b, ln))
    res = {"lines": len(texts), "file_bytes": len(data),
           "appends": len(sizes), "hook": gpu["hook"],
           "cpu_hook": cpu["hook"],
           "kernel_resolved": prog.decision()["kernel_resolved"],
           "max_states": prog.decision()["max_states"],
           "records_equal_cpu": got == ref,
           "records_equal_python_re": got == want,
           "parsed": sum(not body.startswith('{"log": ')
                         for _, body in got),
           "parsed_times": sum(ts is not None for ts, _ in got),
           "raw_launches": raw_launches,
           "raw_device_appends": len(gpu["steps"]) + len(cpu["steps"]),
           "lines_per_s": len(texts) / gpu["wall"],
           "cpu_lines_per_s": len(texts) / cpu["wall"],
           "decoded": {
               "lines": len(small_texts), "device_appends": device_appends,
               "filter_device_appends": len(dec["steps"]),
               "hook_taken": dec["hook"]["taken"],
               "records_equal_python_re":
                   dec_got == config2r_fold(small_texts),
               "sp_counted": sp_counted(decode_events, dec["tagged"]),
               "launches": launches,
               "expected_launches": {"grep_dfa": device_appends,
                                     "grep_assoc": 0},
               "lines_per_s": len(small_texts) / dec["wall"],
               "p50_ms": step_p50(dec["steps"])},
           "k3": {"shape": [1, TAIL_BUCKET, L],
                  "mismatches": int((k3 != plain).sum()),
                  "max_abs_err": int((k3.int() - plain.int()).abs().max()),
                  "ms": cuda_ms(torch, lambda: prog.dispatch(b, ln), 50),
                  "plain_ms": cuda_ms(torch, lambda: plain_dispatch(
                      torch, tg, prog, tables, b, ln), 3),
                  "bound_ms": k3_bound, "bound_by": k3_by,
                  **scan_global(torch, tg, prog, b, ln, plain, 50)},
           "card": card}
    res["decoded"]["k3_busy_share"] = (res["k3"]["ms"] * device_appends
                                       / (dec["wall"] * 1e3))
    log("config2r: " + json.dumps(res))
    failed = [k for k in ("records_equal_cpu", "records_equal_python_re")
              if not res[k]]
    # as written, every append takes the hook: no decline, no kernel
    for h in (res["hook"], res["cpu_hook"]):
        if h["taken"] != len(sizes) or h["declines"]:
            failed.append("hook")
    if raw_launches != {"grep_dfa": 0, "grep_assoc": 0} \
            or res["raw_device_appends"]:
        failed.append("raw_launches")
    d = res["decoded"]
    if (not d["records_equal_python_re"]
            or d["sp_counted"] != len(small_texts)):
        failed.append("decoded_records")
    if (launches != d["expected_launches"] or device_appends == 0
            or d["filter_device_appends"] != device_appends
            or d["hook_taken"] or res["kernel_resolved"] != "scan"):
        failed.append("launches")
    if (res["k3"]["mismatches"] or res["k3"]["global_mismatches"]
            or not res["parsed_times"]):
        failed.append("k3")
    if failed:
        raise SystemExit(f"config 2r failed {failed}: {res}")
    return res


# config 5 (conf/baseline5-k8s.conf: forward → kubernetes with Merge_Log
# On and Buffer_Size 0 → grep Exclude log health-check → null): edge
# agents' traffic over loopback TCP, pods in namespaces, a preload cache
K8S_RECORDS = 262_144
K8S_PODS = 256
K8S_NAMESPACES = 16
K8S_NODES = 32
K8S_CONNS = 4
K8S_TAG_ZIPF_S = 1.1
K8S_SMALL_SHARE = 0.01   # records in Message / Forward / < 32-record messages
K8S_RESEND_SHARE = 0.01  # chunks resent with the same id
K8S_EXCLUDE = "health-check"
K8S_INVALID = "\u0001INVALID\u0001"  # 9 bytes, swapped for invalid UTF-8
K8S_INVALID_BYTES = b"bad\xff\xfe\xc3(x\x80"
CONFIG5_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "conf", "baseline5-k8s.conf")
# the tag regex written here in Python's syntax, for the independent check
K8S_TAG_PY = re.compile(
    r"^kube\.var\.log\.containers\."
    r"(?P<pod_name>[a-z0-9](?:[-a-z0-9.]*[a-z0-9])?)_"
    r"(?P<namespace_name>[^_]+)_(?P<container_name>.+)-"
    r"(?P<docker_id>[a-f0-9]{12,64})\.log$")
# an edge agent: sends each framed message, then waits for its ack bytes
K8S_CLIENT = r"""
import socket, struct, sys
data = open(sys.argv[1], "rb").read()
s = socket.create_connection(("127.0.0.1", int(sys.argv[2])))
pos = 0
while pos < len(data):
    (n,) = struct.unpack_from(">I", data, pos)
    msg = data[pos + 4:pos + 4 + n]
    pos += 4 + n
    (n,) = struct.unpack_from(">I", data, pos)
    ack = data[pos + 4:pos + 4 + n]
    pos += 4 + n
    s.sendall(msg)
    got = b""
    while len(got) < len(ack):
        part = s.recv(len(ack) - len(got))
        if not part:
            sys.exit("the server closed the connection before an ack")
        got += part
    if got != ack:
        sys.exit("wrong ack %r for %r" % (got, ack))
s.close()
"""


def k8s_log(rng: random.Random, i: int) -> str:
    """One Docker/CRI ``log`` value: ~55% JSON application lines of
    80-400 B, ~40% plain text, ~3% kubelet probes with ``health-check``,
    ~2% stack traces over 512 B; ~0.5% carry invalid UTF-8."""
    r = rng.random()
    if r < 0.55:
        body = {"level": rng.choice(["info", "warn", "error", "debug"]),
                "ts": f"2024-05-01T12:{i % 60:02d}:{(i * 7) % 60:02d}Z",
                "caller": f"svc/handler{rng.randrange(40)}.go:"
                          f"{rng.randrange(900)}",
                "msg": "request served",
                "latency_ms": round(rng.random() * 300, 3),
                "req": rng.randrange(10 ** 9)}
        if rng.random() < 0.1:
            body["stream"] = "inner"     # collides: the record's wins
        pad = rng.randrange(80, 400) - len(json.dumps(body))
        if pad > 0:
            body["note"] = "x" * pad
        line = json.dumps(body)
    elif r < 0.95:
        line = (f"I0501 12:00:{i % 60:02d}.{i % 1000:03d} {rng.randrange(9)}"
                f" controller.go:{rng.randrange(999)}] synced "
                + "w" * rng.randrange(10, 200))
    elif r < 0.98:
        line = (f'10.1.{rng.randrange(256)}.{rng.randrange(256)} - - '
                f'"GET /healthz HTTP/1.1" 200 2 "-" "kube-probe/1.29" '
                f'health-check ok')
    else:
        line = "panic: runtime error\n" + "".join(
            f"goroutine {k} [running]:\n\tmain.f{k}()\n"
            for k in range(rng.randrange(14, 30)))
    if rng.random() < 0.005:
        line = K8S_INVALID + line
    return line + "\n"


def make_k8s_traffic(np, seed: int, cache_dir: str,
                     n_records: int = K8S_RECORDS) -> dict:
    """Config 5's traffic and metadata from the seed: 256 pods in 16
    namespaces with 1-3 containers each; a ``.meta`` file for 90% of the
    pods; ``n_records`` records in PackedForward messages of 256-4096
    entries (half gzip), tags drawn Zipf(1.1), and ~1% of the records in
    Message and Forward mode and messages below 32 records; every
    message with a ``chunk`` id, ~1% of them sent again later on the
    same connection; each of 4 connections with its own tags. Returns
    the framed messages of each connection, what each tag's records are
    (for the check) and the counts."""
    from fluentbit_tpu_torch.codec.msgpack import EventTime, packb

    rng = random.Random(seed)
    tags, metas = [], {}
    for p in range(K8S_PODS):
        ns = f"team-{p % K8S_NAMESPACES:02d}"
        pod = (f"svc{p // 4}-{rng.randrange(16 ** 9):09x}-"
               f"{rng.randrange(36 ** 5):05x}")
        if rng.random() < 0.9:
            labels = {f"app.kubernetes.io/l{k}": f"v{rng.randrange(99)}"
                      for k in range(rng.randrange(2, 9))}
            anns = {f"note/{k}": "x" * rng.randrange(1, 30)
                    for k in range(rng.randrange(0, 5))}
            meta = {"metadata": {"name": pod, "namespace": ns,
                                 "uid": f"{rng.randrange(16 ** 32):032x}",
                                 "labels": labels, "annotations": anns},
                    "spec": {"nodeName":
                             f"node-{rng.randrange(K8S_NODES):02d}"}}
            metas[(ns, pod)] = meta
            with open(os.path.join(cache_dir, f"{ns}_{pod}.meta"), "w") as f:
                json.dump(meta, f)
        for c in range(rng.randrange(1, 4)):
            ctr = ["app", "sidecar", "log_shipper"][c]
            tags.append(f"kube.var.log.containers.{pod}_{ns}_{ctr}-"
                        f"{rng.randrange(16 ** 64):064x}.log")
    weights = 1.0 / np.arange(1, len(tags) + 1) ** K8S_TAG_ZIPF_S
    weights /= weights.sum()
    nprng = np.random.default_rng(seed)

    def pick_tag() -> str:
        return tags[int(nprng.choice(len(tags), p=weights))]

    per_tag: dict = {}
    conns = [[] for _ in range(K8S_CONNS)]
    conn_of = {t: i % K8S_CONNS for i, t in enumerate(tags)}
    n = sent = 0
    small_left = int(n_records * K8S_SMALL_SHARE)
    while n < n_records:
        if small_left > 0 and rng.random() < 0.75:
            mode = rng.choice(["message", "forward"])
            size = 1 if mode == "message" else rng.randrange(2, 32)
            small_left -= size
        else:
            mode = rng.choice(["packed", "gzip"])
            size = rng.randrange(256, 4097)
        size = min(size, n_records - n)
        tag = pick_tag()
        ents, raws = [], []
        for _ in range(size):
            sec = 1714560000 + n // 64
            ts = (EventTime(sec, (n * 7919) % 10 ** 9) if n % 5
                  else sec if n % 10 else sec + (n % 1000) / 1000.0)
            rec = {"log": k8s_log(rng, n), "stream":
                   "stderr" if rng.random() < 0.2 else "stdout",
                   "time": f"2024-05-01T12:00:{n % 60:02d}.{n:09d}Z"}
            ents.append([ts, rec])
            raws.append(packb([ts, rec]).replace(
                K8S_INVALID.encode(), K8S_INVALID_BYTES))
            n += 1
        cid = f"{conn_of[tag]}-{sent}"
        sent += 1
        option = {"chunk": cid}
        if mode == "message":
            wire = packb([tag, ents[0][0], ents[0][1], option])
        elif mode == "forward":
            wire = packb([tag, ents, option])
        else:
            blob = b"".join(raws)
            if mode == "gzip":
                option["compressed"] = "gzip"
                blob = gzip.compress(blob, compresslevel=1)
            wire = packb([tag, blob, option])
        if mode in ("message", "forward"):
            wire = wire.replace(K8S_INVALID.encode(), K8S_INVALID_BYTES)
        ack = packb({"ack": cid})
        frame = (struct.pack(">I", len(wire)) + wire
                 + struct.pack(">I", len(ack)) + ack)
        conns[conn_of[tag]].append(frame)
        per_tag.setdefault(tag, []).append(ents)
        if sent % round(1 / K8S_RESEND_SHARE) == 0:
            conns[conn_of[tag]].append(("resend", frame))
    # each resend goes later on its connection than the message it repeats
    resends = 0
    for c, frames in enumerate(conns):
        out, pending = [], []
        for f in frames:
            if isinstance(f, tuple):
                pending.append(f[1])
                resends += 1
            else:
                out.append(f)
                if pending and rng.random() < 0.5:
                    out.append(pending.pop(0))
        conns[c] = b"".join(out + pending)
    return {"conns": conns, "per_tag": per_tag, "metas": metas,
            "tags": tags, "records": n, "messages": sent,
            "resends": resends,
            "device_appends": sum(len(e) >= 32 for v in per_tag.values()
                                  for e in v),
            "wire_bytes": sum(len(c) for c in conns)}


def config5_expected(traffic: dict) -> dict:
    """The records each tag must reach the output with, computed here:
    Python ``re`` on the tag, the ``.meta`` JSON, ``json.loads`` of the
    ``log`` after ``rstrip`` with the record's keys winning, and
    ``"health-check"`` searched in ``log``."""
    out = {}
    for tag, messages in traffic["per_tag"].items():
        m = K8S_TAG_PY.match(tag)
        ident = m.groupdict()
        meta = traffic["metas"].get((ident["namespace_name"],
                                     ident["pod_name"]), {})
        k8s = dict(ident)
        md, spec = meta.get("metadata", {}), meta.get("spec", {})
        if md.get("uid"):
            k8s["pod_id"] = md["uid"]
        if spec.get("nodeName"):
            k8s["host"] = spec["nodeName"]
        if md.get("labels"):
            k8s["labels"] = md["labels"]
        if md.get("annotations"):
            k8s["annotations"] = md["annotations"]
        rows = []
        for ents in messages:
            for ts, rec in ents:
                body = dict(rec)
                body["log"] = body["log"].replace(
                    K8S_INVALID, K8S_INVALID_BYTES.decode("utf-8",
                                                          "replace"))
                text = body["log"].rstrip()
                if text.startswith("{"):
                    try:
                        parsed = json.loads(text)
                    except ValueError:
                        parsed = None
                    if isinstance(parsed, dict):
                        for k, v in parsed.items():
                            body.setdefault(k, v)
                body["kubernetes"] = k8s
                if K8S_EXCLUDE not in body["log"]:
                    rows.append((ts, body))
        if rows:
            out[tag] = rows
    return out


def run_config5(flb, tcf, device: str, traffic: dict, cache_dir,
                work_dir: str) -> dict:
    """Config 5 on ``device``: with ``cache_dir`` None,
    ``conf/baseline5-k8s.conf`` loaded as written through the port's
    loader with only its Port set to 0 (an ephemeral one); else the same
    chain with the preload cache and a ``lib`` output beside ``null``.
    Four client processes send the traffic (one connection each, every
    ack awaited); the wall runs from their start to the last ack."""
    chunks = []
    if cache_dir is None:
        conf = tcf.load_config_file(CONFIG5_CONF)
        inp = next(s for s in conf.sections if s.name == "input")
        inp.properties = [(k, "0" if k.lower() == "port" else v)
                          for k, v in inp.properties]
        ctx = flb.create(device=device)
        tcf.apply_to_context(ctx, conf, os.path.dirname(CONFIG5_CONF))
    else:
        ctx = flb.create(device=device, flush="1", grace="2")
        ffd = ctx.input("forward", port="0")
        ctx.filter("kubernetes", match="kube.*", merge_log="on",
                   buffer_size="0", kube_meta_preload_cache_dir=cache_dir)
        ctx.filter("grep", match="kube.*", exclude=f"log {K8S_EXCLUDE}")
        ctx.output("null", match="*")
        ctx.output("lib", match="*",
                   callback=lambda data, tag: chunks.append((tag, data)))
    paths = []
    for c, frames in enumerate(traffic["conns"]):
        paths.append(os.path.join(work_dir, f"conn{c}.bin"))
        with open(paths[-1], "wb") as f:
            f.write(frames)
    ctx.start()
    procs = []
    try:
        port = ctx.engine.inputs[0].plugin.bound_port
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", K8S_CLIENT, p,
                                   str(port)]) for p in paths]
        rcs = [p.wait(timeout=900) for p in procs]
        wall = time.perf_counter() - t0
        ctx.flush_now()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        ctx.stop()
    if any(rcs):
        raise SystemExit(f"config 5 ({device}): a client failed: {rcs}")
    kube = ctx.engine.filters[0].plugin
    grep = ctx.engine.filters[1].plugin
    return {"chunks": chunks, "wall": wall,
            "kube_steps": list(kube.step_seconds),
            "grep_steps": list(grep.match_seconds),
            "program": grep._program,
            "health": ctx.engine.inputs[0].plugin.health_block(),
            "metrics": ctx.engine.metrics.to_prometheus()}


def config5_k4(np, torch, tg, assemble, prog, traffic: dict) -> list:
    """K4 at config 5's own rows: the ``log`` values of the largest and
    of the smallest PackedForward message staged as grep stages them,
    [1, Bp, 512], against its plain version on the card, with times and
    bound."""
    from fluentbit_tpu_torch.ops.batch import bucket_size

    msgs = [e for v in traffic["per_tag"].values() for e in v
            if len(e) >= 256]
    out = []
    for ents in (max(msgs, key=len), min(msgs, key=len)):
        vals = [rec["log"].replace(K8S_INVALID, K8S_INVALID_BYTES.decode(
            "utf-8", "replace")).encode() for _ts, rec in ents]
        Bp = bucket_size(len(vals), max_len=L)
        staged = assemble(vals, L, Bp)
        b = torch.from_numpy(staged.batch[None]).cuda()
        ln = torch.from_numpy(staged.lengths[None]).cuda()
        before = tg.grep_assoc.launches
        got = prog.dispatch(b, ln)
        launches = tg.grep_assoc.launches - before
        k4 = leaf_calls(tg, prog, b, ln, "assoc")
        pl = leaf_calls(tg, prog, b, ln, "plain")
        plain = merged(torch, prog, [c() for c in pl])
        torch.cuda.synchronize()
        mism = int((got != plain).sum())
        res = {"shape": [1, Bp, L], "records": len(vals),
               "overflow_rows": len(staged.overflow), "launches": launches,
               "mismatches": mism,
               "max_abs_err": int((got.int() - plain.int()).abs().max()),
               "matched_rows": int(got.sum()),
               "ms": cuda_ms(torch, lambda: [c() for c in k4], 30),
               "host_enqueue_ms": host_ms(torch, lambda: [c() for c in k4],
                                          30),
               "plain_ms": cuda_ms(torch, lambda: [c() for c in pl], 3),
               "k_groups": prog.decision()["k_groups"],
               "max_states": [leaf.max_states
                              for leaf in prog._children or [prog]]}
        res["bound_ms"], res["bound_by"] = bound_ms(
            torch, prog, b, ln, table_bytes_read(torch, tg, prog, b, ln))
        log("config5-k4-vs-plain: " + json.dumps(res))
        if mism or launches != 1 or not 0 < res["matched_rows"] < Bp:
            raise SystemExit(f"K4 on config 5's rows failed: {res}")
        out.append(res)
    return out


def phase_config5(np, torch, tg, assemble, flb, tcf, decode_events,
                  seed: int, card: str) -> dict:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "meta")
        os.mkdir(cache)
        t0 = time.perf_counter()
        traffic = make_k8s_traffic(np, seed, cache)
        make_s = time.perf_counter() - t0
        want = config5_expected(traffic)
        tg.grep_assoc.launches = tg.grep_dfa.launches = 0
        as_written = run_config5(flb, tcf, "cuda", traffic, None, tmp)
        launches_conf = {"grep_assoc": tg.grep_assoc.launches,
                         "grep_dfa": tg.grep_dfa.launches}
        tg.grep_assoc.launches = tg.grep_dfa.launches = 0
        gpu = run_config5(flb, tcf, "cuda", traffic, cache, tmp)
        launches = {"grep_assoc": tg.grep_assoc.launches,
                    "grep_dfa": tg.grep_dfa.launches}
        cpu = run_config5(flb, tcf, "cpu", traffic, cache, tmp)

    def by_tag(run) -> dict:
        out: dict = {}
        for tag, data in run["chunks"]:
            out.setdefault(tag, []).append(data)
        return {t: b"".join(v) for t, v in out.items()}

    got, ref = by_tag(gpu), by_tag(cpu)
    decoded = {t: [(ev.timestamp, ev.body) for ev in decode_events(v)]
               for t, v in got.items()}
    k4 = config5_k4(np, torch, tg, assemble, gpu["program"], traffic)

    def p50(steps, names) -> dict:
        return {k: statistics.median(s[i] for s in steps) * 1e3
                for i, k in enumerate(names)}

    def kube_p50(run) -> dict:
        """The filter's p50 ms on appends of >= 32 records (those that
        reach K4) and on the smaller ones."""
        big = [t for n, t in run["kube_steps"] if n >= 32]
        small = [t for n, t in run["kube_steps"] if n < 32]
        return {"appends_ge_32": statistics.median(big) * 1e3,
                "appends_lt_32": statistics.median(small) * 1e3}

    grep_steps = ("staging", "launch_readback", "overflow_regex")
    expected = {"grep_assoc": traffic["device_appends"], "grep_dfa": 0}
    n_out = sum(len(v) for v in want.values())
    res = {"records": traffic["records"], "messages": traffic["messages"],
           "resends": traffic["resends"], "tags": len(traffic["tags"]),
           "tags_sent": len(traffic["per_tag"]),
           "wire_bytes": traffic["wire_bytes"], "traffic_make_s": make_s,
           "records_out": n_out,
           "kernel_resolved": gpu["program"].decision()["kernel_resolved"],
           "equal_cpu": got == ref,
           "equal_python_check": decoded == want,
           "launches": launches, "launches_as_written": launches_conf,
           "expected_launches": expected,
           "health": gpu["health"], "health_cpu": cpu["health"],
           "health_as_written": as_written["health"],
           "lines_per_s": traffic["records"] / gpu["wall"],
           "cpu_lines_per_s": traffic["records"] / cpu["wall"],
           "as_written_lines_per_s": traffic["records"] / as_written["wall"],
           "kube_p50_ms": kube_p50(gpu), "cpu_kube_p50_ms": kube_p50(cpu),
           "grep_p50_ms": p50(gpu["grep_steps"], grep_steps),
           "cpu_grep_p50_ms": p50(cpu["grep_steps"], grep_steps),
           "grep_device_appends": len(gpu["grep_steps"]),
           "k4_ms": k4[0]["ms"], "k4_shape": k4[0]["shape"],
           "k4_busy_share": (k4[0]["ms"] * traffic["device_appends"]
                             / (gpu["wall"] * 1e3)),
           "card": card}
    log("config5: " + json.dumps(res))
    failed = [k for k in ("equal_cpu", "equal_python_check") if not res[k]]
    absorbed = traffic["messages"]
    for h in (res["health"], res["health_cpu"], res["health_as_written"]):
        if (h["absorbed"], h["dedup_hits"]) != (absorbed, traffic["resends"]):
            failed.append("dedup")
    if (launches != expected or launches_conf != expected
            or res["grep_device_appends"] != expected["grep_assoc"]
            or not expected["grep_assoc"]
            or res["kernel_resolved"] != "assoc"):
        failed.append("launches")
    if failed:
        raise SystemExit(f"config 5 failed {failed}: {res}")
    res["k4_rows"] = k4
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fluentbit_tpu_torch as flb
    from fluentbit_tpu_torch import config_format as tcf
    from fluentbit_tpu_torch.codec.events import decode_events, encode_event
    from fluentbit_tpu_torch.codec.msgpack import EventTime
    from fluentbit_tpu_torch.flux import kernels as tfk
    from fluentbit_tpu_torch.ops import cuda_build
    from fluentbit_tpu_torch.ops import grep as tg
    from fluentbit_tpu_torch.ops import mesh as tmesh
    from fluentbit_tpu_torch.ops import sketch as tsk
    from fluentbit_tpu_torch.ops import utf8 as tu
    from fluentbit_tpu_torch.ops.batch import assemble
    from fluentbit_tpu_torch.ops.device import describe, resolve
    from fluentbit_tpu_torch.regex.dfa import compile_dfa

    t_all = time.perf_counter()
    # the event codec extension builds against these headers: a host
    # without them fails the build below, by name
    include = cuda_build.python_include()
    log("python_include: " + json.dumps({
        "path": include,
        "python_h": os.path.isfile(os.path.join(include, "Python.h"))}))
    env = environment(torch)
    log("env: " + json.dumps(env))

    # fresh build from the sources in this checkout
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    sources = list(cuda_build.SOURCES)
    cuda_build.libraries.build(sources)
    for name in sources:
        cuda_build.libraries.load(name)
    build = {"seconds": time.perf_counter() - t0,
             "kernels": {n: {"compile_seconds": v["seconds"],
                             "ptxas": [ln for ln in v["ptxas"].splitlines()
                                       if "Used" in ln or "spill" in ln]}
                         for n, v in cuda_build.libraries.build_log.items()}}
    log("build: " + json.dumps(build))
    # the redesigned kernels' full ptxas report (registers, shared
    # memory, spills per instantiation)
    log("ptxas: " + json.dumps({n: cuda_build.libraries.build_log[n]["ptxas"]
                                for n in ("sketch", "utf8")}))

    seconds = {}
    mark = [time.perf_counter()]

    def timed(name, fn, *fargs):
        """Run one phase and note its wall seconds."""
        out = fn(*fargs)
        now = time.perf_counter()
        seconds[name] = now - mark[0]
        mark[0] = now
        return out

    variants = timed("kernels", phase_kernels, np, torch, tg, compile_dfa,
                     args.seed)
    appends = make_appends(args.seed, APPENDS, RECORDS)
    pipeline = timed("pipeline", phase_pipeline, tg, flb, decode_events,
                     appends, env["card"])
    chunks = encode_chunks(encode_event, EventTime, appends)
    raw_chunks = timed("raw_chunks", phase_raw_chunks, tg, flb,
                       decode_events, chunks, appends, env["card"])
    mesh = timed("mesh", phase_mesh, np, torch, tg, tmesh, compile_dfa, flb,
                 chunks, args.seed, env["card"])
    timed("delivery", phase_delivery, tg, flb, decode_events,
          appends, env["card"], pipeline["regex"]["launches"]["grep_dfa"])
    sketches = timed("sketch_kernels", phase_sketch_kernels, np, torch, tsk,
                     assemble, args.seed)
    config4 = timed("config4", phase_config4, np, torch, tsk, flb, args.seed,
                    env["card"], sketches)
    flux_kernels = timed("flux_kernels", phase_flux_kernels, np, torch, tsk,
                         tfk, args.seed)
    flux_appends = make_flux_appends(np, args.seed)
    flux = timed("flux", phase_flux, np, torch, tsk, tfk, tmesh, flb,
                 decode_events, flux_appends, env["card"], flux_kernels,
                 sketches)
    merge = timed("merge_kernel", phase_merge_kernel, torch, tsk, args.seed)
    mesh_sketch = timed("mesh_sketch", phase_mesh_sketch, np, torch, tsk,
                        tfk, tmesh, assemble, args.seed)
    sql = timed("sql", phase_sql, np, torch, tsk, tfk, tmesh, flb,
                decode_events, flux_appends[:APPENDS], env["card"])
    assoc = timed("assoc_kernels", phase_assoc_kernels, np, torch, tg,
                  compile_dfa, args.seed)
    config3 = timed("config3", phase_config3, tg, flb, decode_events,
                    args.seed, env["card"], assoc)
    # ~5% of config 2's times do not parse: the parser logs each one at
    # WARNING, as the reference does; keep them off the run's stderr
    logging.getLogger("flb.parser").setLevel(logging.ERROR)
    ndjson = ndjson_corpus(args.seed, CONFIG2_LINES)
    utf8 = timed("utf8_kernels", phase_utf8_kernels, np, torch, tu, assemble,
                 ndjson.split(b"\n")[:-1])
    config2 = timed("config2", phase_config2, np, torch, tu, assemble, flb,
                    decode_events, ndjson, env["card"])
    config2j = timed("config2j", phase_config2j, flb, decode_events, ndjson,
                     env["card"])
    timed("codec", phase_codec, args.seed, ndjson, env["card"])
    config2r = timed("config2r", phase_config2r, np, torch, tg, assemble, flb,
                     decode_events, args.seed, env["card"])
    config5 = timed("config5", phase_config5, np, torch, tg, assemble, flb,
                    tcf, decode_events, args.seed, env["card"])
    log("phase_seconds (each with the data made before it): "
        + json.dumps(seconds))

    main_shape = next(v for v in variants
                      if v["program"] == "apache2" and v["shape"][1] == 4096)
    kernels = {"kernels": [{
        "name": "grep_dfa",
        "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/grep_dfa.cu",
        "replaces": "fluentbit_tpu/ops/grep.py:394",
        "fuses": ["fluentbit_tpu/ops/grep.py:314",
                  "fluentbit_tpu/ops/grep.py:343"],
        "launches": pipeline["regex"]["launches"]["grep_dfa"],
        "launches_raw_chunks": raw_chunks["regex"]["launches"]["grep_dfa"],
        # config 2r's decoded run (an exact SP task on the tag); as
        # written, the parser's batch hook takes it with no kernel
        "launches_config2r": config2r["decoded"]["launches"]["grep_dfa"],
        "launches_config2r_raw": config2r["raw_launches"]["grep_dfa"],
        "config2r_k3": config2r["k3"],
        "config1_rows": mesh["main_rows"][0],
        "global_ms": main_shape["global_ms"],
        "max_abs_err": max([v["max_abs_err"] for v in variants]
                           + [config2r["k3"]["max_abs_err"],
                              mesh["main_rows"][0]["max_abs_err"]]),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "variants": variants,
    }]}
    replaces = {"hll_update": ("fluentbit_tpu/ops/sketch.py:137",
                               ["fluentbit_tpu/ops/sketch.py:40",
                                "fluentbit_tpu/ops/sketch.py:66",
                                "fluentbit_tpu/ops/sketch.py:76"]),
                "cms_update": ("fluentbit_tpu/ops/sketch.py:267",
                               ["fluentbit_tpu/ops/sketch.py:260"])}
    for name, (at, fuses) in replaces.items():
        cases = [r for r in sketches if r["kernel"] == name]
        main = next(r for r in cases if r["shape"][0] == RECORDS
                    and r.get("p", HLL_P) == HLL_P
                    and r.get("w", CMS_W) == CMS_W and not r.get("weighted"))
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "fluentbit_tpu_torch/csrc/sketch.cu",
            "replaces": at, "fuses": fuses,
            "launches": config4["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shape": main["shape"], "variants": cases})
    # K6's grouped form: the flux state's branch above 512 groups (the
    # reference runs it per group on the host, flux/state.py:476-492)
    grouped = [r for r in sketches if r["kernel"] == "hll_update_groups"]
    wide_k6 = next(r for r in grouped if r["case"] == "wide")
    kernels["kernels"].append({
        "name": "hll_update_groups", "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/sketch.cu",
        "replaces": "fluentbit_tpu/ops/sketch.py:137",
        "fuses": ["fluentbit_tpu/flux/state.py:488"],
        "launches": flux["launches"]["hll_update_groups"],
        "max_abs_err": max(r["max_abs_err"] for r in grouped),
        "ms": wide_k6["ms"], "plain_ms": wide_k6["plain_ms"],
        "bound_ms": wide_k6["bound_ms"], "bound_by": wide_k6["bound_by"],
        "host_enqueue_ms": wide_k6["host_enqueue_ms"],
        "library_ms": None, "shape": wide_k6["shape"],
        "groups": wide_k6["groups"], "variants": grouped})
    k10 = [r for r in flux_kernels if r["kernel"] == "fused_absorb"]
    k9 = [r for r in flux_kernels if r["kernel"] == "segment_counts"]
    main_k10 = next(r for r in k10 if r["case"] == "main")
    kernels["kernels"].append({
        "name": "flux_absorb", "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/sketch.cu",
        "replaces": "fluentbit_tpu/flux/kernels.py:189",
        "fuses": ["fluentbit_tpu/flux/kernels.py:80",
                  "fluentbit_tpu/ops/sketch.py:76",
                  "fluentbit_tpu/ops/sketch.py:267"],
        "launches": flux["launches"]["flux_absorb"],
        "max_abs_err": max(r["max_abs_err"] for r in k10),
        "ms": main_k10["ms"], "plain_ms": main_k10["plain_ms"],
        "bound_ms": main_k10["bound_ms"], "bound_by": main_k10["bound_by"],
        "library_ms": None, "shape": main_k10["shape"], "variants": k10})
    # K9 is K10's counts-only launch: the flux path counts inside K10, so
    # its own launch has no caller on the main path
    kernels["kernels"].append({
        "name": "segment_counts", "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/sketch.cu",
        "replaces": "fluentbit_tpu/flux/kernels.py:80",
        "on_main_path": False,
        "launches": flux["launches"]["segment_counts"],
        "max_abs_err": max(r["max_abs_err"] for r in k9),
        "ms": k9[0]["ms"], "plain_ms": k9[0]["plain_ms"],
        "bound_ms": k9[0]["bound_ms"], "bound_by": k9[0]["bound_by"],
        "library_ms": k9[0]["library_ms"], "shape": k9[0]["shape"],
        "variants": k9})
    main_k4 = next(r for r in assoc if r["program"] == "config3"
                   and r["shape"][1] == TAIL_BUCKET and r["segment"] == 32)
    kernels["kernels"].append({
        "name": "grep_assoc", "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/grep_assoc.cu",
        "replaces": "fluentbit_tpu/ops/grep.py:413",
        # config 3's decoded run (an exact SP task on the tag); as
        # written, rewrite_tag's batch hook takes it with no kernel
        "launches": config3["decoded"]["launches"]["grep_assoc"],
        "launches_config3_raw": config3["raw_launches"]["grep_assoc"],
        "launches_config1_exclude": pipeline["regex+exclude"]["launches"][
            "grep_assoc"],
        "config1_exclude_rows": mesh["main_rows"][1],
        "launches_config5": config5["launches"]["grep_assoc"],
        "config5_rows": config5["k4_rows"],
        "max_abs_err": max([r["max_abs_err"] for r in assoc]
                           + [mesh["main_rows"][1]["max_abs_err"]]
                           + [r["max_abs_err"] for r in config5["k4_rows"]]),
        "ms": main_k4["ms"], "plain_ms": main_k4["plain_ms"],
        "bound_ms": main_k4["bound_ms"], "bound_by": main_k4["bound_by"],
        "library_ms": None, "k3_ms": main_k4["k3_ms"],
        "shape": main_k4["shape"], "variants": assoc})
    main_k5 = next(r for r in mesh["cases"] if r["program"] == "apache2"
                   and r["shards"] == 8)
    kernels["kernels"].append({
        "name": "grep_mesh", "route": "cuda",
        "source": "fluentbit_tpu_torch/ops/grep.py",
        "kernels": ["fluentbit_tpu_torch/csrc/grep_dfa.cu",
                    "fluentbit_tpu_torch/csrc/grep_assoc.cu"],
        "replaces": "fluentbit_tpu/ops/grep.py:741",
        "fuses": ["fluentbit_tpu/ops/grep.py:509",
                  "fluentbit_tpu/ops/grep.py:551",
                  "fluentbit_tpu/ops/grep.py:624",
                  "fluentbit_tpu/ops/grep.py:805"],
        "launches": mesh["filter_branch"]["launches"]["grep_mesh"],
        "max_abs_err": max(r["max_abs_err"] for r in mesh["cases"]),
        "ms": main_k5["ms"], "plain_ms": main_k5["plain_ms"],
        "bound_ms": main_k5["bound_ms"], "bound_by": main_k5["bound_by"],
        "library_ms": None, "shape": main_k5["shape"],
        "shards": main_k5["shards"], "counts_epilogue": mesh["epilogue"],
        "variants": mesh["cases"]})
    main_k11 = next(r for r in utf8 if r["case"] == "config2_lines"
                    and r["shape"][0] == UTF8_B)
    kernels["kernels"].append({
        "name": "utf8_validate", "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/utf8.cu",
        "replaces": "fluentbit_tpu/ops/utf8.py:121",
        "launches": config2["utf8"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in utf8),
        "ms": main_k11["ms"], "plain_ms": main_k11["plain_ms"],
        "bound_ms": main_k11["bound_ms"], "bound_by": main_k11["bound_by"],
        "library_ms": None, "shape": main_k11["shape"], "variants": utf8})
    main_merge = next(r for r in merge if r["op"] == "max")
    kernels["kernels"].append({
        "name": "shard_merge", "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/sketch.cu",
        "replaces": "fluentbit_tpu/flux/kernels.py:232",
        "fuses": ["fluentbit_tpu/flux/kernels.py:221",
                  "fluentbit_tpu/flux/kernels.py:242",
                  "fluentbit_tpu/flux/kernels.py:129",
                  "fluentbit_tpu/ops/sketch.py:440",
                  "fluentbit_tpu/ops/sketch.py:506"],
        "launches": sql["launches"]["cuda_mesh"]["shard_merge"],
        "launches_flux_filter_mesh": flux["mesh_launches"]["shard_merge"],
        "max_abs_err": max(r["max_abs_err"] for r in merge),
        "ms": main_merge["ms"], "plain_ms": main_merge["plain_ms"],
        "bound_ms": main_merge["bound_ms"],
        "bound_by": main_merge["bound_by"],
        # no single PyTorch call computes max(base, max over shards) in
        # place; the yardstick is two calls (amax, then maximum into base)
        "library_ms": None,
        "same_function_ms": main_merge["same_function_ms"],
        "same_function": "torch.maximum(base, parts.amax(0), out=base)",
        "partials_only_ms": main_merge["partials_only_ms"],
        "shape": main_merge["shape"], "variants": merge})
    mesh_rows = {
        "hll": ("hll_mesh", "fluentbit_tpu/ops/sketch.py:449",
                ["fluentbit_tpu/ops/sketch.py:421",
                 "fluentbit_tpu/ops/sketch.py:478",
                 "fluentbit_tpu/ops/sketch.py:400"], RECORDS),
        "cms": ("cms_mesh", "fluentbit_tpu/ops/sketch.py:515",
                ["fluentbit_tpu/ops/sketch.py:486",
                 "fluentbit_tpu/ops/sketch.py:542"], RECORDS),
        "segment_counts": ("segment_counts_mesh",
                           "fluentbit_tpu/flux/kernels.py:139",
                           ["fluentbit_tpu/flux/kernels.py:110"], RECORDS),
        "fused_absorb": ("flux_absorb_mesh",
                         "fluentbit_tpu/flux/kernels.py:348",
                         ["fluentbit_tpu/flux/kernels.py:189",
                          "fluentbit_tpu/flux/kernels.py:287"], RECORDS)}
    for program, (name, at, fuses, B) in mesh_rows.items():
        cases = [r for r in mesh_sketch if r["program"] == program]
        main = next(r for r in cases if r["shards"] == MESH_N
                    and r["shape"][0] == B)
        on_path = program == "fused_absorb"
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": ("fluentbit_tpu_torch/flux/kernels.py"
                       if program in ("segment_counts", "fused_absorb")
                       else "fluentbit_tpu_torch/ops/sketch.py"),
            "kernels": ["fluentbit_tpu_torch/csrc/sketch.cu"],
            "replaces": at, "fuses": fuses, "on_main_path": on_path,
            # K10's mesh half: the SQL run on the 8-shard mesh; the
            # others have no caller in the pipeline, as in the reference:
            # their own phase's shard launches over n = 1, 2, 8
            "launches": (sql["launches"]["cuda_mesh"]["flux_absorb_mesh"]
                         if on_path else
                         sum(next(iter(r["launches"].values()))
                             for r in cases)),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "unsharded_ms": main["unsharded_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"), "shape": main["shape"],
            "shards": MESH_N, "variants": cases})
    log(f"total_seconds: {time.perf_counter() - t_all:.1f}")
    log(env["card"])
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": describe(resolve("cuda:0"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fluentbit_tpu_torch``) on one GPU.

Run from the repository root on a host with a CUDA card:

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. environment: torch/CUDA/nvcc/triton versions, the card's name and power
   limit;
2. build: the main path's kernel from ``fluentbit_tpu_torch/csrc`` with
   ``nvcc``, with ptxas' report;
3. kernel against plain: the ``grep_dfa`` kernel against its plain torch
   version on the card, bool for bool, on three programs (apache2 k=3, an
   even-k literal set, a mixed-k 3-rule set) at [R, 65536, 512] and the
   main path's [R, 4096, 512], with CUDA-event times of both;
4. pipeline: BASELINE config 1 (lib input → grep apache2 → lib output),
   64 appends of 4096 records, through
   ``fluentbit_tpu_torch.create(device="cuda")``, then again with
   an Exclude rule in front; each run's output bytes must equal the same
   pipeline on ``device="cpu"``, the kept records must equal a Python
   ``re`` filter over the input, and the kernel's launch count must show
   every append of >= 32 records went through it.

The card's name and power limit (as ``nvidia-smi`` gives them) come
before the kernels JSON line, which is the line before the last; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
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

EVEN_K = ["GET", "DENY"]             # literal rules: k = 6, pair tables
MIXED_K = [APACHE2, "GET", r"^\d+ GET"]  # k = 3, 6, 5: three child programs

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


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, warmed, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
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
    results = []
    programs = [("apache2", [APACHE2]), ("even_k_literals", EVEN_K),
                ("mixed_k", MIXED_K)]
    for name, patterns in programs:
        prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L, dev)
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
            p_ms = cuda_ms(torch, lambda: plain_dispatch(torch, tg, prog,
                                                         tables, b, ln), 3)
            bms, by = bound_ms(torch, prog, b, ln,
                               table_bytes_read(torch, tg, prog, b, ln))
            res = {"program": name, "shape": [R, B, L],
                   "k_groups": prog.decision()["k_groups"],
                   "launches": launches, "mismatches": mism, "max_abs_err": err,
                   "matched_rows": int(got.sum()), "ms": k_ms,
                   "plain_ms": p_ms, "bound_ms": bms, "bound_by": by}
            log("kernel-vs-plain: " + json.dumps(res))
            if mism:
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


def run_pipeline(flb, device: str, appends: list, exclude: bool) -> tuple:
    out = []
    ctx = flb.create(device=device, flush="50ms", grace="2")
    in_ffd = ctx.input("lib", tag="bench.apache")
    f = ctx.filter("grep", match="bench.*")
    if exclude:
        ctx.set(f, exclude="log " + EXCLUDE)
    ctx.set(f, regex="log " + APACHE2)
    ctx.output("lib", match="*", callback=lambda data, tag: out.append(data))
    ctx.start()
    t0 = time.perf_counter()
    try:
        for _recs, text in appends:
            ctx.push(in_ffd, text)
        ctx.flush_now()
        wall = time.perf_counter() - t0
    finally:
        ctx.stop()
    grep = ctx.engine.filters[0].plugin
    return b"".join(out), wall, list(grep.match_seconds), grep._program


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


def phase_pipeline(tg, flb, decode_events, seed: int, card: str) -> dict:
    appends = make_appends(seed, APPENDS, RECORDS)
    n_records = APPENDS * RECORDS
    device_appends = sum(len(r) >= 32 for r, _ in appends)
    report = {}
    for exclude in (False, True):
        label = "regex+exclude" if exclude else "regex"
        tg.grep_dfa.launches = 0
        got, wall, match_s, prog = run_pipeline(flb, "cuda", appends, exclude)
        launches = tg.grep_dfa.launches
        k_groups = len(prog.decision()["k_groups"])
        ref, cpu_wall, _, _ = run_pipeline(flb, "cpu", appends, exclude)
        bodies = [ev.body for ev in decode_events(got)]
        want = expected_bodies(appends, exclude)
        res = {"rules": label, "records": n_records, "appends": len(appends),
               "kept": len(bodies), "bytes_equal_cpu": got == ref,
               "kept_equals_python_re": bodies == want,
               "launches": launches, "expected_launches":
                   device_appends * k_groups,
               "lines_per_s": n_records / wall,
               "p50_append_match_ms": statistics.median(match_s) * 1e3,
               "cpu_lines_per_s": n_records / cpu_wall, "card": card}
        log("pipeline: " + json.dumps(res))
        if not res["bytes_equal_cpu"]:
            raise SystemExit(f"{label}: cuda output bytes differ from cpu")
        if not res["kept_equals_python_re"]:
            raise SystemExit(f"{label}: kept records differ from Python re "
                             f"({len(bodies)} vs {len(want)})")
        if launches != res["expected_launches"] or launches == 0:
            raise SystemExit(f"{label}: {launches} kernel launches, expected "
                             f"{res['expected_launches']}")
        report[label] = res
    return report


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
    from fluentbit_tpu_torch.codec.events import decode_events
    from fluentbit_tpu_torch.ops import cuda_build
    from fluentbit_tpu_torch.ops import grep as tg
    from fluentbit_tpu_torch.ops.device import describe, resolve
    from fluentbit_tpu_torch.regex.dfa import compile_dfa

    t_all = time.perf_counter()
    env = environment(torch)
    log("env: " + json.dumps(env))

    # fresh build from the sources in this checkout
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    cuda_build.libraries.load("grep_dfa")
    build = {"seconds": time.perf_counter() - t0,
             "kernels": {n: {"nvcc_seconds": v["seconds"],
                             "ptxas": [ln for ln in v["ptxas"].splitlines()
                                       if "Used" in ln or "spill" in ln]}
                         for n, v in cuda_build.libraries.build_log.items()}}
    log("build: " + json.dumps(build))

    variants = phase_kernels(np, torch, tg, compile_dfa, args.seed)
    pipeline = phase_pipeline(tg, flb, decode_events, args.seed, env["card"])

    main_shape = next(v for v in variants
                      if v["program"] == "apache2" and v["shape"][1] == 4096)
    kernels = {"kernels": [{
        "name": "grep_dfa",
        "route": "cuda",
        "source": "fluentbit_tpu_torch/csrc/grep_dfa.cu",
        "replaces": "fluentbit_tpu/ops/grep.py:394",
        "fuses": ["fluentbit_tpu/ops/grep.py:314",
                  "fluentbit_tpu/ops/grep.py:343"],
        "launches": pipeline["regex"]["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "variants": variants,
    }]}
    log(f"total_seconds: {time.perf_counter() - t_all:.1f}")
    log(env["card"])
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": describe(resolve("cuda:0"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

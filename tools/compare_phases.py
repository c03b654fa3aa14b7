"""Run pipelines through one tree's own chip_smoke.py phases.

    python tools/compare_phases.py <tree root> [config1] [config1null]
        [config2] [config2j] [config2r] [config3] [config4] [config5]
        [delivery] [flux]

On a host with a CUDA card. The tree's root (a checkout, or a
``git archive`` of another commit unpacked in a git-ignored directory)
goes first on ``sys.path``, so its ``fluentbit_tpu_torch`` and its
``chip_smoke.py`` run; the phases get the seed 0 and, where a phase
only reads a kernel's time for a busy share, a fixed stand-in. config1
is the raw path on pre-encoded chunks (``phase_raw_chunks``: regex, then
regex + Exclude, with the p50 raw steps, the overflow re-check among
them); config1null is the same chunks, regex only, into a null output
(built here from the tree's package, so every tree has it); delivery is
the smoke's delivery phase (config 1's appends to a file output that
retries and to out_retry, then under a route_condition). config2j and
delivery are phases a tree before them lacks (then reported as
failed). Prints one line ``compare: <root>
{...}`` with each phase's lines/s, p50 steps and launches (or its
failure). To compare two trees, run them in turns in one call: parent,
change, change, parent.
"""
import importlib.util
import json
import logging
import os
import sys

KEYS = ("lines_per_s", "ingest_lines_per_s", "p50_latency_s", "cpu_lines_per_s", "hook", "cpu_hook", "p50_ms",
        "cpu_p50_ms", "appends", "launches", "raw_launches",
        "mesh_lines_per_s", "p50_append_raw", "cpu_p50_append_raw",
        "as_written_lines_per_s", "kube_p50_ms", "grep_p50_ms",
        "p50_ms_cardinality", "p50_ms_frequency")


def pick(res: dict) -> dict:
    """The KEYS of a phase's result; config1's per rule set, delivery's
    per run."""
    if "regex" in res:
        return {label: pick(r) for label, r in res.items()}
    if "routed" in res:
        return {label: pick(res[label]) for label in ("raw", "routed")}
    return {k: res[k] for k in KEYS if k in res}


def config1_null(cs, flb, chunks: list) -> dict:
    """Config 1's pre-encoded chunks (regex only) on cuda into a null
    output: lines/s from the first append until ``flush_now`` returns."""
    import time

    ctx = flb.create(device="cuda", flush="50ms", grace="2")
    ctx.input("lib", tag="bench.apache")
    ctx.filter("grep", match="bench.*", regex="log " + cs.APACHE2)
    ctx.output("null", match="*")
    ctx.start()
    ins = ctx.engine.inputs[0]
    try:
        t0 = time.perf_counter()
        for data, n in chunks:
            ctx.engine.input_log_append(ins, "bench.apache", data, n)
        ctx.flush_now()
        wall = time.perf_counter() - t0
    finally:
        ctx.stop()
    return {"lines_per_s": sum(n for _d, n in chunks) / wall}


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    which = sys.argv[2:]
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "smoke_under_test", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

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

    if not os.path.abspath(flb.__file__).startswith(root):
        raise SystemExit(f"imported {flb.__file__}, not the tree's")
    logging.getLogger("flb.parser").setLevel(logging.ERROR)
    if "--dry" in which:
        print("compare:", root, flb.__file__)
        return 0
    cuda_build.libraries.build(list(cuda_build.SOURCES))
    card = cs.card_line()
    out = {}
    ndjson = None
    for w in which:
        try:
            if w in ("config2", "config2j") and ndjson is None:
                ndjson = cs.ndjson_corpus(0, cs.CONFIG2_LINES)
            if w in ("config1", "config1null", "delivery"):
                appends = cs.make_appends(0, cs.APPENDS, cs.RECORDS)
                chunks = cs.encode_chunks(encode_event, EventTime, appends)
            if w == "config1":
                res = cs.phase_raw_chunks(tg, flb, decode_events, chunks,
                                          appends, card)
            elif w == "config1null":
                res = config1_null(cs, flb, chunks)
            elif w == "delivery":
                res = cs.phase_delivery(tg, flb, decode_events, appends,
                                        card, cs.APPENDS)
            elif w == "config2":
                res = cs.phase_config2(np, torch, tu, assemble, flb,
                                       decode_events, ndjson, card)
            elif w == "config2j":
                res = cs.phase_config2j(flb, decode_events, ndjson, card)
            elif w == "config4":
                res = cs.phase_config4(np, torch, tsk, flb, 0, card, [
                    {"kernel": "hll_update", "shape": [cs.RECORDS, 256],
                     "p": cs.HLL_P, "ms": 0.0050},
                    {"kernel": "cms_update", "case": "path",
                     "ms": 0.0035}])
            elif w == "config5":
                res = cs.phase_config5(np, torch, tg, assemble, flb, tcf,
                                       decode_events, 0, card)
            elif w == "config3":
                res = cs.phase_config3(tg, flb, decode_events, 0, card, [
                    {"program": "config3", "shape": [8, cs.TAIL_BUCKET, 512],
                     "segment": 32, "ms": 0.0236}])
            elif w == "config2r":
                res = cs.phase_config2r(np, torch, tg, assemble, flb,
                                        decode_events, 0, card)
            elif w == "flux":
                res = cs.phase_flux(
                    np, torch, tsk, tfk, tmesh, flb, decode_events,
                    cs.make_flux_appends(np, 0), card,
                    [{"kernel": "fused_absorb", "case": "main",
                      "ms": 0.0074}],
                    [{"kernel": "hll_update", "shape": [cs.RECORDS, 256],
                      "p": 10, "ms": 0.0049},
                     {"kernel": "cms_update", "shape": [cs.RECORDS, 256],
                      "w": cs.CMS_W, "ms": 0.0051},
                     {"kernel": "hll_update_groups", "case": "wide",
                      "ms": 0.0049}])
            else:
                continue
            out[w] = pick(res)
        except SystemExit as e:  # a phase's failed check
            out[w] = {"failed": str(e)[:800]}
        except AttributeError as e:  # a phase this tree does not have
            out[w] = {"failed": str(e)[:800]}
    print("compare:", root, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

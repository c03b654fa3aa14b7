"""Run configs 3, 2r and flux through one tree's own chip_smoke.py phases.

    python tools/compare_phases.py <tree root> [config3] [config2r] [flux]

On a host with a CUDA card. The tree's root (a checkout, or a
``git archive`` of another commit unpacked in a git-ignored directory)
goes first on ``sys.path``, so its ``fluentbit_tpu_torch`` and its
``chip_smoke.py`` run; the phases get the seed 0 and, where a phase
only reads a kernel's time for a busy share, a fixed stand-in. Prints
one line ``compare: <root> {...}`` with each phase's lines/s, p50 steps
and launches (or its failure). To compare two trees, run them in turns
in one call: parent, change, change, parent.
"""
import importlib.util
import json
import logging
import os
import sys

KEYS = ("lines_per_s", "cpu_lines_per_s", "hook", "cpu_hook", "p50_ms",
        "cpu_p50_ms", "appends", "launches", "raw_launches",
        "mesh_lines_per_s")


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
    from fluentbit_tpu_torch.codec.events import decode_events
    from fluentbit_tpu_torch.flux import kernels as tfk
    from fluentbit_tpu_torch.ops import cuda_build
    from fluentbit_tpu_torch.ops import grep as tg
    from fluentbit_tpu_torch.ops import mesh as tmesh
    from fluentbit_tpu_torch.ops import sketch as tsk
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
    for w in which:
        try:
            if w == "config3":
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
            out[w] = {k: res[k] for k in KEYS if k in res}
        except SystemExit as e:  # a phase's failed check
            out[w] = {"failed": str(e)[:800]}
    print("compare:", root, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the expert-parallel MoE serving path goes, on one
CUDA card.

    PYTHONPATH=src python3 scripts/profile_torch_ep.py \
        [--mesh none 1x8 2x4] [--out build/profile_ep.json]

Builds olmoe-1b-7b at full width as ``chip_smoke.py`` phase 46 does
(bfloat16 weights from a seeded card generator) and, for each mesh
(``none``: no mesh; ``DxM``: a (data D, model M) mesh of entries of the
card), warms up and then traces phase 46's calls under
``torch.profiler``: one prefill of its B 8 x S 1,024 prompts and its 4
decode steps (``chip_smoke.ep_serve``), each in the profiler range
``serve.prefill`` or ``serve.decode``.  For each range, as
``profile_torch_lm.py`` reads it: calls, wall (profiler on), kernel
launches, device time, busy share, device time by kind of kernel and the
kernels that take the most.

Writes the numbers as JSON to ``--out`` and prints them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from profile_torch_lm import range_times  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", nargs="+", default=["none", "1x8", "2x4"])
    ap.add_argument("--out", default="build/profile_ep.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_ep: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.parallel.sharding import make_mesh

    smi = chip_smoke.nvidia_smi_line()
    device = torch.device("cuda")
    model, params, rec = chip_smoke.init_full(torch, chip_smoke.EP_ARCH,
                                              device)
    toks = chip_smoke.ep_tokens(np, torch, model.cfg, device)
    result = {"card": smi, "torch": torch.__version__, "model": rec,
              "batch": [chip_smoke.EP_BATCH, chip_smoke.EP_SEQ],
              "decode_steps": chip_smoke.EP_STEPS, "meshes": {}}
    for name in args.mesh:
        mesh = None
        if name != "none":
            shape = tuple(int(n) for n in name.split("x"))
            mesh = make_mesh(shape, ("data", "model"),
                             [device] * (shape[0] * shape[1]))
        chip_smoke.ep_serve(torch, model, params, toks, mesh)   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            calls, _ = chip_smoke.ep_serve(torch, model, params, toks, mesh)
            wall = time.perf_counter() - t0
        result["meshes"][name] = {
            "profiled_wall_s": wall,
            "launch_counts": [dict(kind=k, **{n: c for n, c in l.items()
                                              if c})
                              for k, _, l in calls],
            **range_times(torch, prof)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the port's CNN path goes, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_torch_cnn.py [--images 32]
        [--window 3] [--out build/profile_cnn.json]

Plans and serves the CNN path exactly as ``chip_smoke.py`` does (its
``plan_cnn_path`` and ``serve``: four AlexNet requests on U = 8 UAVs with
a fifth of the memory each, ``--images`` images per request through
``distributed_forward`` sliced by its placement), and reports:

* images/s over a serving window of at least ``--window`` seconds after
  a warm-up, with the spread per serve and per request
  (``chip_smoke.serve_window``);
* a ``torch.profiler`` trace of one serve: kernel launches, the summed
  device time of all kernels (busy share = device time / wall), the
  kernels with the most device time, and per profiler range of the CNN
  path (``cnn.conv``, ``cnn.pool``, ``cnn.fc``, and inside a conv layer
  ``conv2d.im2col`` and ``conv2d.gemm``) its calls, host time and the
  device time of the kernels launched inside it (``range_times``).

Writes the numbers as JSON to ``--out`` and prints them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)

RANGES = ("cnn.conv", "cnn.pool", "cnn.fc", "conv2d.im2col", "conv2d.gemm")


def range_times(torch, prof):
    """Per profiler range in ``RANGES``: calls, host time, and the device
    time of the kernels whose launch call lies inside it, nested ranges
    included.  A kernel is matched to its launch call by the tracer's
    correlation id, so kernels launched through ctypes count as well as
    PyTorch's own; kernels left unmatched are listed under "unattributed"."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in evs
             if e.name() in RANGES and e.device_type() != cuda]
    launch_at = {e.correlation_id(): e.start_ns() for e in evs
                 if e.device_type() != cuda and "Launch" in e.name()}
    out = {r: {"calls": 0, "host_s": 0.0, "device_s": 0.0, "kernels": 0}
           for r in RANGES}
    for t0, t1, name in spans:
        out[name]["calls"] += 1
        out[name]["host_s"] += (t1 - t0) * 1e-9
    lost = {"kernels": 0, "device_s": 0.0, "names": set()}
    for e in evs:
        if e.device_type() != cuda or e.name() in RANGES:
            continue
        t = launch_at.get(e.correlation_id())
        inside = [name for t0, t1, name in spans
                  if t is not None and t0 <= t <= t1]
        for name in inside:
            out[name]["device_s"] += e.duration_ns() * 1e-9
            out[name]["kernels"] += 1
        if not inside:
            lost["kernels"] += 1
            lost["device_s"] += e.duration_ns() * 1e-9
            lost["names"].add(e.name()[:60])
    lost["names"] = sorted(lost["names"])
    out["unattributed"] = lost
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--out", default="build/profile_cnn.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_cnn: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    smi = chip_smoke.nvidia_smi_line()
    _, plan, _, params, xs, plan_s = chip_smoke.plan_cnn_path(
        np, torch, "cuda", args.images)
    assigns = [s.assign for s in plan.placements]
    chip_smoke.serve(torch, params, xs, assigns)                # warm-up
    rate, n_serves, per_serve, walls = chip_smoke.serve_window(
        torch, params, xs, assigns, args.window)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.serve(torch, params, xs, assigns)
        prof_wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = [e for e in events if e.device_type == cuda
               and e.name not in RANGES
               and not getattr(e, "is_user_annotation", False)]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    dev_us = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    ranges = range_times(torch, prof)
    walls_ms = sorted(w * 1e3 for w in walls)
    result = {
        "card": smi, "torch": torch.__version__,
        "config": {"model": "alexnet", "uavs": chip_smoke.U,
                   "mem_frac": 0.2, "requests": len(assigns),
                   "images_per_request": args.images, "p2_steps": 200},
        "placements": [list(a) for a in assigns], "plan_s": plan_s,
        "window": {"images_per_s": rate, "serves": n_serves,
                   "serve_images_per_s_min": min(per_serve),
                   "serve_images_per_s_max": max(per_serve),
                   "request_ms_min": walls_ms[0],
                   "request_ms_median": walls_ms[len(walls_ms) // 2],
                   "request_ms_max": walls_ms[-1]},
        "profiled_wall_s": prof_wall,
        "kernel_launches": len(kernels),
        "device_busy_s": dev_us * 1e-6 if kernels else "not measured",
        "device_busy_share": dev_us * 1e-6 / prof_wall if kernels
        else "not measured",
        "ranges": ranges,
        "top_kernels": [{"name": n[:90], "launches": c, "device_s": t * 1e-6}
                        for n, (c, t) in top],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

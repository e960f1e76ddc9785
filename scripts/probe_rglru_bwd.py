#!/usr/bin/env python3
"""The RG-LRU reverse scan's ``tma`` route against variants of itself and
its ``simt`` kernel, on one CUDA card.

    PYTHONPATH=src python3 scripts/probe_rglru_bwd.py \
        [--out build/probe_rglru_bwd.json]

``csrc/rglru_scan_bwd.cu``'s ``tma`` route has three constants: the strip
a block owns (``WT``, 32 channels), the steps a box holds (``TT``, 64:
8 KB boxes in float32, 4 KB in bfloat16) and the ring's depth
(``STAGES``, 4).  This script builds copies of the source under
``build/probe_rglru_bwd/`` with one of them changed at a time:

* ``strip16``: 16-channel strips (twice the blocks, half a warp busy);
* ``stages3``, ``stages6``: a 3- or 6-stage ring;
* ``tt16``, ``tt32``: boxes of 16 or 32 steps;

and times each beside the source as it is (``shipped``) and its ``simt``
kernel (the launcher's route 0), at recurrentgemma-9b's training
call (B 1, T 4,096, W 4,096, float32, dhT given) and at its served
prefill's B 8 x T 1,345 in float32 and bfloat16: CUDA events over a graph
of 20 launches, every variant in turns, twice (the second pass in reverse
order).  Each variant's outputs are held bitwise against the shipped
route's, and those against ``rglru_bwd_ref`` on the first shape.

Writes the numbers as JSON to ``--out`` and prints them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)

WT = "constexpr int WT = 32;"
TT = "constexpr int TT = 64;"
STAGES = "constexpr int STAGES = 4;"
VARIANTS = {
    "shipped": [],
    "strip16": [(WT, "constexpr int WT = 16;")],
    "stages3": [(STAGES, "constexpr int STAGES = 3;")],
    "stages6": [(STAGES, "constexpr int STAGES = 6;")],
    "tt16": [(TT, "constexpr int TT = 16;")],
    "tt32": [(TT, "constexpr int TT = 32;")],
}
#: (B, T, W, dtype name)
SHAPES = [(1, 4096, 4096, "float32"), (8, 1345, 4096, "float32"),
          (8, 1345, 4096, "bfloat16")]


def edited(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def build():
    """{variant: loaded library}, every nvcc running at once, and the
    ptxas lines of each variant's ``tma`` kernels."""
    from repro_torch.kernels import _build
    procs = []
    for name, edits in VARIANTS.items():
        d = os.path.join(ROOT, "build", "probe_rglru_bwd", name)
        os.makedirs(d, exist_ok=True)
        shutil.copy(_build.CSRC / "hopper.cuh", d)
        src = edited((_build.CSRC / "rglru_scan_bwd.cu").read_text(), edits)
        with open(f"{d}/rglru_scan_bwd.cu", "w") as f:
            f.write(src)
        out = f"{d}/rglru_scan_bwd.so"
        procs.append((name, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
             f"{d}/rglru_scan_bwd.cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs, regs = {}, {}
    for name, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        regs[name] = [f"{entry}: {r}; {s}" for entry, r, s in
                      chip_smoke.ptxas_resources(log) if "tma" in entry]
        libs[name] = ctypes.CDLL(out)
    return libs, regs


def launcher(torch, lib, args, route):
    """A call of ``lib``'s reverse scan on ``args`` (route 0: simt, 1:
    tma) into outputs of its own; returns (call, outputs)."""
    from repro_torch.kernels.rglru_scan import rglru_scan as rs
    fn = lib.repro_rglru_scan_bwd
    fn.argtypes, fn.restype = rs._BWD_ARGTYPES, ctypes.c_int
    a, h, h0, dh, dhT = args
    outs = (torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0))

    def call():
        err = fn(a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(),
                 dhT.data_ptr(), *(o.data_ptr() for o in outs), *a.shape,
                 rs._DTYPES[a.dtype], rs._DTYPES[h0.dtype], route,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"route {route}: error {err}")
    return call, outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "probe_rglru_bwd.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_rglru_bwd: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref
    device = torch.device("cuda")
    record = {"card": chip_smoke.nvidia_smi_line(), "times_us": []}
    print(record["card"], flush=True)
    libs, record["registers"] = build()
    print(json.dumps(record["registers"]), flush=True)
    for i, (b, t, w, dname) in enumerate(SHAPES):
        dtype = getattr(torch, dname)
        rargs = chip_smoke.rglru_bwd_operands(torch, 900 + i, b, t, w, True,
                                              dtype, device)
        calls = {n: launcher(torch, lib, rargs, 1)
                 for n, lib in libs.items()}
        calls["simt"] = launcher(torch, libs["shipped"], rargs, 0)
        for call, _ in calls.values():
            call()
        torch.cuda.synchronize()
        ref = calls["shipped"][1]
        bitwise = {n: all(torch.equal(o, r) for o, r in zip(outs, ref))
                   for n, (_, outs) in calls.items()}
        if i == 0:
            bitwise["plain"] = all(torch.equal(o, r) for o, r in
                                   zip(ref, rglru_bwd_ref(*rargs)))
        names = list(calls)
        us = {n: [] for n in names}
        for n in names + names[::-1]:
            us[n].append(chip_smoke.time_ms(torch, calls[n][0], 20,
                                            graph=True) * 1e3)
        nbytes = rargs[0].element_size() * 5 * b * t * w \
            + rargs[2].element_size() * 3 * b * w
        row = {"shape": [b, t, w], "dtype": dname, "us": us,
               "gb_per_s": {n: nbytes / min(v) / 1e3 for n, v in us.items()},
               "bound_us": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e6,
               "bitwise_vs_shipped": bitwise}
        record["times_us"].append(row)
        print(json.dumps(row), flush=True)
        del rargs, calls, ref
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

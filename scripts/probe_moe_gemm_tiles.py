#!/usr/bin/env python3
"""The expert GEMM's wgmma tile shapes against each other, on one CUDA card.

    PYTHONPATH=src python3 scripts/probe_moe_gemm_tiles.py \
        [--out build/probe_moe_gemm_tiles.json]

``csrc/moe_gemm.cuh`` holds the tile both the expert GEMM's forward and
its backward (dX, dW) launch, in two configurations: ``Narrow`` (the
forward's: 128 x 128 outputs, a 5-stage ring, each thread stores its own
outputs) and ``Wide`` (the backward's: 128 x 256, 4 stages, the tile
staged in the freed ring and stored by TMA).  This script builds copies of
``csrc/moe_matmul.cu`` and ``csrc/moe_matmul_bwd.cu`` under
``build/probe_moe_gemm/`` with the backward's tile set to each of

* ``narrow_threads``: ``Tile<128, 5, false>`` (the forward's tile);
* ``wide_threads``: ``Tile<256, 4, false>``;
* ``narrow_staged``: ``Tile<128, 5, true>``;
* ``wide_staged``: ``Tile<256, 4, true>`` (the source as it is);

and one whose forward takes ``Wide`` (``forward_wide``).  It times dX and
dW at ``chip_smoke.MOE_BWD_CASES[:3]`` (granite-moe-1b-a400m's two
training shapes, olmoe-1b-7b's) and the forward at olmoe's prefill and
granite's two shapes, bfloat16, every variant in turns (CUDA events over
a graph of 20 launches; each variant twice, the second pass in reverse
order) beside ``torch.bmm``, and holds each variant's output bitwise
against the source's.  Then it builds ``wide_threads`` and
``wide_staged`` with ``clock64`` stamps in the first consumer thread of
every block and reports, per tile, the cycles from entry to the first
full stage (barrier set-up and the first TMA round trip), of the mainloop
(and within it the waits on full stages and on wgmma groups), and of the
epilogue (the stores issued; staged: until TMA has read the tile).

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

WIDE = "using Wide = Tile<256, 4, true>;"
NARROW_FWD = "moe_gemm::launch<0, 1, moe_gemm::Narrow>"
VARIANTS = {
    "narrow_threads": ({WIDE: "using Wide = Tile<128, 5, false>;"}, {}),
    "wide_threads": ({WIDE: "using Wide = Tile<256, 4, false>;"}, {}),
    "narrow_staged": ({WIDE: "using Wide = Tile<128, 5, true>;"}, {}),
    "wide_staged": ({}, {}),
    "forward_wide": ({}, {NARROW_FWD:
                          "moe_gemm::launch<0, 1, moe_gemm::Wide>"}),
}
BWD = ["narrow_threads", "wide_threads", "narrow_staged", "wide_staged"]
FWD = ["wide_staged", "forward_wide"]
FWD_CASES = [(64, 1144, 2048, 1024), (32, 1280, 1024, 512),
             (32, 1280, 512, 1024)]

# clock64 stamps: (text in moe_gemm.cuh, text put in its place)
WAIT1 = ("    hopper::wgmma_wait<1>();                 "
         "// step kt - 1 has finished\n")
STAMP_TAIL = """  if (threadIdx.x == 0) {
    const long long t_end = clock64();
    atomicAdd(&g_st[0], (unsigned long long)(t_first - t_start));
    atomicAdd(&g_st[1], (unsigned long long)(t_loop - t_first));
    atomicAdd(&g_st[2], (unsigned long long)(t_end - t_loop));
    atomicAdd(&g_st[3], 1ull);
    atomicAdd(&g_st[4], (unsigned long long)w_full);
    atomicAdd(&g_st[5], (unsigned long long)w_mma);
  }
"""
STAMPS = [
    ("namespace moe_gemm {\n",
     "namespace moe_gemm {\n__device__ unsigned long long g_st[8];\n"),
    ("  extern __shared__ uint8_t smem_raw[];\n",
     "  const long long t_start = clock64();\n"
     "  long long t_first = 0, t_loop = 0, w_full = 0, w_mma = 0;\n"
     "  extern __shared__ uint8_t smem_raw[];\n"),
    ("    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);\n",
     "    const long long ta0 = clock64();\n"
     "    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);\n"
     "    const long long ta1 = clock64();\n"
     "    if (kt == 0) t_first = ta1; else w_full += ta1 - ta0;\n"),
    (WAIT1, "    const long long tb0 = clock64();\n" + WAIT1 +
     "    w_mma += clock64() - tb0;\n"),
    ("  hopper::wgmma_wait<0>();\n",
     "  hopper::wgmma_wait<0>();\n  t_loop = clock64();\n"),
    ("      hopper::bulk_wait_read();\n    }\n    return;\n",
     "      hopper::bulk_wait_read();\n    }\n" + STAMP_TAIL + "    return;\n"),
    ("    }\n  }\n}\n\n// The tensor map",
     "    }\n  }\n" + STAMP_TAIL + "}\n\n// The tensor map"),
]
STAMP_API = """
extern "C" int probe_stamps_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, moe_gemm::g_st, 64);
}
extern "C" int probe_stamps_zero() {
  static const unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(moe_gemm::g_st, z, 64);
}
"""


def edited(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def build(variants, stamps):
    """{(variant, source): loaded library}, every nvcc running at once."""
    from repro_torch.kernels import _build
    procs = []
    for name in variants:
        hdr_edits, fwd_edits = VARIANTS[name]
        d = os.path.join(ROOT, "build", "probe_moe_gemm",
                         name + ("_stamps" if stamps else ""))
        os.makedirs(d, exist_ok=True)
        for f in ("hopper.cuh", "moe_gemm.cuh", "moe_matmul.cu",
                  "moe_matmul_bwd.cu"):
            shutil.copy(_build.CSRC / f, d)
        hdr = edited(open(f"{d}/moe_gemm.cuh").read(),
                     list(hdr_edits.items()) + (STAMPS if stamps else []))
        open(f"{d}/moe_gemm.cuh", "w").write(hdr)
        fwd = edited(open(f"{d}/moe_matmul.cu").read(),
                     list(fwd_edits.items()))
        open(f"{d}/moe_matmul.cu", "w").write(fwd)
        if stamps:
            with open(f"{d}/moe_matmul_bwd.cu", "a") as f:
                f.write(STAMP_API)
        for src in ("moe_matmul", "moe_matmul_bwd"):
            out = f"{d}/{src}.so"
            procs.append(((name, src), out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                 f"{d}/{src}.cu"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs, regs = {}, {}
    for key, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log[-3000:]}")
        regs[f"{key[0]}/{key[1]}"] = [
            f"{entry}: {r}; {s}" for entry, r, s in
            chip_smoke.ptxas_resources(log) if "tile_kernel" in entry]
        libs[key] = ctypes.CDLL(out)
    return libs, regs


def launcher(torch, lib, symbol, a, b, out, dims):
    from repro_torch.kernels.moe_matmul import moe_matmul as mm
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = mm._ARGTYPES, ctypes.c_int

    def call():
        route = ctypes.c_int(-1)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), *dims, 1,
                 torch.cuda.current_stream().cuda_stream, ctypes.byref(route))
        if err or route.value != 1:
            raise RuntimeError(f"{symbol}: error {err}, route {route.value}")
    return call


def products(torch, device):
    """(kind, symbol, source, (e, c, d, f), a, b, out shape, torch.bmm)."""
    for i, (e, c, d, f) in enumerate(chip_smoke.MOE_BWD_CASES[:3]):
        x, w, dy = chip_smoke.moe_bwd_operands(torch, 800 + i, e, c, d, f,
                                               torch.bfloat16, device)
        yield ("dx", "repro_moe_matmul_dx", "moe_matmul_bwd", (e, c, d, f),
               dy, w, (e, c, d), lambda: torch.bmm(dy, w.transpose(1, 2)))
        yield ("dw", "repro_moe_matmul_dw", "moe_matmul_bwd", (e, c, d, f),
               x, dy, (e, d, f), lambda: torch.bmm(x.transpose(1, 2), dy))
    for e, c, d, f in FWD_CASES:
        x, w = chip_smoke.moe_operands(torch, 5, e, c, d, f, torch.bfloat16,
                                       device)
        yield ("forward", "repro_moe_matmul", "moe_matmul", (e, c, d, f),
               x, w, (e, c, f), lambda: torch.bmm(x, w))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "probe_moe_gemm_tiles.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_moe_gemm_tiles: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    record = {"card": chip_smoke.nvidia_smi_line(), "times_us": [],
              "stamps": []}
    print(record["card"], flush=True)
    libs, record["registers"] = build(list(VARIANTS), stamps=False)
    slibs, _ = build(["wide_threads", "wide_staged"], stamps=True)
    for kind, symbol, src, dims, a, b, shape, lib in products(torch, device):
        names = FWD if kind == "forward" else BWD
        outs = {n: torch.empty(shape, dtype=torch.bfloat16, device=device)
                for n in names}
        calls = {n: launcher(torch, libs[(n, src)], symbol, a, b, outs[n],
                             dims) for n in names}
        for n in names:
            calls[n]()
        torch.cuda.synchronize()
        bitwise = {n: bool(torch.equal(outs[n], outs["wide_staged"]))
                   for n in names}
        us = {n: [] for n in names}
        for n in names + names[::-1]:
            us[n].append(chip_smoke.time_ms(torch, calls[n], 20,
                                            graph=True) * 1e3)
        row = {"kind": kind, "shape": list(dims), "us": us,
               "bmm_us": chip_smoke.time_ms(torch, lib, 20, graph=True) * 1e3,
               "bitwise_vs_source": bitwise}
        record["times_us"].append(row)
        print(json.dumps(row), flush=True)
        if kind == "forward":
            continue
        for n in ("wide_threads", "wide_staged"):
            sl = slibs[(n, "moe_matmul_bwd")]
            call = launcher(torch, sl, symbol, a, b, outs[n], dims)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            if sl.probe_stamps_zero():
                raise RuntimeError("probe_stamps_zero failed")
            call()
            torch.cuda.synchronize()
            if sl.probe_stamps_read(buf):
                raise RuntimeError("probe_stamps_read failed")
            tiles = buf[3]
            st = {"kind": kind, "shape": list(dims), "variant": n,
                  "tiles": tiles,
                  "cycles_per_tile": {
                      k: buf[i] / tiles for i, k in (
                          (0, "prologue"), (1, "mainloop"), (4, "full_waits"),
                          (5, "wgmma_waits"), (2, "epilogue"))},
                  "sm_clock": subprocess.run(
                      ["nvidia-smi", "--query-gpu=clocks.sm",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()}
            record["stamps"].append(st)
            print(json.dumps(st), flush=True)
        del a, b, outs
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

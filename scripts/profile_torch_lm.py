#!/usr/bin/env python3
"""Where the time of the port's LM serving path goes, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_torch_lm.py \
        [--arch gemma2-9b|olmoe-1b-7b|recurrentgemma-9b|xlstm-350m|
                qwen2-vl-2b|whisper-tiny] \
        [--out build/profile_lm.json]

Builds the model at full width as ``chip_smoke.py`` does (bfloat16
weights from a seeded card generator), warms up, and traces the smoke's
serving run of that model under ``torch.profiler``: its requests through
``ContinuousBatcher`` at max_batch 8 (``chip_smoke.SERVED``,
``chip_smoke.serve_lm``), or for whisper-tiny its streams of frames
through the step functions (``chip_smoke.serve_steps``). Each prefill
call and decode step runs in the profiler range ``serve.prefill`` or
``serve.decode`` and ends in a device synchronise; a kernel counts for
the range its launch call lies in, matched by the tracer's correlation
id, so the ctypes kernels count as well as PyTorch's own. For each of
the two ranges: calls, wall (profiler on), kernel launches, summed
device time (busy share = device time / wall), device time by kind of
kernel (the flash- and decode-attention, expert-GEMM, RG-LRU-scan and
mLSTM-chunk kernels, GEMMs by cuBLAS / CUTLASS names, and the rest:
norms, RoPE, routing, activations, the sLSTM step's elementwise ops,
casts, copies) and the kernels that take the most.

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

RANGES = ("serve.prefill", "serve.decode")


def kind_of(name: str) -> str:
    if "flash_attention_kernel" in name or "flash_wgmma_kernel" in name:
        return "flash_attention"
    if any(k in name for k in ("decode_split_kernel", "decode_mma_kernel",
                               "decode_merge_kernel")):
        return "decode_attention"
    if any(k in name for k in ("moe_matmul_kernel", "moe_wide_kernel",
                               "moe_decode_kernel")):
        return "moe_matmul"
    if "rglru_scan_kernel" in name or "rglru_tma_kernel" in name:
        return "rglru_scan"
    if any(k in name for k in ("mlstm_chunk_kernel", "mlstm_wgmma_kernel",
                               "mlstm_decode_kernel")):
        return "mlstm_chunk"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "gemm"
    return "other"


def range_times(torch, prof):
    """Per range in ``RANGES``: calls, wall, and the device time of the
    kernels whose launch call lies inside it, by kind and by name."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    host = [e for e in evs if e.device_type() != cuda]
    host_names = {e.name() for e in host}
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in host
             if e.name() in RANGES]
    launch_at = {e.correlation_id(): e.start_ns() for e in host
                 if "Launch" in e.name()}
    out = {r: {"calls": 0, "wall_s": 0.0, "kernel_launches": 0,
               "device_s": 0.0, "by_kind": defaultdict(lambda: [0, 0.0]),
               "by_name": defaultdict(lambda: [0, 0.0])} for r in RANGES}
    for t0, t1, name in spans:
        out[name]["calls"] += 1
        out[name]["wall_s"] += (t1 - t0) * 1e-9
    lost = {"kernels": 0, "device_s": 0.0}
    for e in evs:
        if e.device_type() != cuda or e.name() in host_names or \
                e.is_user_annotation():
            continue
        t = launch_at.get(e.correlation_id())
        inside = [n for t0, t1, n in spans if t is not None and t0 <= t <= t1]
        sec = e.duration_ns() * 1e-9
        if not inside:
            lost["kernels"] += 1
            lost["device_s"] += sec
            continue
        r = out[inside[0]]
        r["kernel_launches"] += 1
        r["device_s"] += sec
        for table, key in ((r["by_kind"], kind_of(e.name())),
                           (r["by_name"], e.name())):
            table[key][0] += 1
            table[key][1] += sec
    for r in out.values():
        r["device_busy_share"] = (r["device_s"] / r["wall_s"]
                                  if r["kernel_launches"] else "not measured")
        r["by_kind"] = {k: {"launches": c, "device_s": s}
                        for k, (c, s) in sorted(r["by_kind"].items())}
        top = sorted(r.pop("by_name").items(), key=lambda kv: -kv[1][1])[:8]
        r["top_kernels"] = [{"name": n[:90], "launches": c, "device_s": s}
                            for n, (c, s) in top]
    out["unattributed"] = lost
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=chip_smoke.LM_ARCH,
                    choices=sorted(chip_smoke.SERVED))
    ap.add_argument("--out", default="build/profile_lm.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_lm: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import Request

    smi = chip_smoke.nvidia_smi_line()
    spec = chip_smoke.SERVED[args.arch]
    cfg = get_arch(args.arch)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))

    def requests(n, prompt, max_new, seed=0):
        return chip_smoke.lm_requests(np, Request, cfg.vocab_size, n, prompt,
                                      max_new, seed)

    want = {"prefill": spec["prefill"], "decode": spec["decode"]}
    if cfg.family == "audio":
        # the batcher passes no frames: the step functions, as phase 27
        gen = torch.Generator(device="cuda").manual_seed(7)
        frames = torch.randn((spec["streams"], cfg.enc_seq, cfg.d_model),
                             generator=gen, device="cuda").to(torch.bfloat16)
        toks, _ = chip_smoke.padded_prompts(np, torch, cfg.vocab_size,
                                            spec["streams"], spec["prompt"],
                                            3, "cuda")

        def run(warm_up):
            out = chip_smoke.serve_steps(
                np, torch, model, params, toks, frames, spec["cache_len"],
                2 if warm_up else spec["steps"], want)
            return out["launches"], {
                "streams": out["streams"], "frames": cfg.enc_seq,
                "prompt_tokens": out["prompt_tokens"],
                "cache_len": spec["cache_len"]}
    else:
        scfg = ServeConfig(max_batch=chip_smoke.LM_BATCH,
                           max_seq=spec["max_seq"])

        def run(warm_up):
            reqs = requests(2, (64, 64), (3, 3), seed=99) if warm_up else \
                requests(spec["requests"], spec["prompt"], spec["max_new"])
            done, timer, launches, _ = chip_smoke.serve_lm(
                np, torch, model, params, scfg, reqs, want)
            return launches, {
                "max_batch": scfg.max_batch, "max_seq": scfg.max_seq,
                "requests": len(done),
                "prefill_shapes": [[c["batch"], c["tokens"]]
                                   for c in timer.prefill]}
    run(warm_up=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        launches, config = run(warm_up=False)
        wall = time.perf_counter() - t0
    result = {"card": smi, "torch": torch.__version__,
              "config": {"model": cfg.name, "dtype": cfg.dtype, **config},
              "profiled_wall_s": wall, "launch_counts": launches,
              **range_times(torch, prof)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""xlstm-350m's in-model gradients on one CUDA card, side by side: the
mLSTM through its kernels, through its plain versions, and through
mixes of the two, to tell a kernel's fault from the model's own
conditioning (``chip_smoke.py`` phase 45's gate).

    PYTHONPATH=src python3 scripts/probe_xlstm_grad_gate.py \
        [--seq 256] [--steps 3] [--train-seq 1024] [--dtype float32] \
        [--base kernel-chunks] [--out build/xlstm_grad_gate.json]

xlstm-350m at full width and depth from seed 0 (float32 masters); with
``--steps`` > 0 first trained as phase 45 trains it (bf16 compute,
remat full, 2 microbatches of one ``--train-seq`` sequence, WSD at lr
1e-3).  Then at ``--seq`` seeded tokens, in compute ``--dtype``, the
loss and every gradient through each side:

* ``plain``: ``mlstm_chunk_ref`` / ``mlstm_chunk_bwd_ref`` at the
  kernels' chunks (the forward's route's, ``BWD_CHUNK``; with ``--base
  model-chunks`` at the model's, 256 or S): the sides' reference;
* ``kernels``: the forward and the backward kernel;
* ``fwd_kernel``: the forward kernel, the plain backward at
  ``BWD_CHUNK``;
* ``bwd_kernel``: the plain forward at the forward kernel's chunks, the
  backward kernel;
* ``kernel_chunks`` / ``model_chunks``: the plain versions at the other
  base's chunks;
* ``reordered``: both plain versions at chunks of 64 (phase 45's
  yardstick), and ``chunks_16``, ``chunks_128`` likewise.

Per side and leaf the largest gap from ``plain`` as a share of the
leaf's largest plain gradient; prints each side's largest and median
share, its worst leaves and its loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--train-seq", type=int, default=1024)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--base", default="kernel-chunks",
                    choices=("kernel-chunks", "model-chunks"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "xlstm_grad_gate.json"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_xlstm_grad_gate: needs a CUDA device")
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import lm_data
    from repro_torch.kernels.mlstm_chunk import ops as lops
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        BWD_CHUNK, CHUNK, mlstm_chunk, mlstm_chunk_bwd, mlstm_route)
    from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_bwd_ref,
                                                     mlstm_chunk_ref)
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import init_state, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths
    device = torch.device("cuda")
    cfg = get_arch("xlstm-350m")
    model = build_model(cfg, device)
    tcfg = TrainConfig(steps=max(args.steps, 1), lr=1e-3, warmup_steps=0,
                       microbatches=2, schedule="wsd")
    state = init_state(model, torch.Generator(device=device).manual_seed(0),
                       tcfg)
    if args.steps:
        step = make_train_step(model, cfg, tcfg)
        data = lm_data(cfg, 2, args.train_seq, seed=0, prefetch=0)
        for _ in range(args.steps):
            state, _ = step(state, next(data))
    params = state["params"]
    del state
    plist = leaves(params)
    paths = [p for p, _ in leaves_with_paths(params)]
    check = build_model(dataclasses.replace(cfg, dtype=args.dtype), device)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, args.seq + 1)), device=device)

    def ref(chunk):
        return lambda *a: mlstm_chunk_ref(*a, chunk=chunk)

    def bref(chunk):
        return lambda *a: mlstm_chunk_bwd_ref(*a, chunk=chunk)

    fc = CHUNK[mlstm_route(getattr(torch, args.dtype), args.seq)]
    at_kernels = (ref(fc), bref(BWD_CHUNK))
    at_model = (ref(None), bref(None))
    kernel_base = args.base == "kernel-chunks"
    sides = {"plain": at_kernels if kernel_base else at_model,
             "kernels": (mlstm_chunk, mlstm_chunk_bwd),
             "fwd_kernel": (mlstm_chunk, bref(BWD_CHUNK)),
             "bwd_kernel": (ref(fc), mlstm_chunk_bwd),
             "model_chunks" if kernel_base else "kernel_chunks":
                 at_model if kernel_base else at_kernels,
             "reordered": (ref(64), bref(64)),
             "chunks_16": (ref(16), bref(16)),
             "chunks_128": (ref(128), bref(128))}
    saved = lops._TRAIN_BY_DEVICE["cuda"]
    grads, losses = {}, {}
    for name, fns in sides.items():
        lops._TRAIN_BY_DEVICE["cuda"] = fns
        try:
            loss = check.train_loss(params, toks[:, :-1], toks[:, 1:])
            loss.backward()
        finally:
            lops._TRAIN_BY_DEVICE["cuda"] = saved
        grads[name] = [torch.zeros_like(p) if p.grad is None
                       else p.grad.clone() for p in plist]
        losses[name] = float(loss.detach())
        for p in plist:
            p.grad = None
    out = {"card": torch.cuda.get_device_name(0), "dtype": args.dtype,
           "base": args.base, "seq": args.seq, "steps": args.steps,
           "train_seq": args.train_seq, "losses": losses, "sides": {}}
    base = grads["plain"]
    for name in sides:
        if name == "plain":
            continue
        shares = []
        for path, a, b in zip(paths, base, grads[name]):
            top = float(a.abs().max())
            if top > 0:
                shares.append((float((a - b).abs().max()) / top, path))
        shares.sort(reverse=True)
        out["sides"][name] = {
            "largest_share": shares[0][0],
            "median_share": statistics.median(s for s, _ in shares),
            "worst": shares[:4]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

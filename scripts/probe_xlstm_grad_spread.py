#!/usr/bin/env python3
"""How far xlstm-350m's gradients move when only the mLSTM's chunking
changes: the plain side's own spread, the yardstick of the in-model
gradient gate (``chip_smoke.py`` phase 45).

    PYTHONPATH=src python3 scripts/probe_xlstm_grad_spread.py \
        [--device cuda] [--dtype bfloat16] [--seq 256] [--chunk 64] \
        [--out build/xlstm_grad_spread.json]

xlstm-350m at full width and depth, random init from seed 0 (float32
masters), one sequence of ``--seq`` seeded tokens: the loss and every
gradient through the mLSTM's plain versions (``mlstm_chunk_ref`` and
``mlstm_chunk_bwd_ref``) at the model's chunks (256, or S), then again
at chunks of ``--chunk``, the compute dtype ``--dtype``.  Per leaf the
largest gap as a share of the leaf's largest gradient; prints the
largest and the median share and the two losses.  No kernel runs: on
the card the plain versions run as torch ops there.
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "xlstm_grad_spread.json"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.mlstm_chunk import ops as lops
    from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_bwd_ref,
                                                     mlstm_chunk_ref)
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    device = torch.device(args.device)
    cfg = dataclasses.replace(get_arch("xlstm-350m"), dtype=args.dtype)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        dtype=torch.float32)
    plist = leaves(params)
    for p in plist:
        p.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, args.seq + 1)), device=device)

    def grads(chunk):
        fwd = lambda *a: mlstm_chunk_ref(*a, chunk=chunk)        # noqa
        bwd = lambda *a: mlstm_chunk_bwd_ref(*a, chunk=chunk)    # noqa
        saved = dict(lops._TRAIN_BY_DEVICE)
        lops._TRAIN_BY_DEVICE[device.type] = (fwd, bwd)
        try:
            loss = model.train_loss(params, toks[:, :-1], toks[:, 1:])
            loss.backward()
        finally:
            lops._TRAIN_BY_DEVICE.update(saved)
        out = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
               for p in plist]
        for p in plist:
            p.grad = None
        return float(loss.detach()), out

    base_loss, base = grads(None)
    other_loss, other = grads(args.chunk)
    shares = [float((a - b).abs().max() / a.abs().max())
              for a, b in zip(base, other) if a.abs().max() > 0]
    out = {"device": str(device), "dtype": args.dtype, "seq": args.seq,
           "chunk": args.chunk, "losses": [base_loss, other_loss],
           "largest_share": max(shares),
           "median_share": statistics.median(shares),
           "leaves": len(shares)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""What moves phase 41's granite-moe gradient gate, on one CUDA card.

    PYTHONPATH=src python3 scripts/probe_moe_grad_gate.py [--trials 3] \
        [--out build/probe_moe_grad_gate.json]

Each trial trains granite-moe-1b-a400m at full width and depth as
``chip_smoke.py``'s phase 41 does (``FULL_TRAIN_SLICE[0]``: 3 WSD steps of
2 x 4,096 tokens from seed 0, bf16 compute on float32 masters), then
takes the gradients at the gate's S 1,024 (the same tokens, seed 3) on
these sides: ``plain`` (every kernel's plain version), ``plain_again``
(the same, once more), ``kernels``, ``kernels_plain_bwd`` (the kernels,
but the expert GEMM's dX and dW on their plain versions) and
``reordered`` (``chip_smoke.plain_kernels(True)``).  For each side against
``plain``: every leaf's largest gap as a share of its largest plain
gradient, the gate's reading (a leaf's share over the gate's limit: the
larger of ``LM_GAP`` x the reordered side's largest share and
``GRAD_FLOOR_ULPS`` bf16 ulps), the loss, and per MoE layer the tokens
whose top-k experts differ from ``plain``'s (the first forward of each
layer; the remat recompute repeats it).

Writes the numbers as JSON to ``--out`` and prints them.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)


class plain_backward:
    """The expert GEMM's dX and dW on their plain versions, its forward
    and every other kernel as they are."""

    def __enter__(self):
        from repro_torch.kernels.moe_matmul import ops as mops
        from repro_torch.kernels.moe_matmul.ref import (moe_matmul_dw_ref,
                                                        moe_matmul_dx_ref)
        self.saved = mops._TRAIN_BY_DEVICE["cuda"]
        mops._TRAIN_BY_DEVICE["cuda"] = (self.saved[0], moe_matmul_dx_ref,
                                         moe_matmul_dw_ref)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.moe_matmul import ops as mops
        mops._TRAIN_BY_DEVICE["cuda"] = self.saved
        return False


def trained_params(torch, device, f):
    """granite-moe's parameters after ``f``'s steps, as phase 41 trains
    them, and its model and config."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import lm_data
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import init_state, make_train_step
    cfg = get_arch(f["arch"])
    model = build_model(cfg, device)
    tcfg = TrainConfig(steps=f["steps"], lr=f["lr"], warmup_steps=0,
                       microbatches=f["microbatches"], schedule="wsd")
    state = init_state(model, torch.Generator(device=device).manual_seed(0),
                       tcfg)
    step = make_train_step(model, cfg, tcfg)
    data = lm_data(cfg, f["batch"], f["seq"], seed=0, prefetch=0)
    losses = []
    for _ in range(f["steps"]):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    del state["opt"], step
    gc.collect()
    torch.cuda.empty_cache()
    return model, cfg, state["params"], losses


def side_grads(torch, model, params, toks, labels, ctx, routes):
    """(loss, gradients, each MoE layer's top-k experts) on one side."""
    from repro_torch.tree import leaves
    plist = leaves(params)
    routes.clear()
    with ctx:
        loss = model.train_loss(params, toks, labels)
        loss.backward()
    grads = [p.grad for p in plist]
    for p in plist:
        p.grad = None
    torch.cuda.synchronize()
    picks = [torch.sort(i, dim=-1).values for i in routes]
    return float(loss.detach()), grads, picks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "probe_moe_grad_gate.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_moe_grad_gate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.models import moe
    from repro_torch.tree import leaves_with_paths
    device = torch.device("cuda")
    f = chip_smoke.FULL_TRAIN_SLICE[0]
    routes = []
    route = moe.moe_route

    def recording_route(*a, **kw):
        r = route(*a, **kw)
        routes.append(r["idx"].detach().clone())
        return r
    moe.moe_route = recording_route
    sides = {"plain_again": lambda: chip_smoke.plain_kernels(),
             "kernels": contextlib.nullcontext,
             "kernels_plain_bwd": plain_backward,
             "reordered": lambda: chip_smoke.plain_kernels(True)}
    record = {"card": chip_smoke.nvidia_smi_line(), "arch": f["arch"],
              "trials": []}
    print(record["card"], flush=True)
    for trial in range(args.trials):
        model, cfg, params, losses = trained_params(torch, device, f)
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, f["check_seq"] + 1)),
                               device=device)
        x, y = toks[:, :-1], toks[:, 1:]
        paths = [p for p, _ in leaves_with_paths(params)]
        base_loss, base, base_picks = side_grads(
            torch, model, params, x, y, chip_smoke.plain_kernels(), routes)
        n_moe = cfg.n_layers                # then the remat recompute
        top = [float(g.abs().max()) for g in base]
        shares, out = {}, {"train_losses": losses, "plain_loss": base_loss,
                           "sides": {}}
        for name, ctx in sides.items():
            loss, got, picks = side_grads(torch, model, params, x, y, ctx(),
                                          routes)
            shares[name] = [float((a - b).abs().max()) / t if t else 0.0
                            for a, b, t in zip(got, base, top)]
            flips = {i: int((p != q).any(-1).sum()) for i, (p, q) in
                     enumerate(zip(picks[:n_moe], base_picks[:n_moe]))}
            out["sides"][name] = {
                "loss": loss, "largest_share": max(shares[name]),
                "flipped_tokens_by_layer": {k: v for k, v in flips.items()
                                            if v}}
            del got
            torch.cuda.empty_cache()
        limit = [max(chip_smoke.LM_GAP * max(shares["reordered"]),
                     chip_smoke.GRAD_FLOOR_ULPS * float(chip_smoke.bf16_ulp(
                         torch, torch.tensor(t))) / t if t else 0.0)
                 for t in top]
        for name in sides:
            reading = sorted(((s / lim if lim else 0.0, p) for s, lim, p in
                              zip(shares[name], limit, paths)), reverse=True)
            out["sides"][name]["gate_reading"] = reading[0][0]
            out["sides"][name]["worst_leaves"] = [
                {"leaf": p, "of_limit": r} for r, p in reading[:5]]
        record["trials"].append(out)
        print(json.dumps(out), flush=True)
        del model, params, base, toks
        gc.collect()
        torch.cuda.empty_cache()
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"trial {trial}: losses {losses}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

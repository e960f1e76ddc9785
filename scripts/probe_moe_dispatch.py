#!/usr/bin/env python3
"""The MoE layer's dispatch, a gather against a scatter, on one CUDA card.

    PYTHONPATH=src python3 scripts/probe_moe_dispatch.py \
        [--out build/probe_moe_dispatch.json]

``models/moe.py::moe_apply`` puts each pick's copy of its token in its
slot of the expert buffer (``index_copy``), as the reference scatters, so
its gradient is a gather at the slots and a sum over a token's k copies.
It used to gather the tokens into the slots (``index_select`` of each
slot's source row), whose gradient is an atomic bfloat16 ``index_add``.
This script runs one MoE layer at granite-moe-1b-a400m's training shape
(B 1, S 4,096, d 1,024, 32 experts, top 8, d_expert 512, GLU, capacity
factor 1.25, bfloat16 from float32 masters, seeded random weights and
inputs) forward and backward with each dispatch: both
layers' outputs bitwise against each other, the gradient elements that
differ between two backward passes of each, and each one's time (CUDA
events over 10 eager forward-and-backward calls, in turns: gather,
scatter, scatter, gather).

Writes the numbers as JSON to ``--out`` and prints them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)

B, S, D, E, K, F, CF = 1, 4096, 1024, 32, 8, 512, 1.25


def moe_apply_gather(p, x, *, top_k, act, glu, capacity_factor):
    """``moe_apply`` with the tokens gathered into the slots (the port's
    earlier dispatch); the rest as ``models/moe.py``."""
    import torch
    from repro_torch.kernels.moe_matmul.ops import expert_gemm
    from repro_torch.models.layers import _ACT
    from repro_torch.models.moe import moe_route
    dt = x.dtype
    b, s, d = x.shape
    e = p["w_in"].shape[0]
    r = moe_route(p, x, top_k=top_k, capacity_factor=capacity_factor)
    cap, keep = r["cap"], r["keep"]
    idx_flat = r["idx"].reshape(b, s * top_k)
    rows = b * cap
    n_slots = e * rows
    seq = torch.arange(b, device=x.device)[:, None]
    slot = idx_flat * rows + seq * cap + torch.clamp(r["pos"], max=cap - 1)
    dest = torch.where(keep, slot, torch.full_like(slot, n_slots))
    tok = (seq * s + torch.arange(s * top_k, device=x.device)[None, :]
           // top_k)
    src = torch.full((n_slots + 1,), b * s, dtype=torch.long,
                     device=x.device)
    src.index_copy_(0, dest.reshape(-1), tok.reshape(-1))
    x_ext = torch.cat([x.reshape(b * s, d), x.new_zeros((1, d))])
    buf = x_ext.index_select(0, src[:n_slots]).view(e, rows, d)
    h = expert_gemm(buf, p["w_in"].to(dt))
    if glu:
        h = _ACT[act](expert_gemm(buf, p["w_gate"].to(dt))) * h
    else:
        h = _ACT[act](h)
    y_buf = expert_gemm(h, p["w_out"].to(dt)).view(n_slots, d)
    y_tok = y_buf.index_select(0, slot.reshape(-1)).view(b, s * top_k, d)
    w = (r["gate"].reshape(b, s * top_k) * keep.to(torch.float32)).to(dt)
    y = (y_tok * w[..., None]).view(b, s, top_k, d).sum(dim=2)
    return y, r["aux"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "probe_moe_dispatch.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_moe_dispatch: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.models.moe import moe_apply, moe_init
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    p = {k: v.to(device).requires_grad_() for k, v in
         moe_init(D, E, F, True, gen, torch.float32).items()}
    x = torch.randn((B, S, D), generator=gen).to(device, torch.bfloat16)
    x.requires_grad_()
    dy = torch.randn((B, S, D), generator=gen).to(device)
    fns = {"gather": moe_apply_gather, "scatter": moe_apply}

    def run(fn):
        pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
        y, aux = fn(pb, x, top_k=K, act="silu", glu=True,
                    capacity_factor=CF)
        grads = torch.autograd.grad((y.float() * dy).sum() + aux,
                                    [x, *p.values()])
        return y, grads

    record = {"card": chip_smoke.nvidia_smi_line(),
              "shape": dict(B=B, S=S, d=D, E=E, top_k=K, d_expert=F,
                            capacity_factor=CF)}
    outs = {}
    for name, fn in fns.items():
        y, g1 = run(fn)
        _, g2 = run(fn)
        torch.cuda.synchronize()
        outs[name] = y
        record[f"{name}_grad_elements_differing_run_to_run"] = int(sum(
            int((a != b).sum()) for a, b in zip(g1, g2)))
    record["outputs_bitwise_equal"] = bool(torch.equal(outs["gather"],
                                                       outs["scatter"]))
    ms = {name: [] for name in fns}
    for name in ("gather", "scatter", "scatter", "gather"):
        for _ in range(2):
            run(fns[name])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run(fns[name])
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / 10)
    record["forward_backward_ms"] = ms
    print(json.dumps(record), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

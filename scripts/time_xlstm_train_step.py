#!/usr/bin/env python3
"""One training step of xlstm-350m at full width and depth on one CUDA
card, and where its time goes by layer kind.

    PYTHONPATH=src python3 scripts/time_xlstm_train_step.py \
        [--seq 4096] [--out build/xlstm_train_step.json]

xlstm-350m (24 layers: 12 sLSTM and 12 mLSTM, d 1,024, vocab 50,304,
tied) with bf16 compute on float32 masters, ``remat="full"``, trained
through ``make_train_step`` (WSD, lr 1e-3) on one microbatch of one
sequence.  A warm-up step at ``--warm-seq`` first; then a step at
``--seq`` as it runs (the wall, tokens/s, peak memory, kernel launches);
then a step at ``--seq`` with each layer timed: a wrapper around each
block's apply synchronises the card and adds the first pass's wall to
the kind's forward, and hooks on each layer's input and output gradients
take the wall from the output's gradient to the input's: the kind's
backward, the recompute under remat included (torch's checkpoint stops
a recompute once it has the tensors it needs, so the wrapper never sees
it return).  The rest of the step (embedding, head, loss, optimizer) is
the wall minus those sums.  The synchronising adds its own time: both
walls are reported.

Writes the numbers as JSON to ``--out`` and prints them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


class LayerTimer:
    """Wraps ``model.blocks``' apply functions: per kind the seconds of
    the first forward and of the backward (with its recompute) of its
    layers."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.saved = list(model.blocks)
        self.on = False
        self.reset()
        model.blocks = [blk._replace(apply=self.wrap(kind, blk.apply))
                        for kind, blk in zip(model.kinds, model.blocks)]

    def reset(self):
        self.secs = {k: {"forward": 0.0, "window": 0.0}
                     for k in set(self.model.kinds)}
        self.starts = {}

    def now(self):
        self.torch.cuda.synchronize()
        return time.perf_counter()

    def wrap(self, kind, apply):
        torch = self.torch

        def timed(p, x, state, ctx):
            if not self.on:
                return apply(p, x, state, ctx)
            if torch._C._current_graph_task_id() != -1:   # a recompute
                return apply(p, x, state, ctx)
            t0 = self.now()
            out = apply(p, x, state, ctx)
            self.secs[kind]["forward"] += self.now() - t0
            if x.requires_grad:
                key = object()

                def started(g):
                    self.starts[key] = self.now()

                def ended(g):
                    self.secs[kind]["window"] += self.now() - \
                        self.starts.pop(key)
                out[0].register_hook(started)
                x.register_hook(ended)
            return out
        return timed

    def restore(self):
        self.model.blocks = self.saved


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--warm-seq", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "xlstm_train_step.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_xlstm_train_step: needs a CUDA device")
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import lm_data
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import init_state, make_train_step
    device = torch.device("cuda")
    _build.build(["mlstm_chunk", "mlstm_chunk_bwd"])
    cfg = get_arch("xlstm-350m")
    model = build_model(cfg, device)
    tcfg = TrainConfig(steps=3, lr=1e-3, warmup_steps=0, microbatches=1,
                       schedule="wsd")
    state = init_state(model, torch.Generator(device=device).manual_seed(0),
                       tcfg)
    step = make_train_step(model, cfg, tcfg)
    timer = LayerTimer(torch, model)

    def run(seq, seed):
        batch = next(lm_data(cfg, 1, seq, seed=seed, prefetch=0))
        nonlocal state
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, float(m["loss"])

    warm_s, _ = run(args.warm_seq, 0)
    torch.cuda.reset_peak_memory_stats()
    wall, loss = run(args.seq, 1)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    timer.on = True
    timed_wall, timed_loss = run(args.seq, 2)
    timer.on = False
    timer.restore()
    kinds = {}
    for kind, t in timer.secs.items():
        kinds[kind] = {"forward_s": t["forward"],
                       "backward_with_recompute_s": t["window"],
                       "total_s": t["forward"] + t["window"],
                       "share_of_timed_step": (t["forward"] + t["window"])
                       / timed_wall}
    rest = timed_wall - sum(k["total_s"] for k in kinds.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    out = {"card": torch.cuda.get_device_name(0),
           "nvidia_smi": smi[0] if smi else "not read",
           "model": cfg.name, "seq": args.seq, "microbatches": 1,
           "remat": cfg.remat, "warm_step_s": warm_s,
           "warm_seq": args.warm_seq, "step_wall_s": wall,
           "tokens_per_s": args.seq / wall, "loss": loss,
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "timed_step_wall_s": timed_wall, "timed_step_loss": timed_loss,
           "by_kind": kinds, "rest_s": rest}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

"""End-to-end training script through the PyTorch port (the counterpart of
``examples/train_lm.py``): WSD schedule, gradient accumulation, async
checkpointing, failure-recovery restart, LLHR pipeline plan printout.

    PYTHONPATH=src python3 examples/torch_train_lm.py                # ~12M params
    PYTHONPATH=src python3 examples/torch_train_lm.py --full         # ~100M params
    PYTHONPATH=src python3 examples/torch_train_lm.py --simulate-failure
    PYTHONPATH=src python3 examples/torch_train_lm.py --device cpu --steps 40

The models are the reference's: float32, so every attention call runs the
flash kernel's SIMT route forward and the backward kernel on the card.
The default device is the card; ``--device cpu`` runs the plain PyTorch
path.  The pipeline plan takes the card's constants (its name and memory,
half the H100 SXM's dense bf16 peak as its MAC rate, NVLink one way; the
hop latency and the 4 x 4 torus are this script's assumptions), or
``--chip-macs`` and ``--chip-hbm-bytes``; on the CPU without them it is
skipped.  ``--simulate-failure`` stops at 60 % of the steps, restores the
latest committed checkpoint and resumes.  ``main`` returns the run's
record; the script asserts that the loss fell.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import (ArchConfig, AttentionConfig, TRAIN_4K,
                                      TrainConfig)
from repro_torch.core.channel import ICIChannel, ICIParams
from repro_torch.core.pipeline_opt import (H100_SXM_NVLINK_BYTES_ONE_WAY,
                                           ChipParams, card_chip,
                                           plan_pipeline)
from repro_torch.data.pipeline import lm_data
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.train_loop import init_state, train_loop

#: the interconnect figures no data sheet gives: this script's assumptions
HOP_LATENCY_S = 2e-6             # one NVLink hop, switch included
TORUS = (4, 4)                   # 16 stage groups, adjacent ones one hop apart
DCN_BYTES = 400e9 / 8            # one 400 Gb/s network port a card


def nano_config(full: bool) -> ArchConfig:
    if full:     # ~100M params (llama-like)
        return ArchConfig(
            name="lm-100m", family="dense", n_layers=12, d_model=768,
            d_ff=2048, vocab_size=32000,
            attention=AttentionConfig(n_heads=12, n_kv_heads=4,
                                      head_dim=64),
            tie_embeddings=True, remat="none", dtype="float32")
    return ArchConfig(
        name="lm-12m", family="dense", n_layers=6, d_model=384,
        d_ff=1024, vocab_size=4096,
        attention=AttentionConfig(n_heads=6, n_kv_heads=2, head_dim=64),
        tie_embeddings=True, remat="none", dtype="float32")


def print_plan(cfg, args, device):
    """The LLHR 4-stage pipeline plan of ``cfg`` at train_4k, or None when
    there is no chip to plan for."""
    if args.chip_macs is None or args.chip_hbm_bytes is None:
        if device.type != "cuda":
            print("LLHR pipeline plan skipped: the CPU has no card to read "
                  "(pass --chip-macs and --chip-hbm-bytes)")
            return None
        card = card_chip(device)
        chip = ChipParams(card.name, args.chip_macs or card.macs_per_s,
                          args.chip_hbm_bytes or card.hbm_bytes)
    else:
        chip = ChipParams("chip", args.chip_macs, args.chip_hbm_bytes)
    ici = ICIChannel(ICIParams(link_bw_bytes=H100_SXM_NVLINK_BYTES_ONE_WAY,
                               hop_latency_s=HOP_LATENCY_S, torus=TORUS,
                               dcn_bw_bytes=DCN_BYTES))
    plan = plan_pipeline(cfg, TRAIN_4K, n_stages=4, chips_per_stage=64,
                         chip=chip, ici=ici)
    print(f"LLHR 4-stage pipeline plan on {chip.name} ({chip.macs_per_s:.6g}"
          f" MAC/s, {chip.hbm_bytes:.6g} B; assumed hop {HOP_LATENCY_S} s, "
          f"torus {TORUS}): blocks/stage={plan.blocks_per_stage} "
          f"bottleneck={plan.bottleneck_s * 1e3:.1f}ms "
          f"coords={plan.stage_coords}")
    return plan


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one)")
    ap.add_argument("--simulate-failure", action="store_true",
                    help="kill training at 60%% and restart from the "
                    "latest committed checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--chip-macs", type=float, default=None,
                    help="a chip's MAC/s for the plan (default: the card's)")
    ap.add_argument("--chip-hbm-bytes", type=float, default=None,
                    help="a chip's memory in bytes for the plan (default: "
                         "the card's)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_")

    cfg = nano_config(args.full)
    model = build_model(cfg, device)
    print(f"arch {cfg.name}: {cfg.n_params / 1e6:.1f}M params on {device}")
    plan = print_plan(cfg, args, device)

    tcfg = TrainConfig(steps=args.steps, lr=1e-3, warmup_steps=20,
                       schedule="wsd", microbatches=2,
                       checkpoint_dir=ckpt_dir, checkpoint_every=25)
    data = lm_data(cfg, batch=args.batch, seq_len=args.seq)
    writer = ckpt.AsyncCheckpointer(ckpt_dir, keep=2)
    t0 = time.time()

    def hook(step, state, metrics):
        if (step + 1) % tcfg.checkpoint_every == 0:
            writer.save(step + 1, state)
        if (step + 1) % 20 == 0:
            print(f"step {step + 1:4d} loss {metrics['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")

    def generator():
        return torch.Generator(device=device).manual_seed(tcfg.seed)

    stop_at = int(args.steps * 0.6) if args.simulate_failure else None
    it = iter(data)
    restored = None
    if stop_at:
        tcfg_pre = dataclasses.replace(tcfg, steps=stop_at)
        state, hist = train_loop(model, cfg, tcfg_pre, it,
                                 generator=generator(), hooks=[hook])
        writer.wait()
        print(f"\n-- simulated node failure at step {stop_at}; "
              f"restoring latest committed checkpoint --")
        restored = ckpt.latest_step(ckpt_dir)
        if restored is None:
            raise SystemExit(f"no checkpoint committed before step {stop_at}"
                             f" (one every {tcfg.checkpoint_every} steps): "
                             f"run more --steps")
        like = init_state(model, generator(), tcfg)
        state = ckpt.restore(ckpt_dir, restored, like)
        print(f"restored step {restored}; resuming to {args.steps}")
        state, hist2 = train_loop(model, cfg, tcfg, it, state=state,
                                  hooks=[hook])
        hist += hist2
    else:
        state, hist = train_loop(model, cfg, tcfg, it, generator=generator(),
                                 hooks=[hook])
    writer.close()
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    wall = time.time() - t0
    print(f"\nloss: {first:.4f} -> {last:.4f} over {len(hist)} steps "
          f"({wall:.0f}s total)")
    assert last < first, "training must reduce loss"
    return {"first": float(first), "last": float(last), "steps": len(hist),
            "restored_step": restored, "n_layers": cfg.n_layers,
            "microbatches": tcfg.microbatches, "plan": plan, "wall_s": wall,
            "ckpt_dir": ckpt_dir,
            "checkpoints": sorted(os.listdir(ckpt_dir))}


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_torch_rollout.py [--batch 256]
        [--frames 32] [--reps 3] [--profile-frames 4]
        [--out build/profile_rollout.json]

Runs the main-path rollout of ``chip_smoke.py`` (AlexNet, U = 8, RQ = 4,
P2 with 30 steps and 25 repairs) and reports:

* the steady wall time of ``FleetRollout.run`` over ``--reps`` runs after
  a warm-up (host clock, ending on the host copy of the trace);
* a stage breakdown from one extra run in which each stage of the tick
  (P2, link geometry, chain DP, power tightening, airtime) is wrapped in a
  host timer that synchronises the device at its end; the stages' sum
  against that run's wall gives the rest (mobility, failures, arrivals,
  energy, stacking);
* a ``torch.profiler`` trace of a ``--profile-frames`` rollout (the
  trace of all 32 frames is too large to parse quickly): kernel launches
  (in all and a frame), the summed device time of all kernels (busy
  share = device time / wall), and the kernels with the most device time;
* the replan latency: ``PLAN_REPS`` calls of ``plan_batch_multi`` at
  ``--batch`` scenarios (4 requests over the 8 UAVs), each on the host
  clock ending on the host copy of the plan, after a warm-up.

Writes the numbers as JSON to ``--out`` and prints them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

#: timed ``plan_batch_multi`` calls after the warm-up
PLAN_REPS = 20


def build_fleet(torch, frames, device):
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.rollout import PositionSpec, RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.scenario_engine import PlanFnCache
    spec = RolloutSpec(frames=frames, requests_per_frame=4,
                       jitter_sigma_m=2.0, failure_prob=0.05,
                       recovery_prob=0.3, battery_j=5e3)
    return FleetRollout(RadioChannel(), make_devices(8), cnn_cost(ALEXNET),
                        spec, plan_cache=PlanFnCache(),
                        position_spec=PositionSpec(steps=30, repair_iters=25),
                        seed=0, device=device)


def timed_stages(torch, totals):
    """Wrap the tick's stages (as the rollout module imported them) in
    synchronising host timers that add into ``totals``; returns an undo."""
    import repro_torch.core.rollout as rl
    names = ("_positions_pgd", "fused_link_geometry",
             "_chain_dp_solve_kernelized", "solve_power_batched",
             "links_from_assignment_batched", "_frame_tx_time_multi")
    saved = {n: getattr(rl, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            return out
        return timed

    for n, fn in saved.items():
        setattr(rl, n, wrap(n, fn))
    return lambda: [setattr(rl, n, fn) for n, fn in saved.items()]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile-frames", type=int, default=4)
    ap.add_argument("--out", default="build/profile_rollout.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_rollout: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.positions import hex_init
    from repro_torch.runtime.scenario_engine import ScenarioGenerator
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    base = hex_init(8, 40.0, jitter=0.5, seed=0)
    fleet = build_fleet(torch, args.frames, "cuda")
    fleet.run(base, n_trajectories=args.batch)                 # warm-up
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet.run(base, n_trajectories=args.batch)
        walls.append(time.perf_counter() - t0)

    totals = defaultdict(float)
    undo = timed_stages(torch, totals)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet.run(base, n_trajectories=args.batch)   # the tick reads the wrappers
    staged_wall = time.perf_counter() - t0
    undo()
    stages = dict(totals)                        # the stages never nest
    stages["rest"] = staged_wall - sum(stages.values())

    batch = ScenarioGenerator(base, pos_sigma_m=2.0, failure_prob=0.05,
                              seed=0).draw(args.batch)
    n_req = np.random.default_rng(0).multinomial(
        4, np.full(8, 1.0 / 8), size=args.batch)
    fleet.plan_batch_multi(batch, n_req)                       # warm-up
    plan_walls = []
    for _ in range(PLAN_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet.plan_batch_multi(batch, n_req)    # ends on the host copy
        plan_walls.append(time.perf_counter() - t0)

    short = build_fleet(torch, args.profile_frames, "cuda")
    short.run(base, n_trajectories=args.batch)                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        short.run(base, n_trajectories=args.batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    dev_us = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    busy = dev_us * 1e-6 / prof_wall if kernels else "not measured"
    result = {
        "card": smi, "torch": torch.__version__,
        "config": {"model": "alexnet", "uavs": 8, "batch": args.batch,
                   "frames": args.frames, "requests_per_frame": 4,
                   "p2_steps": 30, "repair_iters": 25},
        "steady_wall_s": walls,
        "staged_wall_s": staged_wall, "stages_s": stages,
        "profiled_frames": args.profile_frames,
        "profiled_wall_s": prof_wall,
        "kernel_launches": len(kernels),
        "kernel_launches_per_frame": len(kernels) / args.profile_frames,
        "device_busy_s": dev_us * 1e-6 if kernels else "not measured",
        "device_busy_share": busy,
        "top_kernels": [{"name": n[:90], "launches": c, "device_s": t * 1e-6}
                        for n, (c, t) in top],
        "plan_batch_multi_wall_s": plan_walls,
        "plan_batch_multi_median_s": float(np.median(plan_walls)),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    print("rollout trajectory-frames/s (steady, mean):",
          args.batch * args.frames / float(np.mean(walls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The paper's evaluation on the card: time-framed swarm simulation with
all three planners and failure injection, through the PyTorch port.

LeNet and AlexNet on 6 UAVs, 4 requests a frame.  The LLHR rows run
``SwarmSim``'s rollout on the card (one link-geometry and one fused
chain-DP launch a frame, P2 at 80 steps); the heuristic and random
baselines run the legacy host loop.  Every row reports its feasibility
rate so infeasible frames cannot hide inside the mean, and its wall time
(the card synchronised before the clock stops).  The script asserts
LLHR <= both baselines in mean latency (Fig. 5's ordering) and that the
failure row replans.

    PYTHONPATH=src python3 examples/torch_uav_swarm_sim.py [--frames 3]
    PYTHONPATH=src python3 examples/torch_uav_swarm_sim.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs.alexnet import ALEXNET
from repro_torch.configs.lenet import LENET
from repro_torch.core.baselines import HeuristicPlanner, RandomPlanner
from repro_torch.core.channel import RadioChannel, RadioParams
from repro_torch.core.cost_model import cnn_cost
from repro_torch.core.placement import solve_chain_dp
from repro_torch.core.planner import LLHRPlanner
from repro_torch.core.swarm import (SwarmSim, average_power, latency_summary,
                                    make_devices)
from repro_torch.device import resolve_device


def llhr(ch, steps, device):
    """Chain-DP-placement LLHR planner — the solver the rollout
    implements, so SwarmSim's auto backend runs the whole frame loop on
    the device."""
    return LLHRPlanner(ch, placement_solver=solve_chain_dp,
                       position_steps=steps, device=device)


def synced_wall(device, fn):
    """``fn()`` and its wall time in seconds, the device drained on both
    sides of the clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def run(model_name, cfg, planner_name, planner, frames, device, fail=False):
    sim = SwarmSim(cnn_cost(cfg), make_devices(6), planner,
                   requests_per_frame=4,
                   failure_frame=1 if fail else -1, failure_uav=2,
                   device=device)
    stats, wall = synced_wall(device, lambda: sim.run(frames=frames))
    s = latency_summary(stats)
    pw = average_power(stats)
    flag = " (+failure@1)" if fail else ""
    print(f"  {model_name:8s} {planner_name:10s} avg latency "
          f"{s.mean_latency:8.4f} s   avg power {pw * 1e3:7.2f} mW   "
          f"feasible {100 * s.feasibility_rate:3.0f}%   wall "
          f"{wall:.3f} s{flag}")
    return stats, s


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    ch = RadioChannel(RadioParams())

    print("=== swarm simulation:", args.frames, "frames, 6 UAVs, "
          f"4 requests/frame, on {device} ===")
    for model_name, cfg in (("lenet", LENET), ("alexnet", ALEXNET)):
        _, lat = run(model_name, cfg, "LLHR", llhr(ch, 80, device),
                     args.frames, device)
        _, heur = run(model_name, cfg, "heuristic",
                      HeuristicPlanner(ch, device=device), args.frames,
                      device)
        _, rand = run(model_name, cfg, "random",
                      RandomPlanner(ch, device=device), args.frames, device)
        assert lat.mean_latency <= heur.mean_latency + 1e-9 and \
            lat.mean_latency <= rand.mean_latency + 1e-9, \
            "LLHR must dominate (Fig. 5)"
    print("\n=== failure delegation (the paper's Section II semantics) ===")
    stats, s = run("lenet", LENET, "LLHR", llhr(ch, 80, device), args.frames,
                   device, fail=True)
    assert args.frames < 2 or stats[1].replanned, "the failure must replan"
    print("\nall orderings match the paper: LLHR <= heuristic, random")


if __name__ == "__main__":
    main()

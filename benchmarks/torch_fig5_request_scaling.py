"""Fig. 5 through the PyTorch port — average latency vs number of
requests: LLHR against the heuristic (static path) and random-selection
baselines (the counterpart of ``benchmarks/fig5_request_scaling.py``:
the same grid, rows and columns).

The LLHR series is ONE ``FleetRollout.run`` on the card per point,
serving the frame's whole request stream (one chain-DP placement per
capturing UAV, the aggregate per-UAV MACs priced exactly against the
eq. 11b budget).  The baselines keep the legacy host loop
(``SwarmSim(backend="legacy")``), as in the reference; they launch no
planner kernel.

    PYTHONPATH=src python3 -m benchmarks.torch_fig5_request_scaling [--smoke]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from benchmarks.torch_common import (MODELS, add_device_arg,
                                     block_until_ready, emit, run_rollout)
from repro_torch.core.baselines import HeuristicPlanner, RandomPlanner
from repro_torch.core.channel import RadioChannel, RadioParams
from repro_torch.core.cost_model import cnn_cost
from repro_torch.core.swarm import SwarmSim, latency_summary, make_devices
from repro_torch.device import resolve_device

REQUESTS = (2, 4, 8, 16, 25)
BASELINES = {"heuristic": HeuristicPlanner, "random": RandomPlanner}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI grid: 2 request counts, 2 frames")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params = RadioParams()
    requests = REQUESTS
    frames, steps = 4, 60
    if args.smoke:
        requests, frames, steps = (2, 8), 2, 30
    for rq in requests:
        trace, wall = run_rollout("alexnet", 6, rq, params, frames=frames,
                                  position_steps=steps, device=device)
        emit(f"fig5/llhr/requests={rq}", wall,
             f"{trace.mean_latency:.4f}", trace.feasibility_rate)
    ch = RadioChannel(params)
    mc = cnn_cost(MODELS["alexnet"])
    for name, cls in BASELINES.items():
        for rq in requests:
            sim = SwarmSim(mc, make_devices(6), cls(ch, device=device),
                           requests_per_frame=rq, backend="legacy",
                           device=device)
            t0 = time.perf_counter()
            stats = sim.run(frames=frames)
            block_until_ready(device)
            wall = (time.perf_counter() - t0) * 1e6
            s = latency_summary(stats)
            emit(f"fig5/{name}/requests={rq}", wall,
                 f"{s.mean_latency:.4f}", s.feasibility_rate)


if __name__ == "__main__":
    main()

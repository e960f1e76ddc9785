"""Fig. 2 through the PyTorch port — average latency vs P_max, for
different #UAVs and bandwidths (the counterpart of
``benchmarks/fig2_latency_power.py``: the same grid, rows and columns).

Paper claims reproduced: latency falls as P_max rises (longer reliable
links become usable), as #UAVs rises (more placement freedom), and as
bandwidth rises (faster reliable links).  Each point is ONE (B = 1,
T = frames) ``FleetRollout.run`` on the card with the fused
P2 -> P1 -> P3 solve per frame; rows carry the feasibility rate.

    PYTHONPATH=src python3 -m benchmarks.torch_fig2_latency_power [--smoke]
        [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks.torch_common import add_device_arg, emit, run_rollout
from repro_torch.core.channel import RadioParams

PMAX_MW = (20, 40, 60, 80, 100, 120)
UAVS = (4, 6, 8)
BW_MHZ = (10, 20)
REQUESTS = 6


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI grid: 2 points, 2 frames")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    grid = [(bw, n, pmax) for bw in BW_MHZ for n in UAVS for pmax in PMAX_MW]
    frames, steps = 4, 60
    if args.smoke:
        grid, frames, steps = [(10, 4, 40), (10, 4, 120)], 2, 30
    for bw, n, pmax in grid:
        params = RadioParams(p_max_watts=pmax * 1e-3, bandwidth_hz=bw * 1e6)
        trace, wall = run_rollout("alexnet", n, REQUESTS, params,
                                  frames=frames, position_steps=steps,
                                  device=args.device)
        emit(f"fig2/bw={bw}MHz/uavs={n}/pmax={pmax}mW", wall,
             f"{trace.mean_latency:.4f}", trace.feasibility_rate)


if __name__ == "__main__":
    main()

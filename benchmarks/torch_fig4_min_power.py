"""Fig. 4 through the PyTorch port — average minimum transmit power for
reliable intermediate-data transfer vs bandwidth, #UAVs and CNN model
(the counterpart of ``benchmarks/fig4_min_power.py``: the same grid,
rows and columns).

Each point is ONE ``FleetRollout.run`` on the card; the power averaged is
the used-links tightened P1 optimum over the rollout's frames.  The
per-request memory cap sits below the model's single-host threshold, so
the placement performs the intermediate-data transfers the figure
measures.

    PYTHONPATH=src python3 -m benchmarks.torch_fig4_min_power [--smoke]
        [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks.torch_common import add_device_arg, emit, run_rollout
from repro_torch.core.channel import RadioParams

BW_MHZ = (10, 15, 20)
UAVS = (4, 6, 8)
# just below each model's single-host memory threshold (see fig. 3)
SPLIT_MEM_FRAC = {"lenet": 2e-4, "alexnet": 0.18}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI grid: lenet only, 2 points, 2 frames")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    grid = [(model, n, bw) for model in ("lenet", "alexnet")
            for n in UAVS for bw in BW_MHZ]
    frames, steps = 4, 60
    if args.smoke:
        grid, frames, steps = [("lenet", 4, 10), ("lenet", 4, 20)], 2, 30
    for model, n, bw in grid:
        params = RadioParams(bandwidth_hz=bw * 1e6)
        trace, wall = run_rollout(model, n, 4, params, frames=frames,
                                  position_steps=steps,
                                  mem_frac=SPLIT_MEM_FRAC[model],
                                  device=args.device)
        emit(f"fig4/{model}/uavs={n}/bw={bw}MHz", wall,
             f"{trace.mean_power * 1e3:.3f}", trace.feasibility_rate)


if __name__ == "__main__":
    main()

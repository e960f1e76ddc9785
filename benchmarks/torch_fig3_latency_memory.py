"""Fig. 3 through the PyTorch port — average latency vs per-UAV memory
cap, for 5-layer LeNet and 8-layer AlexNet under different request
counts (the eq. 11a sweep; the counterpart of
``benchmarks/fig3_latency_memory.py``: the same grid, rows and columns).

Each point is ONE ``FleetRollout.run`` on the card serving the full
multi-source request stream.  The sweep values are per-placement memory
caps, and the request count prices period-compute contention exactly
(the frame's aggregate per-UAV MACs against the eq. 11b budget).  Below
each model's knee the row reports feasibility 0.

    PYTHONPATH=src python3 -m benchmarks.torch_fig3_latency_memory [--smoke]
        [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks.torch_common import add_device_arg, emit, run_rollout
from repro_torch.core.channel import RadioParams

# per-request sweep (eq. 11a): the first point of each model sits just
# below the knee (its biggest layer fits no device: feasibility 0), the
# next force multi-UAV splits, then the cap relaxes to single-host
MEM_FRACS = {"lenet": (1.6e-4, 1.8e-4, 2.2e-4, 1.0),
             "alexnet": (0.13, 0.15, 0.25, 1.0)}
REQUESTS = (4, 8)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI grid: lenet only, 2 points, 2 frames")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    models = ("lenet", "alexnet")
    frames, steps = 4, 60
    if args.smoke:
        models, frames, steps = ("lenet",), 2, 30
    for model in models:
        fracs = MEM_FRACS[model]
        reqs = REQUESTS
        if args.smoke:
            fracs, reqs = fracs[-2:], REQUESTS[:1]
        for rq in reqs:
            for mf in fracs:
                trace, wall = run_rollout(model, 6, rq, RadioParams(),
                                          frames=frames,
                                          position_steps=steps, mem_frac=mf,
                                          device=args.device)
                emit(f"fig3/{model}/requests={rq}/mem_frac={mf}", wall,
                     f"{trace.mean_latency:.4f}", trace.feasibility_rate)


if __name__ == "__main__":
    main()

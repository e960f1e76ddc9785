"""Quickstart through the PyTorch port: plan a UAV swarm with LLHR and run
the partitioned CNN (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python3 examples/torch_quickstart.py [--device cpu]

1. Builds the paper's LeNet cost model (eq. 1-3).
2. Runs the three LLHR stages: P2 positions -> P1 powers -> P3 placement
   (P2 on the device).
3. Executes LeNet partitioned exactly as placed (its conv layers through
   the conv2d GEMM kernel on the card) and asserts the prediction is
   identical to the monolithic model's.
4. Re-plans on the survivors when the first UAV of request 0 fails.
"""
import argparse

import torch

from repro_torch.configs.lenet import LENET
from repro_torch.core.channel import RadioChannel
from repro_torch.core.cost_model import cnn_cost
from repro_torch.core.planner import LLHRPlanner
from repro_torch.core.swarm import make_devices
from repro_torch.device import resolve_device
from repro_torch.models.cnn import distributed_forward, forward, init_cnn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- the paper's model + swarm -------------------------------------
    model_cost = cnn_cost(LENET)
    devices = make_devices(5, mem_frac=2e-4)   # 5 UAVs, ~215 KB weight
    # budget each: LeNet (242 KB of weights/request) MUST be distributed
    channel = RadioChannel()           # Section IV constants

    print("LeNet placeable layers:")
    for l in model_cost.layers:
        print(f"  {l.name:8s} c_j={l.flops:10.0f} MACs   "
              f"m_j={l.weight_bytes:9.0f} B   K_j={l.act_bits:9.0f} bits")

    # --- LLHR: P2 -> P1 -> P3 -------------------------------------------
    planner = LLHRPlanner(channel, position_steps=200, device=device)
    plan, problems = planner.plan(model_cost, devices, requests=[0, 1])

    print("\nOptimal UAV positions (P2):")
    for i, (x, y) in enumerate(plan.positions):
        print(f"  uav{i}: ({x:7.1f}, {y:7.1f}) m   "
              f"P_i = {plan.power.power[i] * 1e3:6.2f} mW")
    print(f"Total transmit power (P1): {plan.total_power * 1e3:.2f} mW")
    for r, sol in enumerate(plan.placements):
        print(f"request {r}: layers -> UAVs {sol.assign}   "
              f"latency {sol.latency * 1e3:.2f} ms  [{sol.solver}]")
    print("breakdown:", {k: f"{v * 1e3:.2f} ms" for k, v in
                         plan.latency_breakdown(problems).items()})

    # --- execute the placement ------------------------------------------
    params = init_cnn(LENET, torch.Generator().manual_seed(0), device=device)
    img = torch.randn((1, 32, 32, 3), generator=torch.Generator()
                      .manual_seed(1)).to(device)
    y_mono = forward(LENET, params, img)
    y_dist, hops = distributed_forward(LENET, params, img,
                                       plan.placements[0].assign)
    same = bool(torch.equal(y_mono, y_dist))
    print(f"\npartitioned inference == monolithic: {same} "
          f"({hops} inter-UAV transfers)")
    print("predicted class:", int(torch.argmax(y_dist[0])))
    if not same:
        raise AssertionError("partitioned inference differs from the "
                             "monolithic model")

    # --- failure delegation ----------------------------------------------
    victim = plan.placements[0].assign[0]
    plan2, _ = planner.replan_on_failure(plan, problems, dead=victim)
    print(f"\nUAV {victim} failed -> re-planned on survivors: "
          f"feasible={plan2.feasible}, "
          f"latency {plan2.total_latency * 1e3:.2f} ms")
    return {"assign": [list(s.assign) for s in plan.placements],
            "total_latency_s": plan.total_latency, "hops": hops,
            "sliced_equals_monolithic": same,
            "replan_feasible": plan2.feasible}


if __name__ == "__main__":
    main()

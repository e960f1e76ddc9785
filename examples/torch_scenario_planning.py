"""Fleet-scale what-if planning with the port's batched scenario engine
(the counterpart of ``examples/scenario_planning.py``).

Plans an ensemble of Monte-Carlo swarm scenarios (mobility jitter, UAV
failures, log-normal shadowing) in one call on the card, prints the
robustness profile of the nominal plan, refreshes it periodically with
``PeriodicReplanner``, optimizes positions on the device (the fused P2
stage), and answers single failures from the precomputed contingency
table.

    PYTHONPATH=src python3 examples/torch_scenario_planning.py \\
        [--scenarios 256] [--uavs 6] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.lenet import LENET
from repro_torch.core.channel import RadioChannel
from repro_torch.core.cost_model import cnn_cost
from repro_torch.core.positions import hex_init
from repro_torch.core.swarm import make_devices
from repro_torch.runtime.scenario_engine import (ContingencyTable,
                                                 PositionSpec,
                                                 ScenarioEngine,
                                                 ScenarioGenerator)
from repro_torch.runtime.serve_loop import PeriodicReplanner


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenarios", type=int, default=256)
    ap.add_argument("--uavs", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    mc = cnn_cost(LENET)
    devs = make_devices(args.uavs)
    base = hex_init(args.uavs, 40.0)
    engine = ScenarioEngine(RadioChannel(), devs, mc, device=args.device)

    print(f"=== {args.scenarios} Monte-Carlo scenarios, {args.uavs} UAVs, "
          f"{len(mc.layers)} LeNet layers ===")
    gen = ScenarioGenerator(base, pos_sigma_m=3.0, failure_prob=0.05,
                            shadow_sigma_db=2.0, seed=0)
    plan = engine.plan_batch(gen.draw(args.scenarios))
    print(f"feasible scenarios : {plan.n_feasible}/{args.scenarios}")
    for q in (50, 90, 95, 99):
        print(f"  p{q:<2d} latency       : "
              f"{plan.latency_percentile(q) * 1e3:8.3f} ms")
    if plan.n_feasible:
        b = plan.best()
        print(f"best scenario      : #{b}  latency "
              f"{plan.latency[b] * 1e3:.3f} ms  power "
              f"{plan.total_power[b] * 1e3:.1f} mW")

    print("\n=== periodic re-optimization, amortized over the ensemble ===")
    rp = PeriodicReplanner(engine, gen, period=5,
                           n_scenarios=args.scenarios)
    refreshed_at = []
    for frame in range(10):
        if rp.tick(frame):
            refreshed_at.append(frame)
            print(f"  frame {frame}: refreshed — nominal "
                  f"{rp.nominal_latency * 1e3:.3f} ms, p95 "
                  f"{rp.robust_latency(95) * 1e3:.3f} ms, placement "
                  f"{tuple(int(x) for x in rp.assignment)}")

    print("\n=== fused P2: optimize positions on device in the same call ===")
    engine_p2 = ScenarioEngine(RadioChannel(), devs, mc,
                               position_spec=PositionSpec(steps=300),
                               device=args.device)
    sparse = ScenarioGenerator(base * 3.0, pos_sigma_m=3.0, seed=1)
    plan_p2 = engine_p2.plan_batch(sparse.draw(args.scenarios))
    d = np.sqrt(((plan_p2.positions[:, :, None] -
                  plan_p2.positions[:, None, :]) ** 2).sum(-1))
    d[:, np.eye(args.uavs, dtype=bool)] = np.inf
    min_sep = float(d.min())
    print(f"feasible scenarios : {plan_p2.n_feasible}/{args.scenarios} "
          f"(positions optimized from a 3x-spread swarm)")
    print(f"min separation     : {min_sep:8.3f} m (constraint: 40 m)")
    print(f"p95 latency        : "
          f"{plan_p2.latency_percentile(95) * 1e3:8.3f} ms")

    print("\n=== precomputed failure contingencies (one batched call) ===")
    table = ContingencyTable(engine, base, source=0)
    delegated = {}
    for dev in devs[:3]:
        cp = table.lookup([dev.name])
        if cp is None:
            print(f"  {dev.name} fails -> no feasible single-failure plan")
            continue
        # lookup() returns survivor-space indices; name them for the reader
        survivors = [x.name for x in devs if x.name != dev.name]
        hosts = sorted({survivors[i] for i in cp.assign})
        delegated[dev.name] = hosts
        print(f"  {dev.name} fails -> delegate layers to "
              f"{', '.join(hosts)}  latency {cp.latency * 1e3:.3f} ms")
    print("\ndone.")
    return {"feasible": plan.n_feasible, "refreshed_at": refreshed_at,
            "retraces": rp.retraces, "p2_feasible": plan_p2.n_feasible,
            "p2_min_separation_m": min_sep,
            "delegated": delegated}


if __name__ == "__main__":
    main()

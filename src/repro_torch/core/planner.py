"""LLHRPlanner — orchestrates P1 -> P2 -> P3 exactly as Section III:

  1. P2 positions the UAVs (the paper solves P1 analytically inside P2 by
     making 8a tight, which is what ``solve_positions`` minimizes);
  2. P1 sizes each UAV's transmit power for reliable links at those
     positions (closed form eq. 7, Pmax-gated feasibility);
  3. P3 places the layers of each request on the feasible-link topology.

The planner also owns the paper's dynamics: periodic re-optimization
("to support the dynamics of the system over time, the optimization is
executed periodically") and failure delegation (a dead UAV's layers are
re-placed on the survivors).

P2 runs on the planner's ``device`` (the card unless ``device="cpu"``);
P1 and P3 are host numpy, as in the reference.  ``placement_solver``
picks P3's solver (exact branch-and-bound by default; the baselines plug
in the greedy and random ones), and ``optimize_positions=False`` skips P2
for callers that supply positions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channel import RadioChannel
from repro_torch.core.cost_model import ModelCost
from repro_torch.core.placement import (Device, PlacementProblem,
                                        PlacementSolution, place_requests,
                                        solve_bnb)
from repro_torch.core.power import (PowerSolution, min_power_for_placement,
                                    solve_power)
from repro_torch.core.positions import solve_positions
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class Plan:
    positions: np.ndarray                 # [U, 2]
    power: PowerSolution
    placements: List[PlacementSolution]   # one per request
    rate: np.ndarray                      # [U, U] bits/s at solved powers
    total_latency: float
    total_power: float
    solver: str

    @property
    def feasible(self) -> bool:
        return all(np.isfinite(s.latency) for s in self.placements)

    def latency_breakdown(self, problems: Sequence[PlacementProblem]
                          ) -> Dict[str, float]:
        ts = tp = tx = 0.0
        for p, s in zip(problems, self.placements):
            if not s.assign:
                continue
            ts += p.transfer_time(p.source, s.assign[0], p.input_bits)
            for j, i in enumerate(s.assign):
                tp += p.compute_time(i, j)
                if j + 1 < len(s.assign):
                    tx += p.transfer_time(i, s.assign[j + 1], p.act_bits[j])
        return {"t_source": ts, "t_compute": tp, "t_transfer": tx}


@dataclass
class LLHRPlanner:
    """End-to-end LLHR optimizer (the paper's contribution)."""

    channel: RadioChannel
    radius: float = 20.0
    placement_solver: Callable[[PlacementProblem], PlacementSolution] = \
        solve_bnb
    optimize_positions: bool = True        # False => caller supplies positions
    position_steps: int = 400
    seed: int = 0
    device: DeviceLike = None              # where P2 runs; None -> cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    def plan(self,
             model: ModelCost,
             devices: Sequence[Device],
             requests: Sequence[int],
             positions: Optional[np.ndarray] = None,
             act_scale: float = 1.0,
             t: int = 0) -> Tuple[Plan, List[PlacementProblem]]:
        """Produce a full LLHR plan.

        ``requests``: source UAV index per request.  ``positions``: [U, 2]
        to skip P2 and plan at these positions.  ``act_scale``: scales
        each layer's output bits K_j (quantised intermediate tensors,
        e.g. 0.25 for int8 of float32).  ``t``: the simulator's
        frame index (``SwarmPlanner`` protocol), ignored: the LLHR plan is
        time-invariant, positions are re-optimized every call.
        """
        del t
        U = len(devices)
        # --- P2: positions ------------------------------------------------
        if positions is None:
            if not self.optimize_positions:
                raise ValueError("positions required when not optimizing")
            pos_sol = solve_positions(U, self.channel, self.radius,
                                      steps=self.position_steps,
                                      seed=self.seed, device=self.device)
            positions = pos_sol.positions
        dist = np.sqrt(((positions[:, None] - positions[None, :]) ** 2)
                       .sum(-1))
        # --- P1: powers (reliability over all feasible links) -------------
        pw = solve_power(dist, self.channel)
        rate = pw.rate_matrix(self.channel, dist)
        # --- P3: per-request layer placement ------------------------------
        problems = [self._problem(model, devices, rate, src, act_scale)
                    for src in requests]
        # share residual caps across the request stream
        shared_mem = np.zeros(U)
        shared_cmp = np.zeros(U)
        for p in problems:
            p.mem_used = shared_mem
            p.compute_used = shared_cmp
        placements = place_requests(problems, self.placement_solver)
        # --- tighten P1 to links actually used -----------------------------
        used_links = [l for s in placements for l in s.links]
        for p, s in zip(problems, placements):
            if s.assign:
                used_links.append((p.source, s.assign[0]))
        pw_used = min_power_for_placement(dist, self.channel, used_links)
        total_lat = float(sum(s.latency for s in placements))
        return (Plan(positions, pw_used, placements, rate, total_lat,
                     pw_used.total_power, self.placement_solver.__name__),
                problems)

    # ------------------------------------------------------------------
    def replan_on_failure(self,
                          plan: Plan,
                          problems: List[PlacementProblem],
                          dead: int) -> Tuple[Plan, List[PlacementProblem]]:
        """Delegation: remove a dead UAV and re-place every affected request
        on the survivors (the paper: 'it will delegate this subtask to
        another UAV to execute it until the whole request is completed')."""
        survivors = [i for i in range(len(problems[0].devices)) if i != dead]
        idx_map = {old: new for new, old in enumerate(survivors)}
        new_problems: List[PlacementProblem] = []
        for p in problems:
            devices = [p.devices[i] for i in survivors]
            rate = plan.rate[np.ix_(survivors, survivors)]
            src = idx_map.get(p.source, 0)   # dead source: nearest survivor
            new_problems.append(PlacementProblem(
                p.compute, p.memory, p.act_bits, devices, rate,
                source=src, input_bits=p.input_bits))
        shared_mem = np.zeros(len(survivors))
        shared_cmp = np.zeros(len(survivors))
        for p in new_problems:
            p.mem_used = shared_mem
            p.compute_used = shared_cmp
        placements = place_requests(new_problems, self.placement_solver)
        positions = plan.positions[survivors]
        dist = np.sqrt(((positions[:, None] - positions[None, :]) ** 2)
                       .sum(-1))
        used_links = [l for s in placements for l in s.links]
        pw = min_power_for_placement(dist, self.channel, used_links)
        total_lat = float(sum(s.latency for s in placements))
        new_plan = Plan(positions, pw, placements,
                        pw.rate_matrix(self.channel, dist), total_lat,
                        pw.total_power, plan.solver + "+replan")
        return new_plan, new_problems

    # ------------------------------------------------------------------
    def _problem(self, model: ModelCost, devices: Sequence[Device],
                 rate: np.ndarray, source: int,
                 act_scale: float = 1.0) -> PlacementProblem:
        compute = np.array([l.flops for l in model.layers])
        memory = np.array([l.weight_bytes for l in model.layers])
        act = np.array([l.act_bits for l in model.layers]) * act_scale
        return PlacementProblem(compute, memory, act, list(devices), rate,
                                source=source, input_bits=model.input_bits)


__all__ = ["Plan", "LLHRPlanner"]

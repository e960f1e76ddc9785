"""The paper's two comparison baselines (Fig. 5).

* ``HeuristicPlanner`` — "the system model configuration is the same as the
  LLHR model, except that the UAVs have a static path to follow that is
  defined in the input configuration": positions come from a fixed
  grid-coverage tour (no P2), power still sized by P1, placement by the
  myopic greedy (no global ILP).
* ``RandomPlanner`` — "the UAVs randomly move in the covered area" and the
  placement is a random feasible selection.

Neither runs P2, so both plan on the host (numpy); ``device`` is handed
to the inner ``LLHRPlanner`` as every planner of the port takes one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.channel import RadioChannel
from repro_torch.core.cost_model import ModelCost
from repro_torch.core.placement import (Device, PlacementProblem,
                                        solve_greedy, solve_random)
from repro_torch.core.planner import LLHRPlanner
from repro_torch.device import DeviceLike, resolve_device


def static_tour_positions(n_uavs: int, t: int, area: float = 480.0,
                          cell: float = 40.0) -> np.ndarray:
    """Fixed boustrophedon coverage tour over the paper's 12x12 cell grid.

    At time frame ``t`` the i-th UAV sits at tour position (t + i*stride),
    i.e. the swarm is spread evenly along a static path — the 'heuristic'
    baseline's input configuration.
    """
    per_side = int(area // cell)                     # 12 cells/side
    cells: List[Tuple[float, float]] = []
    for r in range(per_side):
        cols = range(per_side) if r % 2 == 0 else range(per_side - 1, -1, -1)
        for c in cols:
            cells.append((c * cell + cell / 2.0, r * cell + cell / 2.0))
    stride = max(1, len(cells) // max(n_uavs, 1))
    pos = [cells[(t + i * stride) % len(cells)] for i in range(n_uavs)]
    return np.asarray(pos, dtype=np.float64)


def random_positions(n_uavs: int, rng: np.random.Generator,
                     area: float = 480.0, min_sep: float = 0.0
                     ) -> np.ndarray:
    """Uniform random positions (random-walk waypoints)."""
    for _ in range(64):
        pos = rng.uniform(0.0, area, size=(n_uavs, 2))
        if min_sep <= 0:
            return pos
        d = np.sqrt(((pos[:, None] - pos[None, :]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        if d.min() >= min_sep:
            return pos
    return pos


@dataclass
class HeuristicPlanner:
    """Static-path baseline: LLHR minus position optimization minus ILP.

    Implements the ``SwarmPlanner`` protocol: ``t`` indexes the fixed tour
    (the 'static path defined in the input configuration')."""

    channel: RadioChannel
    radius: float = 20.0
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def plan(self, model: ModelCost, devices: Sequence[Device],
             requests: Sequence[int], t: int = 0,
             area: float = 480.0):
        positions = static_tour_positions(len(devices), t, area)
        inner = LLHRPlanner(self.channel, self.radius,
                            placement_solver=solve_greedy,
                            optimize_positions=False, device=self.device)
        return inner.plan(model, devices, requests, positions=positions)


@dataclass
class RandomPlanner:
    """Random-movement, random-placement baseline.

    Positions are sampled inside the swarm's formation footprint (scaled by
    ``spread``) rather than the whole 480 m area: with the paper's channel a
    fully scattered swarm has no reliable links at all, and the baseline is
    meant to produce the *worst finite* latency (Fig. 5), not a dead network.

    Implements the ``SwarmPlanner`` protocol: ``t`` reseeds the per-frame
    movement and placement draws.
    """

    channel: RadioChannel
    radius: float = 20.0
    seed: int = 0
    spread: float = 1.6
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def plan(self, model: ModelCost, devices: Sequence[Device],
             requests: Sequence[int], t: int = 0, area: float = 480.0):
        rng = np.random.default_rng(self.seed + t)
        span = 2 * self.radius * (math.sqrt(len(devices)) + 1) * self.spread
        positions = random_positions(len(devices), rng, min(span, area),
                                     min_sep=2 * self.radius)

        def _rand(p: PlacementProblem):
            return solve_random(p, seed=self.seed + t)

        inner = LLHRPlanner(self.channel, self.radius,
                            placement_solver=_rand,
                            optimize_positions=False, device=self.device)
        return inner.plan(model, devices, requests, positions=positions)


__all__ = ["static_tour_positions", "random_positions", "HeuristicPlanner",
           "RandomPlanner"]

"""P2 — UAV position optimization (eq. 8-9).

    min_{S}  sum_i  (sigma^2/h0) * (2^(K/(B tau)) - 1) * d_{i,k}^2
    s.t.     x_i^2 + y_i^2 <= R^2            (coverage circle, eq. 8c)
             d_{i,k} >= 2R                    (anti-collision, eq. 8d)

``solve_positions`` is the B = 1 slice of the batched projected-gradient
solver (``core.batch.solve_positions_batched``), started from a
hexagonal packing; ``chain_oracle`` is the analytic optimum of a chain
(collinear at exactly 2R).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.batch import solve_positions_batched
from repro_torch.core.channel import RadioChannel
from repro_torch.device import DeviceLike


@dataclass(frozen=True)
class PositionSolution:
    positions: np.ndarray        # [U, 2]
    objective: float             # total power proxy (eq. 9)
    iterations: int
    max_violation: float         # residual constraint violation (m)


def hex_init(n: int, spacing: float, center: Tuple[float, float] = (0., 0.),
             jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """Hexagonal close packing init: densest arrangement respecting d >= 2R."""
    pts: List[Tuple[float, float]] = []
    rows = int(math.ceil(math.sqrt(n))) + 2
    dy = spacing * math.sqrt(3.0) / 2.0
    for r in range(rows):
        for c in range(rows):
            x = c * spacing + (spacing / 2.0 if r % 2 else 0.0)
            pts.append((x, r * dy))
            if len(pts) >= n * 4:
                break
    arr = np.asarray(pts[:max(n * 4, n)], dtype=np.float64)
    arr -= arr.mean(axis=0)
    order = np.argsort((arr ** 2).sum(axis=1))
    out = arr[order[:n]] + np.asarray(center)
    if jitter:
        rng = np.random.default_rng(seed)
        out = out + rng.normal(scale=jitter, size=out.shape)
    return out


def solve_positions(n_uavs: int,
                    channel: RadioChannel,
                    radius: float = 20.0,
                    area_center: Tuple[float, float] = (0.0, 0.0),
                    links: Optional[np.ndarray] = None,
                    steps: int = 800,
                    lr: float = 0.5,
                    seed: int = 0,
                    device: DeviceLike = None) -> PositionSolution:
    """Projected gradient descent on eq. (9) for one swarm, on ``device``.

    ``links``: [U, U] bool, which pairs exchange data (default: the
    chain i -> i+1).
    """
    pos0 = hex_init(n_uavs, 2.0 * radius, area_center, jitter=0.5, seed=seed)
    sol = solve_positions_batched(
        pos0[None], channel.params, radius=radius,
        links=None if links is None else np.asarray(links, dtype=bool)[None],
        steps=steps, lr=lr, center=area_center, device=device)
    return PositionSolution(positions=sol.positions[0],
                            objective=float(sol.objective[0]),
                            iterations=steps,
                            max_violation=float(sol.max_violation[0]))


def chain_oracle(n: int, radius: float,
                 center: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
    """Analytic optimum for a chain: collinear, consecutive spacing = 2R."""
    xs = (np.arange(n) - (n - 1) / 2.0) * 2.0 * radius
    return np.stack([xs + center[0], np.full(n, center[1])], axis=1)


__all__ = ["PositionSolution", "hex_init", "solve_positions", "chain_oracle"]

"""P1 — transmit-power optimization (eq. 6).

    min_p  sum_i p_i   s.t.  p_i >= P_i^th (reliability),  0 <= p_i <= p_max

Per-UAV power must satisfy the reliability threshold of every link the UAV
actually transmits on, so the binding threshold is the max over its outgoing
links.  The problem is separable per UAV and the closed form of eq. (7) gives
the global optimum directly; we additionally run the paper's "exhaustive
search" refinement on a power grid to *verify* optimality (the paper proposes
convex + exhaustive search), which doubles as a property test oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

import numpy as np

from repro_torch.core.channel import RadioChannel


@dataclass(frozen=True)
class PowerSolution:
    power: np.ndarray            # [U] optimal transmit power (W)
    threshold: np.ndarray        # [U] binding threshold per UAV (W)
    feasible: np.ndarray         # [U] bool: threshold <= p_max
    link_feasible: np.ndarray    # [U,U] bool reliability mask
    total_power: float

    def rate_matrix(self, channel: RadioChannel,
                    dist: np.ndarray) -> np.ndarray:
        """rho_{i,k} at the solved powers (eq. 5); 0 on infeasible links."""
        rate = channel.rate(dist, self.power[:, None])
        rate = np.where(self.link_feasible, rate, 0.0)
        np.fill_diagonal(rate, np.inf)   # self-transfer is free
        return rate


def solve_power(dist: np.ndarray,
                channel: RadioChannel,
                links: Optional[np.ndarray] = None,
                bits: Optional[float] = None) -> PowerSolution:
    """Solve P1 for a swarm with pairwise distances ``dist`` [U,U].

    ``links``: optional [U,U] bool mask of links that must be reliable
    (default: all pairs — the paper sizes power before placement is known).
    """
    p_max = channel.params.p_max_watts
    th_mat = channel.power_threshold(dist, bits)          # [U,U] eq. (7)
    np.fill_diagonal(th_mat, 0.0)
    link_feasible = th_mat <= p_max
    np.fill_diagonal(link_feasible, True)
    if links is None:
        links = link_feasible                              # all feasible pairs
    use = links & link_feasible
    masked = np.where(use, th_mat, 0.0)
    threshold = masked.max(axis=1)                         # binding constraint
    power = np.minimum(threshold, p_max)                   # (6a)-(6b)
    feasible = threshold <= p_max
    return PowerSolution(power=power, threshold=threshold, feasible=feasible,
                         link_feasible=link_feasible,
                         total_power=float(power.sum()))


def exhaustive_refine(sol: PowerSolution, dist: np.ndarray,
                      channel: RadioChannel, grid: int = 256) -> np.ndarray:
    """The paper's exhaustive-search pass: per UAV, scan a power grid in
    [0, p_max] and keep the smallest grid point meeting all reliability
    constraints.  Used to verify the closed form (returns grid powers)."""
    U = dist.shape[0]
    p_max = channel.params.p_max_watts
    th = sol.threshold
    levels = np.linspace(0.0, p_max, grid)
    out = np.empty(U)
    for i in range(U):
        ok = levels >= th[i] - 1e-15
        out[i] = levels[ok][0] if ok.any() else p_max
    return out


def min_power_for_placement(dist: np.ndarray, channel: RadioChannel,
                            placement_links: Iterable[Tuple[int, int]]
                            ) -> PowerSolution:
    """P1 restricted to the links a placement actually uses (tighter optimum:
    a UAV that transmits to nobody needs zero power)."""
    U = dist.shape[0]
    links = np.zeros((U, U), dtype=bool)
    for i, k in placement_links:
        if i != k:
            links[i, k] = True
    return solve_power(dist, channel, links=links)


__all__ = ["PowerSolution", "solve_power", "exhaustive_refine",
           "min_power_for_placement"]

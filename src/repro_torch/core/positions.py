"""P2 — UAV position optimization (eq. 8-9).

    min_{S}  sum_i  (sigma^2/h0) * (2^(K/(B tau)) - 1) * d_{i,k}^2
    s.t.     x_i^2 + y_i^2 <= R^2            (coverage circle, eq. 8c)
             d_{i,k} >= 2R                    (anti-collision, eq. 8d)

``solve_positions`` is the B = 1 slice of the batched projected-gradient
solver (``core.batch.solve_positions_batched``), started from a
hexagonal packing; ``solve_positions_legacy`` is the original
one-scenario solver (a gradient loop on the device, then a host NumPy
push-apart repair), kept as the batched path's parity oracle;
``chain_oracle`` is the analytic optimum of a chain (collinear at
exactly 2R); ``assign_stages_to_torus`` is P2's discrete analogue for the
pipeline planner: stage groups placed on the chips' torus.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.batch import (chain_links, coverage_radius,
                                    position_coeff, solve_positions_batched)
from repro_torch.core.channel import ICIChannel, RadioChannel
from repro_torch.device import DeviceLike, resolve_device


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


def solve_positions_legacy(n_uavs: int,
                           channel: RadioChannel,
                           radius: float = 20.0,
                           area_center: Tuple[float, float] = (0.0, 0.0),
                           links: Optional[np.ndarray] = None,
                           steps: int = 800,
                           lr: float = 0.5,
                           seed: int = 0,
                           device: DeviceLike = None) -> PositionSolution:
    """The original one-scenario solver: ``steps`` normalized gradient
    steps on ``device`` (autograd on the chain-link objective plus the
    eq. 8d hinge x 10 coeff, each step projected onto the coverage
    circle; the last iterate is kept), then a HOST-SIDE NumPy argmin
    push-apart repair (50 passes) on the float32 result.  The parity
    oracle of the batched path; new code calls ``solve_positions``.
    """
    dev = resolve_device(device)
    U = n_uavs
    if links is None:
        links = chain_links(U)
    links = np.asarray(links, dtype=bool)
    two_r = 2.0 * radius
    coeff = position_coeff(channel.params)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    links_t = torch.as_tensor(links | links.T, device=dev)
    eye = torch.eye(U, dtype=torch.bool, device=dev)
    coeff_t, lr_t, two_r2 = f32(coeff), f32(lr), f32(two_r ** 2)
    cover_t = f32(coverage_radius(U, radius))
    center = f32(np.asarray(area_center, np.float32))
    two, ten, eps9, eps12, one = (f32(v) for v in (2.0, 10.0, 1e-9, 1e-12,
                                                   1.0))

    def objective(pos):
        diff = pos[:, None, :] - pos[None, :, :]
        d2 = (diff * diff).sum(-1)
        obj = torch.where(links_t, coeff_t * d2, 0.0).sum() / two
        viol = torch.clamp_min(two_r2 - d2, 0.0)
        pen = torch.where(eye, 0.0, viol * viol).sum()
        return obj + ten * coeff_t * pen

    pos = torch.as_tensor(hex_init(U, two_r, area_center, jitter=0.5,
                                   seed=seed), dtype=torch.float32,
                          device=dev)
    for _ in range(steps):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(p), p)
        pos = pos - lr_t * g / (torch.sqrt((g * g).sum()) + eps12)
        rel = pos - center
        r = torch.sqrt((rel * rel).sum(1, keepdim=True))
        pos = center + rel * torch.minimum(one,
                                           cover_t / torch.maximum(r, eps9))
    pos = pos.cpu().numpy()      # float32, writable
    # hard repair of residual separation violations (push-apart passes)
    for _ in range(50):
        d = np.sqrt(((pos[:, None] - pos[None, :]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        i, k = np.unravel_index(np.argmin(d), d.shape)
        if d[i, k] >= two_r - 1e-6:
            break
        mid = (pos[i] + pos[k]) / 2.0
        dir_ = pos[i] - pos[k]
        nrm = np.linalg.norm(dir_) + 1e-9
        pos[i] = mid + dir_ / nrm * (radius + 1e-3)
        pos[k] = mid - dir_ / nrm * (radius + 1e-3)
    d = np.sqrt(((pos[:, None] - pos[None, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    viol = max(0.0, two_r - float(d.min()))
    d2 = np.where(np.isfinite(d), d, 0.0) ** 2
    obj = float(np.sum(np.where(links | links.T, coeff * d2, 0.0)) / 2.0)
    return PositionSolution(pos, obj, steps, viol)


def chain_oracle(n: int, radius: float,
                 center: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
    """Analytic optimum for a chain: collinear, consecutive spacing = 2R."""
    xs = (np.arange(n) - (n - 1) / 2.0) * 2.0 * radius
    return np.stack([xs + center[0], np.full(n, center[1])], axis=1)


# ---------------------------------------------------------------------------
# Discrete torus placement (the pipeline planner's P2)
# ---------------------------------------------------------------------------


def assign_stages_to_torus(n_stages: int, traffic: np.ndarray,
                           channel: ICIChannel,
                           sweeps: int = 4,
                           exact_cutoff: int = 8,
                           node_budget: int = 200_000
                           ) -> List[Tuple[int, int]]:
    """Place ``n_stages`` stage groups on the chips' torus minimizing
    hop-weighted traffic (quadratic assignment).

    ``traffic[i, k]`` = bytes/step stage i sends to stage k.

    A greedy snake walk + pairwise 2-opt builds the incumbent; for
    ``n_stages <= exact_cutoff`` it is then refined by depth-first
    branch-and-bound over stage -> coordinate permutations.  Transfer costs
    are nonnegative, so a prefix's accumulated cost is an admissible lower
    bound — any prefix already at the incumbent cost is pruned, which is
    what keeps the O(n!) permutation space from being enumerated.  Stage 0
    is pinned to the seed's coordinate (torus translations preserve hop
    counts, so this loses no generality), and the search is hard-capped at
    ``node_budget`` candidate evaluations: a large call returns the best
    placement found so far, never worse than the seed.  The visiting
    order is the reference's, so ties resolve the same way.
    """
    tx, ty = channel.params.torus
    coords = [(x, y) for x in range(tx) for y in range(ty)]
    assert n_stages <= len(coords)
    # greedy: walk stages in chain order along a snake path (hop=1 neighbours)
    snake: List[Tuple[int, int]] = []
    for x in range(tx):
        col = [(x, y) for y in range(ty)]
        snake.extend(col if x % 2 == 0 else col[::-1])
    placement = snake[:n_stages]

    def cost(pl: Sequence[Tuple[int, int]]) -> float:
        c = 0.0
        for i in range(n_stages):
            for k in range(n_stages):
                if traffic[i, k] > 0:
                    c += channel.transfer_time(traffic[i, k],
                                               channel.hops(pl[i], pl[k]))
        return c

    best = cost(placement)
    for _ in range(sweeps):                      # 2-opt improvement
        improved = False
        for i in range(n_stages):
            for k in range(i + 1, n_stages):
                pl = list(placement)
                pl[i], pl[k] = pl[k], pl[i]
                c = cost(pl)
                if c < best - 1e-12:
                    placement, best = pl, c
                    improved = True
        if not improved:
            break
    if n_stages > exact_cutoff or n_stages < 2:
        return list(placement)

    # --- branch-and-bound refinement (prefix cost prunes permutations) ----
    pair_cache: dict = {}

    def pair_cost(i: int, j: int, ci: Tuple[int, int],
                  cj: Tuple[int, int]) -> float:
        key = (i, j, ci, cj)
        c = pair_cache.get(key)
        if c is None:
            c = 0.0
            if traffic[i, j] > 0:
                c += channel.transfer_time(traffic[i, j],
                                           channel.hops(ci, cj))
            if traffic[j, i] > 0:
                c += channel.transfer_time(traffic[j, i],
                                           channel.hops(cj, ci))
            pair_cache[key] = c
        return c

    budget = node_budget
    root = placement[0]
    stack: List[Tuple[List[Tuple[int, int]], float]] = [([root], 0.0)]
    while stack and budget > 0:
        prefix, pc = stack.pop()
        j = len(prefix)
        if j == n_stages:
            if pc < best - 1e-12:
                best, placement = pc, list(prefix)
            continue
        used = set(prefix)
        cands = []
        for c in coords:
            if c in used:
                continue
            budget -= 1
            inc = sum(pair_cost(i, j, prefix[i], c) for i in range(j))
            if pc + inc < best - 1e-12:
                cands.append((inc, c))
            if budget <= 0:
                break
        cands.sort(reverse=True)                 # pop cheapest child first
        for inc, c in cands:
            stack.append((prefix + [c], pc + inc))
    return list(placement)


__all__ = ["PositionSolution", "hex_init", "solve_positions",
           "solve_positions_legacy", "chain_oracle", "assign_stages_to_torus"]

"""P3 — layer-allocation optimization (eq. 10-14).

    min_delta  sum_r sum_{i,k} sum_j  delta_{r,i,j} delta_{r,k,j+1} K_j/rho_ik
               + sum_i t_i^(p) + t_s
    s.t.       per-device memory cap  (11a), compute cap (11b),
               each layer on exactly one device (11c), binary (11d)

Three solvers, strongest first:

* ``solve_bnb``      — exact ILP via depth-first branch-and-bound with an
                       admissible lower bound; matches brute force on small
                       instances and is what the paper's scale (L<=8,
                       U<=12) needs.
* ``solve_chain_dp`` — exact under the contiguous-blocks restriction
                       (device changes only move forward through a device
                       order); O(L^2 * U).  ``solve_chain_dp_minmax`` is
                       its bottleneck variant over exactly S stages, the
                       pipeline planner's objective.
* ``solve_greedy``   — the paper's delegation semantics: place each layer on
                       the current device until a cap is hit, then delegate
                       to the best next device.  Baseline + B&B warm start.

Latencies follow eq. (11)-(14) exactly: source transfer t_s (eq. 12),
compute t_i^p = c_j / e_i (eq. 13), inter-device transfer K_j / rho_ik
(eq. 14).  Multi-request placement consumes residual caps across requests
(the sums over r in 11a/11b).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Device:
    """One UAV / stage group: caps and throughput (Section II-A)."""

    name: str
    mem_cap: float       # \bar{m}_i  [bytes]
    compute_cap: float   # \bar{c}_i  [MACs per frame]
    throughput: float    # e_i        [MACs per second]


@dataclass
class PlacementProblem:
    """One request's placement instance."""

    compute: np.ndarray      # [L] c_j    (MACs)
    memory: np.ndarray       # [L] m_j    (bytes)
    act_bits: np.ndarray     # [L] K_j    (bits out of layer j)
    devices: List[Device]
    rate: np.ndarray         # [U,U] rho_{i,k} bits/s (inf on diagonal)
    source: int = 0          # UAV that captured the request (eq. 12)
    input_bits: float = 0.0  # K_s
    mem_used: Optional[np.ndarray] = None      # residual-cap bookkeeping
    compute_used: Optional[np.ndarray] = None

    def __post_init__(self):
        U = len(self.devices)
        if self.mem_used is None:
            self.mem_used = np.zeros(U)
        if self.compute_used is None:
            self.compute_used = np.zeros(U)

    @property
    def L(self) -> int:
        return len(self.compute)

    @property
    def U(self) -> int:
        return len(self.devices)

    def fits(self, dev: int, layer: int) -> bool:
        """Whether ``layer`` fits ``dev``'s residual memory and compute
        caps."""
        d = self.devices[dev]
        return (self.mem_used[dev] + self.memory[layer] <= d.mem_cap + 1e-9
                and self.compute_used[dev] + self.compute[layer]
                <= d.compute_cap + 1e-9)

    def transfer_time(self, i: int, k: int, bits: float) -> float:
        if i == k:
            return 0.0
        r = self.rate[i, k]
        return float("inf") if r <= 0 else bits / r

    def compute_time(self, dev: int, layer: int) -> float:
        return self.compute[layer] / self.devices[dev].throughput

    def latency(self, assign: Sequence[int]) -> float:
        """Objective eq. (11) for a full assignment [L] -> device ids."""
        t = self.transfer_time(self.source, assign[0], self.input_bits)  # t_s
        for j in range(self.L):
            t += self.compute_time(assign[j], j)                    # eq. (13)
            if j + 1 < self.L:
                t += self.transfer_time(assign[j], assign[j + 1],
                                        self.act_bits[j])           # eq. (14)
        return t

    def feasible(self, assign: Sequence[int]) -> bool:
        mem = self.mem_used.copy()
        cmp_ = self.compute_used.copy()
        for j, i in enumerate(assign):
            mem[i] += self.memory[j]
            cmp_[i] += self.compute[j]
        for i, d in enumerate(self.devices):
            if mem[i] > d.mem_cap + 1e-9 or cmp_[i] > d.compute_cap + 1e-9:
                return False
        return True

    def commit(self, assign: Sequence[int]) -> None:
        """Consume residual caps (multi-request sums of eq. 11a/11b)."""
        for j, i in enumerate(assign):
            self.mem_used[i] += self.memory[j]
            self.compute_used[i] += self.compute[j]


@dataclass(frozen=True)
class PlacementSolution:
    assign: Tuple[int, ...]
    latency: float
    solver: str

    @property
    def links(self) -> List[Tuple[int, int]]:
        out = []
        for a, b in zip(self.assign[:-1], self.assign[1:]):
            if a != b:
                out.append((a, b))
        return out


INFEASIBLE = PlacementSolution((), float("inf"), "infeasible")
#: search nodes after which ``solve_bnb`` keeps its best-so-far answer
BNB_NODE_LIMIT = 2_000_000


# ---------------------------------------------------------------------------
# Exact branch-and-bound ILP
# ---------------------------------------------------------------------------


def solve_bnb(p: PlacementProblem, node_limit: int = BNB_NODE_LIMIT
              ) -> PlacementSolution:
    """Exact DFS branch-and-bound on delta_{i,j}.

    Lower bound from layer j onward (admissible): for each remaining layer,
    the min over devices of compute time, ignoring caps and transfers (both
    nonnegative).  Warm-started with the greedy solution.  After
    ``node_limit`` search nodes the best answer so far is kept.
    """
    L, U = p.L, p.U
    # per-layer min compute time over devices that could *ever* fit it alone
    min_ct = np.empty(L)
    for j in range(L):
        opts = [p.compute[j] / d.throughput for i, d in enumerate(p.devices)
                if (p.memory[j] + p.mem_used[i] <= d.mem_cap + 1e-9 and
                    p.compute[j] + p.compute_used[i] <= d.compute_cap + 1e-9)]
        if not opts:
            return INFEASIBLE
        min_ct[j] = min(opts)
    suffix_lb = np.concatenate([np.cumsum(min_ct[::-1])[::-1], [0.0]])

    warm = solve_greedy(p)
    best_lat = warm.latency
    best: Optional[Tuple[int, ...]] = tuple(warm.assign) if warm.assign else None

    mem = p.mem_used.copy()
    cmp_ = p.compute_used.copy()
    assign = [-1] * L
    nodes = 0

    # device order per layer: cheapest compute first (good pruning order)
    dev_order = [sorted(range(U), key=lambda i: p.compute[j] /
                        p.devices[i].throughput) for j in range(L)]

    def dfs(j: int, cost: float) -> None:
        nonlocal best_lat, best, nodes
        nodes += 1
        if nodes > node_limit:
            return
        if j == L:
            if cost < best_lat:
                best_lat, best = cost, tuple(assign)
            return
        for i in dev_order[j]:
            d = p.devices[i]
            if mem[i] + p.memory[j] > d.mem_cap + 1e-9:
                continue
            if cmp_[i] + p.compute[j] > d.compute_cap + 1e-9:
                continue
            step = p.compute[j] / d.throughput
            if j == 0:
                step += p.transfer_time(p.source, i, p.input_bits)
            else:
                step += p.transfer_time(assign[j - 1], i, p.act_bits[j - 1])
            new_cost = cost + step
            if new_cost + suffix_lb[j + 1] >= best_lat - 1e-15:
                continue
            assign[j] = i
            mem[i] += p.memory[j]
            cmp_[i] += p.compute[j]
            dfs(j + 1, new_cost)
            mem[i] -= p.memory[j]
            cmp_[i] -= p.compute[j]
            assign[j] = -1

    dfs(0, 0.0)
    if best is None:
        return INFEASIBLE
    return PlacementSolution(best, best_lat, "bnb")


def solve_brute(p: PlacementProblem) -> PlacementSolution:
    """Exhaustive enumeration (test oracle; U^L)."""
    best, best_lat = None, float("inf")
    for assign in itertools.product(range(p.U), repeat=p.L):
        if not p.feasible(assign):
            continue
        lat = p.latency(assign)
        if lat < best_lat:
            best, best_lat = assign, lat
    if best is None:
        return INFEASIBLE
    return PlacementSolution(tuple(best), best_lat, "brute")


# ---------------------------------------------------------------------------
# Contiguous-block DP (pipeline stages)
# ---------------------------------------------------------------------------


def solve_chain_dp(p: PlacementProblem,
                   device_order: Optional[Sequence[int]] = None
                   ) -> PlacementSolution:
    """Exact min-latency chain partition into contiguous blocks assigned to
    devices in a fixed order (each device used at most once, order given;
    index order by default).

    dp[j][s] = best cost of placing layers [0..j) using devices order[<s]
    with layer j-1 on device order[s-1].  O(L^2 * U).
    """
    L, U = p.L, p.U
    order = list(device_order) if device_order is not None else list(range(U))
    S = len(order)
    NEG = float("inf")
    # block_cost[a][b][i]: compute time of layers [a..b) on device i, or inf
    pre_c = np.concatenate([[0.0], np.cumsum(p.compute)])
    pre_m = np.concatenate([[0.0], np.cumsum(p.memory)])

    def block_ok(a: int, b: int, dev: int) -> bool:
        d = p.devices[dev]
        return (pre_m[b] - pre_m[a] + p.mem_used[dev] <= d.mem_cap + 1e-9 and
                pre_c[b] - pre_c[a] + p.compute_used[dev]
                <= d.compute_cap + 1e-9)

    dp = np.full((L + 1, S + 1), NEG)
    parent = np.full((L + 1, S + 1, 2), -1, dtype=np.int64)
    dp[0, 0] = 0.0
    for b in range(1, L + 1):
        for s in range(1, S + 1):
            dev = order[s - 1]
            for a in range(b):
                if not block_ok(a, b, dev):
                    continue
                ct = (pre_c[b] - pre_c[a]) / p.devices[dev].throughput
                for s0 in range(s):
                    base = dp[a, s0]
                    if not np.isfinite(base):
                        continue
                    if a == 0:
                        tr = p.transfer_time(p.source, dev, p.input_bits)
                    else:
                        prev_dev = order[s0 - 1]
                        tr = p.transfer_time(prev_dev, dev, p.act_bits[a - 1])
                    cost = base + tr + ct
                    if cost < dp[b, s]:
                        dp[b, s] = cost
                        parent[b, s] = (a, s0)
    s_best = int(np.argmin(dp[L, :]))
    if not np.isfinite(dp[L, s_best]):
        return INFEASIBLE
    # reconstruct
    assign = [0] * L
    b, s = L, s_best
    while b > 0:
        a, s0 = parent[b, s]
        for j in range(a, b):
            assign[j] = order[s - 1]
        b, s = int(a), int(s0)
    return PlacementSolution(tuple(assign), float(dp[L, s_best]), "chain_dp")


def solve_chain_dp_minmax(p: PlacementProblem, n_stages: int,
                          device_order: Optional[Sequence[int]] = None
                          ) -> PlacementSolution:
    """Bottleneck variant: partition the chain into EXACTLY ``n_stages``
    contiguous non-empty blocks minimizing the max per-stage latency
    (compute + incoming transfer) — the pipeline-throughput objective the
    pipeline planner uses on top of the paper's sum-latency DP.

    dp[b][s] = best achievable bottleneck placing layers [0..b) on stages
    [0..s).  O(L^2 * S).  Latency reported = bottleneck (pipeline period).
    """
    L = p.L
    order = list(device_order) if device_order is not None else \
        list(range(min(n_stages, p.U)))
    S = min(n_stages, len(order), L)
    pre_c = np.concatenate([[0.0], np.cumsum(p.compute)])
    pre_m = np.concatenate([[0.0], np.cumsum(p.memory)])
    INF = float("inf")
    dp = np.full((L + 1, S + 1), INF)
    parent = np.full((L + 1, S + 1), -1, dtype=np.int64)
    dp[0, 0] = 0.0
    for s in range(1, S + 1):
        dev = order[s - 1]
        d = p.devices[dev]
        for b in range(s, L + 1):
            for a in range(s - 1, b):
                if not np.isfinite(dp[a, s - 1]):
                    continue
                if pre_m[b] - pre_m[a] + p.mem_used[dev] > d.mem_cap + 1e-9:
                    continue
                if (pre_c[b] - pre_c[a] + p.compute_used[dev]
                        > d.compute_cap + 1e-9):
                    continue
                ct = (pre_c[b] - pre_c[a]) / d.throughput
                if a == 0:
                    tr = p.transfer_time(p.source, dev, p.input_bits)
                else:
                    tr = p.transfer_time(order[s - 2], dev,
                                         p.act_bits[a - 1])
                stage_cost = ct + tr
                cand = max(dp[a, s - 1], stage_cost)
                if cand < dp[b, s]:
                    dp[b, s] = cand
                    parent[b, s] = a
    if not np.isfinite(dp[L, S]):
        return INFEASIBLE
    assign = [0] * L
    b = L
    for s in range(S, 0, -1):
        a = int(parent[b, s])
        for j in range(a, b):
            assign[j] = order[s - 1]
        b = a
    return PlacementSolution(tuple(assign), float(dp[L, S]), "chain_minmax")


# ---------------------------------------------------------------------------
# Greedy delegation (the paper's fallback semantics + heuristic baseline)
# ---------------------------------------------------------------------------


def solve_greedy(p: PlacementProblem) -> PlacementSolution:
    """Myopic: each layer goes to the device minimizing (transfer + compute)
    given the previous layer's device; if a device's cap is exhausted the
    layer is 'delegated' (Section II: 'it will delegate this subtask')."""
    mem = p.mem_used.copy()
    cmp_ = p.compute_used.copy()
    assign: List[int] = []
    prev = p.source
    total = 0.0
    for j in range(p.L):
        best_i, best_c = -1, float("inf")
        for i, d in enumerate(p.devices):
            if mem[i] + p.memory[j] > d.mem_cap + 1e-9:
                continue
            if cmp_[i] + p.compute[j] > d.compute_cap + 1e-9:
                continue
            bits = p.input_bits if j == 0 else p.act_bits[j - 1]
            c = p.transfer_time(prev, i, bits) + p.compute_time(i, j)
            if c < best_c:
                best_i, best_c = i, c
        if best_i < 0:
            return INFEASIBLE
        assign.append(best_i)
        mem[best_i] += p.memory[j]
        cmp_[best_i] += p.compute[j]
        total += best_c
        prev = best_i
    return PlacementSolution(tuple(assign), total, "greedy")


def solve_random(p: PlacementProblem, seed: int = 0,
                 tries: int = 64) -> PlacementSolution:
    """Random-selection baseline: first cap-feasible uniform assignment whose
    links are all reliable (finite latency) — 'produces the worst latency'."""
    rng = np.random.default_rng(seed)
    for _ in range(tries):
        assign = tuple(int(x) for x in rng.integers(0, p.U, size=p.L))
        if p.feasible(assign):
            lat = p.latency(assign)
            if np.isfinite(lat):
                return PlacementSolution(assign, lat, "random")
    return solve_greedy(p)   # random never found feasible: fall back


def place_requests(problems: Sequence[PlacementProblem],
                   solver=solve_bnb) -> List[PlacementSolution]:
    """Place a stream of requests, consuming residual caps (sums over r)."""
    out: List[PlacementSolution] = []
    for p in problems:
        sol = solver(p)
        if sol.assign:
            p.commit(sol.assign)
        out.append(sol)
    return out


__all__ = ["Device", "PlacementProblem", "PlacementSolution", "INFEASIBLE",
           "solve_bnb", "solve_brute", "solve_chain_dp", "solve_chain_dp_minmax",
           "solve_greedy", "solve_random", "place_requests"]

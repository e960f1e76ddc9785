"""UAV-swarm simulator (Section II + IV experimental setup).

Time-framed simulation: each frame, the capturing UAVs generate requests,
the active planner produces positions/powers/placements, latency and power
are accounted, and an injected failure triggers delegation.  Device types
follow Section IV: Raspberry-Pi-class devices, 1 GB RAM, with per-second
multiplication throughputs e_i in {560, 512, 256} (interpreted as MMACs/s
per the cited Disabato et al. benchmark — raw ops/s would make even LeNet
take hours, contradicting Fig. 3's second-scale latencies).

For an ``LLHRPlanner`` placing with the chain DP, ``SwarmSim`` runs the
whole T-frame loop as one ``FleetRollout`` on its ``device`` (one link
geometry and one fused chain-DP launch a frame on the card); the
per-frame host loop ``run_legacy`` is the rollout's parity oracle and the
path of the baseline planners.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Dict, List, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np

from repro_torch.core.cost_model import ModelCost
from repro_torch.core.placement import Device, solve_chain_dp
from repro_torch.core.planner import LLHRPlanner, Plan
from repro_torch.core.positions import hex_init
from repro_torch.core.rollout import PositionSpec, RolloutSpec
from repro_torch.device import DeviceLike, resolve_device

# Section IV device throughputs (MMACs/s) and memory (1 GB RAM, of which a
# fraction is available to weights).
RPI_THROUGHPUTS = (560e6, 512e6, 256e6)
RPI_MEM_BYTES = 1 << 30


@runtime_checkable
class SwarmPlanner(Protocol):
    """The planner contract the simulator dispatches on: produce a full
    plan for one frame's requests at time ``t``.

    Implemented by ``LLHRPlanner`` (time-invariant: ``t`` is ignored) and
    both baselines (``HeuristicPlanner`` walks its static tour with ``t``,
    ``RandomPlanner`` reseeds its draws with it)."""

    def plan(self, model: ModelCost, devices: Sequence[Device],
             requests: Sequence[int], *, t: int = 0
             ) -> Tuple[Plan, list]: ...


def make_devices(n: int, mem_frac: float = 1.0,
                 frame_s: float = 60.0,
                 throughputs: Sequence[float] = RPI_THROUGHPUTS,
                 ) -> List[Device]:
    """n UAVs cycling through the three Raspberry-Pi variants.

    ``frame_s`` sets the per-period compute budget (eq. 11b cap):
    \\bar{c}_i = e_i * frame_s — a UAV cannot absorb more MACs per
    optimization period than it can physically execute.
    """
    devs = []
    for i in range(n):
        e = throughputs[i % len(throughputs)]
        devs.append(Device(name=f"uav{i}", mem_cap=RPI_MEM_BYTES * mem_frac,
                           compute_cap=e * frame_s, throughput=e))
    return devs


@dataclass
class FrameStats:
    """One frame of one trajectory (``RolloutTrace.frame_stats``)."""

    t: int
    latency: float
    power: float
    breakdown: Dict[str, float]
    n_requests: int
    feasible: bool
    replanned: bool = False


@dataclass
class SwarmSim:
    """Drives a planner over T time frames; the figure scripts run this
    once per (planner, config) point.

    ``backend``:

    * ``"auto"``    — the rollout when the planner is an ``LLHRPlanner``
                      placing with ``solve_chain_dp`` (the solver the
                      rollout implements); the legacy host loop otherwise;
    * ``"rollout"`` — force the rollout for any ``LLHRPlanner``; its
                      ``placement_solver`` is SUBSTITUTED by the chain DP;
    * ``"legacy"``  — force the host loop.

    Both backends serve the same request stream: ``requests_per_frame``
    source draws a frame from ``np.random.default_rng(seed)``.  On the
    rollout backend ``jitter_sigma_m`` (mobility jitter) and
    ``battery_j`` (each UAV's charge) are live scenario axes of its
    ``RolloutSpec``; the host loop does not model them.  The
    rollout runs on ``device`` (None = CUDA, raises without it;
    ``"cpu"`` takes the plain path).
    """

    model: ModelCost
    devices: List[Device]
    planner: SwarmPlanner                 # LLHR / Heuristic / Random planner
    requests_per_frame: int = 4
    seed: int = 0
    failure_frame: int = -1               # inject a UAV failure at this frame
    failure_uav: int = 0
    backend: str = "auto"
    jitter_sigma_m: float = 0.0           # rollout-only mobility jitter
    battery_j: float = float("inf")       # rollout-only per-UAV battery
    device: DeviceLike = None             # where the rollout runs

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def run(self, frames: int = 5) -> List[FrameStats]:
        use_rollout = self.backend == "rollout" or (
            self.backend == "auto"
            and isinstance(self.planner, LLHRPlanner)
            and self.planner.placement_solver is solve_chain_dp)
        if not use_rollout:
            return self.run_legacy(frames)
        if not isinstance(self.planner, LLHRPlanner):
            raise ValueError("the rollout backend plans with the fused LLHR "
                             "solve; use backend='legacy' for baselines")
        return self._run_rollout(frames)

    # ------------------------------------------------------------------
    def _run_rollout(self, frames: int) -> List[FrameStats]:
        """The whole frame loop as one B = 1 ``FleetRollout.run``."""
        from repro_torch.runtime.fleet_rollout import FleetRollout

        planner = self.planner
        U = len(self.devices)
        spec = RolloutSpec(frames=frames,
                           requests_per_frame=self.requests_per_frame,
                           jitter_sigma_m=self.jitter_sigma_m,
                           battery_j=self.battery_j)
        p2 = PositionSpec(steps=planner.position_steps,
                          radius=planner.radius) \
            if planner.optimize_positions else None
        rollout = FleetRollout(planner.channel, self.devices, self.model,
                               spec, position_spec=p2, seed=self.seed,
                               device=self.device)
        # the legacy loop's RNG protocol: one source draw per request per
        # frame, served whole (one placement per capturing UAV)
        rng = np.random.default_rng(self.seed)
        arrivals = np.stack([
            np.bincount(rng.integers(0, U, size=self.requests_per_frame),
                        minlength=U)
            for _ in range(frames)])[:, None, :]           # [T, 1, U]
        forced = [(self.failure_frame, self.failure_uav)] \
            if 0 <= self.failure_frame < frames else None
        base = hex_init(U, 2.0 * planner.radius, jitter=0.5,
                        seed=planner.seed)
        trace = rollout.run(base, n_trajectories=1, arrivals=arrivals,
                            forced_failures=forced)
        return trace.frame_stats(0)

    # ------------------------------------------------------------------
    def run_legacy(self, frames: int = 5) -> List[FrameStats]:
        """The per-frame host loop — one planner call per frame; the
        rollout's parity oracle and the baselines' only path."""
        rng = np.random.default_rng(self.seed)
        out: List[FrameStats] = []
        U = len(self.devices)
        for t in range(frames):
            # each UAV generates RQ_i requests, sum = RQ  (Section II-A)
            sources = rng.integers(0, U, size=self.requests_per_frame)
            plan, problems = self.planner.plan(
                self.model, self.devices, list(sources), t=t)
            replanned = False
            if t == self.failure_frame and isinstance(self.planner,
                                                      LLHRPlanner):
                plan, problems = self.planner.replan_on_failure(
                    plan, problems, self.failure_uav)
                replanned = True
            out.append(FrameStats(
                t=t, latency=plan.total_latency / max(len(sources), 1),
                power=plan.total_power,
                breakdown=plan.latency_breakdown(problems),
                n_requests=len(sources), feasible=plan.feasible,
                replanned=replanned))
        return out


@dataclass(frozen=True)
class LatencySummary:
    """Latency statistics that cannot hide infeasible frames: the mean is
    over feasible frames ONLY, and ``feasibility_rate`` says how many
    frames that mean actually covers."""

    mean_latency: float        # mean over feasible frames (inf when none)
    feasibility_rate: float    # feasible frames / all frames
    n_frames: int
    n_feasible: int

    def __str__(self) -> str:
        return (f"{self.mean_latency:.4f} s over "
                f"{100.0 * self.feasibility_rate:.0f}% feasible frames "
                f"({self.n_feasible}/{self.n_frames})")


def latency_summary(stats: Sequence[FrameStats]) -> LatencySummary:
    """Mean per-request latency PLUS the feasibility rate it covers."""
    lats = np.asarray([s.latency for s in stats], dtype=np.float64)
    ok = np.isfinite(lats) & np.asarray([s.feasible for s in stats])
    return LatencySummary(
        mean_latency=float(lats[ok].mean()) if ok.any() else float("inf"),
        feasibility_rate=float(ok.mean()) if len(stats) else 0.0,
        n_frames=len(stats), n_feasible=int(ok.sum()))


def average_latency(stats: Sequence[FrameStats]) -> float:
    """Mean latency over feasible frames only — prefer ``latency_summary``,
    which also reports how many frames were dropped as infeasible."""
    vals = [s.latency for s in stats if np.isfinite(s.latency)]
    return float(np.mean(vals)) if vals else float("inf")


def feasibility_rate(stats: Sequence[FrameStats]) -> float:
    return latency_summary(stats).feasibility_rate


def average_power(stats: Sequence[FrameStats]) -> float:
    """Mean tightened transmit power over FEASIBLE frames only."""
    vals = [s.power for s in stats if s.feasible]
    return float(np.mean(vals)) if vals else 0.0


__all__ = ["RPI_THROUGHPUTS", "RPI_MEM_BYTES", "make_devices", "FrameStats",
           "SwarmPlanner", "SwarmSim", "LatencySummary", "latency_summary",
           "average_latency", "feasibility_rate", "average_power"]

"""LLHR applied to a pipeline of accelerator chips: pipeline-stage planning.

The same P3 chain-partition (contiguous DP) that places CNN layers on
UAVs places transformer blocks on pipeline-stage groups of chips, and the
same P2 'positions' idea places those stages on the chips' torus so that
activation hand-offs travel one hop.

The planner is host NumPy in float64, the reference's arithmetic operation
for operation.  It knows no hardware: the chip (``ChipParams``) and the
interconnect (``ICIChannel``) are required arguments.  For an H100 SXM,
``card_chip`` reads the card's name and memory and takes the dense bf16
peak from NVIDIA's data sheet, and ``H100_SXM_NVLINK_BYTES_ONE_WAY`` is
the data sheet's NVLink rate; the hop latency and the topology are the
caller's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.channel import ICIChannel
from repro_torch.core.cost_model import arch_cost
from repro_torch.core.placement import (Device, PlacementProblem,
                                        solve_chain_dp, solve_chain_dp_minmax)
from repro_torch.core.positions import assign_stages_to_torus
from repro_torch.launch.roofline import BF16_FLOPS, NVLINK_BW

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, FLOP/s, and
#: NVLink 900 GB/s counts both directions (a stage hand-off uses one); the
#: roofline module holds the card's constants
H100_SXM_BF16_FLOPS = BF16_FLOPS
H100_SXM_NVLINK_BYTES_ONE_WAY = NVLINK_BW


@dataclass(frozen=True)
class ChipParams:
    """One chip of a pipeline stage: what it computes and what it holds."""

    name: str
    macs_per_s: float        # multiply-accumulates a second (FLOP/s / 2)
    hbm_bytes: float         # device memory


def card_chip(device) -> ChipParams:
    """The H100 SXM at CUDA ``device``: its name and memory from the card,
    half the data sheet's dense bf16 FLOP/s as its MAC rate.  Another kind
    of card (the PCIe and NVL H100s among them) raises: its peak is not
    the H100 SXM's."""
    import torch
    props = torch.cuda.get_device_properties(device)
    if "H100" not in props.name or "PCIe" in props.name or \
            "NVL" in props.name:
        raise ValueError(f"card_chip: {props.name} is not an H100 SXM; "
                         "give its ChipParams from its own data sheet")
    return ChipParams(props.name, H100_SXM_BF16_FLOPS / 2.0,
                      float(props.total_memory))


@dataclass(frozen=True)
class StagePlan:
    """A pipeline partition of an architecture onto stage groups."""

    arch: str
    n_stages: int
    boundaries: Tuple[int, ...]        # stage s owns blocks [b[s], b[s+1])
    stage_coords: Tuple[Tuple[int, int], ...]   # torus placement per stage
    stage_latency_s: Tuple[float, ...]          # compute time per stage
    transfer_latency_s: Tuple[float, ...]       # hand-off time per boundary
    bottleneck_s: float                # max stage latency (pipeline period)
    total_latency_s: float             # single-microbatch fill latency

    @property
    def blocks_per_stage(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.boundaries[:-1],
                                           self.boundaries[1:]))


def stage_devices(n_stages: int, chips_per_stage: int, chip: ChipParams,
                  hbm_frac: float = 0.85) -> List[Device]:
    """Each pipeline stage is a group of chips acting as one LLHR 'UAV'."""
    return [Device(name=f"stage{s}",
                   mem_cap=chip.hbm_bytes * hbm_frac * chips_per_stage,
                   compute_cap=float("inf"),
                   throughput=chip.macs_per_s * chips_per_stage)
            for s in range(n_stages)]


def plan_pipeline(cfg: ArchConfig, shape: ShapeConfig, n_stages: int,
                  chips_per_stage: int = 1, *, chip: ChipParams,
                  ici: ICIChannel, microbatches: Optional[int] = None,
                  objective: str = "bottleneck") -> StagePlan:
    """LLHR P3 (contiguous DP) + P2 (torus assignment) for one arch/shape.

    ``objective``: 'bottleneck' partitions into exactly ``n_stages`` blocks
    minimizing the pipeline period (the throughput goal); 'latency' is
    the paper's sum objective (single-request end-to-end, may merge stages).
    """
    model = arch_cost(cfg, shape)
    devices = stage_devices(n_stages, chips_per_stage, chip)
    mb = microbatches or max(1, min(shape.global_batch, 4 * n_stages))
    # per-microbatch costs: scale activation bits and compute by 1/mb
    compute = np.array([l.flops for l in model.layers]) / mb
    memory = np.array([l.weight_bytes for l in model.layers])
    act = np.array([l.act_bits for l in model.layers]) / mb
    # one-hop rate between adjacent stages (P2 below makes this true)
    rate = np.full((n_stages, n_stages), ici.rate(1) * 8.0)   # bits/s
    np.fill_diagonal(rate, np.inf)
    problem = PlacementProblem(compute, memory, act, devices, rate,
                               source=0, input_bits=model.input_bits / mb)
    if objective == "bottleneck":
        sol = solve_chain_dp_minmax(problem, n_stages)
    else:
        sol = solve_chain_dp(problem)
    if not sol.assign:
        raise ValueError(
            f"{cfg.name}/{shape.name}: no feasible {n_stages}-stage partition"
            f" (weights {sum(memory)/1e9:.1f} GB vs "
            f"{devices[0].mem_cap*n_stages/1e9:.1f} GB)")
    # boundaries from the assignment
    bounds = [0]
    for j in range(1, len(sol.assign)):
        if sol.assign[j] != sol.assign[j - 1]:
            bounds.append(j)
    bounds.append(len(sol.assign))
    used_stages = len(bounds) - 1
    # stage compute latencies
    stage_lat = []
    for s in range(used_stages):
        a, b = bounds[s], bounds[s + 1]
        stage_lat.append(float(compute[a:b].sum()) /
                         devices[0].throughput)
    # P2: place stages on the torus, traffic = boundary activation bytes
    traffic = np.zeros((used_stages, used_stages))
    for s in range(used_stages - 1):
        traffic[s, s + 1] = act[bounds[s + 1] - 1] / 8.0
    coords = assign_stages_to_torus(used_stages, traffic, ici)
    transfer = []
    for s in range(used_stages - 1):
        hops = ici.hops(coords[s], coords[s + 1])
        transfer.append(ici.transfer_time(traffic[s, s + 1], hops))
    bottleneck = max(stage_lat) if stage_lat else 0.0
    total = sum(stage_lat) + sum(transfer)
    return StagePlan(cfg.name, used_stages, tuple(bounds), tuple(coords),
                     tuple(stage_lat), tuple(transfer), bottleneck, total)


def pipeline_efficiency(plan: StagePlan, microbatches: int) -> float:
    """1F1B efficiency: mb / (mb + stages - 1) adjusted for imbalance."""
    if not plan.stage_latency_s:
        return 1.0
    mean = float(np.mean(plan.stage_latency_s))
    balance = mean / plan.bottleneck_s if plan.bottleneck_s else 1.0
    bubble = microbatches / (microbatches + plan.n_stages - 1)
    return balance * bubble


__all__ = ["ChipParams", "StagePlan", "card_chip",
           "pipeline_efficiency", "plan_pipeline", "stage_devices",
           "H100_SXM_BF16_FLOPS", "H100_SXM_NVLINK_BYTES_ONE_WAY"]

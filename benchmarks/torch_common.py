"""Shared helpers of the port's figure scripts: CSV emission and timed
planner / rollout runs through ``repro_torch`` (the counterpart of
``benchmarks/common.py``).

Every LLHR figure point is ONE ``FleetRollout.run`` on the chosen device
(``run_rollout``); the scalar planners stay the figures' oracle
(``run_planner``).  The device is the card unless the caller names the
CPU: ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.alexnet import ALEXNET
from repro_torch.configs.lenet import LENET
from repro_torch.core.baselines import HeuristicPlanner, RandomPlanner
from repro_torch.core.channel import RadioChannel, RadioParams
from repro_torch.core.cost_model import cnn_cost
from repro_torch.core.planner import LLHRPlanner
from repro_torch.core.positions import hex_init
from repro_torch.core.rollout import PositionSpec, RolloutSpec
from repro_torch.core.swarm import make_devices
from repro_torch.device import DeviceLike, resolve_device

MODELS = {"lenet": LENET, "alexnet": ALEXNET}


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the LLHR rollouts (default cuda; "
                         "cpu runs the plain PyTorch path)")


def block_until_ready(device: torch.device) -> None:
    """Wait for the device's queued work (the CPU's is done on return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emit(name: str, us_per_call: float, derived,
         feasibility: Optional[float] = None) -> None:
    """CSV row: name, wall time, derived quantity, feasibility rate (empty
    for rows without one) — the reference's columns."""
    feas = "" if feasibility is None else f"{feasibility:.3f}"
    print(f"{name},{us_per_call:.1f},{derived},{feas}")


def run_planner(planner_kind: str, model: str, n_uavs: int, requests: int,
                params: RadioParams, seed: int = 0, t: int = 0,
                device: DeviceLike = None):
    """-> (plan, wall_us).  planner_kind in {llhr, heuristic, random}.

    One scalar planner call, the figures' oracle; the LLHR figure points
    go through ``run_rollout``."""
    dev = resolve_device(device)
    ch = RadioChannel(params)
    mc = cnn_cost(MODELS[model])
    devs = make_devices(n_uavs)
    reqs = list(np.arange(requests) % n_uavs)
    t0 = time.perf_counter()
    if planner_kind == "llhr":
        plan, _ = LLHRPlanner(ch, position_steps=60, seed=seed,
                              device=dev).plan(mc, devs, reqs, t=t)
    elif planner_kind == "heuristic":
        plan, _ = HeuristicPlanner(ch, device=dev).plan(mc, devs, reqs, t=t)
    else:
        plan, _ = RandomPlanner(ch, seed=seed, device=dev).plan(
            mc, devs, reqs, t=t)
    block_until_ready(dev)
    wall_us = (time.perf_counter() - t0) * 1e6
    return plan, wall_us


def run_rollout(model: str, n_uavs: int, requests: int, params: RadioParams,
                frames: int = 4, position_steps: int = 60,
                mem_frac: float = 1.0, seed: int = 0,
                radius: float = 20.0, device: DeviceLike = None):
    """ONE rollout call per figure point: a (B = 1, T = ``frames``) fleet
    rollout with mild mobility jitter and the fused P2 -> P1 -> P3 solve
    per frame, serving the frame's whole multi-source request stream.

    -> (trace, wall_us): the wall of the steady call, after a warm-up
    call that builds the point's plan function (every point is a new
    signature) and the kernels; each call ends in a device synchronise."""
    from repro_torch.runtime.fleet_rollout import FleetRollout

    dev = resolve_device(device)
    ch = RadioChannel(params)
    mc = cnn_cost(MODELS[model])
    devs = make_devices(n_uavs, mem_frac=mem_frac)
    spec = RolloutSpec(frames=frames, requests_per_frame=requests,
                       jitter_sigma_m=radius / 20.0)
    ro = FleetRollout(ch, devs, mc, spec,
                      position_spec=PositionSpec(steps=position_steps,
                                                 radius=radius), seed=seed,
                      device=dev)
    base = hex_init(n_uavs, 2.0 * radius, jitter=0.5, seed=seed)
    ro.run(base, n_trajectories=1)             # warm-up: build + kernels
    block_until_ready(dev)
    t0 = time.perf_counter()
    trace = ro.run(base, n_trajectories=1)
    block_until_ready(dev)
    wall_us = (time.perf_counter() - t0) * 1e6
    return trace, wall_us

"""Fault tolerance: failure detection -> LLHR re-plan (the paper's
delegation, Section II) -> checkpoint discovery -> resume, plus
straggler mitigation by throughput demotion (the reference's
``runtime/fault_tolerance.py``; host Python, no device work of its own).

The detector is fed by missed heartbeats, drained batteries and step
times; the *re-planning* path is the paper's mechanism: placement is
re-solved with the dead device removed, exactly like a UAV delegating
its subtask, or answered from a precomputed ``ContingencyTable``.
``scale_elastic`` re-plans a pipeline for whatever stage count survives.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.channel import ICIChannel
from repro_torch.core.pipeline_opt import ChipParams, StagePlan, plan_pipeline
from repro_torch.core.placement import Device
from repro_torch.runtime import checkpoint as ckpt


@dataclass
class DeviceHealth:
    name: str
    alive: bool = True
    last_heartbeat: float = 0.0
    # exponentially-averaged step-time; stragglers show up here
    step_time_ema: float = 0.0
    # last reported battery charge (J); a drained UAV is dead on arrival
    charge: float = float("inf")


class HealthTracker:
    """Heartbeat + step-time + battery tracking; classifies dead (missed
    heartbeats OR drained battery) and straggling devices.

    Battery death is the fleet rollout's third failure axis: a UAV whose
    telemetry reports ``charge <= battery_floor_j`` is marked dead exactly
    like a lapsed heartbeat, so the SAME delegation path (contingency
    lookup, then live re-plan) absorbs it — no separate machinery."""

    def __init__(self, names: Sequence[str], timeout_s: float = 60.0,
                 straggler_factor: float = 1.5,
                 battery_floor_j: float = 0.0,
                 now: Optional[float] = None):
        self.timeout = timeout_s
        self.factor = straggler_factor
        self.battery_floor = battery_floor_j
        # registration counts as the first heartbeat: a device that NEVER
        # reports must time out like one that stopped reporting, not sit
        # immortal at last_heartbeat == 0.0
        now = time.monotonic() if now is None else now
        self.devices = {n: DeviceHealth(n, last_heartbeat=now)
                        for n in names}

    def heartbeat(self, name: str, step_time: float,
                  now: Optional[float] = None) -> None:
        d = self.devices[name]
        now = time.monotonic() if now is None else now
        d.last_heartbeat = now
        d.step_time_ema = step_time if d.step_time_ema == 0 else \
            0.8 * d.step_time_ema + 0.2 * step_time

    def battery(self, name: str, charge_j: float) -> None:
        """Record a battery telemetry sample (e.g. a ``RolloutTrace``
        charge row); ``scan`` classifies drained devices as dead."""
        self.devices[name].charge = charge_j

    def scan(self, now: Optional[float] = None
             ) -> Tuple[List[str], List[str]]:
        """-> (dead, stragglers)."""
        now = time.monotonic() if now is None else now
        dead, slow = [], []
        alive_times = [d.step_time_ema for d in self.devices.values()
                       if d.alive and d.step_time_ema > 0]
        median = float(np.median(alive_times)) if alive_times else 0.0
        for d in self.devices.values():
            if not d.alive:
                continue
            if d.charge <= self.battery_floor:
                d.alive = False
                dead.append(d.name)
            elif now - d.last_heartbeat > self.timeout:
                d.alive = False
                dead.append(d.name)
            elif median and d.step_time_ema > self.factor * median:
                slow.append(d.name)
        return dead, slow


@dataclass
class ElasticPlanState:
    """Current placement + the device set it assumes.  ``plan`` is
    whatever the runner's ``replan_fn`` or contingency table returns (a
    ``StagePlan``, a ``ContingencyPlan``, a plan dict, ...)."""

    devices: List[Device]
    plan: Optional[Union[StagePlan, Any]] = None
    generation: int = 0


class FaultTolerantRunner:
    """Orchestrates: detect -> re-plan (LLHR delegation) -> restore -> go.

    ``replan_fn(devices) -> plan`` re-solves the placement (P3) over the
    surviving devices; ``restore_fn(step)`` reloads the last committed
    checkpoint.  The runner is exercised end-to-end by the integration
    tests (failure injected mid-run) and the chaos harness.
    """

    def __init__(self, devices: Sequence[Device],
                 replan_fn: Callable[[Sequence[Device]], object],
                 ckpt_dir: str,
                 straggler_demote: float = 0.5,
                 contingency: Optional[object] = None,
                 straggler_cooldown_s: float = 30.0,
                 demote_floor: float = 0.1,
                 health: Optional[HealthTracker] = None):
        self.state = ElasticPlanState(list(devices))
        self.replan_fn = replan_fn
        self.ckpt_dir = ckpt_dir
        self.demote = straggler_demote
        # straggler hysteresis: a demoted device is off-limits for
        # ``straggler_cooldown_s`` and never drops below ``demote_floor`` x
        # its original throughput — without these, every scan of one slow
        # device re-demotes it (throughput -> 0, a replan per tick)
        self.straggler_cooldown = straggler_cooldown_s
        self.demote_floor = demote_floor
        self._demoted_at: Dict[str, float] = {}
        self._base_throughput = {d.name: d.throughput for d in devices}
        # optional precomputed failure plans (scenario_engine.ContingencyTable
        # or anything with ``lookup(dead_names) -> plan | None``): delegation
        # becomes a table lookup instead of a re-solve at failure time
        self.contingency = contingency
        self.health = health if health is not None \
            else HealthTracker([d.name for d in devices])
        self.state.plan = replan_fn(self.state.devices)
        self.events: List[Dict] = []

    # ------------------------------------------------------------------
    def on_failure(self, dead_names: Sequence[str]) -> object:
        """Delegation: drop dead devices, re-solve placement — or switch to
        the precomputed contingency plan when the batched engine already
        solved this failure scenario up front.  A contingency hit installs a
        ``ContingencyPlan`` already normalized to the survivor index space,
        so its ``assign`` addresses the shrunk ``state.devices`` list exactly
        like a live ``replan_fn`` result would."""
        survivors = [d for d in self.state.devices
                     if d.name not in set(dead_names)]
        if not survivors:
            raise RuntimeError("no surviving devices")
        self.state.devices = survivors
        plan = self.contingency.lookup(dead_names) if self.contingency \
            else None
        precomputed = plan is not None
        self.state.plan = plan if precomputed else self.replan_fn(survivors)
        self.contingency = None    # table assumed the full swarm; now stale
        self.state.generation += 1
        self.events.append({"kind": "failure", "dead": list(dead_names),
                            "generation": self.state.generation,
                            "precomputed": precomputed})
        return self.state.plan

    def rearm_contingency(self, table: object) -> None:
        """Install a fresh precomputed failure table.

        After a failure/demotion invalidates the old table, build a
        ``ContingencyTable`` over a ``ScenarioEngine`` for the CURRENT
        survivor devices (the old engine is specialized to the old swarm)
        and re-arm the fast delegation path here.  For pure mobility
        updates — same devices, new positions — ``on_mobility`` refreshes
        the existing table in place and costs no recompile."""
        self.contingency = table

    def on_mobility(self, positions, source: int = 0) -> None:
        """Mobility update: refresh the precomputed failure table at newly
        measured positions.  The refresh is a pure device-side re-execution
        through the compiled-plan cache (no retrace), and when the table's
        engine fuses P2 the measured positions are only an initialization —
        every refreshed ``ContingencyPlan`` then carries device-optimized
        survivor positions, so delegation never ships a position solve from
        host."""
        if self.contingency is not None and \
                hasattr(self.contingency, "refresh"):
            self.contingency.refresh(positions, source=source)

    def on_battery(self, charges: Dict[str, float],
                   now: Optional[float] = None) -> Optional[object]:
        """Feed battery telemetry (device name -> joules remaining, e.g. the
        last frame of a ``RolloutTrace.charge``) and immediately scan: a
        drained UAV becomes a failure the precomputed contingency path
        absorbs like any other death.  Returns the new plan when anything
        died, else None."""
        for name, charge in charges.items():
            if name in self.health.devices:
                self.health.battery(name, float(charge))
        dead, _ = self.health.scan(now)
        return self.on_failure(dead) if dead else None

    def on_straggler(self, slow_names: Sequence[str],
                     now: Optional[float] = None) -> Optional[object]:
        """Demote straggler throughput and shift load away (re-plan).

        Hysteresis: a device demoted within ``straggler_cooldown_s`` is
        skipped (one demotion gets a chance to take effect before the
        next), and throughput never drops below ``demote_floor`` x the
        device's registration-time throughput.  When every reported
        straggler is filtered out, NO replan happens and no event is
        recorded — repeated scans of the same slow device demote once."""
        now = time.monotonic() if now is None else now
        eligible = set()
        for d in self.state.devices:
            if d.name not in set(slow_names):
                continue
            last = self._demoted_at.get(d.name)
            if last is not None and now - last < self.straggler_cooldown:
                continue
            floor = self.demote_floor * self._base_throughput.get(
                d.name, d.throughput)
            if d.throughput <= floor:
                continue
            eligible.add(d.name)
        if not eligible:
            return None
        new_devs = []
        for d in self.state.devices:
            if d.name in eligible:
                floor = self.demote_floor * self._base_throughput.get(
                    d.name, d.throughput)
                new_devs.append(Device(d.name, d.mem_cap, d.compute_cap,
                                       max(d.throughput * self.demote,
                                           floor)))
                self._demoted_at[d.name] = now
            else:
                new_devs.append(d)
        self.state.devices = new_devs
        self.state.plan = self.replan_fn(new_devs)
        self.contingency = None    # table assumed pre-demotion throughputs
        self.state.generation += 1
        self.events.append({"kind": "straggler", "slow": sorted(eligible),
                            "generation": self.state.generation})
        return self.state.plan

    def restore_step(self) -> Optional[int]:
        return ckpt.latest_step(self.ckpt_dir)

    def tick(self, now: Optional[float] = None) -> Optional[object]:
        dead, slow = self.health.scan(now)
        if dead:
            return self.on_failure(dead)
        if slow:
            return self.on_straggler(slow, now=now)
        return None


def scale_elastic(n_devices: int, cfg, shape, chips_per_stage: int = 1, *,
                  chip: ChipParams, ici: ICIChannel) -> StagePlan:
    """Elastic rescale helper: plan for whatever device count survives."""
    return plan_pipeline(cfg, shape, n_stages=max(1, n_devices),
                         chips_per_stage=chips_per_stage, chip=chip, ici=ici)


__all__ = ["DeviceHealth", "HealthTracker", "ElasticPlanState",
           "FaultTolerantRunner", "scale_elastic"]

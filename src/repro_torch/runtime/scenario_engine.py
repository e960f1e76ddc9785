"""Fleet-scale scenario engine: plan hundreds of LLHR swarm scenarios in one
batched call on the card.

* ``ScenarioGenerator`` — Monte-Carlo draws around a nominal swarm state
  (host numpy, seeded): Gaussian position jitter, i.i.d. UAV failures,
  log-normal shadowing on the channel gain, a capturing UAV per scenario.
* ``ScenarioEngine``    — the whole planning tick (optionally P2, then the
  link geometry, P1, eq. (5) rates, the chain-DP placement + backtrack and
  the used-links power tightening) over the whole scenario axis on one
  device.  Construct it with a ``PositionSpec`` to fuse the P2 stage.
* ``ContingencyTable``  — every single-UAV-failure plan precomputed in one
  engine call, so a fault-tolerant runner can delegate at once instead of
  re-solving at failure time.
* ``PlanFnCache``       — built planning functions shared by every engine
  with the same static problem signature and device.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.batch import chain_links
from repro_torch.core.channel import RadioChannel, RadioParams
from repro_torch.core.cost_model import ModelCost
from repro_torch.core.placement import Device
from repro_torch.core.rollout import (PositionSpec, make_plan_fn,
                                      percentile_with_inf)
from repro_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# Monte-Carlo scenario generation
# ---------------------------------------------------------------------------


@dataclass
class ScenarioBatch:
    """A batch of B swarm scenarios (the engine's input)."""

    positions: np.ndarray                  # [B, U, 2] UAV positions (m)
    source: np.ndarray                     # [B] capturing UAV per scenario
    active: Optional[np.ndarray] = None    # [B, U] bool; False = failed UAV
    gain_scale: Optional[np.ndarray] = None  # [B, U, U] shadowing factor

    @property
    def n_scenarios(self) -> int:
        return self.positions.shape[0]

    @property
    def n_uavs(self) -> int:
        return self.positions.shape[1]


@dataclass
class ScenarioGenerator:
    """Monte-Carlo draws around a nominal swarm state.

    * ``pos_sigma_m``     — std-dev of per-axis Gaussian mobility jitter.
    * ``failure_prob``    — i.i.d. probability each UAV has failed; at least
                            one UAV always survives, and the scenario source
                            is always drawn among survivors.
    * ``shadow_sigma_db`` — std-dev (dB) of symmetric log-normal shadowing
                            applied multiplicatively to the link gain.
    """

    base_positions: np.ndarray
    pos_sigma_m: float = 0.0
    failure_prob: float = 0.0
    shadow_sigma_db: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self.base_positions = np.asarray(self.base_positions, np.float64)
        self._rng = np.random.default_rng(self.seed)

    def draw(self, n_scenarios: int) -> ScenarioBatch:
        rng = self._rng
        U = self.base_positions.shape[0]
        pos = np.broadcast_to(self.base_positions,
                              (n_scenarios, U, 2)).copy()
        if self.pos_sigma_m > 0:
            pos += rng.normal(scale=self.pos_sigma_m, size=pos.shape)
        active = None
        if self.failure_prob > 0:
            active = rng.random((n_scenarios, U)) >= self.failure_prob
            none_alive = ~active.any(axis=1)
            active[none_alive, 0] = True       # at least one survivor
        gain_scale = None
        if self.shadow_sigma_db > 0:
            # draw once per unordered pair and mirror (reciprocity)
            sh_db = rng.normal(scale=self.shadow_sigma_db,
                               size=(n_scenarios, U, U))
            upper = np.triu(sh_db, k=1)
            sh_db = upper + np.swapaxes(upper, 1, 2)
            gain_scale = 10.0 ** (sh_db / 10.0)
            eye = np.eye(U, dtype=bool)
            gain_scale[:, eye] = 1.0
        if active is None:
            source = rng.integers(0, U, size=n_scenarios)
        else:                                   # source among survivors
            source = np.array([rng.choice(np.flatnonzero(a))
                               for a in active])
        return ScenarioBatch(positions=pos, source=source, active=active,
                             gain_scale=gain_scale)

    def failure_sweep(self, source: int = 0) -> ScenarioBatch:
        """One scenario per single-UAV failure (plus the no-failure nominal
        scenario at index U) at the nominal positions — the contingency set.

        ``source`` is the capturing UAV; the scenario that kills it uses the
        next surviving UAV as source instead."""
        U = self.base_positions.shape[0]
        pos = np.broadcast_to(self.base_positions, (U + 1, U, 2)).copy()
        active = np.ones((U + 1, U), dtype=bool)
        active[np.arange(U), np.arange(U)] = False
        src = np.array([(source + 1) % U if k == source else source
                        for k in range(U)] + [source])
        return ScenarioBatch(positions=pos, source=src, active=active)


# ---------------------------------------------------------------------------
# Built-plan cache
# ---------------------------------------------------------------------------


class PlanFnCache:
    """Cache of the engine's built planning functions.

    Keyed on the static problem signature — (U, L, device order, dtype,
    radio params, P2 spec, torch device, device-cap and model-cost
    constants) — so every ``ScenarioEngine`` with the same configuration
    shares ONE built function and its device-resident constants.
    ``builds`` counts builds per key: a steady workload builds once per
    signature.  LRU-bounded to ``maxsize`` signatures; evicting drops only
    the cache's reference, and a key built again after its eviction counts
    a second build (``debug.sanitized`` reports it as a re-build).
    """

    def __init__(self, maxsize: int = 64):
        self._fns: Dict[tuple, object] = {}   # dicts iterate in LRU order
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds: Dict[tuple, int] = {}

    def get(self, key: tuple, builder):
        """Built callable for ``key``; ``builder()`` makes it."""
        fn = self._fns.pop(key, None)
        if fn is None:
            self.misses += 1
            fn = builder()
            self.builds[key] = self.builds.get(key, 0) + 1
            while len(self._fns) >= self.maxsize:
                old = next(iter(self._fns))
                del self._fns[old]
                self.evictions += 1
        else:
            self.hits += 1
        self._fns[key] = fn       # (re)insert at the most-recent end
        return fn

    def build_count(self, keys: Optional[Sequence[tuple]] = None) -> int:
        keys = self.builds.keys() if keys is None else keys
        return sum(self.builds.get(k, 0) for k in keys)

    def info(self) -> Dict[str, object]:
        return {"entries": len(self._fns), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "builds": self.build_count()}

    def clear(self) -> None:
        self._fns.clear()
        self.builds.clear()
        self.hits = self.misses = self.evictions = 0


#: Default shared cache — all engines in the process use it unless they are
#: constructed with an explicit private one.
PLAN_FN_CACHE = PlanFnCache()


# ---------------------------------------------------------------------------
# Batched planning engine
# ---------------------------------------------------------------------------


@dataclass
class BatchPlan:
    """Plans for a batch of scenarios.

    ``rate`` (and hence ``latency``) comes from the all-feasible-links P1
    solve, while ``power``/``total_power`` are the P1 optimum tightened to
    the links each placement actually uses.  ``positions`` are the
    positions the plan was priced at (P2-optimized with a
    ``PositionSpec``)."""

    scenarios: ScenarioBatch
    power: np.ndarray          # [B, U] transmit powers on used links (W)
    rate: np.ndarray           # [B, U, U] rho at the sizing powers (bits/s)
    assign: np.ndarray         # [B, L] device id per layer (-1 = infeasible)
    latency: np.ndarray        # [B] end-to-end latency (s; inf = infeasible)
    total_power: np.ndarray    # [B]
    positions: Optional[np.ndarray] = None   # [B, U, 2]

    @property
    def feasible(self) -> np.ndarray:
        return np.isfinite(self.latency)

    @property
    def n_feasible(self) -> int:
        return int(self.feasible.sum())

    def best(self) -> int:
        """Index of the lowest-latency feasible scenario."""
        if not self.feasible.any():
            raise ValueError("no feasible scenario in this batch")
        return int(np.argmin(self.latency))

    def latency_percentile(self, q: float) -> float:
        """Latency percentile across the WHOLE ensemble, infeasible
        scenarios included as inf."""
        return percentile_with_inf(self.latency, q)


@dataclass
class MultiSourcePlan:
    """Plans for a batch of scenarios serving a WHOLE request stream each
    (Section II-A: every UAV generates RQ_i requests, sum = RQ): one
    chain-DP placement per (scenario, capturing UAV), the aggregate
    per-UAV MACs priced against the eq. (11b) period budget."""

    scenarios: ScenarioBatch
    n_requests: np.ndarray      # [B, U] arrival counts the plan served
    power: np.ndarray           # [B, U] transmit powers on used links (W)
    rate: np.ndarray            # [B, U, U] rho at the sizing powers (bits/s)
    assign: np.ndarray          # [B, U, L] device ids per source (-1 = inf.)
    source_latency: np.ndarray  # [B, U] per-request latency per source
    latency: np.ndarray         # [B] arrival-weighted mix (s; inf = inf.)
    load: np.ndarray            # [B, U] aggregate per-UAV MACs (eq. 11b lhs)
    cap_feasible: np.ndarray    # [B] bool — aggregate load within budget
    total_power: np.ndarray     # [B]
    positions: Optional[np.ndarray] = None   # [B, U, 2]

    @property
    def feasible(self) -> np.ndarray:
        return np.isfinite(self.latency)

    @property
    def n_feasible(self) -> int:
        return int(self.feasible.sum())

    def latency_percentile(self, q: float) -> float:
        return percentile_with_inf(self.latency, q)


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


class ScenarioEngine:
    """Vectorized LLHR fast path on one device: (P2) + link geometry + P1 +
    eq. (5) + chain-DP placement + used-links power tightening.

    One instance is specialized to a (channel, devices, model) triple, an
    optional ``PositionSpec`` and a torch ``device`` (None = CUDA; raises
    without a GPU — pass ``device="cpu"`` for the plain path).  Its
    planning functions come from ``PLAN_FN_CACHE`` (or ``plan_cache``), so
    rebuilding an engine reuses the built plan.
    """

    def __init__(self, channel: RadioChannel | RadioParams,
                 devices: Sequence[Device], model: ModelCost,
                 device_order: Optional[Sequence[int]] = None,
                 act_scale: float = 1.0,
                 plan_cache: Optional[PlanFnCache] = None,
                 position_spec: Optional[PositionSpec] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = channel.params if isinstance(channel, RadioChannel) \
            else channel
        self.devices = list(devices)
        self.model = model
        self.order = tuple(device_order) if device_order is not None else \
            tuple(range(len(self.devices)))
        self.position_spec = position_spec
        self.compute = np.array([l.flops for l in model.layers])
        self.memory = np.array([l.weight_bytes for l in model.layers])
        self.act_bits = np.array([l.act_bits for l in model.layers]) * act_scale
        self.input_bits = float(model.input_bits)
        self.mem_cap = np.array([d.mem_cap for d in self.devices])
        self.compute_cap = np.array([d.compute_cap for d in self.devices])
        self.throughput = np.array([d.throughput for d in self.devices])
        self.plan_cache = plan_cache if plan_cache is not None \
            else PLAN_FN_CACHE
        solve_key = self._cache_key()
        multi_key = ("solve-multi",) + solve_key[1:]
        self._cache_keys_used = (solve_key, multi_key)
        self._builder = partial(
            make_plan_fn, params=self.params, compute=self.compute,
            memory=self.memory, act_bits=self.act_bits,
            input_bits=self.input_bits, mem_cap=self.mem_cap,
            compute_cap=self.compute_cap, throughput=self.throughput,
            order=self.order, p2=self.position_spec, device=self.device)
        self._solve = self.plan_cache.get(solve_key, self._builder)
        # the multi-source plan is built lazily on first use
        self._multi_key = multi_key
        self._solve_multi = None

    def _cache_key(self) -> tuple:
        """Static signature of the built plan: (U, L, order, dtype, radio
        params, P2 spec, torch device) plus every model/device constant."""
        base = (len(self.devices), len(self.compute), self.order, "float32",
                self.params,
                self.position_spec.key() if self.position_spec else None,
                str(self.device))
        consts = (self.compute.tobytes(), self.memory.tobytes(),
                  self.act_bits.tobytes(), self.input_bits,
                  self.mem_cap.tobytes(), self.compute_cap.tobytes(),
                  self.throughput.tobytes())
        return ("solve",) + base + consts

    @property
    def build_count(self) -> int:
        """Total builds paid for THIS engine's cache entries."""
        return self.plan_cache.build_count(self._cache_keys_used)

    def plan_cache_info(self) -> Dict[str, object]:
        """The shared plan cache's entries, hits, misses and builds
        (``PlanFnCache.info``)."""
        return self.plan_cache.info()

    # ------------------------------------------------------------------
    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        x = np.asarray(x)
        if not x.flags.writeable:          # e.g. a np.broadcast_to view
            x = x.copy()
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _p2_links(self, B_: int, U: int,
                  p2_links: Optional[np.ndarray]):
        """The [B, U, U] transfer topology the fused P2 stage optimizes
        positions for (None on engines without a ``PositionSpec``)."""
        if self.position_spec is None:
            if p2_links is not None:
                raise ValueError("p2_links given but this engine has no "
                                 "PositionSpec; build it with "
                                 "position_spec=")
            return None
        links = chain_links(U, self.order) if p2_links is None else \
            np.asarray(p2_links, dtype=bool)
        if links.ndim == 2:
            links = np.broadcast_to(links, (B_, U, U))
        return self._tensor(links, torch.bool)

    def _inputs(self, scenarios: ScenarioBatch):
        B_, U = scenarios.n_scenarios, scenarios.n_uavs
        active = scenarios.active if scenarios.active is not None else \
            np.ones((B_, U), dtype=bool)
        gain = scenarios.gain_scale
        return (self._tensor(scenarios.positions),
                self._tensor(active, torch.bool),
                None if gain is None else self._tensor(gain))

    # ------------------------------------------------------------------
    def plan_batch(self, scenarios: ScenarioBatch,
                   p2_links: Optional[np.ndarray] = None) -> BatchPlan:
        """Solve (P2 +) P1 + P3 for every scenario in one device pass.

        ``p2_links``: [U, U] or [B, U, U] bool transfer topology the fused
        P2 stage optimizes positions for (default: the chain walked in the
        engine's device order).  Only valid with a ``PositionSpec``."""
        B_, U = scenarios.n_scenarios, scenarios.n_uavs
        positions, active, gain = self._inputs(scenarios)
        positions, power, rate, assign, latency = self._solve(
            positions, self._tensor(scenarios.source, torch.long), active,
            gain, self._p2_links(B_, U, p2_links))
        power = _host(power, np.float64)
        return BatchPlan(scenarios=scenarios, power=power,
                         rate=_host(rate, np.float64),
                         assign=_host(assign, np.int64),
                         latency=_host(latency, np.float64),
                         total_power=power.sum(-1),
                         positions=_host(positions, np.float64))

    def plan_batch_multi(self, scenarios: ScenarioBatch,
                         n_requests: np.ndarray,
                         p2_links: Optional[np.ndarray] = None
                         ) -> MultiSourcePlan:
        """Serve each scenario's WHOLE request stream in one device pass.

        ``n_requests``: [U] (tiled over scenarios) or [B, U] arrival counts
        per capturing UAV (``scenarios.source`` is ignored — every UAV with
        a positive count is a source)."""
        B_, U = scenarios.n_scenarios, scenarios.n_uavs
        n_req = np.asarray(n_requests, np.float32)
        n_req = np.broadcast_to(n_req, (B_, U)).copy()
        if (n_req < 0).any():
            raise ValueError("n_requests must be nonnegative counts")
        positions, active, gain = self._inputs(scenarios)
        if self._solve_multi is None:
            self._solve_multi = self.plan_cache.get(
                self._multi_key, partial(self._builder, multi_source=True))
        (positions, power, rate, assign, lat_src, latency, load,
         cap_ok) = self._solve_multi(positions, self._tensor(n_req), active,
                                     gain, self._p2_links(B_, U, p2_links))
        power = _host(power, np.float64)
        return MultiSourcePlan(
            scenarios=scenarios, n_requests=n_req.astype(np.int64),
            power=power, rate=_host(rate, np.float64),
            assign=_host(assign, np.int64),
            source_latency=_host(lat_src, np.float64),
            latency=_host(latency, np.float64),
            load=_host(load, np.float64),
            cap_feasible=_host(cap_ok, bool),
            total_power=power.sum(-1),
            positions=_host(positions, np.float64))

    def plan_positions(self, positions: np.ndarray,
                       source: int = 0) -> BatchPlan:
        """Convenience: plan a single scenario (adds/strips the batch axis)."""
        batch = ScenarioBatch(positions=np.asarray(positions)[None],
                              source=np.array([source]))
        return self.plan_batch(batch)


# ---------------------------------------------------------------------------
# Precomputed failure contingencies (delegation without a re-solve)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContingencyPlan:
    """The delegation plan to apply when ``dead`` has failed.

    ``positions`` are the positions the plan was priced at — with a
    position-optimizing engine, the P2 solution for that failure scenario
    (where the survivors should fly), otherwise the nominal positions the
    table was refreshed with."""

    dead: Optional[str]        # device name, or None for the nominal plan
    dead_index: int            # index into the ORIGINAL device list (-1)
    assign: Tuple[int, ...]    # device ids into the ORIGINAL device list
    latency: float
    power: np.ndarray          # [U] over the ORIGINAL devices (0 for dead)
    positions: Optional[np.ndarray] = None   # [U, 2] over ORIGINAL devices

    @property
    def survivor_assign(self) -> Tuple[int, ...]:
        """The assignment re-indexed into the survivor device list (ids
        above the dead device shift down by one)."""
        if self.dead_index < 0:
            return self.assign
        return tuple(i - 1 if i > self.dead_index else i
                     for i in self.assign)

    def as_survivor_plan(self) -> "ContingencyPlan":
        """Normalize to survivor index space: assign re-indexed and power/
        positions sliced to the shrunk device list."""
        if self.dead_index < 0:
            return self
        return ContingencyPlan(
            dead=self.dead, dead_index=-1, assign=self.survivor_assign,
            latency=self.latency,
            power=np.delete(self.power, self.dead_index),
            positions=None if self.positions is None else
            np.delete(self.positions, self.dead_index, axis=0))


class ContingencyTable:
    """All single-failure delegation plans, computed in one batched call.

    The paper's delegation ("it will delegate this subtask to another UAV")
    is a re-solve at failure time; the table instead plans the whole
    failure sweep (U + 1 scenarios, one ``plan_batch``) up front on the
    engine's device.
    """

    def __init__(self, engine: ScenarioEngine, positions: np.ndarray,
                 source: int = 0):
        self.engine = engine
        self.plans: Dict[Optional[str], ContingencyPlan] = {}
        self.refresh(positions, source=source)

    def refresh(self, positions: np.ndarray, source: int = 0) -> None:
        """Recompute the failure sweep at new positions, in place (the
        engine's built plan is reused).  The engine is specialized to a
        fixed device set: a shrunk swarm needs a new engine and table."""
        engine = self.engine
        if positions.shape[0] != len(engine.devices):
            raise ValueError(
                f"positions are for {positions.shape[0]} UAVs but the engine "
                f"plans {len(engine.devices)}; build a new ScenarioEngine "
                f"(and table) for a changed swarm")
        sweep = ScenarioGenerator(positions).failure_sweep(source=source)
        U = positions.shape[0]
        plan = engine.plan_batch(sweep)
        names = [d.name for d in engine.devices]
        self.plans.clear()
        for k, name in enumerate(names + [None]):
            self.plans[name] = ContingencyPlan(
                dead=name, dead_index=k if k < U else -1,
                assign=tuple(int(x) for x in plan.assign[k]),
                latency=float(plan.latency[k]), power=plan.power[k],
                positions=plan.positions[k])

    def lookup(self, dead_names: Sequence[str]
               ) -> Optional[ContingencyPlan]:
        """Precomputed plan for a single failure, normalized to the SURVIVOR
        index space; None for multi-failures, unknown devices or an
        infeasible contingency."""
        if len(dead_names) != 1:
            return None
        plan = self.plans.get(dead_names[0])
        if plan is None or not np.isfinite(plan.latency):
            return None
        return plan.as_survivor_plan()


__all__ = [
    "ScenarioBatch", "ScenarioGenerator", "BatchPlan", "MultiSourcePlan",
    "ScenarioEngine", "ContingencyPlan", "ContingencyTable", "PlanFnCache",
    "PLAN_FN_CACHE", "PositionSpec",
]

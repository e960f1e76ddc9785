"""The fused LLHR planning tick and the (B, T) fleet rollout, in PyTorch.

The planning tick (``make_plan_fn``) chains, on one device with no host
round trip:

    (P2 positions from the input initializations, when ``p2`` is set)
    -> link geometry: distance, eq. (7) thresholds, first-pass P1 powers,
       eq. (5) rates (the fused link-geometry kernel on CUDA)
    -> chain-DP placement with a device-side backtrack (the tropical-DP
       kernel, one launch per layer, on CUDA)
    -> used-links mask from the assignment -> tightened P1 powers.

The rollout (``make_rollout_fn``) runs that tick once per frame over B
independent trajectories: mobility, failure/recovery, the battery gate,
the frame's whole multi-source request stream, and energy accounting.
The reference's ``lax.scan`` over frames is a Python loop here, with no
data-dependent branch and no host synchronisation between frames; random
draws come in as tensors made on the host once per rollout.

Shapes: B = trajectories/scenarios, T = frames, U = UAVs (also the source
axis), L = layers, S = solved source slots.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batch import (_chain_dp_solve, _chain_dp_solve_kernelized,
                                    _positions_pgd, chain_dp_tables,
                                    chain_links, coverage_radius,
                                    links_from_assignment_batched,
                                    placement_compute_load, position_coeff,
                                    shared_cap_feasible, solve_power_batched)
from repro_torch.core.channel import RadioParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.link_geometry.ops import fused_link_geometry

INF = math.inf


@dataclass(frozen=True)
class PositionSpec:
    """Static P2 hyperparameters for the fused planner (part of the plan
    cache key)."""

    steps: int = 300           # projected-gradient iterations
    lr: float = 0.5            # normalized-gradient step size (m)
    radius: float = 20.0       # UAV coverage radius R (eq. 8c/8d)
    repair_iters: int = 50     # device-side push-apart iterations

    def key(self) -> tuple:
        return ("p2", self.steps, self.lr, self.radius, self.repair_iters)


@dataclass(frozen=True)
class RolloutSpec:
    """Static dynamics constants of a fleet rollout.

    * Mobility: each UAV drifts up to ``drift_m_per_frame`` toward its
      waypoint, plus N(0, jitter_sigma_m) per-axis jitter.
    * Requests: ``requests_per_frame`` is the frame's TOTAL arrival count RQ
      (Section II-A: sum over UAVs of RQ_i); which UAV captures each request
      is drawn per frame — uniform over the swarm, or biased by
      ``arrival_weights``.
    * Failures: i.i.d. Bernoulli per frame — alive UAVs fail with
      ``failure_prob``, failed ones rejoin with ``recovery_prob``.
    * Battery: every UAV starts with ``battery_j`` joules; serving drains
      ``compute_j_per_mac`` per multiply plus transmit power x airtime, and
      hovering costs ``hover_watts`` over the ``frame_s`` frame.  A drained
      UAV is excluded from planning from the NEXT frame on and never
      recovers.
    """

    frames: int = 32
    frame_s: float = 60.0              # optimization period (Section IV)
    requests_per_frame: int = 1        # RQ: total arrivals per frame
    arrival_weights: Optional[Tuple[float, ...]] = None  # per-UAV RQ_i bias
    drift_m_per_frame: float = 0.0     # waypoint pull per frame (m)
    jitter_sigma_m: float = 0.0        # mobility jitter std-dev (m)
    waypoint_range_m: float = 0.0      # waypoints drawn in +-range around base
    failure_prob: float = 0.0
    recovery_prob: float = 0.0
    battery_j: float = math.inf        # initial charge (J); inf = no battery
    hover_watts: float = 0.0
    compute_j_per_mac: float = 1e-9    # ~1 nJ/MAC, Raspberry-Pi class

    def __post_init__(self):
        if self.arrival_weights is not None:
            object.__setattr__(self, "arrival_weights",
                               tuple(float(w) for w in self.arrival_weights))

    def key(self) -> tuple:
        # arrival_weights only bias the host-side multinomial draws, so
        # specs differing only there share one built rollout
        return ("rollout-spec", self.frame_s, self.requests_per_frame,
                self.drift_m_per_frame, self.jitter_sigma_m,
                self.waypoint_range_m, self.failure_prob, self.recovery_prob,
                self.battery_j, self.hover_watts, self.compute_j_per_mac)


# ---------------------------------------------------------------------------
# The fused planning tick
# ---------------------------------------------------------------------------


def _f32(x, device: torch.device) -> torch.Tensor:
    """A host constant (scalar or array) as float32 on ``device``; the
    builders call it once, never inside the frame loop."""
    return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                           device=device)


def make_plan_fn(*, params: RadioParams, compute, memory, act_bits,
                 input_bits, mem_cap, compute_cap, throughput,
                 order: Tuple[int, ...],
                 p2: Optional[PositionSpec] = None,
                 multi_source: bool = False,
                 max_sources: Optional[int] = None,
                 device: DeviceLike = None):
    """The whole planning tick as one function on ``device`` (None =
    CUDA; raises without a GPU).  The model/device constants are moved to
    the device once, here.

    With ``multi_source=False`` the returned function is

        solve(positions, source [B], active, gain_scale, p2_links)
        -> (positions, power, rate, assign [B, L], latency [B])

    With ``multi_source=True`` it serves a frame's whole request stream
    (one chain-DP placement per capturing UAV, weighted by its arrival
    count, the aggregate per-UAV MACs priced against the eq. (11b)
    budget, powers tightened to the union of the served sources' links):

        solve(positions, n_req [B, U], active, gain_scale, p2_links)
        -> (positions, power, rate, assign [B, U, L], lat_src [B, U],
            latency [B], load [B, U], cap_ok [B])

    ``max_sources`` = S < U solves only the S largest arrival counts per
    frame (gathered with a stable sort, as ``jnp.argsort`` is) and
    scatters them back; unrequested sources report assign -1 / latency
    inf.
    """
    dev = resolve_device(device)
    tables = chain_dp_tables(compute, memory, act_bits, input_bits,
                             mem_cap, compute_cap, throughput, order, dev)
    compute_t = _f32(compute, dev)
    compute_cap_t = _f32(compute_cap, dev)
    U = int(np.asarray(mem_cap).shape[0])
    L = int(np.asarray(compute).shape[0])
    S = U if max_sources is None else max(1, min(U, int(max_sources)))
    if p2 is not None:
        p2_consts = dict(coeff=_f32(position_coeff(params), dev),
                         lr=_f32(p2.lr, dev),
                         two_r=_f32(2.0 * p2.radius, dev),
                         cover_r=_f32(coverage_radius(U, p2.radius), dev))

    def geometry(positions, active, gain_scale, p2_links):
        if p2 is not None:
            positions, _, _, _ = _positions_pgd(
                positions, p2_links, center=positions.mean(1),
                steps=p2.steps, repair_iters=p2.repair_iters, **p2_consts)
        dist, th, rate = fused_link_geometry(
            positions, params, active=active, gain_scale=gain_scale)
        return positions, dist, th, rate

    def solve(positions, source, active, gain_scale, p2_links):
        positions, dist, th, rate = geometry(positions, active, gain_scale,
                                             p2_links)
        assign, latency = _chain_dp_solve(tables, rate, source, active)
        used = links_from_assignment_batched(assign, source, U)
        power = solve_power_batched(dist, params, links=used, active=active,
                                    threshold_matrix=th).power
        return positions, power, rate, assign, latency

    def solve_multi(positions, n_req, active, gain_scale, p2_links):
        positions, dist, th, rate = geometry(positions, active, gain_scale,
                                             p2_links)
        B = positions.shape[0]
        n_req = n_req.to(torch.float32)
        if S < U:
            slot_src = torch.argsort(-n_req, dim=-1, stable=True)[:, :S]
        else:
            slot_src = torch.arange(U, device=dev).expand(B, U)
        slot_cnt = torch.gather(n_req, 1, slot_src)                 # [B, S]
        assign_s, lat_s = _chain_dp_solve_kernelized(
            tables, rate, slot_src, active)                         # [B,S,L]
        requested = slot_cnt > 0
        served = requested & torch.isfinite(lat_s)
        # arrival-weighted per-request latency; a requested source the DP
        # could not place makes the whole frame infeasible (inf).  The mask
        # comes before the product: an unrequested slot's 0 x inf would be
        # a NaN (masked, but a NaN an op-level check stops at)
        weighted = (slot_cnt * torch.where(requested, lat_s, 0.0)).sum(-1)
        latency = weighted / torch.clamp_min(n_req.sum(-1), 1.0)
        load = placement_compute_load(
            assign_s, torch.where(requested, slot_cnt, 0.0), compute_t, U)
        cap_ok = shared_cap_feasible(load, compute_cap_t)
        latency = torch.where(cap_ok, latency, INF)
        # tighten P1 to the union of the links every SERVED source uses
        used = links_from_assignment_batched(assign_s, slot_src, U)
        used = (used & served[:, :, None, None]).any(1)
        power = solve_power_batched(dist, params, links=used, active=active,
                                    threshold_matrix=th).power
        if S < U:
            lat_src = torch.full((B, U), INF, device=dev).scatter(
                1, slot_src, torch.where(requested, lat_s, INF))
            assign = torch.full((B, U, L), -1, dtype=torch.int32,
                                device=dev).scatter(
                1, slot_src[..., None].expand(B, S, L),
                torch.where(requested[..., None], assign_s, -1))
        else:
            lat_src, assign = lat_s, assign_s
        return positions, power, rate, assign, lat_src, latency, load, cap_ok

    return solve_multi if multi_source else solve


def _frame_tx_time_multi(assign, n_req, rate, act_bits, input_bits):
    """Arrival-weighted per-UAV time-on-air of a frame's whole request
    stream.  ``assign`` [B, S=U, L] (source s = UAV s), ``n_req`` [B, U],
    ``rate`` [B, U, U] -> tx_time [B, U].  Airtime is the bits each used
    link carries (input bits into the first block, activation bits on
    every device change) over its eq. (5) rate, charged to the
    transmitter; infeasible placements (-1) use no airtime."""
    B, S = n_req.shape
    L = assign.shape[-1]
    U = rate.shape[-1]
    dev = assign.device
    src = torch.arange(S, device=dev, dtype=assign.dtype).expand(B, S)
    prev = torch.cat([src[..., None], assign[..., :-1]], -1)        # [B,S,L]
    bits_in = torch.cat([input_bits[None], act_bits[:-1]])          # [L]
    hop = (prev >= 0) & (assign >= 0) & (prev != assign)
    a = prev.clamp(0, U - 1).long()
    b = assign.clamp(0, U - 1).long()
    rows = torch.arange(B, device=dev)[:, None, None].expand(B, S, L)
    slots = torch.arange(S, device=dev)[None, :, None].expand(B, S, L)
    r = rate[rows, a, b]                                            # [B,S,L]
    t_link = torch.where(hop & (r > 0), bits_in / r, 0.0)
    tx_s = torch.zeros((B, S, U), dtype=torch.float32, device=dev)
    tx_s.index_put_((rows, slots, a), t_link, accumulate=True)
    return (tx_s * n_req[:, :, None]).sum(1)


# ---------------------------------------------------------------------------
# The rollout
# ---------------------------------------------------------------------------


def make_rollout_fn(*, params: RadioParams, compute, memory, act_bits,
                    input_bits, mem_cap, compute_cap, throughput,
                    order: Tuple[int, ...], spec: RolloutSpec,
                    p2: Optional[PositionSpec] = None,
                    with_gain: bool = False, with_drain: bool = False,
                    device: DeviceLike = None):
    """Build the (B, T) fleet rollout on ``device`` (None = CUDA).

    The returned function takes

        pos0      [B, U, 2]  initial positions
        charge0   [B, U]     initial battery (J; inf = unlimited)
        alive0    [B, U]     initial failure state (bool)
        waypoint  [B, U, 2]  per-UAV drift targets
        jitter    [T, B, U, 2]  pre-drawn mobility noise
        fail_u    [T, B, U]  failure uniforms  (< failure_prob kills)
        recov_u   [T, B, U]  recovery uniforms (< recovery_prob revives)
        forced    [T, B, U]  bool, True = externally forced dead this frame
        arrivals  [T, B, U]  drawn request arrivals per capturing UAV

    plus ``gain`` [T, B, U, U] when ``with_gain`` and ``drain`` [T, B, U]
    when ``with_drain``, all on ``device``, and returns per-frame stacks
    (leading T): positions, active, charge, arrival-weighted latency,
    total tightened power (0 on infeasible frames), feasibility, the
    shared-cap verdict, the per-source assignments [B, U, L], per-source
    latencies [B, U], the served arrival counts, and per-UAV transmit and
    compute energy.

    Frame order: mobility -> failure/recovery -> battery gate -> plan ->
    energy drain.  The charge spent serving a frame gates the NEXT frame.
    """
    dev = resolve_device(device)
    # a frame's RQ arrivals touch at most RQ distinct sources, so the
    # tick solves min(U, RQ) DP slots
    solve = make_plan_fn(params=params, compute=compute, memory=memory,
                         act_bits=act_bits, input_bits=input_bits,
                         mem_cap=mem_cap, compute_cap=compute_cap,
                         throughput=throughput, order=order, p2=p2,
                         multi_source=True,
                         max_sources=spec.requests_per_frame, device=dev)
    act_t = _f32(act_bits, dev)
    input_t = _f32(input_bits, dev)
    U = int(np.asarray(mem_cap).shape[0])
    links_const = torch.as_tensor(chain_links(U, order), device=dev) \
        if p2 is not None else None
    drift, hover_e, kappa, p_fail, p_recover, one, eps9 = (
        _f32(x, dev) for x in (
            spec.drift_m_per_frame, spec.hover_watts * spec.frame_s,
            spec.compute_j_per_mac, spec.failure_prob, spec.recovery_prob,
            1.0, 1e-9))

    def rollout(pos0, charge0, alive0, waypoint, jitter, fail_u, recov_u,
                forced, arrivals, *chaos):
        B = pos0.shape[0]
        rows = torch.arange(B, device=dev)
        p2_links = None if links_const is None else \
            links_const.expand(B, U, U)
        pos, alive, charge = pos0, alive0, charge0
        outs = []
        for t in range(jitter.shape[0]):
            gain_t = chaos[0][t] if with_gain else None
            # 1. mobility: bounded step toward the waypoint, plus jitter
            to_wp = waypoint - pos
            nrm = torch.sqrt((to_wp * to_wp).sum(-1, keepdim=True))
            pos = pos + to_wp * torch.minimum(
                one, drift / torch.maximum(nrm, eps9)) + jitter[t]
            # 2. Bernoulli failure / recovery, then forced injections;
            # recovery applies to UAVs that entered the frame dead
            revived = ~alive & (recov_u[t] < p_recover)
            alive = (alive & (fail_u[t] >= p_fail)) | revived
            alive = alive & ~forced[t]
            # 3. battery gate: drained at the frame boundary => excluded
            active = alive & (charge > 0.0)
            # 4. arrivals drawn on a dead UAV go to the FIRST survivor; an
            # all-dead fleet keeps them on (inactive) UAV 0 -> infeasible
            first_active = torch.argmax(active.to(torch.uint8), -1)
            arr_t = arrivals[t]
            n_live = torch.where(active, arr_t, 0.0)
            orphaned = (arr_t - n_live).sum(-1)
            n_eff = n_live.index_put((rows, first_active), orphaned,
                                     accumulate=True)
            # 5. the fused multi-source planning tick
            (pos, power, rate, assign, lat_src, latency, load,
             cap_ok) = solve(pos, n_eff, active, gain_t, p2_links)
            # 6. energy accounting + battery carry; an infeasible frame is
            # not served, so it spends nothing beyond hover
            feasible = torch.isfinite(latency)
            tx_time = _frame_tx_time_multi(assign, n_eff, rate, act_t,
                                           input_t)
            e_cmp = torch.where(feasible[:, None], kappa * load, 0.0)
            e_tx = torch.where(feasible[:, None], power * tx_time, 0.0)
            drain = torch.where(active, e_cmp + e_tx + hover_e, 0.0)
            if with_drain:
                # scripted battery drops: charged whether or not the UAV
                # served this frame
                drain = drain + chaos[-1][t]
            charge = torch.clamp_min(charge - drain, 0.0)
            outs.append((pos, active, charge, latency,
                         torch.where(feasible, power.sum(-1), 0.0),
                         feasible, cap_ok, assign, lat_src, n_eff, e_tx,
                         e_cmp))
        return tuple(torch.stack(x) for x in zip(*outs))

    return rollout


# ---------------------------------------------------------------------------
# Shared statistics helpers
# ---------------------------------------------------------------------------


def percentile_with_inf(latency: np.ndarray, q: float) -> float:
    """Latency percentile across an ensemble, infeasible entries included
    as inf: if the q-th order statistic falls in the infeasible tail the
    result is inf, not a silently optimistic number over the survivors."""
    lat = np.sort(np.asarray(latency, dtype=np.float64).ravel())
    if not lat.size:
        return float("inf")
    pos = q / 100.0 * (lat.size - 1)
    lo = int(np.floor(pos))
    frac = pos - lo
    if frac == 0.0:                      # lands exactly on an element
        return float(lat[lo])
    if not np.isfinite(lat[lo + 1]):     # interpolating into the outage tail
        return float("inf")
    return float(lat[lo] + frac * (lat[lo + 1] - lat[lo]))


__all__ = [
    "PositionSpec", "RolloutSpec", "make_plan_fn", "make_rollout_fn",
    "percentile_with_inf",
]

"""FleetRollout — the host-facing runtime layer over the rollout
(``repro_torch.core.rollout``).

A ``FleetRollout`` is a ``ScenarioEngine`` (same constants, same plan
cache) that also owns a built (B, T) rollout: mobility, failure/recovery,
battery drain, the frame's whole multi-source request stream and the
fused planning tick for every frame of every trajectory, on one device,
with no host synchronisation between frames.

All randomness is drawn on the host per ``run()`` from one numpy
generator, in the reference's order and dtypes, so one seed gives the
reference and the port identical streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rollout import (RolloutSpec, make_rollout_fn,
                                      percentile_with_inf)
from repro_torch.core.swarm import FrameStats
from repro_torch.runtime.scenario_engine import ScenarioEngine


@dataclass
class RolloutTrace:
    """The full (B, T) rollout record, trajectory-major.

    ``latency`` is the arrival-weighted per-request latency of each frame's
    whole request stream (inf = infeasible frame: a requested source the DP
    could not place, or an aggregate load over the eq. 11b period budget —
    see ``cap_feasible``).  ``source_latency`` holds every capturing UAV's
    own per-request latency and ``assign`` its placement.  ``total_power``
    is the tightened used-links transmit power (W), 0 on infeasible frames;
    ``charge`` the battery state AFTER each frame's drain; ``active`` the
    UAVs the frame planned over (alive AND powered); ``n_requests`` the
    served arrival counts (arrivals drawn on a dead UAV are captured by the
    first survivor)."""

    latency: np.ndarray         # [B, T] arrival-weighted (inf = infeasible)
    total_power: np.ndarray     # [B, T] 0 on infeasible frames
    feasible: np.ndarray        # [B, T] bool
    cap_feasible: np.ndarray    # [B, T] bool — eq. 11b aggregate-load check
    source_latency: np.ndarray  # [B, T, U] per-request latency per source
    assign: np.ndarray          # [B, T, U, L] device ids (-1 = infeasible)
    positions: np.ndarray       # [B, T, U, 2] planned (post-P2) positions
    active: np.ndarray          # [B, T, U] bool
    charge: np.ndarray          # [B, T, U] J
    n_requests: np.ndarray      # [B, T, U] served arrivals per source
    energy_tx: np.ndarray       # [B, T, U] J
    energy_cmp: np.ndarray      # [B, T, U] J

    @property
    def n_trajectories(self) -> int:
        return self.latency.shape[0]

    @property
    def n_frames(self) -> int:
        return self.latency.shape[1]

    @property
    def feasibility_rate(self) -> float:
        """Fraction of (trajectory, frame) points with a feasible plan."""
        return float(self.feasible.mean()) if self.feasible.size else 0.0

    @property
    def mean_latency(self) -> float:
        """Mean arrival-weighted latency over FEASIBLE frames (inf when
        none) — read it next to ``feasibility_rate``."""
        vals = self.latency[self.feasible]
        return float(vals.mean()) if vals.size else float("inf")

    @property
    def mean_power(self) -> float:
        """Mean tightened transmit power over FEASIBLE frames."""
        vals = self.total_power[self.feasible]
        return float(vals.mean()) if vals.size else 0.0

    def latency_percentile(self, q: float) -> float:
        """Ensemble percentile over all (trajectory, frame) points,
        infeasible frames included as inf."""
        return percentile_with_inf(self.latency, q)

    def frame_stats(self, trajectory: int = 0) -> List[FrameStats]:
        """One trajectory as per-frame records; ``replanned`` marks frames
        where the planned-over UAV set shrank."""
        b = trajectory
        out: List[FrameStats] = []
        prev_active = None
        for t in range(self.n_frames):
            act = self.active[b, t]
            shrank = prev_active is not None and bool(
                (prev_active & ~act).any())
            prev_active = act
            out.append(FrameStats(
                t=t, latency=float(self.latency[b, t]),
                power=float(self.total_power[b, t]),
                breakdown={"e_tx": float(self.energy_tx[b, t].sum()),
                           "e_compute": float(self.energy_cmp[b, t].sum())},
                n_requests=int(self.n_requests[b, t].sum()),
                feasible=bool(self.feasible[b, t]), replanned=shrank))
        return out


class FleetRollout(ScenarioEngine):
    """Batched multi-frame swarm simulation on one device.

    Extends ``ScenarioEngine`` with a built rollout resolved through the
    same ``PlanFnCache``: the rollout's key is the plan's signature plus
    the ``RolloutSpec`` dynamics constants and the chaos flags.  ``device``
    None = CUDA (raises without a GPU); ``device="cpu"`` runs the plain
    PyTorch path.
    """

    def __init__(self, channel, devices, model, spec: RolloutSpec,
                 device_order=None, act_scale: float = 1.0,
                 plan_cache=None, position_spec=None, seed: int = 0,
                 device=None):
        super().__init__(channel, devices, model, device_order=device_order,
                         act_scale=act_scale, plan_cache=plan_cache,
                         position_spec=position_spec, device=device)
        self.spec = spec
        self._rng = np.random.default_rng(seed)
        self._rollout = self._rollout_fn()

    def _rollout_fn(self, with_gain: bool = False, with_drain: bool = False):
        """The built rollout, through the shared cache; the chaos flags
        (per-frame ``gain_scale`` fades / ``extra_drain`` battery drops)
        select their own entry."""
        rollout_key = ("rollout", with_gain, with_drain,
                       self.spec.key()) + self._cache_key()[1:]
        if rollout_key not in self._cache_keys_used:
            self._cache_keys_used = self._cache_keys_used + (rollout_key,)
        return self.plan_cache.get(rollout_key, partial(
            make_rollout_fn, params=self.params, compute=self.compute,
            memory=self.memory, act_bits=self.act_bits,
            input_bits=self.input_bits, mem_cap=self.mem_cap,
            compute_cap=self.compute_cap, throughput=self.throughput,
            order=self.order, spec=self.spec, p2=self.position_spec,
            with_gain=with_gain, with_drain=with_drain, device=self.device))

    def _arrival_probs(self) -> np.ndarray:
        U = len(self.devices)
        if self.spec.arrival_weights is None:
            return np.full(U, 1.0 / U)
        w = np.asarray(self.spec.arrival_weights, np.float64)
        if w.shape != (U,) or (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"arrival_weights must be {U} nonnegative "
                             "values with a positive sum")
        return w / w.sum()

    def run(self, base_positions: np.ndarray, n_trajectories: int = 1,
            frames: Optional[int] = None,
            charge0: Optional[np.ndarray] = None,
            alive0: Optional[np.ndarray] = None,
            forced_failures: Optional[Sequence[Tuple[int, int]]] = None,
            sources: Optional[np.ndarray] = None,
            arrivals: Optional[np.ndarray] = None,
            waypoints: Optional[np.ndarray] = None,
            forced: Optional[np.ndarray] = None,
            gain_scale: Optional[np.ndarray] = None,
            extra_drain: Optional[np.ndarray] = None,
            rng: Optional[np.random.Generator] = None) -> RolloutTrace:
        """Roll B trajectories forward T frames on the engine's device.

        ``base_positions``: [U, 2] (tiled over trajectories) or [B, U, 2].
        ``forced_failures``: (frame, uav) pairs — the UAV is dead from that
        frame on in every trajectory.  ``forced``: the same hook as a full
        [T, B, U] bool tensor (OR-combined with ``forced_failures``).
        ``gain_scale``: optional [T, B, U, U] (or [T, U, U] / [U, U])
        positive link-gain factors.  ``extra_drain``: optional [T, B, U]
        (or [T, U]) nonnegative extra battery drain in joules per frame.
        ``arrivals``: optional [T, B, U] per-UAV request counts (default:
        ``requests_per_frame`` arrivals drawn multinomially with
        ``spec.arrival_weights``).  ``sources``: optional [T, B] single
        capturing-UAV draws (exclusive with ``arrivals``).  ``waypoints``:
        optional [B, U, 2] drift targets.  ``rng``: optional numpy
        generator for this run's host draws.  The draws are made in the
        reference's order and dtypes.
        """
        U = len(self.devices)
        B = n_trajectories
        T = self.spec.frames if frames is None else frames
        rng = self._rng if rng is None else rng
        base = np.asarray(base_positions, np.float64)
        pos0 = np.broadcast_to(base, (B, U, 2)).astype(np.float32).copy() \
            if base.ndim == 2 else base.astype(np.float32)
        if waypoints is None:
            waypoints = pos0.copy()
            if self.spec.waypoint_range_m > 0:
                waypoints = waypoints + rng.uniform(
                    -self.spec.waypoint_range_m, self.spec.waypoint_range_m,
                    size=(B, U, 2)).astype(np.float32)
        jitter = np.zeros((T, B, U, 2), np.float32)
        if self.spec.jitter_sigma_m > 0:
            jitter = rng.normal(scale=self.spec.jitter_sigma_m,
                                size=(T, B, U, 2)).astype(np.float32)
        fail_u = rng.random((T, B, U)).astype(np.float32)
        recov_u = rng.random((T, B, U)).astype(np.float32)
        if forced is not None:
            forced = np.asarray(forced, dtype=bool)
            if forced.shape != (T, B, U):
                raise ValueError(f"forced must be [T={T}, B={B}, U={U}]; "
                                 f"got {forced.shape}")
            forced = forced.copy()
        else:
            forced = np.zeros((T, B, U), dtype=bool)
        for f, u in (forced_failures or ()):
            if 0 <= f < T:
                forced[f:, :, u] = True
        if gain_scale is not None:
            gain_scale = np.asarray(gain_scale, np.float32)
            if gain_scale.ndim == 2:
                gain_scale = np.broadcast_to(gain_scale, (T, B, U, U))
            elif gain_scale.ndim == 3:
                gain_scale = np.broadcast_to(gain_scale[:, None], (T, B, U, U))
            if gain_scale.shape != (T, B, U, U):
                raise ValueError(f"gain_scale must broadcast to [T={T}, "
                                 f"B={B}, U={U}, U]; got {gain_scale.shape}")
            if (gain_scale <= 0).any():
                raise ValueError("gain_scale factors must be positive")
            gain_scale = np.ascontiguousarray(gain_scale)
        if extra_drain is not None:
            extra_drain = np.asarray(extra_drain, np.float32)
            if extra_drain.ndim == 2:
                extra_drain = np.broadcast_to(extra_drain[:, None],
                                              (T, B, U))
            if extra_drain.shape != (T, B, U):
                raise ValueError(f"extra_drain must broadcast to [T={T}, "
                                 f"B={B}, U={U}]; got {extra_drain.shape}")
            if (extra_drain < 0).any():
                raise ValueError("extra_drain must be nonnegative joules")
            extra_drain = np.ascontiguousarray(extra_drain)
        if sources is not None and arrivals is not None:
            raise ValueError("pass either sources or arrivals, not both")
        if sources is not None:
            sources = np.asarray(sources, np.int64).reshape(T, B)
            if (sources < 0).any() or (sources >= U).any():
                raise ValueError(
                    f"sources must index UAVs in [0, {U}); got values in "
                    f"[{sources.min()}, {sources.max()}]")
            arrivals = np.zeros((T, B, U), np.float32)
            np.put_along_axis(arrivals, sources[..., None],
                              float(self.spec.requests_per_frame), axis=2)
        elif arrivals is None:
            arrivals = rng.multinomial(
                self.spec.requests_per_frame, self._arrival_probs(),
                size=(T, B)).astype(np.float32)
        else:
            arrivals = np.asarray(arrivals, np.float32)
            if arrivals.shape != (T, B, U):
                raise ValueError(f"arrivals must be [T={T}, B={B}, U={U}]; "
                                 f"got {arrivals.shape}")
            if (arrivals < 0).any():
                raise ValueError("arrivals must be nonnegative counts")
            slots = max(1, min(U, self.spec.requests_per_frame))
            widest = int(np.count_nonzero(arrivals, axis=-1).max())
            if widest > slots:
                raise ValueError(
                    f"arrivals touch up to {widest} distinct sources in a "
                    f"frame but the rollout solves min(U, "
                    f"requests_per_frame) = {slots} source slots; raise "
                    f"RolloutSpec.requests_per_frame to at least {widest}")
        if charge0 is None:
            charge0 = np.full((B, U), self.spec.battery_j, np.float32)
        else:
            charge0 = np.broadcast_to(
                np.asarray(charge0, np.float32), (B, U)).copy()
        if alive0 is None:
            alive0 = np.ones((B, U), dtype=bool)

        with_gain = gain_scale is not None
        with_drain = extra_drain is not None
        rollout = self._rollout if not (with_gain or with_drain) \
            else self._rollout_fn(with_gain, with_drain)
        inputs = [np.asarray(pos0, np.float32), charge0,
                  np.asarray(alive0, bool), np.asarray(waypoints, np.float32),
                  jitter, fail_u, recov_u, forced,
                  np.asarray(arrivals, np.float32)]
        if with_gain:
            inputs.append(gain_scale)
        if with_drain:
            inputs.append(extra_drain)
        inputs = [torch.as_tensor(x, device=self.device) for x in inputs]

        (pos, active, charge, latency, power, feasible, cap_ok, assign,
         lat_src, n_eff, e_tx, e_cmp) = rollout(*inputs)

        def tm(x, dtype=np.float64):        # [T, B, ...] -> [B, T, ...]
            return np.swapaxes(x.detach().cpu().numpy(), 0, 1).astype(dtype)

        return RolloutTrace(
            latency=tm(latency), total_power=tm(power),
            feasible=tm(feasible, bool), cap_feasible=tm(cap_ok, bool),
            source_latency=tm(lat_src), assign=tm(assign, np.int64),
            positions=tm(pos), active=tm(active, bool), charge=tm(charge),
            n_requests=tm(n_eff, np.int64),
            energy_tx=tm(e_tx), energy_cmp=tm(e_cmp))


__all__ = ["FleetRollout", "RolloutTrace", "RolloutSpec"]

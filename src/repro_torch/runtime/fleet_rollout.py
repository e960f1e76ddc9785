"""FleetRollout — the host-facing runtime layer over the rollout
(``repro_torch.core.rollout``).

A ``FleetRollout`` is a ``ScenarioEngine`` (same constants, same plan
cache) that also owns a built (B, T) rollout: mobility, failure/recovery,
battery drain, the frame's whole multi-source request stream and the
fused planning tick for every frame of every trajectory, on one device,
with no host synchronisation between frames.  With a mesh
(``repro_torch.parallel.sharding.fleet_mesh``) the trajectory axis is
split over the mesh's devices: each runs the same built rollout on its
block of rows and the host gathers the blocks.

All randomness is drawn on the host per ``run()`` from one numpy
generator, in the reference's order and dtypes, so one seed gives the
reference and the port identical streams, sharded or not.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.rollout import (RolloutSpec, make_rollout_fn,
                                      percentile_with_inf)
from repro_torch.core.swarm import FrameStats
from repro_torch.parallel.sharding import (fleet_mesh, mesh_signature,
                                           pad_to_multiple)
from repro_torch.runtime.scenario_engine import ScenarioEngine


#: the built rollout's outputs in order, as ``RolloutTrace`` fields and
#: their host dtypes
_OUTPUTS = (("positions", np.float64), ("active", bool),
            ("charge", np.float64), ("latency", np.float64),
            ("total_power", np.float64), ("feasible", bool),
            ("cap_feasible", bool), ("assign", np.int64),
            ("source_latency", np.float64), ("n_requests", np.int64),
            ("energy_tx", np.float64), ("energy_cmp", np.float64))


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
    first survivor).

    ``valid`` marks the trajectories the caller asked for.  A mesh-sharded
    run pads B up to a multiple of the mesh size (every shard takes as
    many rows), and the padded rows — edge copies, shard filler — stay in
    the arrays; every aggregate below masks them out, which is what makes
    the statistics shard-count invariant.  Unsharded runs have all rows
    valid."""

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
    valid: Optional[np.ndarray] = None   # [B] bool; None = every row real

    def _valid(self) -> np.ndarray:
        """[B] mask of caller-requested trajectories (padding excluded)."""
        if self.valid is None:
            return np.ones(self.latency.shape[0], dtype=bool)
        return self.valid

    @property
    def n_trajectories(self) -> int:
        """Trajectories the caller asked for (mesh padding rows excluded —
        ``latency.shape[0]`` may be larger after a sharded ragged run)."""
        return int(self._valid().sum())

    @property
    def n_frames(self) -> int:
        return self.latency.shape[1]

    @property
    def feasibility_rate(self) -> float:
        """Fraction of valid (trajectory, frame) points with a feasible
        plan."""
        feas = self.feasible[self._valid()]
        return float(feas.mean()) if feas.size else 0.0

    @property
    def mean_latency(self) -> float:
        """Mean arrival-weighted latency over FEASIBLE frames of valid
        trajectories (inf when none) — read it next to
        ``feasibility_rate``."""
        m = self._valid()
        vals = self.latency[m][self.feasible[m]]
        return float(vals.mean()) if vals.size else float("inf")

    @property
    def mean_power(self) -> float:
        """Mean tightened transmit power over FEASIBLE frames of valid
        trajectories."""
        m = self._valid()
        vals = self.total_power[m][self.feasible[m]]
        return float(vals.mean()) if vals.size else 0.0

    def latency_percentile(self, q: float) -> float:
        """Ensemble percentile over all valid (trajectory, frame) points,
        infeasible frames included as inf."""
        return percentile_with_inf(self.latency[self._valid()], q)

    def frame_stats(self, trajectory: int = 0) -> List[FrameStats]:
        """One trajectory as per-frame records; ``replanned`` marks frames
        where the planned-over UAV set shrank.  A padding row raises."""
        b = trajectory
        if not self._valid()[b]:
            raise IndexError(
                f"trajectory {b} is mesh-padding filler, not a requested "
                f"trajectory (n_trajectories = {self.n_trajectories})")
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
    """Batched multi-frame swarm simulation on a device, or split over a
    mesh of devices along the trajectory axis.

    Extends ``ScenarioEngine`` with a built rollout resolved through the
    same ``PlanFnCache``: the rollout's key is the plan's signature plus
    the mesh signature (``mesh_signature``; None unsharded), the device
    the rollout runs on, the chaos flags and the ``RolloutSpec`` dynamics
    constants, so a mesh's shard rollouts and the single-device rollout
    never share an entry, and rebuilding a ``FleetRollout`` never
    rebuilds one.  ``device`` None = CUDA (raises without a GPU);
    ``device="cpu"`` runs the plain PyTorch path.

    ``mesh=`` / ``mesh_devices=`` (constructor default, overridable per
    ``run``) split the trajectory axis over a ``fleet_mesh``: ragged B is
    padded up to the mesh size and masked back out via
    ``RolloutTrace.valid``.
    """

    def __init__(self, channel, devices, model, spec: RolloutSpec,
                 device_order=None, act_scale: float = 1.0,
                 plan_cache=None, position_spec=None, seed: int = 0,
                 mesh=None, mesh_devices: Union[None, int, Sequence] = None,
                 device=None):
        super().__init__(channel, devices, model, device_order=device_order,
                         act_scale=act_scale, plan_cache=plan_cache,
                         position_spec=position_spec, device=device)
        self.spec = spec
        self._rng = np.random.default_rng(seed)
        self._default_mesh = self._resolve_mesh(mesh, mesh_devices)
        self._rollout = self._rollout_fn(None, self.device)

    @staticmethod
    def _resolve_mesh(mesh, devices):
        """One mesh from the (mesh=, devices=) pair; None = unsharded.

        ``devices`` is an int (the first n CUDA devices) or a device
        sequence; ``devices == 1`` means the single engine device."""
        if mesh is not None and devices is not None:
            raise ValueError("pass either mesh or devices, not both")
        if mesh is None and devices is None:
            return None
        if devices == 1:
            return None
        return fleet_mesh(mesh if mesh is not None else devices)

    def _rollout_fn(self, mesh, device, with_gain: bool = False,
                    with_drain: bool = False):
        """The built rollout on ``device`` for ``mesh``'s shards (or
        unsharded when ``mesh`` is None), through the shared cache; the
        chaos flags (per-frame ``gain_scale`` fades / ``extra_drain``
        battery drops) select their own entry."""
        rollout_key = ("rollout", mesh_signature(mesh), str(device),
                       with_gain, with_drain,
                       self.spec.key()) + self._cache_key()[1:]
        if rollout_key not in self._cache_keys_used:
            self._cache_keys_used = self._cache_keys_used + (rollout_key,)
        return self.plan_cache.get(rollout_key, partial(
            make_rollout_fn, params=self.params, compute=self.compute,
            memory=self.memory, act_bits=self.act_bits,
            input_bits=self.input_bits, mem_cap=self.mem_cap,
            compute_cap=self.compute_cap, throughput=self.throughput,
            order=self.order, spec=self.spec, p2=self.position_spec,
            with_gain=with_gain, with_drain=with_drain, device=device))

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
            mesh=None,
            devices: Union[None, int, Sequence] = None,
            rng: Optional[np.random.Generator] = None) -> RolloutTrace:
        """Roll B trajectories forward T frames on the engine's device, or
        split over a mesh.

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
        optional [B, U, 2] drift targets.  ``mesh`` / ``devices``: split
        the trajectory axis over a ``fleet_mesh`` for this run (overriding
        the constructor default; exclusive with each other).  Every host
        draw is made for the requested B before padding, so a sharded run
        consumes the same streams as the unsharded run; B is then padded
        with edge rows to a multiple of the mesh size, each shard's block
        goes to its device and runs there (no host synchronisation between
        the shards' launches), the host gathers the blocks, and
        ``RolloutTrace.valid`` masks the filler rows.  ``rng``: optional
        numpy generator for this run's host draws.  The draws are made in
        the reference's order and dtypes.
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

        if mesh is not None or devices is not None:
            run_mesh = self._resolve_mesh(mesh, devices)
        else:
            run_mesh = self._default_mesh
        with_gain = gain_scale is not None
        with_drain = extra_drain is not None
        inputs = [np.asarray(pos0, np.float32), charge0,
                  np.asarray(alive0, bool), np.asarray(waypoints, np.float32),
                  jitter, fail_u, recov_u, forced,
                  np.asarray(arrivals, np.float32)]
        bdims = [0, 0, 0, 0, 1, 1, 1, 1, 1]
        if with_gain:
            inputs.append(gain_scale)
            bdims.append(1)
        if with_drain:
            inputs.append(extra_drain)
            bdims.append(1)

        valid = None
        if run_mesh is None:
            rollout = self._rollout if not (with_gain or with_drain) \
                else self._rollout_fn(None, self.device, with_gain,
                                      with_drain)
            outs = [rollout(*[torch.as_tensor(x, device=self.device)
                              for x in inputs])]
        else:
            # pad ragged B up to the mesh size with edge rows (real data,
            # so the filler never produces NaN/inf surprises), record the
            # validity mask, and give every shard its block of rows
            n = len(run_mesh)
            Bpad = pad_to_multiple(B, n)
            if Bpad != B:
                inputs = [np.pad(x, [(0, Bpad - B) if d == bdim else (0, 0)
                                     for d in range(x.ndim)], mode="edge")
                          for x, bdim in zip(inputs, bdims)]
                valid = np.arange(Bpad) < B
            rows = Bpad // n
            # every shard's inputs go to its device first, then every
            # shard launches, then the host gathers: no shard waits on
            # another's results
            shards = []
            for k, dev in enumerate(run_mesh):
                block = slice(k * rows, (k + 1) * rows)
                shards.append((dev, [
                    torch.as_tensor(np.ascontiguousarray(
                        x[block] if bdim == 0 else x[:, block]), device=dev)
                    for x, bdim in zip(inputs, bdims)]))
            outs = [self._rollout_fn(run_mesh, dev, with_gain,
                                     with_drain)(*args)
                    for dev, args in shards]

        def gather(i, dtype):      # [T, B, ...] blocks -> [B, T, ...]
            x = np.concatenate([o[i].detach().cpu().numpy() for o in outs],
                               axis=1)
            return np.swapaxes(x, 0, 1).astype(dtype)

        return RolloutTrace(valid=valid, **{
            name: gather(i, dtype) for i, (name, dtype) in enumerate(_OUTPUTS)})


__all__ = ["FleetRollout", "RolloutTrace", "RolloutSpec"]

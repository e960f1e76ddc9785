"""Batched LLHR planning primitives in PyTorch: geometry and P1 (eq. 4-7),
batched P2 (eq. 8-9) and the contiguous-block chain DP (P3).

Each function mirrors its counterpart in the reference's ``core/batch.py``
operation for operation, so that on the same float32 inputs the discrete
decisions (feasible links, DP parents, placements) come out the same.
Two PyTorch habits are avoided on purpose:

* a Python scalar divided by a tensor is ``reciprocal(t) * scalar`` in
  PyTorch, and a CUDA tensor divided by a CPU scalar is multiplied by the
  scalar's reciprocal; both round differently from a true division.  So
  every constant that meets a division is a 0-dim float32 tensor on the
  operands' device (``_const``).
* reductions that feed a discrete decision keep the reference's operand
  order (``sqrt((x * x).sum(-1))``, not ``linalg.vector_norm``, which
  accumulates otherwise).

Shapes use B = scenarios, U = UAVs, L = layers, S = device-order states
and M = source slots.  Everything runs in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.channel import RadioParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.tropical_dp.ops import chain_dp

INF = math.inf


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``like``'s device (a fill,
    not a host copy, so it never waits for the device)."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


# ---------------------------------------------------------------------------
# Geometry + channel (eq. 4, 5, 7), batched
# ---------------------------------------------------------------------------


def pairwise_dist_batched(positions: torch.Tensor) -> torch.Tensor:
    """[..., U, 2] positions -> [..., U, U] Euclidean distances."""
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    return torch.sqrt((diff * diff).sum(-1))


def link_gain_batched(dist: torch.Tensor, params: RadioParams,
                      gain_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """eq. (4) with the d0 = 1 m clamp of ``RadioChannel.gain``."""
    d = torch.clamp_min(dist, 1.0)
    g = _const(params.h0, dist) / (d * d)
    if gain_scale is not None:
        g = g * gain_scale
    return g


def power_threshold_batched(dist: torch.Tensor, params: RadioParams,
                            bits: Optional[float] = None,
                            gain_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """eq. (7): minimum power delivering ``bits`` within tau, per link."""
    bits = params.packet_bits if bits is None else bits
    spectral = bits * math.log(2.0) / (params.bandwidth_hz * params.tau)
    gain = link_gain_batched(dist, params, gain_scale)
    return _const(params.noise_watts, dist) / gain * \
        _const(math.exp(spectral) - 1.0, dist)


@dataclass(frozen=True)
class BatchPowerSolution:
    """Batched P1 solution (arrays carry a leading B)."""

    power: torch.Tensor          # [B, U]
    threshold: torch.Tensor      # [B, U]
    feasible: torch.Tensor       # [B, U] bool
    link_feasible: torch.Tensor  # [B, U, U] bool
    total_power: torch.Tensor    # [B]


def solve_power_batched(dist: torch.Tensor, params: RadioParams,
                        links: Optional[torch.Tensor] = None,
                        active: Optional[torch.Tensor] = None,
                        gain_scale: Optional[torch.Tensor] = None,
                        threshold_matrix: Optional[torch.Tensor] = None
                        ) -> BatchPowerSolution:
    """Closed-form P1 (eq. 6-7) over a scenario batch.

    A failed UAV (``active`` False) binds no link and transmits at zero
    power.  ``threshold_matrix`` (a prior ``power_threshold_batched``
    result for the same dist/gain_scale) skips recomputing eq. (7).
    """
    U = dist.shape[-1]
    p_max = _const(params.p_max_watts, dist)
    eye = torch.eye(U, dtype=torch.bool, device=dist.device)
    if threshold_matrix is None:
        threshold_matrix = power_threshold_batched(dist, params,
                                                   gain_scale=gain_scale)
    th = torch.where(eye, 0.0, threshold_matrix)
    link_feasible = th <= p_max                      # diag: th=0 -> True
    if active is not None:
        pair = active[..., :, None] & active[..., None, :]
        link_feasible = link_feasible & (pair | eye)
    use = link_feasible if links is None else (links & link_feasible)
    threshold = torch.where(use & ~eye, th, 0.0).amax(-1)
    power = torch.minimum(threshold, p_max)
    feasible = threshold <= p_max
    if active is not None:
        power = torch.where(active, power, 0.0)
        threshold = torch.where(active, threshold, 0.0)
    return BatchPowerSolution(power=power, threshold=threshold,
                              feasible=feasible, link_feasible=link_feasible,
                              total_power=power.sum(-1))


def rate_matrix_batched(dist: torch.Tensor, power: torch.Tensor,
                        params: RadioParams, link_feasible: torch.Tensor,
                        gain_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """eq. (5) at the solved powers: rho_{i,k} [B,U,U]; 0 on infeasible
    links, inf on the diagonal (self-transfer is free)."""
    U = dist.shape[-1]
    p_rx = link_gain_batched(dist, params, gain_scale) * power[..., :, None]
    rate = _const(params.bandwidth_hz, dist) * torch.log2(
        _const(1.0, dist) + p_rx / _const(params.noise_watts, dist))
    rate = torch.where(link_feasible, rate, 0.0)
    eye = torch.eye(U, dtype=torch.bool, device=dist.device)
    return torch.where(eye, INF, rate)


# ---------------------------------------------------------------------------
# Batched P2 — UAV positions (eq. 8-9), repair on device
# ---------------------------------------------------------------------------


def position_coeff(params: RadioParams) -> float:
    """The eq. (9) per-link power weight: sigma^2/h0 * (2^(K/(B tau)) - 1).
    Minimizing sum of coeff * d^2 over links is the paper's P2 objective."""
    return (params.noise_watts / params.h0) * \
        (math.exp(params.packet_bits * math.log(2.0) /
                  (params.bandwidth_hz * params.tau)) - 1.0)


def coverage_radius(n_uavs: int, radius: float) -> float:
    """Coverage-circle radius (eq. 8c) big enough to hold a 2R-separated
    packing of ``n_uavs``."""
    return max(radius, 2.0 * radius * (math.sqrt(float(n_uavs)) + 1.0))


def chain_links(n_uavs: int,
                order: Optional[Sequence[int]] = None) -> np.ndarray:
    """[U, U] bool chain-links mask i -> i+1 (walked in ``order`` if given) —
    the placement pipeline's shape, and P2's default topology."""
    links = np.zeros((n_uavs, n_uavs), dtype=bool)
    idx = list(order) if order is not None else list(range(n_uavs))
    for a, b in zip(idx[:-1], idx[1:]):
        links[a, b] = True
    return links


def _positions_pgd(pos0: torch.Tensor, links: torch.Tensor,
                   coeff: torch.Tensor, lr: torch.Tensor,
                   two_r: torch.Tensor, cover_r: torch.Tensor,
                   center: torch.Tensor, steps: int, repair_iters: int):
    """Projected-gradient P2 over a scenario batch, on the tensors' device.

    ``steps`` iterations of normalized gradient descent on the eq. (9)
    objective plus the smooth separation hinge (eq. 8d), each projected
    onto the coverage circle (eq. 8c), tracking the best-so-far iterate
    per scenario (so the objective trace is non-increasing).  Then
    ``repair_iters`` push-apart iterations: each finds the worst-separated
    pair per scenario and moves it symmetrically to 2R + 2e-3 about its
    midpoint, a no-op once the minimum pairwise distance clears 2R.  The
    gradient comes from ``torch.autograd``.  No host round trip.

    Args: pos0 [B, U, 2]; links [B, U, U] bool (symmetrized here);
    coeff/lr/two_r/cover_r 0-dim float32 tensors; center [B, 2].  Returns
    (positions [B, U, 2], link objective [B], residual separation
    violation [B], objective trace [B, steps]).
    """
    B, U = pos0.shape[0], pos0.shape[-2]
    dev = pos0.device
    eye = torch.eye(U, dtype=torch.bool, device=dev)
    links = links | links.transpose(-1, -2)
    one, two, ten = (_const(v, pos0) for v in (1.0, 2.0, 10.0))
    eps6, eps9, eps12 = (_const(v, pos0) for v in (1e-6, 1e-9, 1e-12))

    def objective(pos):                                             # [B]
        diff = pos[..., :, None, :] - pos[..., None, :, :]
        d2 = (diff * diff).sum(-1)
        obj = torch.where(links, coeff * d2, 0.0).sum((-2, -1)) / two
        viol = torch.clamp_min(two_r * two_r - d2, 0.0)
        pen = torch.where(eye, 0.0, viol * viol).sum((-2, -1))
        return obj + ten * coeff * pen

    def project(pos):
        rel = pos - center[:, None, :]
        r = torch.sqrt((rel * rel).sum(-1, keepdim=True))
        return center[:, None, :] + \
            rel * torch.minimum(one, cover_r / torch.maximum(r, eps9))

    pos = project(pos0.detach())
    best_pos, best_obj = pos, objective(pos).detach()
    trace = []
    for _ in range(steps):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(p).sum(), p)
        gn = torch.sqrt((g * g).sum((-2, -1), keepdim=True))
        pos = project(pos - lr * g / (gn + eps12))
        obj = objective(pos)
        better = obj < best_obj
        best_pos = torch.where(better[:, None, None], pos, best_pos)
        best_obj = torch.minimum(obj, best_obj)
        trace.append(best_obj)
    pos = best_pos

    rows = torch.arange(B, device=dev)
    x_axis = torch.eye(2, dtype=torch.float32, device=dev)[0]   # (1, 0)
    push_len = two_r / two + _const(1e-3, pos0)
    need_below = two_r - eps6
    for _ in range(repair_iters):
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        d = torch.sqrt((diff * diff).sum(-1))
        d = torch.where(eye, INF, d)
        flat = d.reshape(B, -1)
        arg = torch.argmin(flat, -1)
        i, k = arg // U, arg % U
        pi, pk = pos[rows, i], pos[rows, k]
        mid = (pi + pk) / two
        dir_ = pi - pk
        nrm = torch.sqrt((dir_ * dir_).sum(-1, keepdim=True))
        # coincident pair: push along a fixed axis instead of collapsing
        dir_ = torch.where(nrm < eps6, x_axis,
                           dir_ / (nrm + eps9))
        push = dir_ * push_len
        need = (flat.amin(-1) < need_below)[:, None]
        pos = pos.clone()
        pos[rows, i] = torch.where(need, mid + push, pi)
        pos[rows, k] = torch.where(need, mid - push, pk)
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    d2 = (diff * diff).sum(-1)
    d = torch.sqrt(torch.where(eye, INF, d2))
    viol = torch.clamp_min(two_r - d.amin((-2, -1)), 0.0)
    link_obj = torch.where(links, coeff * d2, 0.0).sum((-2, -1)) / two
    trace_t = torch.stack(trace, 1) if trace else pos.new_zeros((B, 0))
    return pos, link_obj, viol, trace_t


@dataclass(frozen=True)
class BatchPositionSolution:
    """Batched P2 solution, on the host.

    ``objective`` is the raw eq. (9) link objective after repair;
    ``objective_trace`` is the penalized objective of the best-so-far
    iterate per GD step (non-increasing)."""

    positions: np.ndarray        # [B, U, 2]
    objective: np.ndarray        # [B]
    max_violation: np.ndarray    # [B] residual separation violation (m)
    objective_trace: np.ndarray  # [B, steps]
    iterations: int


def solve_positions_batched(init_positions: np.ndarray,
                            params: RadioParams,
                            radius: float = 20.0,
                            links: Optional[np.ndarray] = None,
                            steps: int = 800,
                            lr: float = 0.5,
                            repair_iters: int = 50,
                            center: Optional[Tuple[float, float]] = None,
                            device: DeviceLike = None
                            ) -> BatchPositionSolution:
    """Batched P2 (eq. 8-9) on ``device``: ``_positions_pgd`` over a
    [B, U, 2] batch of initial positions, results copied to the host.

    ``links``: [U, U] or [B, U, U] bool transfer topology (default: the
    chain i -> i+1).  ``center``: coverage-circle center shared by the
    batch; default is each scenario's initial centroid.
    """
    dev = resolve_device(device)
    pos0 = torch.as_tensor(np.asarray(init_positions), dtype=torch.float32,
                           device=dev)
    B, U = pos0.shape[0], pos0.shape[1]
    links = np.asarray(chain_links(U) if links is None else links, bool)
    links_t = torch.as_tensor(np.broadcast_to(links, (B, U, U)).copy(),
                              device=dev)
    if center is None:
        center_t = pos0.mean(1)
    else:
        center_t = torch.as_tensor(np.asarray(center, np.float32),
                                   device=dev).expand(B, 2)
    f32 = [torch.tensor(v, dtype=torch.float32, device=dev) for v in
           (position_coeff(params), lr, 2.0 * radius,
            coverage_radius(U, radius))]
    pos, obj, viol, trace = _positions_pgd(pos0, links_t, *f32, center_t,
                                           steps, repair_iters)
    return BatchPositionSolution(
        positions=pos.cpu().numpy().astype(np.float64),
        objective=obj.cpu().numpy().astype(np.float64),
        max_violation=viol.cpu().numpy().astype(np.float64),
        objective_trace=trace.cpu().numpy().astype(np.float64),
        iterations=steps)


def links_from_assignment_batched(assign: torch.Tensor, source: torch.Tensor,
                                  n_uavs: int) -> torch.Tensor:
    """[..., L] chain-DP assignment (+ [...] source) -> [..., U, U] bool
    mask of the inter-UAV transfers each placement performs: source ->
    first layer's device, then every device change along the chain.
    Infeasible placements (assign -1) use no links."""
    lead = assign.shape[:-1]
    L = assign.shape[-1]
    assign = assign.reshape(-1, L)
    source = source.reshape(-1)
    R = assign.shape[0]
    prev = torch.cat([source[:, None], assign[:, :-1]], dim=1)      # [R,L]
    valid = (prev >= 0) & (assign >= 0) & (prev != assign)
    rows = torch.arange(R, device=assign.device)[:, None].expand(R, L)
    a = prev.clamp(0, n_uavs - 1).long()
    b = assign.clamp(0, n_uavs - 1).long()
    hits = torch.zeros((R, n_uavs, n_uavs), dtype=torch.int32,
                       device=assign.device)
    hits.index_put_((rows, a, b), valid.to(torch.int32), accumulate=True)
    return (hits > 0).reshape(*lead, n_uavs, n_uavs)


# ---------------------------------------------------------------------------
# Batched contiguous-block chain DP (P3)
# ---------------------------------------------------------------------------


def prefix_sums(compute: torch.Tensor, memory: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L+1] float32 prefix sums of the layer compute and memory, with a
    leading 0 — the DP's block-cost tables.  Taken on the CPU, once per
    plan function: the values feed the discrete ``ok`` mask directly.

    Each sum adds in the order of the reference's ``jnp.cumsum`` on the
    CPU, XLA's blocked scan (``_blocked_cumsum``), so the tables are
    bitwise the reference's at every L; ``torch.cumsum`` and a sequential
    sum add in other orders and differ in the last bit."""
    def seq(x: torch.Tensor) -> torch.Tensor:
        acc = _blocked_cumsum(x.detach().cpu().numpy().astype(np.float32))
        return torch.from_numpy(np.concatenate(
            [np.zeros(1, np.float32), acc]))

    return seq(compute), seq(memory)


#: the block of XLA's CPU cumsum: a chain of 32 lowers to a [2, 16] scan
_CUMSUM_BLOCK = 16


def _blocked_cumsum(x: np.ndarray) -> np.ndarray:
    """Inclusive float32 prefix sum in XLA's CPU order: a sequential sum
    inside each block of 16 (the input zero-padded to whole blocks), the
    block totals scanned by the same rule, recursively, and each block's
    carry (the sum of the totals before it) added to its in-block sums
    last."""
    n = x.size
    if n <= _CUMSUM_BLOCK:
        return np.add.accumulate(x, dtype=np.float32)
    nb = -(-n // _CUMSUM_BLOCK)
    blocks = np.zeros(nb * _CUMSUM_BLOCK, np.float32)
    blocks[:n] = x
    inner = np.add.accumulate(blocks.reshape(nb, _CUMSUM_BLOCK), axis=1,
                              dtype=np.float32)
    totals = _blocked_cumsum(inner[:, -1])
    carry = np.concatenate([np.zeros(1, np.float32), totals[:-1]])
    return (inner + carry[:, None]).reshape(-1)[:n]


@dataclass(frozen=True)
class ChainDPTables:
    """Everything of the chain DP that depends only on the model, the
    devices and the device order: the per-step block compute time ``ct``
    and feasibility mask ``ok`` of every wavefront step, and the index
    tables of the transfer tensor.  Built once per plan function."""

    order_arr: torch.Tensor     # [S] int64: state s -> device
    prev_dev: torch.Tensor      # [S+1] int64: state s0 -> device
    bits_in: torch.Tensor       # [L] bits entering a block starting at a
    input_bits: torch.Tensor    # 0-dim
    ct: torch.Tensor            # [L(step), L(a), S] float32
    ok: torch.Tensor            # [L(step), L(a), S] float32 0/1

    @property
    def n_layers(self) -> int:
        return self.ct.shape[0]


def chain_dp_tables(compute, memory, act_bits, input_bits, mem_cap,
                    compute_cap, throughput, order: Sequence[int],
                    device: torch.device) -> ChainDPTables:
    """The step-invariant operands of ``_chain_dp_solve_kernelized``,
    computed on the CPU in float32 with the reference's expressions and
    moved to ``device``."""
    f32 = dict(dtype=torch.float32)
    compute = torch.as_tensor(np.asarray(compute), **f32)
    memory = torch.as_tensor(np.asarray(memory), **f32)
    act_bits = torch.as_tensor(np.asarray(act_bits), **f32)
    input_bits = torch.tensor(np.float32(input_bits))
    order = tuple(int(o) for o in order)
    L, S = compute.shape[0], len(order)
    order_arr = torch.tensor(order, dtype=torch.long)
    mem_cap_o = torch.as_tensor(np.asarray(mem_cap), **f32)[order_arr]
    cmp_cap_o = torch.as_tensor(np.asarray(compute_cap), **f32)[order_arr]
    thr_o = torch.as_tensor(np.asarray(throughput), **f32)[order_arr]
    pre_c, pre_m = prefix_sums(compute, memory)
    a_ix = torch.arange(L)
    bits_in = torch.where(a_ix == 0, input_bits,
                          act_bits[torch.clamp_min(a_ix - 1, 0)])   # [L]
    slack = torch.tensor(np.float32(1e-9))
    ct, ok = [], []
    for b in range(1, L + 1):
        blk_c = pre_c[b] - pre_c[:L]                                # [L] (a)
        blk_m = pre_m[b] - pre_m[:L]
        ok.append(((blk_m[:, None] <= mem_cap_o[None, :] + slack) &
                   (blk_c[:, None] <= cmp_cap_o[None, :] + slack) &
                   (a_ix < b)[:, None]).to(torch.float32))          # [L, S]
        ct.append(blk_c[:, None] / thr_o[None, :])                  # [L, S]
    prev_dev = torch.cat([torch.zeros(1, dtype=torch.long), order_arr])
    return ChainDPTables(
        order_arr=order_arr.to(device),
        prev_dev=prev_dev.to(device), bits_in=bits_in.to(device),
        input_bits=input_bits.to(device),
        ct=torch.stack(ct).to(device), ok=torch.stack(ok).to(device))


def _chain_dp_solve_kernelized(tables: ChainDPTables, rate: torch.Tensor,
                               sources: torch.Tensor, active: torch.Tensor):
    """The chain DP with a source-slot axis: the fused chain-DP kernel on
    CUDA tensors (one launch for the whole solve), its plain version
    (``kernels/tropical_dp/ref.py::chain_dp_ref``: L wavefront steps and
    the backtrack) on CPU ones.

    ``rate`` [B, U, U] (inf diagonal, 0 = infeasible link), ``sources``
    [B, M] capturing UAV per slot, ``active`` [B, U] bool.  Returns
    ``(assign [B, M, L] int32, latency [B, M])``; infeasible slots get
    assign -1 and latency inf.  Tie-breaks follow the scalar solver's loop
    order (a outer, s0 inner, first strict improvement).
    """
    return chain_dp(rate, sources, active, tables.order_arr,
                    tables.prev_dev, tables.bits_in, tables.input_bits,
                    tables.ct, tables.ok)


def _chain_dp_solve(tables: ChainDPTables, rate: torch.Tensor,
                    source: torch.Tensor, active: torch.Tensor):
    """Single-source chain DP: one slot of ``_chain_dp_solve_kernelized``.
    Returns ``(assign [B, L] int32, latency [B])``."""
    assign, latency = _chain_dp_solve_kernelized(tables, rate,
                                                 source[:, None], active)
    return assign[:, 0], latency[:, 0]


def _dp_inputs(compute, memory, act_bits, input_bits, mem_cap, compute_cap,
               throughput, rate, active, device_order, device):
    """Tables, rate and active mask of a host-facing chain-DP call on the
    resolved ``device`` (``_as_dp_args`` of the reference: float32 rates,
    every UAV alive when ``active`` is None, index order by default)."""
    dev = resolve_device(device)
    rate = np.array(rate, np.float32)              # a writable copy
    B, U = rate.shape[0], rate.shape[-1]
    order = tuple(device_order) if device_order is not None else \
        tuple(range(U))
    active = np.ones((B, U), dtype=bool) if active is None else \
        np.array(active, dtype=bool)
    tables = chain_dp_tables(compute, memory, act_bits, input_bits, mem_cap,
                             compute_cap, throughput, order, dev)
    return (tables, torch.as_tensor(rate, device=dev),
            torch.as_tensor(active, device=dev), dev)


def solve_chain_dp_batched(compute: np.ndarray, memory: np.ndarray,
                           act_bits: np.ndarray, input_bits: float,
                           mem_cap: np.ndarray, compute_cap: np.ndarray,
                           throughput: np.ndarray, rate: np.ndarray,
                           source: np.ndarray,
                           active: Optional[np.ndarray] = None,
                           device_order: Optional[Sequence[int]] = None,
                           device: DeviceLike = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched mirror of ``placement.solve_chain_dp``, on ``device``.

    Args: per-layer ``compute``/``memory``/``act_bits`` [L] shared across
    the batch; device caps/throughput [U]; ``rate`` [B, U, U] (inf
    diagonal, 0 = infeasible link); ``source`` [B] capturing-UAV index;
    ``active`` [B, U] (None: every UAV alive).

    Returns ``(assign [B, L] int64, latency [B] float64)`` on the host:
    device ids, -1 everywhere on infeasible scenarios, whose latency is
    inf.  On a CUDA device the solve is one fused chain-DP launch.
    """
    tables, rate_t, active_t, dev = _dp_inputs(
        compute, memory, act_bits, input_bits, mem_cap, compute_cap,
        throughput, rate, active, device_order, device)
    source_t = torch.as_tensor(np.array(source, np.int64), device=dev)
    assign, latency = _chain_dp_solve(tables, rate_t, source_t, active_t)
    return _host_dp(assign, latency)


def solve_chain_dp_multisource(compute: np.ndarray, memory: np.ndarray,
                               act_bits: np.ndarray, input_bits: float,
                               mem_cap: np.ndarray, compute_cap: np.ndarray,
                               throughput: np.ndarray, rate: np.ndarray,
                               sources: np.ndarray,
                               active: Optional[np.ndarray] = None,
                               device_order: Optional[Sequence[int]] = None,
                               device: DeviceLike = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing multi-source mirror of ``solve_chain_dp_batched``.

    ``sources``: [B, S] capturing-UAV index per request slot.  Returns
    ``(assign [B, S, L] int64, latency [B, S] float64)``: one chain-DP
    placement per (scenario, source), every slot in the same solve (one
    fused launch on CUDA).  Pricing the stream's aggregate load against
    the shared caps is separate (``placement_compute_load`` /
    ``shared_cap_feasible``)."""
    tables, rate_t, active_t, dev = _dp_inputs(
        compute, memory, act_bits, input_bits, mem_cap, compute_cap,
        throughput, rate, active, device_order, device)
    sources_t = torch.as_tensor(np.array(sources, np.int64), device=dev)
    return _host_dp(*_chain_dp_solve_kernelized(tables, rate_t, sources_t,
                                                active_t))


def _host_dp(assign: torch.Tensor, latency: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray]:
    return (assign.cpu().numpy().astype(np.int64),
            latency.cpu().numpy().astype(np.float64))


def placement_compute_load(assign: torch.Tensor, weights: torch.Tensor,
                           compute: torch.Tensor, n_uavs: int
                           ) -> torch.Tensor:
    """Aggregate per-UAV MACs of a multi-source assignment batch.

    ``assign`` [B, S, L] (device ids, -1 = infeasible), ``weights`` [B, S]
    arrival counts per source, ``compute`` [L] MACs per layer.  Returns
    [B, n_uavs]: the eq. (11b) left-hand side summed over the frame's whole
    request stream.  Infeasible placements contribute nothing.
    """
    uav = torch.arange(n_uavs, device=assign.device)
    onehot = assign[..., None] == uav                            # [B,S,L,U]
    macs_s = (compute[None, None, :, None] * onehot).sum(2)       # [B,S,U]
    return (macs_s * weights[..., None]).sum(1)                   # [B,U]


def shared_cap_feasible(load: torch.Tensor, cap: torch.Tensor
                        ) -> torch.Tensor:
    """eq. (11b) over the whole request stream: True where no UAV's
    aggregate load exceeds its period budget (absolute 1e-9 slack plus a
    float32-scale relative term).  ``load`` [B, U], ``cap`` [U]."""
    budget = cap[None, :] * _const(1.0 + 1e-6, cap) + _const(1e-9, cap)
    return (load <= budget).all(-1)


__all__ = [
    "BatchPowerSolution", "ChainDPTables", "chain_dp_tables",
    "pairwise_dist_batched", "link_gain_batched", "power_threshold_batched",
    "solve_power_batched", "rate_matrix_batched", "position_coeff",
    "coverage_radius", "chain_links", "links_from_assignment_batched",
    "placement_compute_load", "shared_cap_feasible", "prefix_sums",
    "BatchPositionSolution", "solve_positions_batched",
    "solve_chain_dp_batched", "solve_chain_dp_multisource",
]

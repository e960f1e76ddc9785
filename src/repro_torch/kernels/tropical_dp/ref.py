"""Plain PyTorch versions of the chain DP.

* ``dp_step_ref``: the forward-step body of the reference chain DP
  (two-stage masked min with argmin parent pointers) in the kernel's
  (scenario, source slot) operand layout, op for op as
  ``repro/kernels/tropical_dp/ref.py``: the full [B, M, L, S, S+1]
  candidate tensor is materialized, and the a = 0 placeholder row is
  replaced by the per-slot source transfer row.
* ``chain_dp_ref``: the whole solve, op for op as the reference's
  ``repro/core/batch.py::_chain_dp_solve_kernelized``: the slot-invariant
  transfer tensor, L wavefront steps and the backtrack over the flattened
  (scenario, slot) rows.  It is the fused CUDA kernel's plain version, and
  with the step kernel as ``step`` the ``step`` route.
"""
from __future__ import annotations

import math

import torch

INF = math.inf


def dp_step_ref(dp: torch.Tensor, tr: torch.Tensor, tr0: torch.Tensor,
                ct: torch.Tensor, ok: torch.Tensor):
    """Same contract as ``tropical_dp.tropical_dp_step``.

    dp [B, M, L, S+1], tr [B, L, S, S+1], tr0 [B, M, S], ct/ok [L, S]
    -> (row [B, M, S], pa [B, M, S] int32, ps [B, M, S] int32).
    """
    L = tr.shape[1]
    m1 = dp[:, :, :, None, :] + tr[:, None]          # [B, M, L, S, S+1]
    s0_best = torch.argmin(m1, 4).to(torch.int32)    # [B, M, L, S]
    mmin = m1.amin(4)
    # a = 0: the per-slot source row; only dp[0, 0] is finite there, so
    # the first-argmin predecessor is state 0
    a_ix = torch.arange(L, device=dp.device)[None, None, :, None]
    m0 = dp[:, :, 0, 0][..., None] + tr0             # [B, M, S]
    mmin = torch.where(a_ix == 0, m0[:, :, None, :], mmin)
    s0_best = torch.where(a_ix == 0, 0, s0_best)
    cand = mmin + ct[None, None]
    cand = torch.where(ok[None, None] > 0, cand, math.inf)
    a_best = torch.argmin(cand, 2).to(torch.int32)   # [B, M, S]
    row = cand.amin(2)
    ps = torch.gather(s0_best, 2, a_best[:, :, None, :].long())[:, :, 0]
    return row, a_best, ps


def chain_dp_ref(rate: torch.Tensor, sources: torch.Tensor,
                 active: torch.Tensor, order: torch.Tensor,
                 prev_dev: torch.Tensor, bits_in: torch.Tensor,
                 input_bits: torch.Tensor, ct: torch.Tensor,
                 ok: torch.Tensor, *, step=dp_step_ref):
    """Same contract as ``tropical_dp.tropical_dp_chain``.

    ``rate`` [B, U, U] (inf diagonal, 0 = infeasible link), ``sources``
    [B, M] capturing UAV per slot, ``active`` [B, U] bool, ``order`` [S]
    and ``prev_dev`` [S+1] (state s0 -> device) int64, ``bits_in`` [L],
    ``input_bits`` 0-dim, ``ct``/``ok`` [L(step), L(a), S].  The transfer
    tensor ``tr`` is source-independent (its a = 0 row is dead: the step
    takes the per-slot source row ``tr0`` there).  Returns
    ``(assign [B, M, L] int32, latency [B, M])``; infeasible slots get
    assign -1 and latency inf.  Tie-breaks follow the scalar solver's loop
    order (a outer, s0 inner, first strict improvement).
    """
    L = ct.shape[0]
    S = order.shape[0]
    B, M = sources.shape
    dev = rate.device
    active_o = active[:, order]                                     # [B, S]

    r_prev = rate[:, prev_dev[:, None], order[None, :]]             # [B,S+1,S]
    r4 = r_prev[:, None, :, :]
    tr = torch.where(r4 > 0, bits_in[None, :, None, None] / r4,
                     INF)                                           # [B,L,S+1,S]
    s0_lt_s = (torch.arange(S + 1, device=dev)[:, None]
               < torch.arange(1, S + 1, device=dev)[None, :])       # [S+1, S]
    tr = torch.where(s0_lt_s[None, None] & active_o[:, None, None, :], tr,
                     INF)
    tr = tr.transpose(2, 3).contiguous()                            # [B,L,S,S+1]
    rows = torch.arange(B, device=dev)
    r_src = rate[rows[:, None], sources.long()][:, :, order]        # [B, M, S]
    tr_src = torch.where(r_src > 0, input_bits / r_src, INF)
    tr0 = torch.where(active_o[:, None, :], tr_src, INF).contiguous()

    dp = torch.full((B, M, L + 1, S + 1), INF, dtype=torch.float32,
                    device=dev)
    dp[:, :, 0, 0] = 0.0
    pa = torch.zeros((L, B, M, S + 1), dtype=torch.int32, device=dev)
    ps = torch.zeros((L, B, M, S + 1), dtype=torch.int32, device=dev)
    for b in range(1, L + 1):
        row, pa_b, ps_b = step(dp[:, :, :L], tr, tr0, ct[b - 1], ok[b - 1])
        dp[:, :, b, 1:] = row
        pa[b - 1, :, :, 1:] = pa_b
        ps[b - 1, :, :, 1:] = ps_b

    # backtrack on R = B * M flattened rows
    R = B * M
    final = dp[:, :, L, :].reshape(R, S + 1)
    s = torch.argmin(final, 1)
    latency = final.amin(1)
    pa = pa.reshape(L, R, S + 1).long()
    ps = ps.reshape(L, R, S + 1).long()
    rrows = torch.arange(R, device=dev)
    b = torch.full((R,), L, dtype=torch.long, device=dev)
    devs = []
    for j in range(L - 1, -1, -1):
        devs.append(order[torch.clamp_min(s - 1, 0)])
        bi = torch.clamp(b - 1, 0, L - 1)
        a = pa[bi, rrows, s]
        s0 = ps[bi, rrows, s]
        at_start = a == j          # layer j opens the block: hop to the
        b = torch.where(at_start, a, b)      # parent state for layer j-1
        s = torch.where(at_start, s0, s)
    assign = torch.stack(devs[::-1], 1).to(torch.int32)            # [R, L]
    assign = torch.where(torch.isfinite(latency)[:, None], assign, -1)
    return assign.reshape(B, M, L), latency.reshape(B, M)

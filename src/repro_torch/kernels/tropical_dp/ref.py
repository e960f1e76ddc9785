"""Plain PyTorch version of the tropical-DP wavefront step.

The forward-step body of the reference chain DP (two-stage masked min
with argmin parent pointers) in the kernel's (scenario, source slot)
operand layout, op for op as ``repro/kernels/tropical_dp/ref.py``: the
full [B, M, L, S, S+1] candidate tensor is materialized, and the a = 0
placeholder row is replaced by the per-slot source transfer row.
"""
from __future__ import annotations

import math

import torch


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

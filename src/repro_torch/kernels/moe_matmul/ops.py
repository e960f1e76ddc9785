"""Public entry for the MoE layer's expert GEMMs, in the profiler range
``moe.expert_gemm``.

When grad mode is on and an input requires grad, ``expert_gemm`` goes
through ``ExpertGemm``, an autograd Function: its forward launches the
expert-GEMM kernel and its backward the two backward kernels
(``moe_matmul_dx``, ``moe_matmul_dw``) on a CUDA tensor, and takes the
plain versions on a CPU tensor, so the CPU tests run the Function the
card runs.  Otherwise the call is the serving one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.moe_matmul.moe_matmul import (
    moe_matmul, moe_matmul_dw, moe_matmul_dw_meta, moe_matmul_dx,
    moe_matmul_dx_meta, moe_matmul_meta)
from repro_torch.kernels.moe_matmul.ref import (moe_matmul_dw_ref,
                                                moe_matmul_dx_ref,
                                                moe_matmul_ref)

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version, ``meta`` makes the output's
#: shape; nothing falls back
_BY_DEVICE = {"cuda": moe_matmul, "cpu": moe_matmul_ref,
              "meta": moe_matmul_meta}
#: the same for the training path: (forward, dX, dW)
_TRAIN_BY_DEVICE = {"cuda": (moe_matmul, moe_matmul_dx, moe_matmul_dw),
                    "cpu": (moe_matmul_ref, moe_matmul_dx_ref,
                            moe_matmul_dw_ref),
                    "meta": (moe_matmul_meta, moe_matmul_dx_meta,
                             moe_matmul_dw_meta)}


def _fns(table, t: torch.Tensor):
    fns = table.get(t.device.type)
    if fns is None:
        raise ValueError(f"expert_gemm: unsupported device {t.device}")
    return fns


class ExpertGemm(torch.autograd.Function):
    """[E,C,D] @ [E,D,F] with its gradient: saves x and w; the backward
    launches dX only when x needs a gradient and dW only when w does, on
    the output's gradient made contiguous first (the kernels read it
    dense: a loss such as ``y.sum()`` hands a broadcast view)."""

    @staticmethod
    @charged_unit
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        fwd = _fns(_TRAIN_BY_DEVICE, x)[0]
        charge("moe_matmul", x, w)
        return fwd(x, w)

    @staticmethod
    @charged_unit
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        _, fdx, fdw = _fns(_TRAIN_BY_DEVICE, dy)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            charge("moe_matmul_dx", dy, w)
            dx = fdx(dy, w)
        if ctx.needs_input_grad[1]:
            charge("moe_matmul_dw", x, dy)
            dw = fdw(x, dy)
        return dx, dw


@charged_unit
def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM over the dispatched buffer: [E,C,D] @ [E,D,F]."""
    fn = _fns(_BY_DEVICE, x)
    with torch.profiler.record_function("moe.expert_gemm"):
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return ExpertGemm.apply(x, w)
        charge("moe_matmul", x, w)
        return fn(x, w)


__all__ = ["ExpertGemm", "expert_gemm"]

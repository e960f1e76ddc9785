"""Public entry for the RG-LRU's prefill recurrence, in the profiler range
``rglru.scan``.

When grad mode is on and an input requires grad, ``linear_recurrence``
goes through ``LinearRecurrence``, an autograd Function: its forward
launches the scan kernel and its backward the reverse-scan kernel
(``rglru_scan_bwd``) on a CUDA tensor, and takes the plain versions
(``rglru_ref``, ``rglru_bwd_ref``) on a CPU tensor, so the CPU tests run
the Function the card runs.  Otherwise the call is the serving one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref
from repro_torch.kernels.rglru_scan.rglru_scan import (
    rglru_scan, rglru_scan_bwd, rglru_scan_bwd_meta, rglru_scan_meta)

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version, ``meta`` makes the outputs'
#: shapes; nothing falls back
_BY_DEVICE = {"cuda": rglru_scan, "cpu": rglru_ref, "meta": rglru_scan_meta}
#: the same for the training path: (forward, backward)
_TRAIN_BY_DEVICE = {"cuda": (rglru_scan, rglru_scan_bwd),
                    "cpu": (rglru_ref, rglru_bwd_ref),
                    "meta": (rglru_scan_meta, rglru_scan_bwd_meta)}


def _fns(table, t: torch.Tensor):
    fns = table.get(t.device.type)
    if fns is None:
        raise ValueError(f"linear_recurrence: unsupported device "
                         f"{t.device}")
    return fns


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data on a 16-byte boundary, as the reverse
    scan's TMA route reads it: a copy where a contiguous view starts off
    one (a slice of a larger gradient)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class LinearRecurrence(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t with its gradient: saves a, h and h0; the
    backward takes h's gradient contiguous and 16-byte aligned (zeros
    when h is unused) and hT's as it comes (None when hT is unused: the
    kernel reads no zeros)."""

    @staticmethod
    @charged_unit
    def forward(ctx, a, b, h0):
        ctx.set_materialize_grads(False)
        fwd = _fns(_TRAIN_BY_DEVICE, a)[0]
        charge("rglru_scan", a, b, h0)
        h, hT = fwd(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, hT

    @staticmethod
    @charged_unit
    def backward(ctx, dh, dhT):
        a, h, h0 = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else _aligned(dh)
        if dhT is not None:
            dhT = dhT.contiguous()
        bwd = _fns(_TRAIN_BY_DEVICE, a)[1]
        charge("rglru_scan_bwd", a, h, h0, dh, dhT)
        da, db, dh0 = bwd(a, h, h0, dh, dhT)
        return tuple(g if need else None
                     for g, need in zip((da, db, dh0),
                                        ctx.needs_input_grad))


@charged_unit
def linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over [B, T, W]; returns (h, h_T)."""
    fn = _fns(_BY_DEVICE, a)
    with torch.profiler.record_function("rglru.scan"):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                        or h0.requires_grad):
            return LinearRecurrence.apply(a, b, h0)
        charge("rglru_scan", a, b, h0)
        return fn(a, b, h0)


__all__ = ["LinearRecurrence", "linear_recurrence"]

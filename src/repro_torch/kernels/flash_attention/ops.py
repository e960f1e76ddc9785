"""Public entry for prefill attention: the model's ``[B, S, H, D]``
layout in and out, the kernel's ``[B, H, S, D]`` inside.

The head-major operands are transposed views of the model's tensors (no
copy): the CUDA kernels read any strides over (B, heads, S) with the
head dimension contiguous.  The call runs in the profiler range
``attention.flash``.

When grad mode is on and an input requires grad, ``mha`` goes through
``FlashAttention``, an autograd Function: its forward launches the flash
kernel with ``with_lse`` and its backward the backward kernel
(``flash_attention_bwd``) on a CUDA tensor, and takes the plain versions
(``attention_fwd_ref``, ``attention_bwd_ref``) on a CPU tensor, so the CPU
tests run the Function the card runs.  Otherwise the call is the serving
one, one forward launch without the log-sum-exp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_meta,
    flash_attention_meta)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)


def _flash_fwd(q, k, v, **kw):
    return flash_attention(q, k, v, with_lse=True, **kw)


def _flash_fwd_meta(q, k, v, **kw):
    return flash_attention_meta(q, k, v, with_lse=True, **kw)


#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version, ``meta`` makes the output's
#: shape; nothing falls back
_BY_DEVICE = {"cuda": flash_attention, "cpu": attention_ref,
              "meta": flash_attention_meta}
#: the same for the training path: (forward with lse, backward)
_TRAIN_BY_DEVICE = {"cuda": (_flash_fwd, flash_attention_bwd),
                    "cpu": (attention_fwd_ref, attention_bwd_ref),
                    "meta": (_flash_fwd_meta, flash_attention_bwd_meta)}


def _train_fns(t: torch.Tensor):
    fns = _TRAIN_BY_DEVICE.get(t.device.type)
    if fns is None:
        raise ValueError(f"mha: unsupported device {t.device}")
    return fns


class FlashAttention(torch.autograd.Function):
    """Head-major attention with its gradient: saves q, k, v, the output
    and the log-sum-exp, and hands the backward the output's gradient as
    it comes when it is a strided view (the kernel reads its strides, as
    the transpose a cross-entropy loss hands it), but copies it
    contiguous first when a stride is 0: a loss such as ``out.sum()``
    hands a broadcast view, which the bfloat16 route's TMA cannot read."""

    @staticmethod
    @charged_unit
    def forward(ctx, q, k, v, causal, window, cap, q_offset):
        fwd = _train_fns(q)[0]
        opts = dict(causal=causal, window=window, cap=cap, q_offset=q_offset)
        charge("flash_attention", q, k, v, with_lse=True, **opts)
        o, lse = fwd(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    @charged_unit
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if 0 in do.stride():
            do = do.contiguous()
        bwd = _train_fns(do)[1]
        charge("flash_attention_bwd", q, k, v, o, lse, do, **ctx.opts)
        dq, dk, dv = bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


@charged_unit
def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, cap: float = 0.0,
        q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,D]; k/v [B,Sk,KV,D] -> [B,Sq,H,D] (positions are
    indices: causal and window masks need Sk = Sq, or Sk >= q_offset + Sq
    with query row i at position ``q_offset + i``; without them the keys
    may be of any length, as for cross-attention)."""
    fn = _BY_DEVICE.get(q.device.type)
    if fn is None:
        raise ValueError(f"mha: unsupported device {q.device}")
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    with torch.profiler.record_function("attention.flash"):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            out = FlashAttention.apply(qh, kh, vh, causal, window, cap,
                                       q_offset)
        else:
            opts = dict(causal=causal, window=window, cap=cap,
                        q_offset=q_offset)
            charge("flash_attention", qh, kh, vh, **opts)
            out = fn(qh, kh, vh, **opts)
    return out.transpose(1, 2)


__all__ = ["FlashAttention", "mha"]

"""Public entry for the mLSTM cell's chunkwise recurrence, in the
profiler range ``mlstm.chunk``.

When grad mode is on and an input requires grad, ``mlstm`` goes through
``MlstmChunk``, an autograd Function: its forward launches the chunk
kernel and its backward the chunk backward kernel (``mlstm_chunk_bwd``)
on a CUDA tensor, and takes the plain versions (``mlstm_chunk_ref``,
``mlstm_chunk_bwd_ref``) on a CPU tensor, so the CPU tests run the
Function the card runs.  Otherwise the call is the serving one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
    mlstm_chunk, mlstm_chunk_bwd, mlstm_chunk_bwd_meta, mlstm_chunk_meta,
    mlstm_decode_block, mlstm_decode_block_meta)
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_bwd_ref,
                                                 mlstm_chunk_ref,
                                                 mlstm_decode_block_ref)

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version, ``meta`` makes the outputs'
#: shapes; nothing falls back
_BY_DEVICE = {"cuda": mlstm_chunk, "cpu": mlstm_chunk_ref,
              "meta": mlstm_chunk_meta}
#: the same for the decode step on a block of the state's key rows
_BLOCK_BY_DEVICE = {"cuda": mlstm_decode_block,
                    "cpu": mlstm_decode_block_ref,
                    "meta": mlstm_decode_block_meta}
#: the same for the training path: (forward, backward)
_TRAIN_BY_DEVICE = {"cuda": (mlstm_chunk, mlstm_chunk_bwd),
                    "cpu": (mlstm_chunk_ref, mlstm_chunk_bwd_ref),
                    "meta": (mlstm_chunk_meta, mlstm_chunk_bwd_meta)}


def _fns(table, t: torch.Tensor):
    fns = table.get(t.device.type)
    if fns is None:
        raise ValueError(f"mlstm: unsupported device {t.device}")
    return fns


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data on 16 bytes, a copy where it is not:
    the backward's ``wgmma`` route reads dh by TMA."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class MlstmChunk(torch.autograd.Function):
    """The chunkwise mLSTM with its gradient: saves the inputs (q, k, v,
    the gates and the initial state), not h; the backward takes h's
    gradient contiguous and 16-byte aligned (zeros when h is unused) and
    the final state's as they come (None when unused: the kernel reads no
    zeros).  dq, dk, dv come back in q's dtype, the gates' and the
    state's in float32.  The backward holds the stabiliser mx constant but for the final
    state's residual dm1 - <dC1, C1> - <dn1, n1>, which it routes to the
    max that sets mx (``ref.py``): the gradient is exact for any seeds of
    the final state, and the same at any chunk length."""

    @staticmethod
    @charged_unit
    def forward(ctx, q, k, v, i_pre, f_pre, C0, n0, m0, scale):
        ctx.set_materialize_grads(False)
        fwd = _fns(_TRAIN_BY_DEVICE, q)[0]
        charge("mlstm_chunk", q, k, v, i_pre, f_pre, C0, n0, m0, scale)
        out = fwd(q, k, v, i_pre, f_pre, C0, n0, m0, scale)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, C0, n0, m0)
        ctx.scale = scale
        return out

    @staticmethod
    @charged_unit
    def backward(ctx, dh, dC1, dn1, dm1):
        saved = ctx.saved_tensors
        q = saved[0]
        dh = torch.zeros_like(q) if dh is None else _aligned(dh)
        dstate = tuple(None if g is None else g.contiguous()
                       for g in (dC1, dn1, dm1))
        bwd = _fns(_TRAIN_BY_DEVICE, q)[1]
        charge("mlstm_chunk_bwd", *saved, ctx.scale, dh, *dstate)
        grads = bwd(*saved, ctx.scale, dh, *dstate)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + \
            (None,)


@charged_unit
def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_pre: torch.Tensor, f_pre: torch.Tensor, C0: torch.Tensor,
          n0: torch.Tensor, m0: torch.Tensor, scale: float
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, S, H, D] (q unscaled); gates [B, S, H] float32; state
    (C0 [B, H, D, D], n0 [B, H, D], m0 [B, H]) -> (h [B, S, H, D] in q's
    dtype, C1, n1, m1)."""
    fn = _fns(_BY_DEVICE, q)
    with torch.profiler.record_function("mlstm.chunk"):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, i_pre, f_pre, C0, n0,
                                          m0)):
            return MlstmChunk.apply(q, k, v, i_pre, f_pre, C0, n0, m0,
                                    scale)
        charge("mlstm_chunk", q, k, v, i_pre, f_pre, C0, n0, m0, scale)
        return fn(q, k, v, i_pre, f_pre, C0, n0, m0, scale)


@charged_unit
def mlstm_decode_block_step(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, i_pre: torch.Tensor,
                            f_pre: torch.Tensor, C0: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor, scale: float
                            ) -> Tuple[torch.Tensor, ...]:
    """One decode step on a block of DK of the state's D key rows: q, k
    [B, 1, H, DK] (the block's rows, q unscaled), v [B, 1, H, D], gates
    [B, 1, H] float32, C0 [B, H, DK, D], n0 [B, H, DK], m0 [B, H] ->
    (num [B, H, D], den [B, H], C1, n1, m1), num and den the block's
    partial sums, undivided (``ref.mlstm_decode_block_ref``); the
    decode kernel's key-block mode on a CUDA tensor."""
    fn = _fns(_BLOCK_BY_DEVICE, q)
    with torch.profiler.record_function("mlstm.decode_block"):
        charge("mlstm_decode_block", q, k, v, i_pre, f_pre, C0, n0, m0,
               scale)
        return fn(q, k, v, i_pre, f_pre, C0, n0, m0, scale)


__all__ = ["MlstmChunk", "mlstm", "mlstm_decode_block_step"]

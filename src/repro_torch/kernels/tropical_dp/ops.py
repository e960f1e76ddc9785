"""Public entries for the chain DP: the whole solve over every source
slot (``chain_dp``), and one wavefront step (``dp_wavefront_step``, the
reference's ``kernels/tropical_dp/ops.py`` entry)."""
from __future__ import annotations

import torch

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.tropical_dp.ref import chain_dp_ref, dp_step_ref
from repro_torch.kernels.tropical_dp.tropical_dp import (
    tropical_dp_chain, tropical_dp_chain_meta, tropical_dp_step)


def _chain_kernel(rate, sources, active, *tables):
    return tropical_dp_chain(rate.contiguous(), sources.long(),
                             active.contiguous(), *tables)


#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version, ``meta`` makes the outputs'
#: shapes; nothing falls back
_BY_DEVICE = {"cuda": _chain_kernel, "cpu": chain_dp_ref,
              "meta": tropical_dp_chain_meta}


@charged_unit
def chain_dp(rate: torch.Tensor, sources: torch.Tensor, active: torch.Tensor,
             order: torch.Tensor, prev_dev: torch.Tensor,
             bits_in: torch.Tensor, input_bits: torch.Tensor,
             ct: torch.Tensor, ok: torch.Tensor):
    """The chain DP over every (scenario, source slot): ``rate`` [B, U, U],
    ``sources`` [B, M], ``active`` [B, U] bool and the device order's
    tables (``core.batch.ChainDPTables``) -> ``(assign [B, M, L] int32,
    latency [B, M])``.  CUDA tensors launch the fused kernel (or its
    declared ``step`` route; or raise); CPU tensors take the plain
    version.  The two are bitwise identical."""
    fn = _BY_DEVICE.get(rate.device.type)
    if fn is None:
        raise ValueError(f"chain_dp: unsupported device {rate.device}")
    charge("tropical_dp", rate, sources, active, order, prev_dev, bits_in,
           input_bits, ct, ok)
    return fn(rate, sources, active, order, prev_dev, bits_in, input_bits,
              ct, ok)


def _step_meta(dp, tr, tr0, ct, ok):
    b, m, _, s1 = dp.shape
    shape = (b, m, s1 - 1)
    return (dp.new_empty(shape), dp.new_empty(shape, dtype=torch.int32),
            dp.new_empty(shape, dtype=torch.int32))


#: the step's implementations by device type, as ``_BY_DEVICE``
_STEP_BY_DEVICE = {"cuda": tropical_dp_step, "cpu": dp_step_ref,
                   "meta": _step_meta}


@charged_unit
def dp_wavefront_step(dp: torch.Tensor, tr: torch.Tensor, tr0: torch.Tensor,
                      ct: torch.Tensor, ok: torch.Tensor):
    """One chain-DP wavefront step over every (scenario, source slot):
    ``dp`` [B, M, L, S+1], ``tr`` [B, L, S, S+1] (a = 0 row dead), ``tr0``
    [B, M, S], ``ct`` / ``ok`` [L, S] -> (row, pa, ps), each [B, M, S].
    CUDA tensors launch the step kernel of ``csrc/tropical_dp.cu`` (the
    chain DP's ``step`` route; or raise), CPU tensors take its plain
    version ``dp_step_ref``; the two are bitwise identical."""
    fn = _STEP_BY_DEVICE.get(dp.device.type)
    if fn is None:
        raise ValueError(f"dp_wavefront_step: unsupported device "
                         f"{dp.device}")
    charge("tropical_dp_step", dp, tr, tr0, ct, ok)
    return fn(dp, tr, tr0, ct, ok)

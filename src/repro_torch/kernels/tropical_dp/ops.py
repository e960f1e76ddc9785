"""Public entry for the chain DP: the whole solve over every source slot."""
from __future__ import annotations

import torch

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.tropical_dp.ref import chain_dp_ref
from repro_torch.kernels.tropical_dp.tropical_dp import (
    tropical_dp_chain, tropical_dp_chain_meta)


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

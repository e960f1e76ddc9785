"""Public entry for the MoE layer's expert GEMMs, in the profiler range
``moe.expert_gemm``."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul
from repro_torch.kernels.moe_matmul.ref import moe_matmul_ref

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version; nothing falls back
_BY_DEVICE = {"cuda": moe_matmul, "cpu": moe_matmul_ref}


def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM over the dispatched buffer: [E,C,D] @ [E,D,F]."""
    fn = _BY_DEVICE.get(x.device.type)
    if fn is None:
        raise ValueError(f"expert_gemm: unsupported device {x.device}")
    with torch.profiler.record_function("moe.expert_gemm"):
        return fn(x, w)


__all__ = ["expert_gemm"]

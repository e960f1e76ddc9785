"""Plain PyTorch version of the grouped expert GEMM kernel: the
reference's ``moe_matmul_ref``, a float32 batched product cast back to
``x.dtype`` (``torch.matmul`` on the card runs in full float32 unless
TF32 is switched on)."""
from __future__ import annotations

import torch


def moe_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] (fp32 accumulation)."""
    return torch.matmul(x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


__all__ = ["moe_matmul_ref"]

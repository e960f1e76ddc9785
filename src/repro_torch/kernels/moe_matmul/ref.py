"""Plain PyTorch versions of the grouped expert GEMM kernels: the
reference's ``moe_matmul_ref``, a float32 batched product cast back to
``x.dtype`` (``torch.matmul`` on the card runs in full float32 unless
TF32 is switched on), and the backward's two products the same way."""
from __future__ import annotations

import torch


def moe_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] (fp32 accumulation)."""
    return torch.matmul(x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


def moe_matmul_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy [E, C, F] @ w [E, D, F]^T -> dx [E, C, D] (fp32 accumulation,
    in ``dy.dtype``)."""
    return torch.matmul(dy.to(torch.float32),
                        w.to(torch.float32).transpose(1, 2)).to(dy.dtype)


def moe_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x [E, C, D]^T @ dy [E, C, F] -> dw [E, D, F] (fp32 accumulation,
    in ``x.dtype``; zeros for C = 0)."""
    return torch.matmul(x.to(torch.float32).transpose(1, 2),
                        dy.to(torch.float32)).to(x.dtype)


__all__ = ["moe_matmul_dw_ref", "moe_matmul_dx_ref", "moe_matmul_ref"]

"""Plain PyTorch versions of the conv2d kernel: the GEMM with bias and
ReLU, and a direct convolution as the oracle of the whole layer.

Layouts are the reference's: x NHWC, w HWIO, output NHWC.  Both compute
in full float32: ``torch.matmul`` on a CUDA card does unless TF32 is
switched on, and ``conv2d_ref`` turns cuDNN's TF32 (on by default) off
around its ``F.conv2d``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               relu: bool = True) -> torch.Tensor:
    """x [M, K] @ w [K, N] + b [N], then ReLU when ``relu``, in float32."""
    y = x.to(torch.float32) @ w.to(torch.float32) + b
    y = torch.clamp_min(y, 0.0) if relu else y
    return y.to(x.dtype)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               stride: int = 1, padding: int = 0,
               relu: bool = True) -> torch.Tensor:
    """x [N, H, W, C]; w [KH, KW, C, OC]; b [OC] -> [N, OH, OW, OC]."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride, padding=padding)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    y = y.permute(0, 2, 3, 1) + b
    return torch.clamp_min(y, 0.0) if relu else y

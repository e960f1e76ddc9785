"""Public entry for the conv layer: im2col layout (plain PyTorch) plus the
GEMM with fused bias and ReLU (the kernel), in the profiler ranges
``conv2d.im2col`` and ``conv2d.gemm``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d.conv2d import matmul_bias_act
from repro_torch.kernels.conv2d.ref import matmul_ref

#: tensor device type -> GEMM: CUDA launches the kernel (or raises), the
#: CPU takes the plain version; nothing falls back
_BY_DEVICE = {"cuda": matmul_bias_act, "cpu": matmul_ref}


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """x [N, H, W, C] -> (patches [N*OH*OW, KH*KW*C], (N, OH, OW)).

    The feature axis is in (KH, KW, C) order, the order of the HWIO
    filter's ``reshape(KH*KW*C, OC)``.  The windows are a strided view of
    the padded input; the one copy is the final reshape.
    """
    n = x.shape[0]
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    win = x.unfold(1, kh, stride).unfold(2, kw, stride)   # [N,OH,OW,C,KH,KW]
    oh, ow = win.shape[1], win.shape[2]
    patches = win.permute(0, 1, 2, 4, 5, 3)              # [N,OH,OW,KH,KW,C]
    return patches.reshape(n * oh * ow, -1), (n, oh, ow)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           stride: int = 1, padding: int = 0,
           relu: bool = True) -> torch.Tensor:
    """im2col conv: x [N, H, W, C]; w [KH, KW, C, OC]; b [OC] ->
    [N, OH, OW, OC] float32.  On a CUDA tensor the GEMM launches the
    kernel (or raises); on a CPU tensor it takes the plain version."""
    gemm = _BY_DEVICE.get(x.device.type)
    if gemm is None:
        raise ValueError(f"conv2d: unsupported device {x.device}")
    kh, kw, c, oc = w.shape
    with torch.profiler.record_function("conv2d.im2col"):
        patches, (n, oh, ow) = _im2col(x, kh, kw, stride, padding)
        patches = patches.contiguous()
    with torch.profiler.record_function("conv2d.gemm"):
        y = gemm(patches, w.reshape(kh * kw * c, oc).contiguous(),
                 b.contiguous(), relu=relu)
    return y.reshape(n, oh, ow, oc)

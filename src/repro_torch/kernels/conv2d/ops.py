"""Public entry for the conv layer: im2col layout (plain PyTorch) plus the
GEMM with fused bias and ReLU (the kernel), in the profiler ranges
``conv2d.im2col`` and ``conv2d.gemm``.

The patch matrix's feature axis is padded with zero columns to a multiple
of 4 (AlexNet's conv1: 363 -> 364), and the filter matrix with zero rows,
so every conv's GEMM takes the kernel's ``wgmma`` route (TMA needs 16-byte
row strides).  The zeros are written in the one copy that lays the
patches out, on every device."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.conv2d.conv2d import (matmul_bias_act,
                                               matmul_bias_act_meta)
from repro_torch.kernels.conv2d.ref import matmul_ref

#: tensor device type -> GEMM: CUDA launches the kernel (or raises), the
#: CPU takes the plain version, ``meta`` makes the output's shape;
#: nothing falls back
_BY_DEVICE = {"cuda": matmul_bias_act, "cpu": matmul_ref,
              "meta": matmul_bias_act_meta}


#: the GEMM's K is padded to a multiple of this many features
K_MULTIPLE = 4


def _windows(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """x [N, H, W, C] -> the windows [N, OH, OW, KH, KW, C], a strided view
    of the (zero-)padded input."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    win = x.unfold(1, kh, stride).unfold(2, kw, stride)   # [N,OH,OW,C,KH,KW]
    return win.permute(0, 1, 2, 4, 5, 3)


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """x [N, H, W, C] -> (patches [N*OH*OW, KH*KW*C], (N, OH, OW)).

    The feature axis is in (KH, KW, C) order, the order of the HWIO
    filter's ``reshape(KH*KW*C, OC)``.  The windows are a strided view of
    the padded input; the one copy is the final reshape.
    """
    patches = _windows(x, kh, kw, stride, padding)     # [N,OH,OW,KH,KW,C]
    n, oh, ow = patches.shape[:3]
    return patches.reshape(n * oh * ow, -1), (n, oh, ow)


def _im2col_padded(x: torch.Tensor, kh: int, kw: int, stride: int,
                   padding: int):
    """``_im2col``'s patches (the reference's layout, which the tests hold
    it to) with zero feature columns up to a multiple of ``K_MULTIPLE``:
    (patches [N*OH*OW, Kp] contiguous, (N, OH, OW)), made in one copy of
    the windows plus the zero columns."""
    k = kh * kw * x.shape[-1]
    kp = -(-k // K_MULTIPLE) * K_MULTIPLE
    win = _windows(x, kh, kw, stride, padding)
    n, oh, ow = win.shape[:3]
    patches = torch.empty((n * oh * ow, kp), dtype=x.dtype, device=x.device)
    patches[:, k:].zero_()
    patches[:, :k].view(win.shape).copy_(win)
    return patches, (n, oh, ow)


@charged_unit
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
        patches, (n, oh, ow) = _im2col_padded(x, kh, kw, stride, padding)
        wm = w.reshape(kh * kw * c, oc)
        if patches.shape[1] != wm.shape[0]:
            wm = torch.cat([wm, wm.new_zeros(
                (patches.shape[1] - wm.shape[0], oc))])
    wm, b = wm.contiguous(), b.contiguous()
    charge("conv2d", patches, wm, b)
    with torch.profiler.record_function("conv2d.gemm"):
        y = gemm(patches, wm, b, relu=relu)
    return y.reshape(n, oh, ow, oc)

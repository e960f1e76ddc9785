"""CUDA wrapper for the conv layer's GEMM with fused bias and ReLU
(``csrc/conv2d.cu``).

Replaces the Pallas kernel ``src/repro/kernels/conv2d/conv2d.py``
(``matmul_bias_act``): ``[M, K] @ [K, N] + b[N]``, optional ReLU, float32
throughout.  Bound by operations at the CNN path's shapes; the kernel is a
64 x 64 shared-memory tiled SIMT GEMM with the K loop inside the block,
fp32 ``fmaf`` products (no TF32) and masked ragged edges, deterministic
launch to launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def matmul_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    relu: bool = True) -> torch.Tensor:
    """x [M, K], w [K, N], b [N], each a contiguous CUDA float32 tensor on
    one device -> y [M, N] float32, on the current stream without
    synchronising."""
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"matmul_bias_act: want x [M, K], w [K, N], b [N]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    M, K = x.shape
    N = w.shape[1]
    for name, t, shape in (("x", x, (M, K)), ("w", w, (K, N)),
                           ("b", b, (N,))):
        if t.device != x.device or t.device.type != "cuda" or \
                t.dtype != torch.float32 or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(
                f"matmul_bias_act: {name} must be a contiguous CUDA float32 "
                f"tensor of shape {shape} on {x.device}; got {t.device} "
                f"{t.dtype} {tuple(t.shape)}")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("conv2d")
    fn = lib.repro_matmul_bias_act
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 M, N, K, int(relu), stream)
    _build.check_launch(lib, "matmul_bias_act", err)
    matmul_bias_act.launches += 1
    return y


matmul_bias_act.launches = 0

"""CUDA wrapper for the grouped expert GEMM (``csrc/moe_matmul.cu``).

Replaces the Pallas kernel ``src/repro/kernels/moe_matmul/moe_matmul.py``
(``moe_matmul``): ``y[e] = x[e] @ w[e]`` over the capacity-dispatched
buffer, float32 accumulation from float32 or bfloat16 operands, output
in ``x.dtype``.  Bound by operations at olmoe's prefill and by the
weight bytes at its decode; the kernel is a shared-memory tiled SIMT GEMM
with a grid axis over the experts, 64 x 64 tiles for C > 16 rows and
16 x 64 tiles (each weight read once) for the decode's few rows, fp32
``fmaf`` products, masked ragged edges, deterministic launch to launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 65535        # the grid's z extent


def moe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D], w [E, D, F]: contiguous CUDA tensors of one dtype
    (float32 or bfloat16) on one device -> y [E, C, F] in ``x.dtype``, on
    the current stream without synchronising."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_matmul: want x [E, C, D] and w [E, D, F]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[2]
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_matmul: {E} experts, at most {MAX_EXPERTS}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or t.device.type != "cuda" or \
                t.dtype not in _DTYPES or t.dtype != x.dtype or \
                not t.is_contiguous():
            raise ValueError(
                f"moe_matmul: {name} must be a contiguous CUDA float32 or "
                f"bfloat16 tensor of x's dtype on {x.device}; got "
                f"{t.device} {t.dtype}")
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("moe_matmul")
    fn = lib.repro_moe_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, D, F,
                 _DTYPES[x.dtype], stream)
    _build.check_launch(lib, "moe_matmul", err)
    moe_matmul.launches += 1
    return y


moe_matmul.launches = 0

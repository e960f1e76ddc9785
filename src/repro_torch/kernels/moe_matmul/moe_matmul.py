"""CUDA wrapper for the grouped expert GEMM (``csrc/moe_matmul.cu``).

Replaces the Pallas kernel ``src/repro/kernels/moe_matmul/moe_matmul.py``
(``moe_matmul``): ``y[e] = x[e] @ w[e]`` over the capacity-dispatched
buffer, float32 accumulation from float32 or bfloat16 operands, output
in ``x.dtype``.  Bound by operations at olmoe's prefill (2 E C D F flops
at 989 bf16 TFLOP/s) and by the weight bytes at its decode (E D F bf16
values at 3.35 TB/s).  Two routes, counted in
``moe_matmul.launches_by_route``:

* ``wgmma`` (bfloat16 with D and F multiples of 8; such operands must
  be 16-byte aligned, TMA's base address): TMA loads through a ring of shared-memory stages fed by a
  producer warp, ``wgmma`` products into fp32 registers; 128 x 128 tiles
  over two consumer warpgroups for C > 16, and for C <= 16 the swapped
  product ``y^T = w^T x^T`` (F as the MMA's 64 rows, C as its 8 or 16
  columns) streaming the weights through an 8-stage ring;
* ``simt`` (float32, and bfloat16 with D or F not a multiple of 8): the
  shared-memory tiled SIMT GEMM with fp32 ``fmaf`` products.

Masked ragged edges, no split-K, deterministic launch to launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, refuse_grad

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
             + [ctypes.POINTER(ctypes.c_int)])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 65535        # the grid's z extent
#: launcher route codes
ROUTES = ("simt", "wgmma")


def moe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D], w [E, D, F]: contiguous CUDA tensors of one dtype
    (float32 or bfloat16) on one device -> y [E, C, F] in ``x.dtype``, on
    the current stream without synchronising.  Raises under grad."""
    refuse_grad("moe_matmul", "14.6 (MoE training: the backward as grouped "
                "GEMMs on transposed operands)", x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_matmul: want x [E, C, D] and w [E, D, F]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[2]
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_matmul: {E} experts, at most {MAX_EXPERTS}")
    # the bf16 route reads by TMA: 16-byte aligned base addresses
    if x.dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 and \
            (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(
            f"moe_matmul: bfloat16 operands with D and F multiples of 8 are "
            f"read by TMA and need 16-byte aligned data; got data_ptr % 16 "
            f"= {x.data_ptr() % 16}, {w.data_ptr() % 16}")
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
    route = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, D, F,
                 _DTYPES[x.dtype], stream, ctypes.byref(route))
    _build.check_launch(lib, "moe_matmul", err)
    moe_matmul.launches += 1
    moe_matmul.launches_by_route[ROUTES[route.value]] += 1
    return y


moe_matmul.launches = 0
moe_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)

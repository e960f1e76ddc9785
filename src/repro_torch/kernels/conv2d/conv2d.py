"""CUDA wrapper for the conv layer's GEMM with fused bias and ReLU
(``csrc/conv2d.cu``).

Replaces the Pallas kernel ``src/repro/kernels/conv2d/conv2d.py``
(``matmul_bias_act``): ``[M, K] @ [K, N] + b[N]``, optional ReLU, float32
in and out, float32-accurate products.  Bound by operations at the CNN
path's shapes.  Two routes, chosen from the shape (``gemm_route``) and
counted in ``matmul_bias_act.launches_by_route``:

* ``wgmma`` (K a multiple of 4, TMA's 16-byte row stride; x must be
  16-byte aligned, TMA's base address): 3xTF32 on the tensor cores.  A
  pre-pass kernel splits ``w`` transposed into tf32 high and low parts
  (scratch from ``torch.empty``); the GEMM streams x and both parts by TMA
  through a 4-stage ring, splits x in shared memory and accumulates
  ``lo.hi + hi.lo + hi.hi`` with ``wgmma`` into float32 registers, 128 x
  ``conv_tile_n`` output tiles; two CUDA launches a call;
* ``simt`` (other K): the 64 x 64 shared-memory tiled SIMT GEMM with fp32
  ``fmaf`` products; one launch.

Masked ragged edges, no split-K, deterministic launch to launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 3)
#: launcher route codes
ROUTES = ("simt", "wgmma")
#: the wgmma route's output tile: 128 rows by one of these columns
TILE_NS = (64, 96, 128)


def gemm_route(k: int) -> str:
    """``wgmma`` where TMA can read x's rows (K a positive multiple of 4:
    a 16-byte row stride), else ``simt``."""
    return "wgmma" if k > 0 and k % 4 == 0 else "simt"


def conv_tile_n(m: int, n: int, n_sm: int) -> int:
    """The wgmma route's tile width for an [M, N] output: 64 where N <= 64,
    96 where N <= 96 (AlexNet's conv1), else 128, narrowed to 64 where 128
    x 128 tiles would fill less than one wave of ``n_sm`` SMs."""
    if n <= 64:
        return 64
    if n <= 96:
        return 96
    if -(-m // 128) * -(-n // 128) < n_sm:
        return 64
    return 128


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
    route = gemm_route(K)
    # the wgmma route reads x by TMA: a 16-byte aligned base address
    if route == "wgmma" and x.data_ptr() % 16:
        raise ValueError(
            f"matmul_bias_act: with K a multiple of 4 x is read by TMA and "
            f"needs 16-byte aligned data; got data_ptr % 16 = "
            f"{x.data_ptr() % 16}")
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
    tile_n, w_split = 0, None
    if route == "wgmma":
        tile_n = conv_tile_n(M, N, sm_count(x.device))
        w_split = torch.empty((2, N, K), dtype=torch.float32, device=x.device)
    lib = _build.load("conv2d")
    fn = lib.repro_matmul_bias_act
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 M, N, K, int(relu), ROUTES.index(route), tile_n,
                 None if w_split is None else w_split[0].data_ptr(),
                 None if w_split is None else w_split[1].data_ptr(), stream)
    _build.check_launch(lib, "matmul_bias_act", err)
    matmul_bias_act.launches += 1
    matmul_bias_act.launches_by_route[route] += 1
    return y


matmul_bias_act.launches = 0
matmul_bias_act.launches_by_route = dict.fromkeys(ROUTES, 0)


def matmul_bias_act_meta(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         *, relu: bool = True) -> torch.Tensor:
    """``matmul_bias_act`` on ``meta``: y [M, N] float32 and, on the
    ``wgmma`` route, the split filter's scratch the card's wrapper
    allocates; no launch, no arithmetic."""
    del b, relu
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() and gemm_route(K) == "wgmma":
        torch.empty((2, N, K), dtype=torch.float32, device=x.device)
    return y

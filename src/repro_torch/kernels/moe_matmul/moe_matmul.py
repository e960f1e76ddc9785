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

The backward (``csrc/moe_matmul_bwd.cu``; no Pallas kernel has one: the
reference leaves its einsum's gradient to XLA) is two more grouped
GEMMs over the same layouts, ``moe_matmul_dx`` (``dx = dy w^T``) and
``moe_matmul_dw`` (``dw = x^T dy``), on the forward's two routes by the
forward's rule (``bwd_route``), counted in ``launches_by_route``:

* ``wgmma``: the forward's 128 x 128 TMA + ``wgmma`` tile
  (``csrc/moe_gemm.cuh``) with other operand majorness, each operand read
  by TMA in place (dX: dy and w both with F contiguous; dW: x and dy
  both with the reduced C as their rows);
* ``simt``: the forward's SIMT tiles with the operands' majorness as a
  template parameter.

``ops.expert_gemm`` calls the three through an autograd Function when a
gradient is wanted; the bare forward refuses to run under grad (its
output would carry no gradient).
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
#: the backward launchers' route codes
BWD_ROUTES = ("simt", "wgmma")


def check_operands(fn: str, *named: tuple) -> None:
    """Raise unless every ``(name, tensor)`` is a contiguous CUDA float32
    or bfloat16 tensor of the first one's dtype and device."""
    ref = named[0][1]
    for name, t in named:
        if t.device != ref.device or t.device.type != "cuda" or \
                t.dtype not in _DTYPES or t.dtype != ref.dtype or \
                not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous CUDA float32 or "
                f"bfloat16 tensor of {named[0][0]}'s dtype on "
                f"{ref.device}; got {t.device} {t.dtype}")


def check_launchable(fn: str, d: int, f: int, *named: tuple) -> None:
    """Refuse more experts than the grid's z extent (``MAX_EXPERTS``), and
    bfloat16 operands with D and F multiples of 8 (read by TMA on the
    ``wgmma`` route, forward and backward alike) whose data is off 16
    bytes, before building."""
    e = named[0][1].shape[0]
    if e > MAX_EXPERTS:
        raise ValueError(f"{fn}: {e} experts, at most {MAX_EXPERTS}")
    if named[0][1].dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0 \
            and any(t.data_ptr() % 16 for _, t in named):
        raise ValueError(
            f"{fn}: bfloat16 operands with D and F multiples of 8 are "
            f"read by TMA and need 16-byte aligned data; got data_ptr % 16 "
            f"= {', '.join(str(t.data_ptr() % 16) for _, t in named)}")


def moe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D], w [E, D, F]: contiguous CUDA tensors of one dtype
    (float32 or bfloat16) on one device -> y [E, C, F] in ``x.dtype``, on
    the current stream without synchronising.  Raises under grad: the
    training path goes through ``ops.expert_gemm``."""
    refuse_grad("moe_matmul", "14.6: call ops.expert_gemm, whose autograd "
                "Function launches moe_matmul_dx and moe_matmul_dw", x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_matmul: want x [E, C, D] and w [E, D, F]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[2]
    check_launchable("moe_matmul", D, F, ("x", x), ("w", w))
    check_operands("moe_matmul", ("x", x), ("w", w))
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


def bwd_route(dtype: torch.dtype, d: int, f: int) -> str:
    """The route ``moe_matmul_dx`` and ``moe_matmul_dw`` take for operands
    of ``dtype`` at widths D and F: ``wgmma`` for bfloat16 with D and F
    multiples of 8 (TMA's strides; ``wgmma`` has no float32 input), else
    ``simt`` (the forward's rule)."""
    return "wgmma" if dtype == torch.bfloat16 and d > 0 and d % 8 == 0 \
        and f % 8 == 0 else "simt"


def _launch_bwd(wrapper, symbol: str, a: torch.Tensor, b: torch.Tensor,
                out: torch.Tensor, dims) -> torch.Tensor:
    fn = _build.launcher("moe_matmul_bwd", symbol, _ARGTYPES)
    route = ctypes.c_int(-1)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), *dims,
                 _DTYPES[a.dtype], stream, ctypes.byref(route))
    _build.check_launch(_build.load("moe_matmul_bwd"), wrapper.__name__, err)
    wrapper.launches += 1
    wrapper.launches_by_route[BWD_ROUTES[route.value]] += 1
    return out


def moe_matmul_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The expert GEMM's input gradient: dy [E, C, F], w [E, D, F]
    (contiguous CUDA tensors of one dtype, float32 or bfloat16) -> dx
    [E, C, D] = dy w^T in ``dy.dtype``, float32 accumulation over F, on
    the current stream without synchronising."""
    if dy.dim() != 3 or w.dim() != 3 or dy.shape[0] != w.shape[0] or \
            dy.shape[2] != w.shape[2]:
        raise ValueError(f"moe_matmul_dx: want dy [E, C, F] and w "
                         f"[E, D, F]; got {tuple(dy.shape)}, "
                         f"{tuple(w.shape)}")
    E, C, F = dy.shape
    D = w.shape[1]
    check_launchable("moe_matmul_dx", D, F, ("dy", dy), ("w", w))
    check_operands("moe_matmul_dx", ("dy", dy), ("w", w))
    dx = torch.empty((E, C, D), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    return _launch_bwd(moe_matmul_dx, "repro_moe_matmul_dx", dy, w, dx,
                       (E, C, D, F))


def moe_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The expert GEMM's weight gradient: x [E, C, D], dy [E, C, F]
    (contiguous CUDA tensors of one dtype) -> dw [E, D, F] = x^T dy in
    ``x.dtype``, float32 accumulation over C in one fixed order (C = 0
    launches and gives zeros), on the current stream without
    synchronising."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"moe_matmul_dw: want x [E, C, D] and dy "
                         f"[E, C, F]; got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    E, C, D = x.shape
    F = dy.shape[2]
    check_launchable("moe_matmul_dw", D, F, ("x", x), ("dy", dy))
    check_operands("moe_matmul_dw", ("x", x), ("dy", dy))
    dw = torch.empty((E, D, F), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    return _launch_bwd(moe_matmul_dw, "repro_moe_matmul_dw", x, dy, dw,
                       (E, C, D, F))


moe_matmul_dx.launches = moe_matmul_dw.launches = 0
moe_matmul_dx.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)
moe_matmul_dw.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


def moe_matmul_meta(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``moe_matmul`` on ``meta``: y [E, C, F] in ``x.dtype``; no launch,
    no arithmetic."""
    refuse_grad("moe_matmul", "14.6: call ops.expert_gemm, whose autograd "
                "Function launches moe_matmul_dx and moe_matmul_dw", x, w)
    E, C, _ = x.shape
    return torch.empty((E, C, w.shape[2]), dtype=x.dtype, device=x.device)


def moe_matmul_dx_meta(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``moe_matmul_dx`` on ``meta``: dx [E, C, D]; no launch, no
    arithmetic."""
    E, C, _ = dy.shape
    return torch.empty((E, C, w.shape[1]), dtype=dy.dtype, device=dy.device)


def moe_matmul_dw_meta(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``moe_matmul_dw`` on ``meta``: dw [E, D, F]; no launch, no
    arithmetic."""
    E, _, D = x.shape
    return torch.empty((E, D, dy.shape[2]), dtype=x.dtype, device=x.device)

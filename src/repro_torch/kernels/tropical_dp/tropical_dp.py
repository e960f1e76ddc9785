"""CUDA wrapper for the chain-DP wavefront step (``csrc/tropical_dp.cu``).

Replaces the Pallas kernel ``src/repro/kernels/tropical_dp/tropical_dp.py``
(``tropical_dp_step``).  Bound by bytes (an L x (S+1) dp slab and transfer
slice per output) and, at the planner's shapes, by launch overhead; the
kernel runs one thread per output (b, m, s) in the reference's staged
min/argmin order, so it equals ``ref.dp_step_ref`` bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != \
            tuple(shape):
        raise ValueError(f"tropical_dp_step: {name} must be a CUDA {dtype} "
                         f"tensor of shape {tuple(shape)}; got "
                         f"{t.device} {t.dtype} {tuple(t.shape)}")


def tropical_dp_step(dp: torch.Tensor, tr: torch.Tensor, tr0: torch.Tensor,
                     ct: torch.Tensor, ok: torch.Tensor):
    """One chain-DP wavefront step over every (scenario, source slot).

    dp  [B, M, L, S+1] float32 — dp table rows 0..L-1; the last two axes
        contiguous (a row slice of the [B, M, L+1, S+1] table is fine)
    tr  [B, L, S, S+1] float32 contiguous — masked transfer tensor
    tr0 [B, M, S]      float32 contiguous — per-slot source transfer row
    ct  [L, S]         float32 contiguous — block compute time
    ok  [L, S]         float32 contiguous — 1.0 where (a, s) is feasible

    Returns ``(row [B, M, S], pa [B, M, S] int32, ps [B, M, S] int32)``
    on the current stream, without synchronising.
    """
    B, M, L, S1 = dp.shape
    S = S1 - 1
    _check("dp", dp, (B, M, L, S1))
    if dp.stride(3) != 1 or dp.stride(2) != S1 or \
            (B > 1 and dp.stride(0) != M * dp.stride(1)):
        raise ValueError("tropical_dp_step: dp rows must be contiguous "
                         f"[L, S+1] slabs; got strides {dp.stride()}")
    _check("tr", tr, (B, L, S, S1))
    _check("tr0", tr0, (B, M, S))
    _check("ct", ct, (L, S))
    _check("ok", ok, (L, S))
    for name, t in (("tr", tr), ("tr0", tr0), ("ct", ct), ("ok", ok)):
        if not t.is_contiguous():
            raise ValueError(f"tropical_dp_step: {name} must be contiguous")
    lib = _build.load("tropical_dp")
    fn = lib.repro_tropical_dp_step
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    row = torch.empty((B, M, S), dtype=torch.float32, device=dp.device)
    pa = torch.empty((B, M, S), dtype=torch.int32, device=dp.device)
    ps = torch.empty((B, M, S), dtype=torch.int32, device=dp.device)
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream(dp.device).cuda_stream
        err = fn(dp.data_ptr(), dp.stride(1), tr.data_ptr(), tr0.data_ptr(),
                 ct.data_ptr(), ok.data_ptr(), row.data_ptr(), pa.data_ptr(),
                 ps.data_ptr(), B, M, L, S, stream)
    _build.check_launch(lib, "tropical_dp_step", err)
    tropical_dp_step.launches += 1
    return row, pa, ps


tropical_dp_step.launches = 0

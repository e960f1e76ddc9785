"""Hand-written CUDA kernels of the port, one package per kernel.

Each ``<name>/`` holds ``<name>.py`` (the ctypes wrapper of
``csrc/<name>.cu``, with a ``launches`` counter, and a
``launches_by_route`` count where the kernel has more than one route),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (the dispatcher:
CUDA tensors launch the kernel or raise, CPU tensors take the plain
version).  ``_build``
compiles the sources with ``nvcc`` at first use.  A forward wrapper
refuses to run under grad (``refuse_grad``): its output, filled through
``ctypes``, would carry no gradient.  Where the kernel has a backward
(flash attention, the expert GEMM, the RG-LRU scan, the mLSTM chunk),
``ops.py`` holds an autograd Function that launches both.
"""
from __future__ import annotations

from typing import Dict

import torch


def refuse_grad(fn: str, item: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad mode is on and one of ``tensors``
    requires grad: the kernel's output would silently carry no gradient.
    ``item`` names the ROADMAP item that brings the backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn}: the CUDA kernel has no autograd backward here, and its "
            f"output would carry no gradient (ROADMAP queue 1 item {item}); "
            f"run it under torch.no_grad() or on inputs that do not "
            f"require grad")


def _wrappers():
    from repro_torch.kernels.conv2d.conv2d import matmul_bias_act
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.link_geometry.link_geometry import link_geometry
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (mlstm_chunk,
                                                             mlstm_chunk_bwd)
    from repro_torch.kernels.moe_matmul.moe_matmul import (
        moe_matmul, moe_matmul_dw, moe_matmul_dx)
    from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_scan,
                                                           rglru_scan_bwd)
    from repro_torch.kernels.tropical_dp.tropical_dp import (
        tropical_dp_chain, tropical_dp_step)
    return {"link_geometry": link_geometry, "tropical_dp": tropical_dp_chain,
            "tropical_dp_step": tropical_dp_step, "conv2d": matmul_bias_act,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention, "moe_matmul": moe_matmul,
            "moe_matmul_dx": moe_matmul_dx, "moe_matmul_dw": moe_matmul_dw,
            "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd,
            "mlstm_chunk": mlstm_chunk, "mlstm_chunk_bwd": mlstm_chunk_bwd}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``, by kernel.
    ``tropical_dp`` counts the fused chain-DP kernel alone; a solve on the
    chain DP's ``step`` route launches L ``tropical_dp_step`` kernels (and
    runs a torch backtrack)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def route_counts() -> Dict[str, Dict[str, int]]:
    """Launches by route since the last ``reset_launch_counts``, for the
    kernels that count them (``wgmma`` / ``simt``, the
    RG-LRU scan's ``tma`` / ``simt``, the mLSTM's ``decode`` besides, the
    chain DP's ``fused`` / ``step``, where ``step`` counts the step-kernel
    launches of the solves on that route)."""
    return {name: dict(fn.launches_by_route)
            for name, fn in _wrappers().items()
            if hasattr(fn, "launches_by_route")}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", ()):
            fn.launches_by_route[route] = 0


__all__ = ["launch_counts", "refuse_grad", "reset_launch_counts",
           "route_counts"]

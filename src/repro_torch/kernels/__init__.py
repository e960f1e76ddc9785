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

Every dispatch table has a third entry, ``meta``, beside ``cuda`` and
``cpu``: it makes outputs of the kernel's shapes and dtypes (and the
workspaces the card's wrapper allocates through torch) without
arithmetic.  It launches nothing and counts no launch: the launch
counters count the card's launches only.  The dry run
(``launch.dryrun``) runs the port's entry points on it.

An active op profiler (``launch.op_analysis.OpProfiler``) sees a kernel
call as one unit on every device: each public entry of ``ops.py`` and
its autograd Function's passes run inside ``charged_unit``, where the
profiler counts none of the ops (each route's own copies and padding),
and ``charge`` records the call by name, with its work and the route the
card takes for it (``kernels.work.KERNEL_WORK``).  The host collectives
of ``parallel.sharding`` are charged units too (``charge_collective``).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch

#: the active op profilers (``launch.op_analysis.OpProfiler``), in the
#: order they were entered
PROFILERS: List = []


def charged_unit(fn):
    """Decorator of a unit the active op profilers charge as a whole (a
    kernel's public entry, its autograd Function's ``forward`` and
    ``backward``, a collective of ``parallel.sharding``): while it runs
    they count none of the ops inside it, only what it ``charge``s."""
    @functools.wraps(fn)
    def unit(*args, **kwargs):
        if not PROFILERS:
            return fn(*args, **kwargs)
        active = list(PROFILERS)
        for prof in active:
            prof.quiet += 1
        try:
            return fn(*args, **kwargs)
        finally:
            for prof in active:
                prof.quiet -= 1
    return unit


def charge(name: str, *args, **kwargs) -> None:
    """Record one call of kernel ``name`` in the active op profilers,
    with its work (and the card's route) from the operands the wrapper
    takes; nothing when no profiler is active."""
    if not PROFILERS:
        return
    from repro_torch.kernels.work import KERNEL_WORK
    work = KERNEL_WORK[name](*args, **kwargs)
    for prof in list(PROFILERS):
        prof.record_kernel(name, work)


def charge_collective(kind: str, nbytes: float, group: int,
                      shards: Optional[int] = None,
                      pod: bool = False) -> None:
    """Record one collective of ``kind`` over a group of ``group`` shards
    in the active op profilers: ``nbytes`` moved by each shard (the
    reference's accounting: an all-reduce 2x its result's bytes, a
    reduce-scatter its result's bytes times the group, the others 1x),
    charged for ``shards`` of them (default the whole group; a program
    that runs one position of a mesh charges that one), ``pod`` when the
    group crosses pods."""
    for prof in list(PROFILERS):
        prof.record_collective(kind, nbytes, group,
                               group if shards is None else shards, pod)


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
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        mlstm_chunk, mlstm_chunk_bwd, mlstm_decode_block)
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
            "mlstm_chunk": mlstm_chunk, "mlstm_chunk_bwd": mlstm_chunk_bwd,
            "mlstm_decode_block": mlstm_decode_block}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``, by kernel.
    ``tropical_dp`` counts the fused chain-DP kernel alone; a solve on the
    chain DP's ``step`` route launches L ``tropical_dp_step`` kernels (and
    runs a torch backtrack)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def route_counts() -> Dict[str, Dict[str, int]]:
    """Launches by route since the last ``reset_launch_counts``, for the
    kernels that count them (``wgmma`` / ``simt``, the
    RG-LRU scan's ``tma`` / ``simt``, the mLSTM's ``decode`` besides and
    its key-block mode's ``decode_block``, the
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


__all__ = ["PROFILERS", "charge", "charge_collective", "charged_unit",
           "launch_counts", "refuse_grad", "reset_launch_counts",
           "route_counts"]

"""CUDA wrappers for the chain DP (``csrc/tropical_dp.cu``).

Replaces the Pallas kernel ``src/repro/kernels/tropical_dp/tropical_dp.py``
(``tropical_dp_step``) and the reference's loop around it
(``repro/core/batch.py::_chain_dp_solve_kernelized``).  Two wrappers:

* ``tropical_dp_chain``, the whole solve (transfer-tensor build, the L
  wavefront steps, the backtrack) over every (scenario, source slot).
  Two routes, chosen by ``chain_route`` from the shapes alone; each
  route's kernel launches are counted in
  ``tropical_dp_chain.launches_by_route``:

  - ``fused``: one launch, a block per scenario and tile of slots, four
    lanes per output, with its operands (staged by cp.async), the
    transfer tensor, the dp tables, each block start's min over the
    predecessor state and the 8-bit parents in shared memory
    (``chain_plan``, ``chain_smem_bytes``).  It alone adds to
    ``tropical_dp_chain.launches``;
  - ``step`` (tables beyond one block's shared memory, or parents beyond 8
    bits): the plain version's loop around the step kernel, L
    ``tropical_dp_step`` launches and a torch backtrack.

* ``tropical_dp_step``, one wavefront step, one thread per output
  (b, m, s); the ``step`` route's kernel.

Both are bound by bytes and, at the planner's shapes, by launch overhead.
Every sum is one rounded add in the reference's staged order, so both
routes equal ``ref.chain_dp_ref`` (and the step kernel ``ref.dp_step_ref``)
bit for bit.  Neither wrapper reads a value back to the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tropical_dp.ref import chain_dp_ref

#: launcher argument types, bound once (``_build.launcher``)
_ARGTYPES = {
    "repro_tropical_dp_step": (
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "repro_tropical_dp_chain": (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "repro_tropical_dp_chain_smem_bytes": [ctypes.c_int] * 4,
}

#: the routes of ``tropical_dp_chain``
ROUTES = ("fused", "step")
#: dynamic shared memory one block can take on an H100 (227 KB)
SMEM_BUDGET = 232448
MIN_THREADS, MAX_THREADS = 128, 1024
#: lanes that share one output's scans (``Q`` in the kernel)
LANES = 4
#: the parents are 8-bit in shared memory: a < 256, s0 <= S < 256
MAX_LAYERS, MAX_STATES = 256, 255


def _launcher(symbol: str, restype=ctypes.c_int):
    return _build.launcher("tropical_dp", symbol, _ARGTYPES[symbol], restype)


def _check_launch(name: str, err: int) -> None:
    if err:
        _build.check_launch(_build.load("tropical_dp"), name, err)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def chain_smem_bytes(n_layers: int, n_states: int, n_uavs: int,
                     slots: int) -> int:
    """Shared-memory bytes of the fused kernel for one block of ``slots``
    source slots: its sections, each 16-byte aligned, are the transfer
    tensor tr [S][L][S+1] float32; the staged operands ct and ok [L][L][S]
    float32, the scenario's rates [U][U] float32, bits_in [L] and
    input_bits float32, order [S] and prev_dev [S+1] int64, the slots'
    sources [slots] int64 and the active flags [U] uint8; the dp tables
    [slots][L+1][S+1] float32, each block start's min over s0 mn
    [slots][L][S] float32 with its argmin s0b [slots][L][S] uint8, and the
    parents pa, ps [slots][L][S+1] uint8.  The kernel's launcher lays the
    sections out (``ChainSmem``) and refuses a launch whose total is not
    this one (``kernel_smem_bytes`` reads its total)."""
    L, S, U = n_layers, n_states, n_uavs
    sizes = (4 * S * L * (S + 1), 4 * L * L * S, 4 * L * L * S, 4 * U * U,
             4 * (L + 1), 8 * S, 8 * (S + 1), 8 * slots, U,
             4 * slots * (L + 1) * (S + 1), 4 * slots * L * S,
             slots * L * S, slots * L * (S + 1), slots * L * (S + 1))
    return sum(_align16(n) for n in sizes)


def kernel_smem_bytes(n_layers: int, n_states: int, n_uavs: int,
                      slots: int) -> int:
    """The fused kernel's own shared-memory total for these shapes, from
    its launcher's layout (builds the kernel; card only)."""
    return _launcher("repro_tropical_dp_chain_smem_bytes", ctypes.c_longlong)(
        n_layers, n_states, n_uavs, slots)


def chain_route(n_layers: int, n_states: int, n_uavs: int) -> str:
    """``fused`` where one slot's tables and the staged operands fit in a
    block's shared memory and the parents fit in 8 bits, else ``step``;
    from the shapes alone."""
    if n_layers > MAX_LAYERS or n_states > MAX_STATES:
        return "step"
    return "fused" if chain_smem_bytes(n_layers, n_states, n_uavs, 1) \
        <= SMEM_BUDGET else "step"


def chain_plan(n_slots: int, n_layers: int, n_states: int, n_uavs: int
               ) -> Tuple[int, int, int]:
    """The fused launch's (slots a block MT, threads a block, shared-memory
    bytes): ``LANES`` threads for every output of the block's slots, a
    warp a slot where its outputs fit in one (S <= 8), at most 1,024 and
    at least 128 threads (they share the staging and the transfer
    tensor's divisions), with as many slots as keep the tables within the
    budget."""
    L, S = n_layers, n_states
    per_slot = 32 if LANES * S <= 32 else LANES * S
    mt = max(1, min(n_slots, MAX_THREADS // per_slot))
    while mt > 1 and \
            chain_smem_bytes(L, S, n_uavs, mt) > SMEM_BUDGET:
        mt -= 1
    threads = max(MIN_THREADS, (per_slot * mt + 31) // 32 * 32)
    return mt, threads, chain_smem_bytes(L, S, n_uavs, mt)


@functools.lru_cache(maxsize=None)
def _launch_plan(n_slots: int, n_layers: int, n_states: int, n_uavs: int):
    """Per shape, once: the route and, for ``fused``, (MT, threads,
    shared-memory bytes)."""
    if chain_route(n_layers, n_states, n_uavs) == "step":
        return "step", None
    return "fused", chain_plan(n_slots, n_layers, n_states, n_uavs)


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(f"tropical_dp_step: {name} must be a CUDA "
                         f"torch.float32 tensor of shape {tuple(shape)}; "
                         f"got {t.device} {t.dtype} {tuple(t.shape)}")


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
    for arg, t in (("tr", tr), ("tr0", tr0), ("ct", ct), ("ok", ok)):
        if not t.is_contiguous():
            raise ValueError(f"tropical_dp_step: {arg} must be contiguous")
    fn = _launcher("repro_tropical_dp_step")
    row = torch.empty((B, M, S), dtype=torch.float32, device=dp.device)
    pa = torch.empty((B, M, S), dtype=torch.int32, device=dp.device)
    ps = torch.empty((B, M, S), dtype=torch.int32, device=dp.device)
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream(dp.device).cuda_stream
        err = fn(dp.data_ptr(), dp.stride(1), tr.data_ptr(), tr0.data_ptr(),
                 ct.data_ptr(), ok.data_ptr(), row.data_ptr(), pa.data_ptr(),
                 ps.data_ptr(), B, M, L, S, stream)
    _check_launch("tropical_dp_step", err)
    tropical_dp_step.launches += 1
    return row, pa, ps


tropical_dp_step.launches = 0


def tropical_dp_chain(rate: torch.Tensor, sources: torch.Tensor,
                      active: torch.Tensor, order: torch.Tensor,
                      prev_dev: torch.Tensor, bits_in: torch.Tensor,
                      input_bits: torch.Tensor, ct: torch.Tensor,
                      ok: torch.Tensor):
    """The chain DP over every (scenario, source slot), on one device.

    rate       [B, U, U] float32 contiguous — eq. (5) rates, inf diagonal
    sources    [B, M]    int64 (any strides) — capturing UAV of each slot
    active     [B, U]    bool contiguous
    order      [S] int64, prev_dev [S+1] int64 — the device order's tables
    bits_in    [L] float32, input_bits 0-dim float32
    ct, ok     [L(step), L(a), S] float32 contiguous; ``ok`` is 0 for
               a >= step, as ``core.batch.chain_dp_tables`` builds it (the
               fused kernel skips those rows)

    Every index is taken to lie in range (order, prev_dev and sources
    below U): checking that would read back from the card.  Returns
    ``(assign [B, M, L] int32, latency [B, M] float32)`` on the current
    stream without synchronising; infeasible slots get assign -1 and
    latency inf.
    """
    name = "tropical_dp_chain"
    if rate.dim() != 3 or sources.dim() != 2 or ct.dim() != 3:
        raise ValueError(f"{name}: want rate [B, U, U], sources [B, M] and "
                         f"ct [L, L, S]; got {tuple(rate.shape)}, "
                         f"{tuple(sources.shape)}, {tuple(ct.shape)}")
    B, U = rate.shape[0], rate.shape[1]
    M = sources.shape[1]
    L, S = ct.shape[0], ct.shape[2]
    operands = (("rate", rate, (B, U, U), torch.float32, True),
                ("sources", sources, (B, M), torch.int64, False),
                ("active", active, (B, U), torch.bool, True),
                ("order", order, (S,), torch.int64, True),
                ("prev_dev", prev_dev, (S + 1,), torch.int64, True),
                ("bits_in", bits_in, (L,), torch.float32, True),
                ("input_bits", input_bits, (), torch.float32, True),
                ("ct", ct, (L, L, S), torch.float32, True),
                ("ok", ok, (L, L, S), torch.float32, True))
    for arg, t, shape, dtype, contiguous in operands:
        if t.dtype != dtype or t.shape != shape or \
                (contiguous and not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a{' contiguous' * contiguous} "
                f"{dtype} tensor of shape {shape}; got {t.dtype} "
                f"{tuple(t.shape)}")
    index = rate.get_device()
    for arg, t, *_ in operands:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: every operand must be a CUDA tensor "
                             f"on rate's device; {arg} is on {t.device}, "
                             f"rate on {rate.device}")
    dev = rate.device
    if L < 1 or S < 1:
        raise ValueError(f"{name}: want L >= 1 and S >= 1; got L {L}, S {S}")
    if B * M == 0:
        return (torch.empty((B, M, L), dtype=torch.int32, device=dev),
                torch.empty((B, M), dtype=torch.float32, device=dev))
    route, plan = _launch_plan(M, L, S, U)
    if route == "step":
        steps = tropical_dp_step.launches
        out = chain_dp_ref(rate, sources, active, order, prev_dev, bits_in,
                           input_bits, ct, ok, step=tropical_dp_step)
        tropical_dp_chain.launches_by_route["step"] += \
            tropical_dp_step.launches - steps
        return out
    out = (torch.empty((B, M, L), dtype=torch.int32, device=dev),
           torch.empty((B, M), dtype=torch.float32, device=dev))
    mt, threads, smem_bytes = plan
    fn = _launcher("repro_tropical_dp_chain")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rate.data_ptr(), sources.data_ptr(), sources.stride(0),
                 sources.stride(1), active.data_ptr(), order.data_ptr(),
                 prev_dev.data_ptr(), bits_in.data_ptr(),
                 input_bits.data_ptr(), ct.data_ptr(), ok.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), B, U, M, L, S, mt,
                 threads, smem_bytes, stream)
    _check_launch(name, err)
    tropical_dp_chain.launches += 1
    tropical_dp_chain.launches_by_route["fused"] += 1
    return out


tropical_dp_chain.launches = 0
tropical_dp_chain.launches_by_route = dict.fromkeys(ROUTES, 0)


def tropical_dp_chain_meta(rate: torch.Tensor, sources: torch.Tensor,
                           active: torch.Tensor, order: torch.Tensor,
                           prev_dev: torch.Tensor, bits_in: torch.Tensor,
                           input_bits: torch.Tensor, ct: torch.Tensor,
                           ok: torch.Tensor):
    """``tropical_dp_chain`` on ``meta``: ``(assign, latency)`` of its
    shapes and dtypes; no launch, no arithmetic."""
    del active, order, prev_dev, bits_in, input_bits, ok
    B, M, L = rate.shape[0], sources.shape[1], ct.shape[0]
    return (torch.empty((B, M, L), dtype=torch.int32, device=rate.device),
            torch.empty((B, M), dtype=torch.float32, device=rate.device))

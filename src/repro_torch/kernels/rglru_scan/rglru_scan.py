"""CUDA wrapper for the RG-LRU linear recurrence (``csrc/rglru_scan.cu``).

Replaces the Pallas kernel ``src/repro/kernels/rglru_scan/rglru_scan.py``
(``rglru_scan``): ``h_t = a_t h_{t-1} + b_t`` over ``[B, T, W]`` from
``h0``, float32 math, ``h`` in ``a.dtype`` and ``hT`` in ``h0.dtype``.
Bound by bytes (one read of a and b, one write of h).  Each step is one
FMA rounded once, in step order, as the Pallas kernel and the plain
version compute it, so both routes equal the plain version bitwise.
Two routes, chosen by ``rglru_route`` from the shape and dtype alone and
counted in ``rglru_scan.launches_by_route``:

* ``tma`` (``W`` x element bytes a multiple of 16, ``T > 0``): a block
  per (b, 64-channel strip); a producer warp keeps a 4-stage TMA ring of
  [steps x 64 channels] boxes of a and b in flight while one thread a
  channel runs the chain through them; h is staged in shared memory and
  stored with 16-byte stores.  a and b off 16 bytes are refused;
* ``simt`` (any other shape): one thread per (b, w) channel, a chunk of
  steps' loads issued ahead of their dependent chain.

The backward ``rglru_scan_bwd`` (``csrc/rglru_scan_bwd.cu``; no Pallas
kernel has one: the reference leaves its associative scan's gradient to
XLA) runs the adjoint recurrence backwards in time, one FMA rounded once
a step in the plain version's order, so it equals ``rglru_bwd_ref``
bitwise.  Its routes follow the forward's rule (``rglru_route``) and are
counted in ``rglru_scan_bwd.launches_by_route``:

* ``tma``: the forward's ring run backwards in time, a block per (b,
  32-channel strip); a producer warp loads boxes of a[t+1], h[t-1] and
  dh[t] from the last box to the first while one thread a channel runs
  the chain through them; da and db are staged in shared memory and
  stored by TMA.  a, h and dh off 16 bytes are refused;
* ``simt``: one thread per (b, w) channel, a chunk of steps' loads
  issued ahead of their dependent chain.

``ops.linear_recurrence`` calls
both through an autograd Function when a gradient is wanted; the bare
forward refuses to run under grad (its output would carry no gradient).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535          # the grid's y extent
#: launcher route codes
ROUTES = ("simt", "tma")
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
#: the backward launcher's route codes: the forward's
BWD_ROUTES = ROUTES


def _check_operands(fn: str, device: torch.device, note: str,
                    *named: tuple) -> None:
    """Raise unless every ``(name, tensor, dtype)`` is a contiguous CUDA
    float32 or bfloat16 tensor of that dtype on ``device``."""
    for name, t, dt in named:
        if t.device != device or t.device.type != "cuda" or \
                t.dtype not in _DTYPES or t.dtype != dt or \
                not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous CUDA float32 or "
                f"bfloat16 tensor on {device} ({note}); got {t.device} "
                f"{t.dtype}")


def rglru_route(dtype: torch.dtype, t: int, w: int) -> str:
    """``tma`` where TMA can read rows of ``w`` elements of ``dtype`` (a
    multiple of 16 bytes) and there is a step to read, else ``simt``."""
    item = torch.empty((), dtype=dtype).element_size()
    return "tma" if t > 0 and (w * item) % 16 == 0 else "simt"


def _refuse_misaligned(fn: str, route: str, w: int, *named) -> None:
    """On the ``tma`` route, raise unless every ``(name, tensor)``'s data
    is 16-byte aligned, as TMA reads it."""
    off = [t.data_ptr() % 16 for _, t in named]
    if route == "tma" and any(off):
        names = ", ".join(n for n, _ in named)
        raise ValueError(
            f"{fn}: {names} are read by TMA at W {w} and need 16-byte "
            f"aligned data; got data_ptr % 16 = "
            f"{', '.join(map(str, off))}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b [B, T, W] contiguous, of one dtype; h0 [B, W] contiguous;
    float32 or bfloat16 CUDA tensors on one device -> (h [B, T, W] in
    ``a.dtype``, hT [B, W] in ``h0.dtype``), on the current stream
    without synchronising.  Raises under grad: the training path goes
    through ``ops.linear_recurrence``."""
    refuse_grad("rglru_scan", "14.7: call ops.linear_recurrence, whose "
                "autograd Function launches rglru_scan_bwd", a, b, h0)
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape) or h0.dim() != 2 \
            or tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: want a, b [B, T, W] and h0 [B, W]; "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    B, T, W = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"rglru_scan: batch {B}, at most {MAX_BATCH}")
    route = rglru_route(a.dtype, T, W)
    _refuse_misaligned("rglru_scan", route, W, ("a", a), ("b", b))
    _check_operands("rglru_scan", a.device, "b of a's dtype",
                    ("a", a, a.dtype), ("b", b, a.dtype),
                    ("h0", h0, h0.dtype))
    h = torch.empty_like(a)
    hT = torch.empty_like(h0)
    if hT.numel() == 0:
        return h, hT
    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                 hT.data_ptr(), B, T, W, _DTYPES[a.dtype], _DTYPES[h0.dtype],
                 ROUTES.index(route), stream)
    _build.check_launch(lib, "rglru_scan", err)
    rglru_scan.launches += 1
    rglru_scan.launches_by_route[route] += 1
    return h, hT


rglru_scan.launches = 0
rglru_scan.launches_by_route = dict.fromkeys(ROUTES, 0)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   dh: torch.Tensor, dhT: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's gradient: a, h (the forward's output) and dh
    [B, T, W] contiguous, of one dtype; h0 and dhT (None: zeros) [B, W]
    contiguous, of one dtype; float32 or bfloat16 CUDA tensors on one
    device -> (da, db [B, T, W] in ``a.dtype``, dh0 [B, W] in
    ``h0.dtype``), on the current stream without synchronising.  The
    route is ``rglru_route``'s; on ``tma`` a, h and dh must be 16-byte
    aligned."""
    if a.dim() != 3 or h0.dim() != 2 or \
            tuple(h0.shape) != (a.shape[0], a.shape[2]) or \
            any(tuple(t.shape) != tuple(a.shape) for t in (h, dh)) or \
            (dhT is not None and tuple(dhT.shape) != tuple(h0.shape)):
        raise ValueError(
            f"rglru_scan_bwd: want a, h, dh [B, T, W] and h0, dhT [B, W]; "
            f"got {tuple(a.shape)}, {tuple(h.shape)}, {tuple(h0.shape)}, "
            f"{tuple(dh.shape)}, "
            f"{None if dhT is None else tuple(dhT.shape)}")
    B, T, W = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"rglru_scan_bwd: batch {B}, at most {MAX_BATCH}")
    route = rglru_route(a.dtype, T, W)
    _refuse_misaligned("rglru_scan_bwd", route, W, ("a", a), ("h", h),
                       ("dh", dh))
    named = [("a", a, a.dtype), ("h", h, a.dtype), ("dh", dh, a.dtype),
             ("h0", h0, h0.dtype)]
    if dhT is not None:
        named.append(("dhT", dhT, h0.dtype))
    _check_operands("rglru_scan_bwd", a.device,
                    "h and dh of a's dtype, dhT of h0's", *named)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if dh0.numel() == 0:
        return da, db, dh0
    fn = _build.launcher("rglru_scan_bwd", "repro_rglru_scan_bwd",
                         _BWD_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(),
                 None if dhT is None else dhT.data_ptr(), da.data_ptr(),
                 db.data_ptr(), dh0.data_ptr(), B, T, W, _DTYPES[a.dtype],
                 _DTYPES[h0.dtype], BWD_ROUTES.index(route), stream)
    _build.check_launch(_build.load("rglru_scan_bwd"), "rglru_scan_bwd", err)
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.launches_by_route[route] += 1
    return da, db, dh0


rglru_scan_bwd.launches = 0
rglru_scan_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


def rglru_scan_meta(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_scan`` on ``meta``: (h, hT) of its shapes and dtypes; no
    launch, no arithmetic."""
    refuse_grad("rglru_scan", "14.7: call ops.linear_recurrence, whose "
                "autograd Function launches rglru_scan_bwd", a, b, h0)
    return torch.empty_like(a), torch.empty_like(h0)


def rglru_scan_bwd_meta(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                        dh: torch.Tensor, dhT: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rglru_scan_bwd`` on ``meta``: (da, db, dh0) of its shapes and
    dtypes; no launch, no arithmetic."""
    del h, dh, dhT
    return torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)

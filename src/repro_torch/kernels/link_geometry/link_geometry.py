"""CUDA wrapper for the fused link-geometry kernel (``csrc/link_geometry.cu``).

Replaces the Pallas kernel ``src/repro/kernels/link_geometry/link_geometry.py``
(``link_geometry``, body ``_geometry_math``): distance -> eq. (4) gain ->
eq. (7) threshold -> first-pass P1 power -> eq. (5) rate in one pass,
where the plain version makes four [B, U, U] passes.  Bound by bytes (U
positions in, 3 U floats out per row) and, at U = 8, by launch overhead.
For U <= 32 the kernel gives each link (b, i, k) one thread, next_pow2(U)
lanes a row, computes each gain once and reduces the row's power with a
segmented warp shuffle; for U > 32 a warp loops over a row.  Every
operation is explicitly rounded in the reference's order.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core.channel import RadioParams
from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 5 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def radio_constants(params: RadioParams) -> dict:
    """The radio constants the kernel takes, computed in double as the
    reference's ``_radio_constants`` does (each rounds to float32 at the
    call)."""
    spectral = params.packet_bits * math.log(2.0) / \
        (params.bandwidth_hz * params.tau)
    return dict(h0=params.h0, noise=params.noise_watts,
                p_max=params.p_max_watts, bandwidth=params.bandwidth_hz,
                expm1_spectral=math.exp(spectral) - 1.0)


def link_geometry(positions: torch.Tensor, active: torch.Tensor,
                  gain_scale: Optional[torch.Tensor], *,
                  params: RadioParams):
    """positions [B, U, 2] f32, active [B, U] f32 (0/1), gain_scale
    [B, U, U] f32 or None, all contiguous on one CUDA device ->
    (dist, threshold, rate), each [B, U, U] float32, on the current
    stream without synchronising."""
    B, U = positions.shape[0], positions.shape[1]
    want = [("positions", positions, (B, U, 2)), ("active", active, (B, U))]
    if gain_scale is not None:
        want.append(("gain_scale", gain_scale, (B, U, U)))
    for name, t, shape in want:
        if t.device != positions.device or t.device.type != "cuda" or \
                t.dtype != torch.float32 or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(
                f"link_geometry: {name} must be a contiguous CUDA float32 "
                f"tensor of shape {shape} on {positions.device}; got "
                f"{t.device} {t.dtype} {tuple(t.shape)}")
    fn = _build.launcher("link_geometry", "repro_link_geometry", _ARGTYPES)
    c = radio_constants(params)
    dist, th, rate = (torch.empty((B, U, U), dtype=torch.float32,
                                  device=positions.device) for _ in range(3))
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream(positions.device).cuda_stream
        err = fn(positions.data_ptr(), active.data_ptr(),
                 None if gain_scale is None else gain_scale.data_ptr(),
                 dist.data_ptr(), th.data_ptr(), rate.data_ptr(), B, U,
                 c["h0"], c["noise"], c["p_max"], c["bandwidth"],
                 c["expm1_spectral"], stream)
    if err:
        _build.check_launch(_build.load("link_geometry"), "link_geometry",
                            err)
    link_geometry.launches += 1
    return dist, th, rate


link_geometry.launches = 0


def link_geometry_meta(positions: torch.Tensor, active: torch.Tensor,
                       gain_scale: Optional[torch.Tensor], *,
                       params: RadioParams):
    """``link_geometry`` on ``meta``: its three outputs' shapes and
    dtypes; no launch, no arithmetic."""
    del active, gain_scale, params
    B, U = positions.shape[0], positions.shape[1]
    out = tuple(torch.empty((B, U, U), dtype=torch.float32,
                            device=positions.device) for _ in range(3))
    return out


def link_geometry_fused(positions: torch.Tensor, active: torch.Tensor,
                        gain_scale: Optional[torch.Tensor], *,
                        params: RadioParams):
    """The geometry stage's math on whole tensors of any device (the
    reference's ``link_geometry_fused``, its kernel body run as one
    program): positions [B, U, 2], active [B, U] (0/1 floats or bool),
    gain_scale [B, U, U] or None -> (dist, threshold, rate), each
    [B, U, U], in the plain version's four passes (``ref``)."""
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    return link_geometry_ref(positions.to(torch.float32), active > 0,
                             gain_scale, params=params)

"""Public entry for the fused link-geometry stage."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channel import RadioParams
from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.link_geometry.link_geometry import (
    link_geometry, link_geometry_meta)
from repro_torch.kernels.link_geometry.ref import link_geometry_ref


def _kernel(positions, active, gain_scale, params):
    return link_geometry(
        positions.contiguous(), active.to(torch.float32).contiguous(),
        None if gain_scale is None
        else gain_scale.to(torch.float32).contiguous(), params=params)


def _plain(positions, active, gain_scale, params):
    return link_geometry_ref(positions, active.to(torch.bool), gain_scale,
                             params=params)


def _meta(positions, active, gain_scale, params):
    return link_geometry_meta(positions, active, gain_scale, params=params)


#: tensor device type -> implementation: CUDA launches the fused kernel
#: (or raises), the CPU takes the plain four-pass version, ``meta`` makes
#: the outputs' shapes; nothing falls back from one to another
_BY_DEVICE = {"cuda": _kernel, "cpu": _plain, "meta": _meta}


@charged_unit
def fused_link_geometry(positions: torch.Tensor, params: RadioParams,
                        active: Optional[torch.Tensor] = None,
                        gain_scale: Optional[torch.Tensor] = None):
    """Geometry stage of the planning tick: positions [B, U, 2] ->
    (dist [B, U, U], eq. (7) threshold matrix, eq. (5) rate at the
    first-pass P1 powers).  ``active`` [B, U] bool defaults to every UAV
    alive.  CUDA tensors launch the fused kernel (or raise); CPU tensors
    take the plain four-pass version."""
    positions = positions.to(torch.float32)
    B, U = positions.shape[0], positions.shape[1]
    if active is None:
        active = torch.ones((B, U), dtype=torch.bool,
                            device=positions.device)
    impl = _BY_DEVICE.get(positions.device.type)
    if impl is None:
        raise ValueError(f"fused_link_geometry: unsupported device "
                         f"{positions.device}")
    charge("link_geometry", positions, active, gain_scale)
    return impl(positions, active, gain_scale, params)

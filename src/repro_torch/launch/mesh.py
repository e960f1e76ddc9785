"""Mesh construction (the reference's ``launch/mesh.py``).

Functions, not module constants, so importing this module touches no
device.  With no explicit ``devices`` a mesh takes the visible CUDA
devices (and raises with too few); an explicit list may repeat one
card, so the production (16, 16) mesh can be 256 entries of one device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.parallel.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def mesh_from_config(cfg: MeshConfig,
                     devices: Optional[Sequence] = None) -> Mesh:
    return make_mesh(cfg.shape, cfg.axes, devices)


def make_host_mesh(n_data: int = 0, n_model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default the visible CUDA
    devices); ``n_data`` <= 0 takes as many as the devices fill."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    else:
        n = len(devices)
    if n_data <= 0:
        n_data = max(1, n // max(n_model, 1))
    return make_mesh((n_data, n_model), ("data", "model"), devices)


__all__ = ["make_host_mesh", "make_production_mesh", "mesh_from_config"]

"""Fused link geometry (eq. 4, 5, 7 + first-pass P1): CUDA kernel + plain
version."""
from repro_torch.kernels.link_geometry.ops import fused_link_geometry

__all__ = ["fused_link_geometry"]

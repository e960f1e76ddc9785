"""Tropical (min-plus) chain DP: the fused CUDA solve, the wavefront-step
kernel of its step route, and their plain versions."""
from repro_torch.kernels.tropical_dp.ops import chain_dp, dp_wavefront_step

__all__ = ["chain_dp", "dp_wavefront_step"]

"""Tropical (min-plus) chain-DP wavefront step: CUDA kernel + plain version."""
from repro_torch.kernels.tropical_dp.ops import dp_wavefront_step

__all__ = ["dp_wavefront_step"]

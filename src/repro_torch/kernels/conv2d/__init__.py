"""Conv layer as im2col + a GEMM with fused bias and ReLU: CUDA kernel +
plain version."""
from repro_torch.kernels.conv2d.ops import conv2d

__all__ = ["conv2d"]

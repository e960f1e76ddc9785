"""Grouped expert GEMM of the MoE layer (``[E,C,D] @ [E,D,F]``): CUDA
kernel + plain version."""
from repro_torch.kernels.moe_matmul.ops import expert_gemm

__all__ = ["expert_gemm"]

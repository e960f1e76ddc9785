"""Online-softmax prefill attention (causal, sliding window, softcap,
GQA): CUDA kernel + plain version."""
from repro_torch.kernels.flash_attention.ops import mha

__all__ = ["mha"]

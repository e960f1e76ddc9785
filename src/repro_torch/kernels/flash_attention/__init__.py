"""Online-softmax prefill attention (causal, sliding window, softcap,
GQA; non-causal with keys of a length of their own for cross-attention):
CUDA kernel + plain version."""
from repro_torch.kernels.flash_attention.ops import mha

__all__ = ["mha"]

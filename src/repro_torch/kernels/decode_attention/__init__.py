"""One query token per sequence against the KV cache (online softmax
over the slots): CUDA kernel + plain version."""
from repro_torch.kernels.decode_attention.ops import decode_mha

__all__ = ["decode_mha"]

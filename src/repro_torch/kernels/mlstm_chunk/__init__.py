"""Chunkwise mLSTM cell from a given state: CUDA kernel + plain
version."""
from repro_torch.kernels.mlstm_chunk.ops import mlstm

__all__ = ["mlstm"]

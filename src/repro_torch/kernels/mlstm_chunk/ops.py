"""Public entry for the mLSTM cell's chunkwise recurrence, in the
profiler range ``mlstm.chunk``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version; nothing falls back
_BY_DEVICE = {"cuda": mlstm_chunk, "cpu": mlstm_chunk_ref}


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_pre: torch.Tensor, f_pre: torch.Tensor, C0: torch.Tensor,
          n0: torch.Tensor, m0: torch.Tensor, scale: float
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, S, H, D] (q unscaled); gates [B, S, H] float32; state
    (C0 [B, H, D, D], n0 [B, H, D], m0 [B, H]) -> (h [B, S, H, D] in q's
    dtype, C1, n1, m1)."""
    fn = _BY_DEVICE.get(q.device.type)
    if fn is None:
        raise ValueError(f"mlstm: unsupported device {q.device}")
    with torch.profiler.record_function("mlstm.chunk"):
        return fn(q, k, v, i_pre, f_pre, C0, n0, m0, scale)


__all__ = ["mlstm"]

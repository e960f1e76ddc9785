"""Plain PyTorch version of the decode-attention kernel: the reference's
``decode_ref`` (one query token per sequence against the cache, slot
valid iff ``slot <= pos[b]``), in float32, output in ``q.dtype``."""
from __future__ import annotations

import math
import torch


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor, *, cap: float = 0.0) -> torch.Tensor:
    """q [B,KV,G,D]; k/v [B,KV,S,D]; pos [B] -> [B,KV,G,D]."""
    d = q.shape[-1]
    s = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgd,bksd->bkgs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if cap:
        logits = torch.tanh(logits / cap) * cap
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", w,
                        v.to(torch.float32)).to(q.dtype)


__all__ = ["decode_ref"]

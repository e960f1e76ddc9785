"""Plain PyTorch version of the decode-attention kernel: the reference's
``decode_ref`` (one query token per sequence against the cache, slot
valid iff ``slot <= pos[b]``), in float32, output in ``q.dtype``; with
``return_lse`` also each query head's log-sum-exp of its masked logits,
and the output then in float32 (the kernel's, for a merge across blocks).
A row with no valid slot (``pos[b] < 0``: a block of a cache split over
``model`` that lies wholly past the position) gives 0 and ``-inf``, as
the kernel does."""
from __future__ import annotations

import math
import torch


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor, *, cap: float = 0.0,
               return_lse: bool = False):
    """q [B,KV,G,D]; k/v [B,KV,S,D]; pos [B] -> [B,KV,G,D], with
    ``return_lse`` the pair (out float32, lse float32 [B,KV,G])."""
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
    # a row with no valid slot: its all--inf softmax is NaN; zero it
    w = w.masked_fill(~valid.any(dim=-1)[:, None, None, None], 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", w, v.to(torch.float32))
    if not return_lse:
        return out.to(q.dtype)
    return out, torch.logsumexp(logits, dim=-1)


__all__ = ["decode_ref"]

"""Plain PyTorch version of the flash-attention kernel: the reference's
``attention_ref`` (full score matrix, ``-inf`` mask, softmax), in
float32 from any input dtype, output in ``q.dtype``."""
from __future__ import annotations

import math
import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  cap: float = 0.0) -> torch.Tensor:
    """q [B,H,S,D]; k/v [B,KV,S,D] (KV divides H) -> [B,H,S,D]."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    # head h reads kv head h // (H / KV), as jnp.repeat lays them out
    k = k[:, :, None].expand(b, kv, h // kv, s, d).reshape(b, h, s, d)
    v = v[:, :, None].expand(b, kv, h // kv, s, d).reshape(b, h, s, d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if cap:
        logits = torch.tanh(logits / cap) * cap
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= q_pos - k_pos < window
    logits = logits.masked_fill(~ok, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w,
                        v.to(torch.float32)).to(q.dtype)


__all__ = ["attention_ref"]

"""Plain PyTorch version of the flash-attention kernel: the reference's
``attention_ref`` (full score matrix, ``-inf`` mask, softmax), in
float32 from any input dtype, output in ``q.dtype``; the keys may have a
length of their own without a mask, as the kernel's."""
from __future__ import annotations

import math
import torch


def check_key_length(fn: str, sq: int, sk: int, causal: bool,
                     window: int) -> None:
    """Raise unless the keys' length ``sk`` suits the masks: any length of
    at least 1 without a mask (none for no queries), ``sk == sq`` with the
    causal mask or a window (both compare query and key indices)."""
    if (sq and sk < 1) or (sk != sq and (causal or window)):
        raise ValueError(f"{fn}: {sk} keys for {sq} queries; a key length "
                         f"of its own needs Sk >= 1, causal=False and no "
                         f"window (got causal={causal}, window={window})")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  cap: float = 0.0) -> torch.Tensor:
    """q [B,H,Sq,D]; k/v [B,KV,Sk,D] (KV divides H; Sk = Sq with a causal
    mask or a window) -> [B,H,Sq,D]."""
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    check_key_length("attention_ref", s, sk, causal, window)
    scale = 1.0 / math.sqrt(d)
    # head h reads kv head h // (H / KV), as jnp.repeat lays them out
    k = k[:, :, None].expand(b, kv, h // kv, sk, d).reshape(b, h, sk, d)
    v = v[:, :, None].expand(b, kv, h // kv, sk, d).reshape(b, h, sk, d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if cap:
        logits = torch.tanh(logits / cap) * cap
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= q_pos - k_pos < window
    logits = logits.masked_fill(~ok, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w,
                        v.to(torch.float32)).to(q.dtype)


__all__ = ["attention_ref", "check_key_length"]

"""Plain PyTorch versions of the flash-attention kernels: the reference's
``attention_ref`` (full score matrix, ``-inf`` mask, softmax), in
float32 from any input dtype, output in ``q.dtype``; the keys may have a
length of their own without a mask, as the kernel's.  For training,
``attention_fwd_ref`` also returns each row's log-sum-exp and
``attention_bwd_ref`` is the backward kernel's formula written out (not
autograd), the sums over a kv head's group of query heads explicit."""
from __future__ import annotations

import math
import torch


def check_key_length(fn: str, sq: int, sk: int, causal: bool,
                     window: int, q_offset: int = 0) -> None:
    """Raise unless the keys' length ``sk`` suits the masks: any length of
    at least 1 without a mask (none for no queries); with the causal mask
    or a window (both compare query and key positions, query row i at
    ``q_offset + i``) at least ``q_offset + sq`` keys; a nonzero offset
    only under a mask."""
    if q_offset < 0 or (q_offset and not (causal or window)):
        raise ValueError(f"{fn}: query offset {q_offset} needs a causal "
                         f"mask or a window and must be >= 0")
    if (sq and sk < 1) or ((causal or window) and sk < q_offset + sq) or \
            (sk != sq and (causal or window) and not q_offset):
        raise ValueError(f"{fn}: {sk} keys for {sq} queries at offset "
                         f"{q_offset}; a key length of its own needs Sk >= 1"
                         f", causal=False and no window, or Sk >= q_offset + "
                         f"Sq with a query offset (got causal={causal}, "
                         f"window={window})")


def _mask(s: int, sk: int, causal: bool, window: int, device,
          q_offset: int = 0) -> torch.Tensor:
    """[Sq, Sk] bool: the (query, key) pairs the masks keep, query row i
    at position ``q_offset + i``."""
    q_pos = torch.arange(q_offset, q_offset + s, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((s, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= q_pos - k_pos < window
    return ok


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            cap: float, q_offset: int = 0):
    """Masked float32 logits [B,H,Sq,Sk] (``-inf`` masked) and the
    unmasked ``tanh(raw / cap)`` (None without a cap)."""
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    # head h reads kv head h // (H / KV), as jnp.repeat lays them out
    k = k[:, :, None].expand(b, kv, h // kv, sk, d).reshape(b, h, sk, d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    t = None
    if cap:
        t = torch.tanh(logits / cap)
        logits = t * cap
    ok = _mask(s, sk, causal, window, q.device, q_offset)
    return logits.masked_fill(~ok, float("-inf")), t


def _attend(q, k, v, causal, window, cap, q_offset=0):
    """The output in ``q.dtype`` and the masked logits."""
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    check_key_length("attention_ref", s, sk, causal, window, q_offset)
    logits, _ = _logits(q, k, causal, window, cap, q_offset)
    v = v[:, :, None].expand(b, kv, h // kv, sk, d).reshape(b, h, sk, d)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.to(torch.float32))
    return out.to(q.dtype), logits


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, cap: float = 0.0,
                  q_offset: int = 0) -> torch.Tensor:
    """q [B,H,Sq,D]; k/v [B,KV,Sk,D] (KV divides H; with a causal mask or
    a window Sk = Sq, or Sk >= q_offset + Sq at a query offset) ->
    [B,H,Sq,D]."""
    return _attend(q, k, v, causal, window, cap, q_offset)[0]


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      cap: float = 0.0, q_offset: int = 0):
    """``attention_ref``'s output and each row's log-sum-exp of its masked
    logits (float32 [B,H,Sq], natural log), as the kernel's ``with_lse``
    launch returns them."""
    out, logits = _attend(q, k, v, causal, window, cap, q_offset)
    return out, torch.logsumexp(logits, dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      cap: float = 0.0, q_offset: int = 0):
    """The backward kernel's formula in float32: P = exp(logit - lse) on
    the kept pairs, delta = rowsum(dO o), dV = P^T dO and dK = dS^T Q
    summed over each kv head's G query heads and the queries, dS = P (dO
    V^T - delta) (1 - tanh^2) scale, dQ = dS K.  Returns (dq [B,H,Sq,D],
    dk, dv [B,KV,Sk,D]) in ``q.dtype``; keys no query reads get zeros."""
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    check_key_length("attention_bwd_ref", s, sk, causal, window, q_offset)
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    logits, t = _logits(q, k, causal, window, cap, q_offset)
    p = torch.exp(logits - lse[..., None]).view(b, kv, g, s, sk)
    qf = q.to(f32).reshape(b, kv, g, s, d)
    dof = do.to(f32).reshape(b, kv, g, s, d)
    kf, vf = k.to(f32), v.to(f32)
    delta = (dof * o.to(f32).reshape(b, kv, g, s, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t).view(b, kv, g, s, sk)
    ds = ds * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf).reshape(b, h, s, d)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


__all__ = ["attention_bwd_ref", "attention_fwd_ref", "attention_ref",
           "check_key_length"]

"""Attention of the served LMs: GQA with causal / sliding-window masks,
logit softcap, rotary embeddings, and KV caches (flat, or a rolling
buffer for a window shorter than the cache).

Prefill attention runs the flash-attention kernel (``ops.mha``) and one
decode step the decode-attention kernel (``ops.decode_mha``): a CUDA
tensor launches the kernel, a CPU tensor takes its plain version.  The
reference computes both with jnp (``models/attention.py``) and swaps its
Pallas kernels in on a TPU; here the kernels are the path.

Layouts are the reference's: ``wq``/``wk``/``wv`` ``[d, heads, Dh]``,
``wo`` ``[H, Dh, d]``, activations ``[B, S, heads, Dh]``, caches
``[B, size, KV, Dh]``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_mha
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.layers import (apply_rope, dense_init, head_out,
                                       head_proj)

Params = Dict[str, torch.Tensor]


def attn_init(d: int, n_heads: int, n_kv: int, head_dim: int,
              qkv_bias: bool, generator: torch.Generator,
              dtype: torch.dtype) -> Params:
    p = {
        "wq": dense_init(d, n_heads * head_dim, generator, dtype).reshape(
            d, n_heads, head_dim),
        "wk": dense_init(d, n_kv * head_dim, generator, dtype).reshape(
            d, n_kv, head_dim),
        "wv": dense_init(d, n_kv * head_dim, generator, dtype).reshape(
            d, n_kv, head_dim),
        "wo": dense_init(n_heads * head_dim, d, generator, dtype).reshape(
            n_heads, head_dim, d),
    }
    if qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((n_heads, head_dim), device=dev)
        p["bk"] = torch.zeros((n_kv, head_dim), device=dev)
        p["bv"] = torch.zeros((n_kv, head_dim), device=dev)
    return p


def _qkv(p: Params, x: torch.Tensor, pos: torch.Tensor, theta: float
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = x.dtype
    q, k, v = (head_proj(x, p[n]) for n in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if theta:
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    return q, k, v


def attention(p: Params, x: torch.Tensor, pos: torch.Tensor, *,
              window: int = 0, cap: float = 0.0, theta: float = 10000.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal full-sequence (prefill) attention: x [B, S, d], pos [B, S]
    (the rotary positions; the masks take positions ``arange(S)``, which
    is what prefill passes).  Returns (y [B, S, d], k, v): the rotated k/v
    ``[B, S, KV, Dh]`` that prefill lays out as the decode cache (the
    reference recomputes them)."""
    q, k, v = _qkv(p, x, pos, theta)
    o = mha(q, k, v, causal=True, window=window, cap=cap)
    return head_out(o, p["wo"]), k, v


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


def init_cache(batch: int, max_seq: int, n_kv: int, head_dim: int,
               window: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """Flat cache, or rolling-buffer cache when window < max_seq."""
    size = min(window, max_seq) if window else max_seq
    return {"k": torch.zeros((batch, size, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, size, n_kv, head_dim), dtype=dtype,
                             device=device)}


def decode_attention(p: Params, x: torch.Tensor, pos: torch.Tensor,
                     cache: Dict[str, torch.Tensor], *, window: int = 0,
                     cap: float = 0.0, theta: float = 10000.0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: x [B, 1, d]; pos [B, 1] int32, the current
    position.  Returns (y [B, 1, d], cache).

    The new k/v are written in place at slot ``pos % size`` (the
    reference selects over the whole cache with ``jnp.where``; the
    values are the same).  Slot validity: a flat cache holds positions
    ``<= pos``; a rolling cache holds position ``pos - ((pos - s) mod
    size)`` in slot s, valid iff >= 0, which is slot ``s <= min(pos,
    size - 1)``: the kernel's mask with that bound.
    """
    q, k_new, v_new = _qkv(p, x, pos, theta)
    k_cache, v_cache = cache["k"], cache["v"]
    b, size = k_cache.shape[:2]
    cur = pos[:, 0]
    rows = torch.arange(b, device=x.device)
    slot = (cur % size).long()
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    last = torch.clamp(cur, max=size - 1).to(torch.int32)
    o = decode_mha(q, k_cache, v_cache, last, cap=cap)
    return head_out(o, p["wo"]), cache


__all__ = ["attention", "attn_init", "decode_attention", "init_cache"]

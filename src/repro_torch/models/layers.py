"""Shared LM building blocks on tensors, the reference's
``models/layers.py``: initialisers, the per-head projections
(``head_proj``, ``head_out``), ``rmsnorm``, ``layernorm``, the (gated)
MLP, rotary embeddings (M-RoPE included), ``softcap``, the embedding
lookup, the LM head and the training loss (``cross_entropy``).

Parameters are dicts of tensors in the reference's layouts (``dense``
weights ``[d_in, d_out]``, the embedding table ``[V, d]``).  Each weight
is cast to the activation's dtype at use, as the reference does, so a
matrix held in the compute dtype gives the same result as an fp32 one
cast there.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def truncated_normal(shape, scale: float, generator: torch.Generator,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in float32 on
    the generator's device and then cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale).to(dtype)


def dense_init(d_in: int, d_out: int, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return truncated_normal((d_in, d_out), 1.0 / math.sqrt(d_in), generator,
                            dtype)


def head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, T, d] @ w [d, heads, ...] -> [B, T, heads, ...] as one
    matrix product."""
    b, t, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).view(b, t, *w.shape[1:])


def head_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o [B, T, H, Dh] @ wo [H, Dh, d] -> [B, T, d]."""
    b, t = o.shape[:2]
    return o.reshape(b, t, -1) @ wo.to(o.dtype).reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# Norm, MLP
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with gemma's ``(1 + scale)``, cast back."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"])).to(dt)


def layernorm_init(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (biased variance), scale and bias, cast
    back."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"] + p["bias"]).to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


_ACT = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}


def mlp_init(d: int, d_ff: int, glu: bool, generator: torch.Generator,
             dtype: torch.dtype) -> Params:
    p = {"w_in": dense_init(d, d_ff, generator, dtype),
         "w_out": dense_init(d_ff, d, generator, dtype)}
    if glu:
        p["w_gate"] = dense_init(d, d_ff, generator, dtype)
    return p


def mlp(p: Params, x: torch.Tensor, act: str, glu: bool) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if glu:
        h = _ACT[act](x @ p["w_gate"].to(dt)) * h
    else:
        h = _ACT[act](h)
    return h @ p["w_out"].to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


@functools.lru_cache(maxsize=None)
def mrope_bands(half: int, sections: Tuple[int, ...], axes: int,
                device=None) -> torch.Tensor:
    """The position axis each of the ``half`` frequencies reads under
    M-RoPE: frequency i takes the section whose cumulative end is the
    first above i, clipped to the ``axes`` position axes (t, h, w).
    Made once per shape and device (a host-to-card copy of
    ``sections`` would wait for the card on every call) and shared:
    read-only."""
    ends = torch.cumsum(torch.tensor(sections, device=device), 0)
    band = torch.searchsorted(ends, torch.arange(half, device=device),
                              right=True)
    return band.clamp(0, axes - 1)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x [B, S, H, D]; pos [B, S], or [B, S, 3] for M-RoPE (qwen2-vl: the
    frequency bands split across the t / h / w positions by
    ``mrope_sections``; a 3-axis pos without sections takes axis 0).
    Rotates the two halves of the head (not interleaved pairs), in
    float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [D/2]
    if mrope_sections and pos.dim() == 3:
        band = mrope_bands(freqs.shape[0], mrope_sections, pos.shape[-1],
                           x.device)
        angles = pos[..., band].to(torch.float32) * freqs      # [B, S, D/2]
    else:
        if pos.dim() == 3:
            pos = pos[..., 0]
        angles = pos[..., None].to(torch.float32) * freqs      # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_init(vocab: int, d: int, generator: torch.Generator,
               dtype: torch.dtype) -> Params:
    return {"table": truncated_normal((vocab, d), 1.0, generator, dtype)}


def embed_lookup(p: Params, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(tokens, p["table"].to(dtype))


def lm_head(table_or_w: torch.Tensor, x: torch.Tensor,
            final_cap: float = 0.0) -> torch.Tensor:
    """x [..., d] @ table [V, d]^T, then the final logit softcap."""
    return softcap(x @ table_or_w.to(x.dtype).T, final_cap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean next-token cross-entropy in float32: logits [..., V],
    labels [...] int; with ``mask`` [...] the mean over its weight (at
    least 1)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


__all__ = ["apply_rope", "cross_entropy", "dense_init", "embed_init",
           "embed_lookup",
           "head_out", "head_proj", "layernorm", "layernorm_init", "lm_head",
           "mlp", "mlp_init", "mrope_bands", "rmsnorm", "rmsnorm_init",
           "rope_freqs", "softcap", "truncated_normal"]

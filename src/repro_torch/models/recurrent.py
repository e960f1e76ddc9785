"""Recurrent blocks: the RG-LRU of Griffin / RecurrentGemma (the
reference's ``models/recurrent.py``, its RG-LRU half; the xLSTM cells
come with the xLSTM slice, ROADMAP queue 1 item 14).

Prefill runs the recurrence through the RG-LRU scan kernel
(``ops.linear_recurrence``: sequential in time, float32), where the
reference takes ``jax.lax.associative_scan`` (the same sums in another
order).  Decode carries O(1) state per layer, ``h [B, w]`` and the
conv history ``[B, K - 1, w]``, and takes one elementwise step in the
compute dtype, as the reference's ``rglru_step`` does.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.rglru_scan.ops import linear_recurrence
from repro_torch.models.layers import _ACT, dense_init, truncated_normal

Params = Dict[str, torch.Tensor]

_RGLRU_C = 8.0


def rglru_init(d: int, width: int, conv_size: int,
               generator: torch.Generator, dtype: torch.dtype) -> Params:
    """Weight matrices in ``dtype``; ``log_lambda`` and the gate biases in
    float32 (the reference takes ``softplus(log_lambda)`` in float32)."""
    dev = generator.device
    # Lambda init so a = exp(-c*softplus(L)) lands in [0.9, 0.999]
    u = torch.empty((width,), dtype=torch.float32, device=dev)
    u.uniform_(0.9, 0.999, generator=generator)
    log_a = torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))  # softplus^-1
    return {
        "w_x": dense_init(d, width, generator, dtype),       # input branch
        "w_gate": dense_init(d, width, generator, dtype),    # gelu gate branch
        "w_out": dense_init(width, d, generator, dtype),
        "conv_w": truncated_normal((conv_size, width),
                                   1.0 / math.sqrt(conv_size), generator,
                                   dtype),
        "w_a": dense_init(width, width, generator, dtype),   # recurrence gate
        "w_i": dense_init(width, width, generator, dtype),   # input gate
        "b_a": torch.zeros((width,), dtype=torch.float32, device=dev),
        "b_i": torch.zeros((width,), dtype=torch.float32, device=dev),
        "log_lambda": log_a,
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``, in its form."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _rglru_gates(p: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., w] post-conv activations -> (a, gated input), both in
    ``x.dtype``; the decay in float32."""
    dt = x.dtype
    r = torch.sigmoid(x @ p["w_a"].to(dt) + p["b_a"].to(dt))
    i = torch.sigmoid(x @ p["w_i"].to(dt) + p["b_i"].to(dt))
    log_a = -_RGLRU_C * _softplus(p["log_lambda"].to(torch.float32)) \
        * r.to(torch.float32)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a.to(dt), beta.to(dt) * i * x


def rglru_seq(p: Params, x: torch.Tensor, h0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU.  x: [B, S, w]; h0: [B, w] -> (h [B, S, w],
    h_S [B, w]), both in ``x.dtype``."""
    a, b = _rglru_gates(p, x)
    h, h_last = linear_recurrence(a.contiguous(), b.contiguous(),
                                  h0.to(x.dtype).contiguous())
    return h, h_last


def rglru_step(p: Params, x: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step in the compute dtype.  x: [B, w], h: [B, w]."""
    a, b = _rglru_gates(p, x)
    h_new = a * h + b
    return h_new, h_new


def causal_conv1d(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  w: [K, width], x: [B, S, width]."""
    k, s = w.shape[0], x.shape[1]
    pad = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], 1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i].to(x.dtype)
    return out


def causal_conv1d_step(w: torch.Tensor, x: torch.Tensor, buf: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-time conv.  x: [B, width]; buf: [B, K-1, width] (history)."""
    hist = torch.cat([buf, x[:, None]], dim=1)              # [B, K, w]
    out = torch.einsum("bkw,kw->bw", hist, w.to(x.dtype))
    return out, hist[:, 1:]


def rglru_block_apply(p: Params, x: torch.Tensor,
                      state: Dict[str, torch.Tensor], decode: bool
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Griffin recurrent block: gate branch * RG-LRU branch -> out proj.
    x: [B, S, d] (S = 1 when ``decode``, with ``state`` carrying the
    decode state ``{"h", "conv"}``)."""
    dt = x.dtype
    gate = _ACT["gelu"](x @ p["w_gate"].to(dt))
    u = x @ p["w_x"].to(dt)
    if decode:
        conv_out, conv_buf = causal_conv1d_step(p["conv_w"], u[:, 0],
                                                state["conv"])
        h_new, y = rglru_step(p, conv_out, state["h"])
        y = y[:, None]
    else:
        conv_out = causal_conv1d(p["conv_w"], u)
        y, h_new = rglru_seq(p, conv_out, state["h"])
        k = p["conv_w"].shape[0]
        conv_buf = u[:, -(k - 1):]          # history for subsequent decode
    out = (gate * y) @ p["w_out"].to(dt)
    return out, {"h": h_new, "conv": conv_buf.contiguous()}


def rglru_block_state(batch: int, width: int, conv_size: int, dtype,
                      device) -> Dict[str, torch.Tensor]:
    return {"h": torch.zeros((batch, width), dtype=dtype, device=device),
            "conv": torch.zeros((batch, conv_size - 1, width), dtype=dtype,
                                device=device)}


__all__ = ["causal_conv1d", "causal_conv1d_step", "rglru_block_apply",
           "rglru_block_state", "rglru_init", "rglru_seq", "rglru_step"]

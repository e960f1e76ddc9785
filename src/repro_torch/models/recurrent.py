"""Recurrent blocks (the reference's ``models/recurrent.py``): the
RG-LRU of Griffin / RecurrentGemma and the xLSTM cells, mLSTM and sLSTM.

RG-LRU prefill runs the recurrence through the RG-LRU scan kernel
(``ops.linear_recurrence``: sequential in time, float32), where the
reference takes ``jax.lax.associative_scan`` (the same sums in another
order).  Decode carries O(1) state per layer, ``h [B, w]`` and the
conv history ``[B, K - 1, w]``, and takes one elementwise step in the
compute dtype, as the reference's ``rglru_step`` does.

The mLSTM cell runs its recurrence, prefill and decode alike, through
the chunkwise mLSTM kernel (``ops.mlstm``, from the carried state
``C [B, H, D, D]``, ``n [B, H, D]``, ``m [B, H]``, float32), where the
reference model computes ``mlstm_chunk_math`` in jnp; under grad the
same call goes through ``ops.mlstm``'s autograd Function, whose backward
is the mLSTM chunk backward kernel.  The sLSTM cell is a step loop in
plain torch, as the reference's ``lax.scan``, trained through torch's
autograd of that loop; its state is ``c, n, m`` in float32 and ``h`` in
the compute dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.mlstm_chunk.ops import mlstm
from repro_torch.kernels.mlstm_chunk.ref import NEG_BIG, seq_step
from repro_torch.kernels.rglru_scan.ops import linear_recurrence
from repro_torch.models.layers import (_ACT, dense_init, head_out,
                                       head_proj, row_parallel,
                                       truncated_normal)

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


def _rglru_gates(p: Params, x: torch.Tensor,
                 x_in: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., w] post-conv activations -> (a, gated input), both in
    ``x.dtype``; the decay in float32.  ``x_in``: the whole width the
    gates' products read where ``x`` and the gate weights' columns are a
    block of it (width-parallel under a mesh); default ``x``."""
    dt = x.dtype
    x_in = x if x_in is None else x_in
    r = torch.sigmoid(x_in @ p["w_a"].to(dt) + p["b_a"].to(dt))
    i = torch.sigmoid(x_in @ p["w_i"].to(dt) + p["b_i"].to(dt))
    log_a = -_RGLRU_C * _softplus(p["log_lambda"].to(torch.float32)) \
        * r.to(torch.float32)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a.to(dt), beta.to(dt) * i * x


def rglru_seq(p: Params, x: torch.Tensor, h0: torch.Tensor,
              x_in: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU.  x: [B, S, w]; h0: [B, w] -> (h [B, S, w],
    h_S [B, w]), both in ``x.dtype``.  Under grad the recurrence runs on
    float32 a, b and h0 and h is cast back, as the reference's ``a32,
    b32`` scan: the backward's ``da_t = lambda_t h_{t-1}`` takes the
    float32 h.  The values equal the serving call's bitwise (the kernel
    computes in float32 either way and rounds h once).  ``x_in``: as
    ``_rglru_gates``."""
    a, b = _rglru_gates(p, x, x_in)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or
                                    h0.requires_grad):
        f32 = torch.float32
        h, h_last = linear_recurrence(a.to(f32).contiguous(),
                                      b.to(f32).contiguous(),
                                      h0.to(f32).contiguous())
        return h.to(x.dtype), h_last.to(x.dtype)
    h, h_last = linear_recurrence(a.contiguous(), b.contiguous(),
                                  h0.to(x.dtype).contiguous())
    return h, h_last


def rglru_step(p: Params, x: torch.Tensor, h: torch.Tensor,
               x_in: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step in the compute dtype.  x: [B, w], h: [B, w];
    ``x_in`` as ``_rglru_gates``."""
    a, b = _rglru_gates(p, x, x_in)
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


def _conv(w: torch.Tensor, u: torch.Tensor, state, decode: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's causal conv of u [B, S, w]: (its output, the history
    a later decode step reads)."""
    if decode:
        return causal_conv1d_step(w, u[:, 0], state["conv"])
    return causal_conv1d(w, u), u[:, -(w.shape[0] - 1):]


def _recur(p: Params, conv_out: torch.Tensor, h: torch.Tensor,
           decode: bool, x_in: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over the conv's output from state h: (y [B, S, w], the
    new state)."""
    if decode:
        h_new, y = rglru_step(p, conv_out, h, x_in)
        return y[:, None], h_new
    return rglru_seq(p, conv_out, h, x_in)


def rglru_block_apply(p: Params, x: torch.Tensor,
                      state: Dict[str, torch.Tensor], decode: bool
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Griffin recurrent block: gate branch * RG-LRU branch -> out proj.
    x: [B, S, d] (S = 1 when ``decode``, with ``state`` carrying the
    decode state ``{"h", "conv"}``)."""
    dt = x.dtype
    gate = _ACT["gelu"](x @ p["w_gate"].to(dt))
    u = x @ p["w_x"].to(dt)
    conv_out, conv_buf = _conv(p["conv_w"], u, state, decode)
    y, h_new = _recur(p, conv_out, state["h"], decode)
    out = (gate * y) @ p["w_out"].to(dt)
    return out, {"h": h_new, "conv": conv_buf.contiguous()}


def rglru_block_sharded(sp, p, x, states, decode: bool):
    """``rglru_block_apply`` width-parallel over ``model`` (``state_bw``):
    ``w_x`` / ``w_gate`` column-parallel, the conv and the scan on each
    position's channels (``ops.linear_recurrence`` at W / |model|), the
    gates' products reading the whole conv output (an ``all_gather``
    over ``model``) into their own columns, and ``w_out`` row-parallel
    with one ``psum``.  ``x``, ``states``: the positions' lists (states
    None for prefill)."""
    names = ("w_x", "w_gate", "w_out", "conv_w", "w_a", "w_i", "b_a",
             "b_i", "log_lambda")
    tp = p.spec("w_x")[1] == "model"
    if tp:
        x = sp.pbroadcast(x, "model")
    ws = {n: p.gather(n) for n in names}
    pk = [{n: ws[n][k] for n in names} for k in range(sp.n)]
    dt = x[0].dtype
    gate = [_ACT["gelu"](xk @ q["w_gate"].to(dt)) for xk, q in zip(x, pk)]
    u = [xk @ q["w_x"].to(dt) for xk, q in zip(x, pk)]
    conv = [_conv(q["conv_w"], uk, st, decode)
            for q, uk, st in zip(pk, u, states or [None] * sp.n)]
    conv_out, conv_buf = [c[0] for c in conv], [c[1] for c in conv]
    whole = sp.all_gather(conv_out, "model", conv_out[0].dim() - 1) \
        if tp else conv_out
    ys, new = [], []
    for k in range(sp.n):
        h0 = states[k]["h"] if decode else x[k].new_zeros(
            (x[k].shape[0], conv_out[k].shape[-1]))
        y, h_new = _recur(pk[k], conv_out[k], h0, decode, whole[k])
        out = gate[k] * y
        ys.append(row_parallel(out, pk[k]["w_out"]) if tp
                  else out @ pk[k]["w_out"].to(dt))
        new.append({"h": h_new, "conv": conv_buf[k].contiguous()})
    if tp:
        ys = [y.to(dt) for y in sp.psum(ys, "model")]
    return ys, new


def rglru_block_state(batch: int, width: int, conv_size: int, dtype,
                      device) -> Dict[str, torch.Tensor]:
    return {"h": torch.zeros((batch, width), dtype=dtype, device=device),
            "conv": torch.zeros((batch, conv_size - 1, width), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunkwise kernel) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------


def mlstm_init(d: int, n_heads: int, head_dim: int,
               generator: torch.Generator, dtype: torch.dtype) -> Params:
    """The reference's layout: q/k/v ``[d, H, D]``, ``wo [H, D, d]``,
    ``w_if [d, 2H]`` (input then forget pre-activations) and ``b_if``
    (0 for the input gates, 3 for the forget gates), all in ``dtype``
    (the reference casts them to the compute dtype at use)."""
    width = n_heads * head_dim

    def proj():
        return dense_init(d, width, generator, dtype).reshape(
            d, n_heads, head_dim)

    p = {"wq": proj(), "wk": proj(), "wv": proj(),
         "wo": dense_init(width, d, generator, dtype).reshape(
             n_heads, head_dim, d),
         "w_if": dense_init(d, 2 * n_heads, generator, dtype)}
    p["b_if"] = torch.cat([torch.zeros(n_heads), torch.full((n_heads,), 3.0)]
                          ).to(device=generator.device, dtype=dtype)
    return p


def _mlstm_qkvg(p: Params, x: torch.Tensor):
    """q, k, v [B, S, H, D] in ``x.dtype``; the gate pre-activations
    [B, S, H] in float32, their bias added in the compute dtype."""
    dt = x.dtype
    q, k, v = (head_proj(x, p[n]) for n in ("wq", "wk", "wv"))
    gates = x @ p["w_if"].to(dt) + p["b_if"].to(dt)
    h = q.shape[2]
    i_pre = gates[..., :h].to(torch.float32).contiguous()
    f_pre = gates[..., h:].to(torch.float32).contiguous()
    return q, k, v, i_pre, f_pre


def mlstm_seq(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """mLSTM over x [B, S, d] from ``state`` (``C, n, m``); S = 1 is a
    decode step.  Returns (y [B, S, d], the final state).  Under grad
    (an input or a weight requiring it) ``ops.mlstm`` takes its autograd
    Function: the chunk kernel forward, the chunk backward kernel on
    ``backward``; the values are the serving call's."""
    q, k, v, i_pre, f_pre = _mlstm_qkvg(p, x)
    scale = 1.0 / math.sqrt(q.shape[-1])
    h, C, n, m = mlstm(q, k, v, i_pre, f_pre, state["C"], state["n"],
                       state["m"], scale)
    return head_out(h, p["wo"]), {"C": C, "n": n, "m": m}


def mlstm_seq_ref(p: Params, x: torch.Tensor,
                  state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sequential mLSTM over x [B, S, d] from ``state`` (the
    reference's oracle ``mlstm_seq_ref``): one exact stabilised step at
    a time in float32 (``ref.seq_step``), q scaled by 1 / sqrt(D).
    Returns (y [B, S, d], the final state ``C, n, m``)."""
    dt = x.dtype
    q, k, v, i_pre, f_pre = _mlstm_qkvg(p, x)
    scale = 1.0 / math.sqrt(q.shape[-1])
    C, n, m = state["C"], state["n"], state["m"]
    ys = []
    for t in range(x.shape[1]):
        C, n, m, y = seq_step(C, n, m, q[:, t].to(torch.float32) * scale,
                              k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
        ys.append(y.to(dt))
    y = head_out(torch.stack(ys, dim=1), p["wo"])
    return y, {"C": C, "n": n, "m": m}


def mlstm_state(batch: int, n_heads: int, head_dim: int, device
                ) -> Dict[str, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, head_dim, head_dim), **f32),
            "n": torch.zeros((batch, n_heads, head_dim), **f32),
            "m": torch.full((batch, n_heads), NEG_BIG, **f32)}


def slstm_init(d: int, n_heads: int, head_dim: int,
               generator: torch.Generator, dtype: torch.dtype) -> Params:
    """The reference's layout: ``w_in [d, 4, H, D]`` (gates i, f, z, o),
    the per-head recurrent matrices ``r [4, H, D, D]``, the bias ``b
    [4, H, D]`` and ``wo [H, D, d]``, all in ``dtype``."""
    width = n_heads * head_dim
    return {
        "w_in": dense_init(d, 4 * width, generator, dtype).reshape(
            d, 4, n_heads, head_dim),
        "r": truncated_normal((4, n_heads, head_dim, head_dim),
                              1.0 / math.sqrt(head_dim), generator, dtype),
        "b": torch.zeros((4, n_heads, head_dim), dtype=dtype,
                         device=generator.device),
        "wo": dense_init(width, d, generator, dtype).reshape(
            n_heads, head_dim, d),
    }


def slstm_seq(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """sLSTM with exponential gating and per-head recurrent mixing over
    x [B, S, d], one step at a time.  The pre-activation plus the
    recurrent term is added in the compute dtype, the cell in float32,
    ``h`` carried in the compute dtype.  Returns (y [B, S, d], the final
    state ``c, n, h, m`` [B, H, D])."""
    dt = x.dtype
    _, g, nh, hd = p["w_in"].shape
    pre_all = head_proj(x, p["w_in"]) + p["b"].to(dt)     # [B, S, 4, H, D]
    # r as [H, D, 4 D]: one batched product over the heads a step
    r = p["r"].to(dt).permute(1, 2, 0, 3).reshape(nh, hd, g * hd)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    ys = []
    for t in range(x.shape[1]):
        rec = torch.bmm(h.transpose(0, 1), r).unflatten(-1, (g, hd))
        z_all = (pre_all[:, t] + rec.permute(1, 2, 0, 3)).to(torch.float32)
        i_pre, f_pre, z_pre, o_pre = z_all.unbind(1)
        log_f_m = -_softplus(-f_pre) + m
        m_new = torch.maximum(log_f_m, i_pre)
        i_ = torch.exp(i_pre - m_new)
        f_ = torch.exp(log_f_m - m_new)
        c = f_ * c + i_ * torch.tanh(z_pre)
        n = f_ * n + i_
        h = (torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)).to(dt)
        m = m_new
        ys.append(h)
    y = head_out(torch.stack(ys, dim=1), p["wo"])
    return y, {"c": c, "n": n, "h": h, "m": m}


def slstm_state(batch: int, n_heads: int, head_dim: int, dtype, device
                ) -> Dict[str, torch.Tensor]:
    shape = (batch, n_heads, head_dim)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, dtype=dtype, device=device),
            "m": torch.full(shape, NEG_BIG, **f32)}


__all__ = ["causal_conv1d", "causal_conv1d_step", "mlstm_init", "mlstm_seq",
           "mlstm_seq_ref", "mlstm_state", "rglru_block_apply",
           "rglru_block_sharded", "rglru_block_state", "rglru_init",
           "rglru_seq", "rglru_step", "slstm_init", "slstm_seq", "slstm_state"]

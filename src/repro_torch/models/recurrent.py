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

from repro_torch.kernels.mlstm_chunk.ops import (mlstm,
                                                 mlstm_decode_block_step)
from repro_torch.kernels.mlstm_chunk.ref import (NEG_BIG, decode_block_merge,
                                                 seq_step)
from repro_torch.kernels.rglru_scan.ops import linear_recurrence
from repro_torch.models.layers import (_ACT, dense_init, head_out,
                                       head_proj, row_parallel,
                                       truncated_normal)
from repro_torch.parallel.param_sharding import state_model_dim

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


def _mlstm_qkvg(p: Params, x: torch.Tensor,
                rows: Optional[Tuple[int, int]] = None):
    """q, k, v [B, S, H, D] in ``x.dtype``; the gate pre-activations
    [B, S, H] in float32, their bias added in the compute dtype.
    ``rows`` (first, count): q and k of that block of the D key rows only
    (the key-block decode step)."""
    dt = x.dtype
    wq, wk = p["wq"], p["wk"]
    if rows is not None:
        wq, wk = (w.narrow(2, *rows) for w in (wq, wk))
    q, k, v = (head_proj(x, w) for w in (wq, wk, p["wv"]))
    gates = x @ p["w_if"].to(dt) + p["b_if"].to(dt)
    h = v.shape[2]
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
    pre_all = head_proj(x, p["w_in"]) + p["b"].to(dt)     # [B, S, 4, H, D]
    # r as [H, D, 4 D]: one batched product over the heads a step
    r = _slstm_r(p["r"], dt)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    ys = []
    for t in range(x.shape[1]):
        c, n, h, m = _slstm_step(pre_all[:, t], h, r, c, n, m, dt)
        ys.append(h)
    y = head_out(torch.stack(ys, dim=1), p["wo"])
    return y, {"c": c, "n": n, "h": h, "m": m}


def _slstm_r(r: torch.Tensor, dt) -> torch.Tensor:
    """r [4, H, D_in, D_out] as [H, D_in, 4 D_out] in ``dt``: one batched
    product over the heads a step."""
    g, nh, hd, out = r.shape
    return r.to(dt).permute(1, 2, 0, 3).reshape(nh, hd, g * out)


def _slstm_step(pre_t: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                c: torch.Tensor, n: torch.Tensor, m: torch.Tensor, dt):
    """One sLSTM step: ``pre_t`` [B, 4, H, Do] the input pre-activations
    of the Do state columns the step updates, ``h`` [B, H, D] the whole
    previous output, ``r`` those columns' recurrent matrix
    (``_slstm_r``), ``c``, ``n``, ``m`` the columns' state -> (c, n, h,
    m) of those columns."""
    g = pre_t.shape[1]
    rec = torch.bmm(h.transpose(0, 1), r).unflatten(-1, (g, r.shape[-1] //
                                                         g))
    z_all = (pre_t + rec.permute(1, 2, 0, 3)).to(torch.float32)
    i_pre, f_pre, z_pre, o_pre = z_all.unbind(1)
    log_f_m = -_softplus(-f_pre) + m
    m_new = torch.maximum(log_f_m, i_pre)
    i_ = torch.exp(i_pre - m_new)
    f_ = torch.exp(log_f_m - m_new)
    c = f_ * c + i_ * torch.tanh(z_pre)
    n = f_ * n + i_
    h = (torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)).to(dt)
    return c, n, h, m_new


def slstm_state(batch: int, n_heads: int, head_dim: int, dtype, device
                ) -> Dict[str, torch.Tensor]:
    shape = (batch, n_heads, head_dim)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, dtype=dtype, device=device),
            "m": torch.full(shape, NEG_BIG, **f32)}


# ---------------------------------------------------------------------------
# xLSTM under a mesh: row blocks handed on along ``model``, and the decode
# state split along its widest trailing dimension (``cache_shardings``)
# ---------------------------------------------------------------------------

_MLSTM_W = ("wq", "wk", "wv", "wo", "w_if", "b_if")
_SLSTM_W = ("w_in", "r", "b", "wo")
_STATE_NAMES = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _gathered(sp, p, names):
    """The layer's weights ``names`` gathered whole, one dict a position:
    over ``data`` (``ShardedTree.gather``) and, where the rules split a
    dimension over ``model`` (decode's TP rules split the sLSTM's
    ``w_in [d, 4, H, D]`` along its four gates where ``model`` divides
    4), all-gathered over ``model`` too."""
    ws = {}
    for n in names:
        w = p.gather(n)
        if not sp.seq_rows:
            for dim, e in enumerate(p.spec(n)):
                if e == "model":
                    w = sp.all_gather(w, "model", dim)
        ws[n] = w
    return [{n: ws[n][k] for n in names} for k in range(sp.n)]


def state_block(sp, k: int, t: torch.Tensor) -> torch.Tensor:
    """Position ``k``'s view of a recurrent-state leaf whose rows are its
    own, as ``param_sharding.cache_shardings`` lays it out: the widest
    trailing dimension (the first of the widest) split over ``model``
    where ``model`` divides it, else whole (the mLSTM's ``C [B, H, D, D]``
    and ``n`` by key rows, ``m [B, H]`` whole at a ``model`` that does not
    divide the heads; the sLSTM's four leaves by ``head_dim``)."""
    n = sp.mesh.shape["model"]
    dim = state_model_dim(t.shape, n)
    if dim is None:
        return t
    c = t.shape[dim] // n
    return t.narrow(dim, sp.index(k)["model"] * c, c)


def _key_rows(sp, k: int, d: int) -> Tuple[int, int]:
    """(first, count) of position ``k``'s block of a state dimension of
    ``d`` split over ``model``."""
    n = sp.mesh.shape["model"]
    if d % n:
        raise ValueError(f"a state dimension of {d} does not split over a "
                         f"model axis of {n}")
    return sp.index(k)["model"] * (d // n), d // n


def _chain(sp, h, init, step, real: int = 0):
    """``step(k, state, rows) -> (y, final state)`` position by position,
    in row-major order, each position starting from the state its
    predecessor along ``model`` hands on (``Spmd.hand_on``), the first
    from ``init(k)``.  ``real`` (a padded prefill's real rows of the
    whole sequence; 0: all): a position steps over its real rows only,
    its padded rows' outputs zero, and one with none hands its starting
    state on, so the state stops at the last real row.  Returns the
    positions' outputs and final states."""
    ys, finals = [None] * sp.n, [None] * sp.n
    for k in range(sp.n):
        prev = sp.prev_along(k)
        st = sp.hand_on(k, None if prev is None else finals[prev],
                        init(k) if prev is None else None, anchor=h[k])
        c = h[k].shape[1]
        mine = c if not real else \
            min(max(real - sp.index(k)["model"] * c, 0), c)
        if mine == 0:
            ys[k], finals[k] = torch.zeros_like(h[k]), tuple(st)
            continue
        y, finals[k] = step(k, st, h[k] if mine == c else h[k][:, :mine])
        ys[k] = y if mine == c else torch.cat(
            [y, y.new_zeros((y.shape[0], c - mine, y.shape[2]))], dim=1)
    return ys, finals


def final_state_blocks(sp, finals, flavor: str):
    """Each position's block (``state_block``) of a chain's final state,
    the last position's along ``model`` given to every position of its
    group (``Spmd.from_index``: GSPMD's all-reduce to which the others
    add zeros): the decode cache a prefill leaves."""
    names = _STATE_NAMES[flavor]
    last = sp.mesh.shape["model"] - 1
    whole = [sp.from_index([f[i] for f in finals], "model", last)
             for i in range(len(names))]
    return [{name: state_block(sp, k, whole[i][k]).contiguous().to(
        sp.device(k)) for i, name in enumerate(names)}
        for k in range(sp.n)]


def mlstm_sharded(sp, p, h, states, decode: bool, real: int = 0):
    """``mlstm_seq`` under a mesh (``p`` the layer's ``ShardedTree``,
    ``h`` / ``states`` the positions' lists).  Rows over ``model``
    (``sp.seq_rows``, train and prefill): each position projects its own
    rows with the weights gathered whole and runs ``ops.mlstm`` from the
    state its predecessor along ``model`` hands on (``_chain``; ``real``
    a padded prefill's real rows); returns
    (y, the positions' final states ``(C, n, m)``).  Decode: each position
    holds its block of the key rows of ``C`` and ``n`` (``state_block``)
    and ``m`` whole, forms q and k for its rows and v whole, runs the
    decode kernel's key-block mode (``ops.mlstm_decode_block_step``) and
    the blocks' partial numerators and denominators are summed over
    ``model`` (two ``psum``s, float32) before the one division; returns
    (y, the new state blocks)."""
    ws = _gathered(sp, p, _MLSTM_W)
    nh, d = ws[0]["wq"].shape[1:]
    scale = 1.0 / math.sqrt(d)
    if decode:
        nums, dens, new = [], [], []
        for k in range(sp.n):
            rows = _key_rows(sp, k, d)
            q, kk, v, i_pre, f_pre = _mlstm_qkvg(ws[k], h[k], rows)
            st = states[k]
            num, den, C, n, m = mlstm_decode_block_step(
                q.contiguous(), kk.contiguous(), v.contiguous(), i_pre,
                f_pre, st["C"], st["n"], st["m"], scale)
            nums.append(num)
            dens.append(den)
            new.append({"C": C, "n": n, "m": m})
        nums, dens = sp.psum(nums, "model"), sp.psum(dens, "model")
        ys = [head_out(decode_block_merge(a, b, st["m"]).to(x.dtype),
                       w["wo"])
              for a, b, st, x, w in zip(nums, dens, new, h, ws)]
        return ys, new

    def init(k):
        return tuple(mlstm_state(h[k].shape[0], nh, d,
                                 sp.device(k)).values())

    def step(k, st, rows):
        q, kk, v, i_pre, f_pre = _mlstm_qkvg(ws[k], rows)
        out, C, n, m = mlstm(q, kk, v, i_pre, f_pre, *st, scale)
        return head_out(out, ws[k]["wo"]), (C, n, m)
    return _chain(sp, h, init, step, real)


def slstm_sharded(sp, p, h, states, decode: bool, real: int = 0):
    """``slstm_seq`` under a mesh.  Rows over ``model`` (train and
    prefill): each position runs the step loop on its own rows from the
    state its predecessor hands on (``_chain``), so each token runs once;
    returns (y, the final states ``(c, n, h, m)``).  Decode: each
    position holds its block of ``head_dim`` of the four state leaves;
    ``h`` is all-gathered over ``model``, each position forms the
    recurrent term and the gates of its columns and updates them, and the
    new ``h`` blocks are all-gathered for the output projection; returns
    (y, the new state blocks)."""
    ws = _gathered(sp, p, _SLSTM_W)
    dt = h[0].dtype
    _, _, nh, d = ws[0]["w_in"].shape
    if decode:
        prev = sp.all_gather([st["h"] for st in states], "model", 2)
        new = []
        for k in range(sp.n):
            lo, c = _key_rows(sp, k, d)
            w, st = ws[k], states[k]
            pre = head_proj(h[k], w["w_in"].narrow(3, lo, c)) + \
                w["b"].narrow(2, lo, c).to(dt)
            r = _slstm_r(w["r"].narrow(3, lo, c), dt)
            cs, ns, hs, ms = _slstm_step(pre[:, 0], prev[k], r, st["c"],
                                         st["n"], st["m"], dt)
            new.append({"c": cs, "n": ns, "h": hs, "m": ms})
        whole = sp.all_gather([st["h"] for st in new], "model", 2)
        return [head_out(hw[:, None], w["wo"])
                for hw, w in zip(whole, ws)], new

    def init(k):
        return tuple(slstm_state(h[k].shape[0], nh, d, dt,
                                 sp.device(k)).values())

    def step(k, st, rows):
        y, fin = slstm_seq(ws[k], rows, dict(zip(_STATE_NAMES["slstm"], st)))
        return y, tuple(fin[n] for n in _STATE_NAMES["slstm"])
    return _chain(sp, h, init, step, real)


__all__ = ["causal_conv1d", "causal_conv1d_step", "final_state_blocks",
           "mlstm_init", "mlstm_seq", "mlstm_seq_ref", "mlstm_sharded",
           "mlstm_state", "rglru_block_apply",
           "rglru_block_sharded", "rglru_block_state", "rglru_init",
           "rglru_seq", "rglru_step", "slstm_init", "slstm_seq", "slstm_sharded",
           "slstm_state", "state_block"]

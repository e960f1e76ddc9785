"""Plain PyTorch versions of the chunkwise mLSTM kernels.

``mlstm_chunk_ref`` is the reference's ``models/recurrent.py::
mlstm_chunk_math`` chunk by chunk from an initial state ``(C0, n0, m0)``,
in float32 and in the reference's operation order.  By default it cuts
``S`` as the reference's ``mlstm_seq`` does (chunks of 256, or one chunk
of ``S`` when 256 does not divide it); ``chunk=`` sets another length,
the last chunk ragged.

``mlstm_decode_block_ref`` is the decode step on a block of the
state's key rows, its partial numerator and denominator undivided (the
decode kernel's key-block mode); ``decode_block_merge`` divides their
sums over the blocks.

``mlstm_chunk_bwd_ref`` is its backward, written out chunk by chunk in
float32 (not autograd: the backward kernel needs a like-for-like plain
version).  Per chunk of L steps, in ``chunk_math``'s notation: b =
cumsum(log sigmoid(f)), a = i - b, mx = max(m0, cummax a), w[t, s] =
exp(a_s - mx_t) for s <= t, inter_t = exp(m0 - mx_t), m_t = b_t + mx_t;
S = scale q k^T, sw = S * w; num = sw V + scale inter q C0, den_raw =
rowsum(sw) + scale inter q . n0, den = max(|den_raw|, exp(-m_t)), h =
num / den; decay_s = exp(a_s - mx_L), carry = exp(m0 - mx_L), C1 =
carry C0 + sum_s decay_s k_s v_s^T, n1 likewise, m1 = b_L + mx_L.

* Only mx is a stabiliser: every h_t, and the state's represented value
  C e^m, n e^m, is exactly invariant to it, so the backward holds mx
  constant (no gradient through cummax or max) but for one term.  m
  itself is not: m1 = b_L + mx_L carries the chunk's forget gates into
  the next chunk, so dm1 adds to db_L, and dm0 (from inter_t and the
  carry) goes back to the previous chunk.  The one term: the final
  state's (C1, n1, m1) moves with mx_L as (-C1, -n1, 1), so mx_L's
  gradient is the residual r = dm1 - <dC1, C1> - <dn1, n1>.  It is zero
  when the final state's gradients are a downstream's that reads only
  the represented value (training's, unused: None; every chunk's for the
  next), and otherwise goes to mx_L = max(m0, max_s a_s)'s argmax: to
  dm0 where m0 holds the max (m0 >= max_s a_s), and on to the previous
  chunk as its own residual; else to da at the first s* with a_s* =
  mx_L, the previous chunk's residual then 0.  So the gradient is exact
  for any (dh, dC1, dn1, dm1), and the same at any chunk length.
* dnum_t = dh_t / den_t, dden_t = -dh_t . h_t / den_t.  Where |den_raw_t|
  wins, dden_raw_t = sign(den_raw_t) dden_t; where exp(-m_t) wins (the
  common case at random init, xLSTM's max(|n^T q|, 1)), dden_raw_t = 0
  and db_t gains -exp(-m_t) dden_t = dh_t . h_t.
* dsw = (dnum V^T + dden_raw 1^T) masked to s <= t; dv = sw^T dnum +
  decay (dC1^T k); dq = scale (dsw * w) K + scale inter (C0 dnum +
  dden_raw n0); dk = scale (dsw * w)^T Q + decay (dC1 v + dn1); da_s =
  sum_t (dsw * sw)[t, s] + decay_s (k_s^T dC1 v_s + k_s . dn1).
* di = da, db -= da, dlog_f = the reverse cumsum of db, df = dlog_f
  sigmoid(-f); dC0 = carry dC1 + scale sum_t inter_t q_t dnum_t^T, dn0 =
  carry dn1 + scale sum_t inter_t dden_raw_t q_t, dm0 = sum_t inter_t
  (scale q_t^T C0 dnum_t + scale q_t . n0 dden_raw_t) + carry (<dC1, C0>
  + <dn1, n0>).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: the reference model's chunk length (``mlstm_seq(chunk=256)``)
MODEL_CHUNK = 256
NEG_BIG = -1e30


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-jax.nn.softplus(-x)`` in softplus's ``max(y, 0) + log1p(exp(-|y|))``
    form: log of the forget gate."""
    y = -x
    return -(torch.clamp(y, min=0.0) + torch.log1p(torch.exp(-torch.abs(y))))


def model_chunk(s: int) -> int:
    """The reference's chunk length for a sequence of ``s``."""
    l = min(MODEL_CHUNK, s)
    return s if s % l else l


def _chunk_terms(q, k, v, i_pre, f_pre, C0, n0, m0, scale: float) -> dict:
    """The forward's terms of one chunk, in the reference's operation
    order (``chunk_math`` and ``chunk_bwd_math`` share them)."""
    l = q.shape[1]
    b = torch.cumsum(log_sigmoid(f_pre), dim=1)
    a = i_pre - b
    M = torch.cummax(a, dim=1).values
    mx = torch.maximum(m0[:, None], M)
    m_t = b + mx
    inter_scale = torch.exp(m0[:, None] - mx)
    w = torch.exp(a[:, None, :, :] - mx[:, :, None, :])       # [B,t,s,H]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    w = torch.where(mask, w, torch.zeros_like(w))
    scores = torch.einsum("bthd,bshd->btsh", q, k) * scale
    sw = scores * w
    intra = torch.einsum("btsh,bshd->bthd", sw, v)
    inter = torch.einsum("bthd,bhdv->bthv", q, C0) * \
        (scale * inter_scale)[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", q, n0) * scale * inter_scale
    den_raw = torch.sum(sw, dim=2) + den_inter
    den = torch.maximum(torch.abs(den_raw), torch.exp(-m_t))
    return dict(b=b, a=a, mx=mx, m_t=m_t, inter_scale=inter_scale, w=w,
                mask=mask, sw=sw, inter=inter, num=inter + intra,
                den_inter=den_inter, den_raw=den_raw, den=den)


def chunk_math(q, k, v, i_pre, f_pre, C0, n0, m0, scale: float):
    """One chunk.  q, k, v [B, L, H, D] float32; gates [B, L, H]; C0
    [B, H, D, D], n0 [B, H, D], m0 [B, H] -> (h [B, L, H, D], C1, n1,
    m1), all float32."""
    t = _chunk_terms(q, k, v, i_pre, f_pre, C0, n0, m0, scale)
    h = t["num"] / t["den"][..., None]
    mx_e = t["mx"][:, -1]
    decay = torch.exp(t["a"] - mx_e[:, None])
    carry = torch.exp(m0 - mx_e)
    C1 = carry[..., None, None] * C0 + \
        torch.einsum("bshd,bshv,bsh->bhdv", k, v, decay)
    n1 = carry[..., None] * n0 + torch.einsum("bshd,bsh->bhd", k, decay)
    m1 = t["b"][:, -1] + mx_e
    return h, C1, n1, m1


def _walk(q, k, v, i_pre, f_pre, C0, n0, m0, scale: float,
          chunk: Optional[int]):
    """Each chunk's operands and starting state, float32, as
    ``mlstm_chunk_ref`` cuts S."""
    s = q.shape[1]
    l = model_chunk(s) if chunk is None else chunk
    f32 = torch.float32
    ops = [t.to(f32) for t in (q, k, v, i_pre, f_pre)]
    state = (C0.to(f32), n0.to(f32), m0.to(f32))
    for c0 in range(0, s, l):
        args = [t[:, c0:c0 + l] for t in ops]
        yield args, state
        state = chunk_math(*args, *state, scale)[1:]


def raw_normaliser(q, k, v, i_pre, f_pre, C0, n0, m0, scale: float,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """[B, S, H] bool: the steps whose normaliser is |den_raw| rather
    than exp(-m_t) (the branch the backward's gradient takes), chunk by
    chunk as ``mlstm_chunk_ref`` cuts S."""
    raw = []
    for args, state in _walk(q, k, v, i_pre, f_pre, C0, n0, m0, scale,
                             chunk):
        t = _chunk_terms(*args, *state, scale)
        raw.append(torch.abs(t["den_raw"]) >= torch.exp(-t["m_t"]))
    return torch.cat(raw, dim=1)


def m0_holds_max(q, k, v, i_pre, f_pre, C0, n0, m0, scale: float,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """[chunks, B, H] bool: the chunks whose starting m0 holds the max
    over their a_s, so that mx_L's gradient goes to m0 rather than to an
    a_s (the backward's residual), chunk by chunk as ``mlstm_chunk_ref``
    cuts S."""
    return torch.stack([
        state[2] >= (args[3] - torch.cumsum(log_sigmoid(args[4]), dim=1)
                     ).max(dim=1).values
        for args, state in _walk(q, k, v, i_pre, f_pre, C0, n0, m0, scale,
                                 chunk)])


def mlstm_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor,
                    C0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                    scale: float, chunk: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """q, k, v [B, S, H, D] (q unscaled, any float dtype); i_pre, f_pre
    [B, S, H]; state C0 [B, H, D, D], n0 [B, H, D], m0 [B, H] -> (h
    [B, S, H, D] in ``q.dtype``, C1, n1, m1 in float32)."""
    s, out_dtype = q.shape[1], q.dtype
    if s < 1:
        raise ValueError("mlstm_chunk_ref: S must be at least 1")
    l = model_chunk(s) if chunk is None else chunk
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    i_pre, f_pre = i_pre.to(f32), f_pre.to(f32)
    C, n, m = C0.to(f32), n0.to(f32), m0.to(f32)
    hs = []
    for c0 in range(0, s, l):
        sl = slice(c0, min(c0 + l, s))
        h, C, n, m = chunk_math(q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                                f_pre[:, sl], C, n, m, scale)
        hs.append(h)
    return torch.cat(hs, dim=1).to(out_dtype), C, n, m


def chunk_bwd_math(q, k, v, i_pre, f_pre, C0, n0, m0, dh, dC1, dn1, dm1,
                   scale: float, dmx=None):
    """The backward of one chunk (the module docstring's rules): the
    forward's operands as ``chunk_math`` takes them, dh [B, L, H, D], the
    final state's gradients dC1, dn1, dm1 and the residual dmx [B, H]
    (mx_L's gradient; each None: zeros), all float32 -> (dq, dk, dv, di,
    df, dC0, dn0, dm0, the previous chunk's residual), float32."""
    t = _chunk_terms(q, k, v, i_pre, f_pre, C0, n0, m0, scale)
    a, mx, m_t, inter, w, mask, sw, num_inter, num, den_inter, den_raw, \
        den = (t[n] for n in ("a", "mx", "m_t", "inter_scale", "w", "mask",
                              "sw", "inter", "num", "den_inter", "den_raw",
                              "den"))
    # the backward
    dnum = dh / den[..., None]
    hdh = torch.sum(dh * num, dim=-1) / den                    # dh . h
    raw = torch.abs(den_raw) >= torch.exp(-m_t)
    dden_raw = torch.where(raw, -torch.sign(den_raw) * hdh / den,
                           torch.zeros_like(den))
    db = torch.where(raw, torch.zeros_like(den), hdh)
    dsw = torch.einsum("bthv,bshv->btsh", dnum, v) + dden_raw[:, :, None]
    dsw = torch.where(mask, dsw, torch.zeros_like(dsw))
    dv = torch.einsum("btsh,bthv->bshv", sw, dnum)
    da = torch.sum(dsw * sw, dim=1)
    ds = dsw * w * scale
    dq = torch.einsum("btsh,bshd->bthd", ds, k) + (scale * inter)[..., None] \
        * (torch.einsum("bhdv,bthv->bthd", C0, dnum)
           + dden_raw[..., None] * n0[:, None])
    dk = torch.einsum("btsh,bthd->bshd", ds, q)
    dC0 = torch.einsum("bthd,bthv->bhdv", q * (scale * inter)[..., None],
                       dnum)
    dn0 = torch.einsum("bth,bthd->bhd", scale * inter * dden_raw, q)
    dm0 = torch.sum(num_inter * dnum, dim=(1, 3)) + \
        torch.sum(den_inter * dden_raw, dim=1)
    decay = torch.exp(a - mx[:, -1:])                          # [B,L,H]
    carry = torch.exp(m0 - mx[:, -1])                          # [B,H]
    if dC1 is not None:
        u = torch.einsum("bhdv,bshv->bshd", dC1, v)
        dk = dk + decay[..., None] * u
        dv = dv + decay[..., None] * torch.einsum("bhdv,bshd->bshv", dC1, k)
        da = da + decay * torch.sum(k * u, dim=-1)
        dC0 = dC0 + carry[..., None, None] * dC1
        dm0 = dm0 + carry * torch.sum(dC1 * C0, dim=(-2, -1))
    if dn1 is not None:
        dk = dk + decay[..., None] * dn1[:, None]
        da = da + decay * torch.einsum("bshd,bhd->bsh", k, dn1)
        dn0 = dn0 + carry[..., None] * dn1
        dm0 = dm0 + carry * torch.sum(dn1 * n0, dim=-1)
    if dm1 is not None:
        db = torch.cat([db[:, :-1], db[:, -1:] + dm1[:, None]], dim=1)
    if dmx is not None:
        # mx_L = max(m0, max_s a_s): its gradient to m0 where m0 holds the
        # max, else to da at the first argmax
        top = torch.max(a, dim=1)
        held = m0 >= top.values
        pick = torch.arange(a.shape[1], device=a.device)[None, :, None] == \
            top.indices[:, None]
        da = da + torch.where(pick & ~held[:, None], dmx[:, None],
                              torch.zeros_like(da))
        dmx = torch.where(held, dmx, torch.zeros_like(dmx))
        dm0 = dm0 + dmx
    db = db - da
    dlog_f = torch.flip(torch.cumsum(torch.flip(db, [1]), dim=1), [1])
    df = dlog_f * torch.sigmoid(-f_pre)
    return dq, dk, dv, da, df, dC0, dn0, dm0, dmx


def mlstm_chunk_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor,
                        C0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                        scale: float, dh: torch.Tensor,
                        dC1: Optional[torch.Tensor] = None,
                        dn1: Optional[torch.Tensor] = None,
                        dm1: Optional[torch.Tensor] = None,
                        chunk: Optional[int] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``mlstm_chunk_ref`` (same chunks) from the
    gradients dh [B, S, H, D] of h and dC1, dn1, dm1 of the final state
    (None: zeros) -> (dq, dk, dv in ``q.dtype``; di, df [B, S, H], dC0,
    dn0, dm0 in float32).  A forward pass records each chunk's starting
    state and the final one, then a reverse pass over the chunks carries
    (dC, dn, dm) and the residual of mx_L's gradient, dm1 - <dC1, C1> -
    <dn1, n1> at the last chunk."""
    s, out_dtype = q.shape[1], q.dtype
    if s < 1:
        raise ValueError("mlstm_chunk_bwd_ref: S must be at least 1")
    l = model_chunk(s) if chunk is None else chunk
    f32 = torch.float32
    q, k, v, dh = q.to(f32), k.to(f32), v.to(f32), dh.to(f32)
    i_pre, f_pre = i_pre.to(f32), f_pre.to(f32)
    state = (C0.to(f32), n0.to(f32), m0.to(f32))
    cuts = [slice(c0, min(c0 + l, s)) for c0 in range(0, s, l)]
    starts = []
    for sl in cuts:
        starts.append(state)
        state = chunk_math(q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                           f_pre[:, sl], *state, scale)[1:]
    dstate = tuple(None if g is None else g.to(f32) for g in (dC1, dn1, dm1))
    dmx = None
    if any(g is not None for g in dstate):
        # mx_L's gradient at the last chunk: dm1 - <dC1, C1> - <dn1, n1>
        gC, gn, gm = dstate
        dmx = torch.zeros_like(state[2]) if gm is None else gm
        if gC is not None:
            dmx = dmx - (gC * state[0]).sum((-2, -1))
        if gn is not None:
            dmx = dmx - (gn * state[1]).sum(-1)
    grads = []
    for sl, st in zip(reversed(cuts), reversed(starts)):
        g = chunk_bwd_math(q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                           f_pre[:, sl], *st, dh[:, sl], *dstate, scale, dmx)
        grads.append(g[:5])
        dstate, dmx = g[5:8], g[8]
    dq, dk, dv, di, df = (torch.cat(list(reversed(gs)), dim=1)
                          for gs in zip(*grads))
    return (dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype), di, df,
            *dstate)


def mlstm_decode_block_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, i_pre: torch.Tensor,
                           f_pre: torch.Tensor, C0: torch.Tensor,
                           n0: torch.Tensor, m0: torch.Tensor, scale: float
                           ) -> Tuple[torch.Tensor, ...]:
    """The decode step (S = 1) on a block of DK of the D key rows, as a
    position of a mesh whose ``model`` axis splits the state's key
    dimension holds it: q, k [B, 1, H, DK] (the block's rows of q, k), v
    [B, 1, H, D], the gates [B, 1, H], C0 [B, H, DK, D], n0 [B, H, DK]
    and m0 [B, H] (whole) -> (num [B, H, D], den [B, H], C1 [B, H, DK,
    D], n1 [B, H, DK], m1 [B, H]), float32.  num and den are the block's
    partial numerator ``(q C0) scale carry + sw v`` and raw denominator
    ``sw + (q . n0) scale carry`` (sw = scale (q . k) exp(a - mx)), in
    ``chunk_math``'s order within the block and undivided: summed over
    the blocks they are the one-step chunk's num and den_raw, and h =
    num / max(|den|, exp(-m1))."""
    f32 = torch.float32
    q, k, v = (t[:, 0].to(f32) for t in (q, k, v))
    ip, fp = i_pre[:, 0].to(f32), f_pre[:, 0].to(f32)
    C0, n0, m0 = C0.to(f32), n0.to(f32), m0.to(f32)
    b = log_sigmoid(fp)
    a = ip - b
    mx = torch.maximum(m0, a)
    inter_scale = torch.exp(m0 - mx)
    w = torch.exp(a - mx)
    sw = torch.einsum("bhd,bhd->bh", q, k) * scale * w
    inter = torch.einsum("bhd,bhdv->bhv", q, C0) * \
        (scale * inter_scale)[..., None]
    num = inter + sw[..., None] * v
    den = sw + torch.einsum("bhd,bhd->bh", q, n0) * scale * inter_scale
    C1 = inter_scale[..., None, None] * C0 + \
        torch.einsum("bhd,bhv,bh->bhdv", k, v, w)
    n1 = inter_scale[..., None] * n0 + k * w[..., None]
    return num, den, C1, n1, b + mx


def decode_block_merge(num: torch.Tensor, den: torch.Tensor,
                       m1: torch.Tensor) -> torch.Tensor:
    """h [B, 1, H, D] float32 from the blocks' summed ``num`` [B, H, D]
    and ``den`` [B, H] (``mlstm_decode_block_ref``) and the new m1:
    ``num / max(|den|, exp(-m1))``."""
    return (num / torch.maximum(torch.abs(den), torch.exp(-m1))[..., None]
            )[:, None]


def seq_step(C, n, m, qt, kt, vt, ip, fp):
    """One step of the exact sequential mLSTM recurrence (the
    reference's ``mlstm_ref`` / ``mlstm_seq_ref`` step), in float32 from
    the carried state: (C, n, m, num / den)."""
    log_f = log_sigmoid(fp)
    m_new = torch.maximum(log_f + m, ip)
    i_ = torch.exp(ip - m_new)
    f_ = torch.exp(log_f + m - m_new)
    kt, vt, qt = (t.to(torch.float32) for t in (kt, vt, qt))
    C = f_[..., None, None] * C + i_[..., None, None] * \
        (kt[..., :, None] * vt[..., None, :])
    n = f_[..., None] * n + i_[..., None] * kt
    num = torch.einsum("bhkv,bhk->bhv", C, qt)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                        torch.exp(-m_new))
    return C, n, m_new, num / den[..., None]


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """The exact sequential recurrence from the zero state (the
    reference's oracle ``kernels/mlstm_chunk/ref.py::mlstm_ref``): q, k,
    v [B, H, S, D] (q pre-scaled), gates [B, H, S] -> h [B, H, S, D] in
    q's dtype, one step at a time in float32."""
    bsz, h, s, d = q.shape
    dev = q.device
    C = torch.zeros((bsz, h, d, d), dtype=torch.float32, device=dev)
    n = torch.zeros((bsz, h, d), dtype=torch.float32, device=dev)
    m = torch.full((bsz, h), NEG_BIG, dtype=torch.float32, device=dev)
    ys = []
    for t in range(s):
        C, n, m, y = seq_step(C, n, m, q[:, :, t], k[:, :, t], v[:, :, t],
                              i_pre[:, :, t].to(torch.float32),
                              f_pre[:, :, t].to(torch.float32))
        ys.append(y.to(q.dtype))
    return torch.stack(ys, dim=2)


__all__ = ["MODEL_CHUNK", "NEG_BIG", "chunk_bwd_math", "chunk_math",
           "decode_block_merge", "log_sigmoid", "m0_holds_max",
           "mlstm_decode_block_ref", "mlstm_chunk_bwd_ref",
           "mlstm_chunk_ref", "mlstm_ref", "model_chunk", "raw_normaliser",
           "seq_step"]

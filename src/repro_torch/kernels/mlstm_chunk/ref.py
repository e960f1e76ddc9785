"""Plain PyTorch version of the chunkwise mLSTM kernel: the reference's
``models/recurrent.py::mlstm_chunk_math`` chunk by chunk from an initial
state ``(C0, n0, m0)``, in float32 and in the reference's operation
order.  By default it cuts ``S`` as the reference's ``mlstm_seq`` does
(chunks of 256, or one chunk of ``S`` when 256 does not divide it);
``chunk=`` sets another length, the last chunk ragged.
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


def chunk_math(q, k, v, i_pre, f_pre, C0, n0, m0, scale: float):
    """One chunk.  q, k, v [B, L, H, D] float32; gates [B, L, H]; C0
    [B, H, D, D], n0 [B, H, D], m0 [B, H] -> (h [B, L, H, D], C1, n1,
    m1), all float32."""
    l = q.shape[1]
    log_f = log_sigmoid(f_pre)
    b = torch.cumsum(log_f, dim=1)
    a = i_pre - b
    M = torch.cummax(a, dim=1).values
    mx = torch.maximum(m0[:, None], M)
    m_t = b + mx
    inter_scale = torch.exp(m0[:, None] - mx)
    w = torch.exp(a[:, None, :, :] - mx[:, :, None, :])       # [B,t,s,H]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    w = torch.where(mask[None, :, :, None], w, torch.zeros_like(w))
    scores = torch.einsum("bthd,bshd->btsh", q, k) * scale
    sw = scores * w
    intra = torch.einsum("btsh,bshd->bthd", sw, v)
    inter = torch.einsum("bthd,bhdv->bthv", q, C0) * \
        (scale * inter_scale)[..., None]
    num = inter + intra
    den_raw = torch.sum(sw, dim=2) + \
        torch.einsum("bthd,bhd->bth", q, n0) * scale * inter_scale
    den = torch.maximum(torch.abs(den_raw), torch.exp(-m_t))
    h = num / den[..., None]
    mx_e = mx[:, -1]
    decay = torch.exp(a - mx_e[:, None])
    carry = torch.exp(m0 - mx_e)
    C1 = carry[..., None, None] * C0 + \
        torch.einsum("bshd,bshv,bsh->bhdv", k, v, decay)
    n1 = carry[..., None] * n0 + torch.einsum("bshd,bsh->bhd", k, decay)
    m1 = b[:, -1] + mx_e
    return h, C1, n1, m1


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


__all__ = ["MODEL_CHUNK", "NEG_BIG", "chunk_math", "log_sigmoid",
           "mlstm_chunk_ref", "model_chunk"]

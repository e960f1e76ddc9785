"""Attention of the served LMs: GQA with causal / sliding-window masks,
logit softcap, rotary embeddings (M-RoPE included), KV caches (flat, or
a rolling buffer for a window shorter than the cache), non-causal
self-attention and cross-attention on external K/V (whisper).

Prefill attention runs the flash-attention kernel (``ops.mha``) and one
decode step the decode-attention kernel (``ops.decode_mha``): a CUDA
tensor launches the kernel, a CPU tensor takes its plain version.  The
reference computes both with jnp (``models/attention.py``) and swaps its
Pallas kernels in on a TPU; here the kernels are the path, cross-attention
included: prefill's through the flash kernel with a key length of its
own, a decode step's through the decode kernel with every slot valid.

Layouts are the reference's: ``wq``/``wk``/``wv`` ``[d, heads, Dh]``,
``wo`` ``[H, Dh, d]``, activations ``[B, S, heads, Dh]``, caches
``[B, size, KV, Dh]``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_mha
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.layers import (apply_rope, dense_init, head_out,
                                       head_proj, row_parallel)

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


def proj(p: Params, x: torch.Tensor, w: str, b: str) -> torch.Tensor:
    """x [B, T, d] -> [B, T, heads, Dh] by ``p[w]``, plus the bias ``p[b]``
    where the layer has one."""
    y = head_proj(x, p[w])
    return y + p[b].to(x.dtype) if b in p else y


def _qkv(p: Params, x: torch.Tensor, pos: torch.Tensor, theta: float,
         mrope: Tuple[int, ...] = ()
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = (proj(p, x, w, b) for w, b in (("wq", "bq"), ("wk", "bk"),
                                              ("wv", "bv")))
    if theta:
        q = apply_rope(q, pos, theta, mrope)
        k = apply_rope(k, pos, theta, mrope)
    return q, k, v


def attention(p: Params, x: torch.Tensor, pos: torch.Tensor, *,
              causal: bool = True, window: int = 0, cap: float = 0.0,
              theta: float = 10000.0, mrope: Tuple[int, ...] = (),
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) attention: x [B, S, d], pos [B, S] or
    [B, S, 3] under M-RoPE (the rotary positions; the masks take positions
    ``arange(S)``, which is what prefill passes), causal or not.  ``kv``:
    external K/V ``[B, Sk, KV, Dh]``, already projected (and rotated),
    for cross-attention: only q is projected, and the call takes no mask
    (``causal=False``, no window) over a key length of its own.  Returns
    (y [B, S, d], k, v): the rotated k/v ``[B, S, KV, Dh]`` that prefill
    lays out as the decode cache (the reference recomputes them), or the
    external ones."""
    if kv is None:
        q, k, v = _qkv(p, x, pos, theta, mrope)
    else:
        q = proj(p, x, "wq", "bq")
        if theta:
            q = apply_rope(q, pos, theta, mrope)
        k, v = kv
    o = mha(q, k, v, causal=causal, window=window, cap=cap)
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


def flat_cache(t: torch.Tensor, size: int) -> torch.Tensor:
    """A prompt's K or V [B, S, KV, Dh] laid out as a flat decode cache
    [B, size, KV, Dh]: zero-padded past S, or cut to ``size``."""
    s = t.shape[1]
    if s < size:
        t = torch.cat([t, t.new_zeros((t.shape[0], size - s) + t.shape[2:])],
                      dim=1)
    return t[:, :size].contiguous()


def decode_attention(p: Params, x: torch.Tensor, pos: torch.Tensor,
                     cache: Dict[str, torch.Tensor], *, window: int = 0,
                     cap: float = 0.0, theta: float = 10000.0,
                     mrope: Tuple[int, ...] = ()
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: x [B, 1, d]; pos [B, 1] int32, the current
    position (or [B, 1, 3] under M-RoPE, whose axis 0 places the slot).
    Returns (y [B, 1, d], cache).

    The new k/v are written in place at slot ``pos % size`` (the
    reference selects over the whole cache with ``jnp.where``; the
    values are the same).  Slot validity: a flat cache holds positions
    ``<= pos``; a rolling cache holds position ``pos - ((pos - s) mod
    size)`` in slot s, valid iff >= 0, which is slot ``s <= min(pos,
    size - 1)``: the kernel's mask with that bound.
    """
    q, k_new, v_new = _qkv(p, x, pos, theta, mrope)
    return head_out(_decode(q, k_new, v_new, pos, cache, cap), p["wo"]), \
        cache


def _decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
            pos: torch.Tensor, cache: Dict[str, torch.Tensor],
            cap: float) -> torch.Tensor:
    """``decode_attention``'s body after the projections: the new k/v
    written into ``cache`` at their slots, then ``ops.decode_mha`` over
    the valid slots.  Returns the heads' output o [B, 1, H, Dh] (before
    ``wo``)."""
    k_cache, v_cache = cache["k"], cache["v"]
    b, size = k_cache.shape[:2]
    cur = (pos[..., 0] if pos.dim() == 3 else pos)[:, 0]
    rows = torch.arange(b, device=q.device)
    slot = (cur % size).long()
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    last = torch.clamp(cur, max=size - 1).to(torch.int32)
    return decode_mha(q, k_cache, v_cache, last, cap=cap)


def cross_decode_attention(p: Params, x: torch.Tensor,
                           kv: Tuple[torch.Tensor, torch.Tensor]
                           ) -> torch.Tensor:
    """One decode step's cross-attention (no rotation: whisper's theta is
    0): x [B, 1, d] over external K/V ``[B, Sk, KV, Dh]`` kept from
    prefill, every slot valid (the decode kernel with ``pos = Sk - 1``
    for each row).  The reference runs its full-sequence attention on the
    one query; the result is the same.  Returns y [B, 1, d]."""
    k, v = kv
    q = proj(p, x, "wq", "bq")
    last = torch.full((x.shape[0],), k.shape[1] - 1, dtype=torch.int32,
                      device=x.device)
    return head_out(decode_mha(q, k, v, last), p["wo"])


# ---------------------------------------------------------------------------
# head-parallel attention under a mesh (``w_qkv``, ``w_o``, ``act_bthd``)
# ---------------------------------------------------------------------------


def local_heads(n_heads: int, n_kv: int, n_model: int,
                m: int) -> Tuple[int, int, int, int]:
    """(first q head, q heads, first KV head, KV heads) of the position
    at index ``m`` along a ``model`` axis of ``n_model``: a block of
    n_heads / n_model q heads and the KV heads they read, so a KV head
    is held by every position whose q heads read it where ``model``
    exceeds the KV heads.  Raises where the q heads do not split, or a
    block's heads would not read its KV heads in GQA order."""
    if n_heads % n_model:
        raise ValueError(f"{n_heads} heads do not split over a model axis "
                         f"of {n_model}")
    hq, g = n_heads // n_model, n_heads // n_kv
    if hq % g and g % hq:
        raise ValueError(f"a block of {hq} of {n_heads} heads does not "
                         f"read whole groups of {n_kv} KV heads")
    q_lo = m * hq
    return q_lo, hq, q_lo // g, max(1, hq // g)


def _head_counts(sp, p) -> Tuple[int, int]:
    """The layer's (q heads, KV heads) from its stored blocks."""
    n_model = sp.mesh.shape["model"]
    hq = p.local("wq")[0].shape[1] * (n_model if p.spec("wq")[1] ==
                                      "model" else 1)
    kv = p.local("wk")[0].shape[1] * (n_model if p.spec("wk")[1] ==
                                      "model" else 1)
    return hq, kv


def _kv_heads(sp, p, name: str, dim: int):
    """A K or V weight (or bias) block of each position's KV heads: the
    stored block where ``model`` splits the KV heads, else the whole
    weight, gathered as a partial use (each position reads only its
    heads, and their gradients sum over the positions sharing one), cut
    to the position's heads."""
    if p.spec(name)[dim] == "model":
        return p.gather(name)
    n_heads, n_kv = _head_counts(sp, p)
    whole = p.gather(name, partial=True)
    out = []
    for k, w in enumerate(whole):
        _, _, kv_lo, kv_n = local_heads(n_heads, n_kv,
                                        sp.mesh.shape["model"],
                                        sp.index(k)["model"])
        out.append(w.narrow(dim, kv_lo, kv_n))
    return out


def _qkv_sharded(sp, p, h, pos, theta: float, mrope: Tuple[int, ...]):
    """Each position's q heads and the K/V heads they read, from ``h``
    replicated over ``model`` (entering through ``pbroadcast``)."""
    h = sp.pbroadcast(h, "model")
    ws = {"wq": p.gather("wq"), "wk": _kv_heads(sp, p, "wk", 1),
          "wv": _kv_heads(sp, p, "wv", 1)}
    if p.has("bq"):
        ws.update(bq=p.gather("bq"), bk=_kv_heads(sp, p, "bk", 0),
                  bv=_kv_heads(sp, p, "bv", 0))
    qkv = [_qkv({n: w[k] for n, w in ws.items()}, h[k], pos[k], theta,
                mrope) for k in range(sp.n)]
    return tuple(list(t) for t in zip(*qkv))


def attention_sharded(sp, p, h, pos, *, causal: bool = True,
                      window: int = 0, cap: float = 0.0,
                      theta: float = 10000.0, mrope: Tuple[int, ...] = ()):
    """``attention`` head-parallel over ``model``: each position runs
    ``ops.mha`` at its own q and KV heads, its ``wo`` rows give a
    partial output (``layers.row_parallel``), and one ``psum`` over
    ``model`` sums them.  Returns
    (y replicated over ``model``, the positions' rotated k, v)."""
    qs, ks, vs = _qkv_sharded(sp, p, h, pos, theta, mrope)
    wo = p.gather("wo")
    ys = [_head_out_partial(mha(q, kk, v, causal=causal, window=window,
                                cap=cap), w)
          for q, kk, v, w in zip(qs, ks, vs, wo)]
    return _summed(sp, ys, h), ks, vs


def _head_out_partial(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """A position's ``head_out`` over its heads: the ``row_parallel``
    partial of the whole product."""
    b, t = o.shape[:2]
    return row_parallel(o.reshape(b, t, -1), wo.reshape(-1, wo.shape[-1]))


def _summed(sp, ys, like):
    """The positions' partials summed over ``model``, in ``like``'s
    dtype."""
    return [y.to(x.dtype) for y, x in zip(sp.psum(ys, "model"), like)]


def decode_attention_sharded(sp, p, h, pos, caches, *, window: int = 0,
                             cap: float = 0.0, theta: float = 10000.0,
                             mrope: Tuple[int, ...] = ()):
    """``decode_attention`` head-parallel over ``model``: each position
    writes its KV heads' new k/v into its cache block (``kv_bskd``) and
    runs ``ops.decode_mha`` at its own heads; one ``psum`` over
    ``model``.  Returns (y, the caches, updated in place)."""
    qs, ks, vs = _qkv_sharded(sp, p, h, pos, theta, mrope)
    ys = [_head_out_partial(_decode(q, kn, vn, ps, c, cap), w)
          for q, kn, vn, ps, c, w in zip(qs, ks, vs, pos, caches,
                                         p.gather("wo"))]
    return _summed(sp, ys, h), caches


__all__ = ["attention", "attention_sharded", "attn_init",
           "cross_decode_attention", "decode_attention",
           "decode_attention_sharded", "flat_cache", "init_cache",
           "local_heads", "proj"]

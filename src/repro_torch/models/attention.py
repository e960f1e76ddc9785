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

Under a mesh (``parallel.sharding.Spmd``) attention runs head-parallel
over ``model`` (``attention_sharded``, ``decode_attention_sharded``), or
in the reference's two sequence layouts: ``attn_seq_shard``
(``attention_seq_sharded``: each position's rows, K/V all-gathered over
``model``, the flash kernel at a query-row offset) and ``seq_shard_kv``
(``decode_attention_seq_kv``: each position's block of the cache's
slots, the decode kernel's partial results merged across ``model`` by
their log-sum-exps; ``cache_block`` cuts a prefill's whole cache into
those blocks).  Whisper's encoder and cross-attention run
``attention_seq_sharded`` non-causally over keys gathered and cut to
their real length (``kv_seq_sharded``), and a decode step's
cross-attention reads a cross cache held by slots, by heads or whole
(``cross_decode_sharded``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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


def _ws(sp, p, names):
    """The weights ``names`` (those the layer has) gathered whole, one
    dict a position."""
    ws = {n: p.gather(n) for n in names if p.has(n)}
    return [{n: w[k] for n, w in ws.items()} for k in range(sp.n)]


_QKV = ("wq", "wk", "wv", "bq", "bk", "bv")


def attention_seq_sharded(sp, p, h, pos, *, causal: bool = True,
                          window: int = 0, cap: float = 0.0,
                          theta: float = 10000.0,
                          mrope: Tuple[int, ...] = (), keys: int = 0,
                          kv=None):
    """``attention`` under ``attn_seq_shard`` (``sp.seq_rows``): position
    m holds rows ``[m c, (m + 1) c)`` of the sequence (``h`` its rows,
    ``pos`` their rotary positions) and the layer's whole weights
    (FSDP-only, gathered as partial uses), projects q / k / v for its
    rows, all-gathers K and V over ``model`` (the backward
    reduce-scatters their gradients) and runs ``ops.mha`` at query offset
    ``m c`` against the keys ``[0, (m + 1) c)``; ``wo`` on its rows, no
    collective after.  ``causal=False`` (whisper's encoder): every row
    reads every key, the gathered keys cut to their ``keys`` real rows
    first (0: all; a sequence padded to a multiple of |model| needs no
    key mask then, and its padded query rows are computed and dropped).
    ``kv`` (the positions' whole K and V, gathered and cut already:
    cross-attention) projects q alone.  Returns (y, the whole K and V on
    each position, [B, S, KV, Dh], for the decode cache)."""
    ws = _ws(sp, p, _QKV + ("wo",))
    if kv is None:
        qkv = [_qkv(w, hk, pk, theta, mrope)
               for w, hk, pk in zip(ws, h, pos)]
        qs = [t[0] for t in qkv]
        ks = sp.all_gather([t[1] for t in qkv], "model", 1)
        vs = sp.all_gather([t[2] for t in qkv], "model", 1)
    else:
        qs = [proj(w, hk, "wq", "bq") for w, hk in zip(ws, h)]
        if theta:
            qs = [apply_rope(q, pk, theta, mrope) for q, pk in zip(qs, pos)]
        ks, vs = kv
    ys = []
    for k in range(sp.n):
        if causal:
            c = qs[k].shape[1]
            end = (sp.index(k)["model"] + 1) * c
            o = mha(qs[k], ks[k][:, :end], vs[k][:, :end], causal=True,
                    window=window, cap=cap, q_offset=end - c)
        else:
            n = keys or ks[k].shape[1]
            o = mha(qs[k], ks[k][:, :n], vs[k][:, :n], causal=False,
                    cap=cap)
        ys.append(head_out(o, ws[k]["wo"]))
    return ys, ks, vs


def kv_seq_sharded(sp, p, x, keys: int = 0):
    """Cross-attention's K and V under ``attn_seq_shard``: each position
    projects its own rows of ``x`` (the encoder's output) with the
    layer's whole ``wk`` / ``wv`` (and biases), and they are all-gathered
    over ``model`` and cut to their ``keys`` real rows (0: all).  Returns
    the positions' whole K and V."""
    ws = _ws(sp, p, ("wk", "wv", "bk", "bv"))
    out = []
    for w, b in (("wk", "bk"), ("wv", "bv")):
        full = sp.all_gather([proj(q, xk, w, b) for q, xk in zip(ws, x)],
                             "model", 1)
        out.append([t[:, :keys] if keys else t for t in full])
    return out


def all_kv_heads(sp, xs, n_heads: int, n_kv: int) -> List[torch.Tensor]:
    """Every KV head on each position, from the positions' head blocks
    (``local_heads``) ``xs`` [B, S, kv heads, Dh]: an all-gather over
    ``model`` along the heads, a head held by several positions (``model``
    above the KV heads) taken once."""
    n = sp.mesh.shape["model"]
    full = sp.all_gather(xs, "model", 2)
    kv_n = local_heads(n_heads, n_kv, n, 0)[3]
    if kv_n * n == n_kv:
        return full
    first = {}
    for m in range(n):
        _, _, lo, cnt = local_heads(n_heads, n_kv, n, m)
        for j in range(lo, lo + cnt):
            first.setdefault(j, m * kv_n + j - lo)
    idx = [first[j] for j in range(n_kv)]
    return [t.index_select(2, torch.tensor(idx, device=t.device))
            for t in full]


def cache_view(sp, k: int, t: torch.Tensor, n_heads: int,
               n_kv: int) -> torch.Tensor:
    """Position ``k``'s view of one cache tensor whose rows are its own
    (``[B_loc, size, KV, Dh]``): slots ``[m L, (m + 1) L)`` under
    ``sp.seq_kv`` (L = size / |model|), else its KV heads
    (``local_heads``)."""
    n, m = sp.mesh.shape["model"], sp.index(k)["model"]
    if sp.seq_kv:
        if t.shape[1] % n:
            raise ValueError(f"a cache of {t.shape[1]} slots does not "
                             f"split over a model axis of {n}")
        blk = t.shape[1] // n
        return t.narrow(1, m * blk, blk)
    _, _, lo, cnt = local_heads(n_heads, n_kv, n, m)
    return t.narrow(2, lo, cnt)


def cache_block(sp, k: int, cache: Dict[str, torch.Tensor], n_heads: int,
                n_kv: int) -> Dict[str, torch.Tensor]:
    """Position ``k``'s block of a decode cache whose rows are its own
    (``cache_view``), contiguous."""
    return {name: cache_view(sp, k, t, n_heads, n_kv).contiguous()
            for name, t in cache.items()}


def decode_attention_seq_kv(sp, p, h, pos, caches, *, window: int = 0,
                            cap: float = 0.0, theta: float = 10000.0,
                            mrope: Tuple[int, ...] = ()):
    """``decode_attention`` under ``seq_shard_kv`` (``sp.seq_kv``):
    position m holds slots ``[m L, (m + 1) L)`` of every KV head's cache
    (a rolling cache of ``size`` slots split alike).  Every position
    forms q for all H heads and the new k / v for all KV heads (where
    ``model`` splits the heads, its own heads' all-gathered over it); the
    position owning slot ``pos % size`` writes them, row by row; each
    runs ``ops.decode_mha(return_lse=True)`` against its block up to its
    local bound ``min(pos, size - 1) - m L`` (negative: no valid slot,
    output 0 and lse ``-inf``); the blocks merge in float32, M =
    ``pmax(lse)``, o = ``psum(o e^(lse - M)) / psum(e^(lse - M))``.  Then
    each position takes its heads for a row-parallel ``wo`` and one
    ``psum``, or, where ``wo`` is whole, the whole output.  Returns (y,
    the caches, updated in place)."""
    heads = p.spec("wq")[1] == "model"
    if heads:
        n_heads, n_kv = _head_counts(sp, p)
        qs, ks, vs = _qkv_sharded(sp, p, h, pos, theta, mrope)
        qs = sp.all_gather(qs, "model", 2)
        ks, vs = (all_kv_heads(sp, t, n_heads, n_kv) for t in (ks, vs))
    else:
        ws = _ws(sp, p, _QKV)
        qkv = [_qkv(w, hk, pk, theta, mrope)
               for w, hk, pk in zip(ws, h, pos)]
        qs, ks, vs = ([t[i] for t in qkv] for i in range(3))
    n = sp.mesh.shape["model"]
    outs, lses = [], []
    for k in range(sp.n):
        c = caches[k]
        kc, vc = c["k"], c["v"]
        b, blk = kc.shape[:2]
        lo = sp.index(k)["model"] * blk
        cur = (pos[k][..., 0] if pos[k].dim() == 3 else pos[k])[:, 0]
        local = cur % (blk * n) - lo
        own = ((local >= 0) & (local < blk))[:, None, None]
        rows = torch.arange(b, device=kc.device)
        slot = local.clamp(0, blk - 1).long()
        kc[rows, slot] = torch.where(own, ks[k][:, 0].to(kc.dtype),
                                     kc[rows, slot])
        vc[rows, slot] = torch.where(own, vs[k][:, 0].to(vc.dtype),
                                     vc[rows, slot])
        last = (torch.clamp(cur, max=blk * n - 1) - lo).to(torch.int32)
        o, lse = decode_mha(qs[k], kc, vc, last, cap=cap, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return _merged_out(sp, p, outs, lses, h, heads), caches


def _all_q(sp, p, h, pos, theta: float, mrope: Tuple[int, ...],
           heads: bool):
    """Every q head on each position: where ``model`` splits the heads,
    each position's own all-gathered over it, else projected whole."""
    if heads:
        h = sp.pbroadcast(h, "model")
        wq = p.gather("wq")
        bq = p.gather("bq") if p.has("bq") else [None] * sp.n
        qs = []
        for k in range(sp.n):
            q = head_proj(h[k], wq[k])
            q = q + bq[k].to(q.dtype) if bq[k] is not None else q
            qs.append(apply_rope(q, pos[k], theta, mrope) if theta else q)
        return sp.all_gather(qs, "model", 2)
    ws = _ws(sp, p, ("wq", "bq"))
    qs = [proj(w, hk, "wq", "bq") for w, hk in zip(ws, h)]
    return [apply_rope(q, pk, theta, mrope) if theta else q
            for q, pk in zip(qs, pos)]


def _merged_out(sp, p, outs, lses, h, heads: bool):
    """The positions' partial attention over their blocks of slots merged
    in float32 by their log-sum-exps (M = ``pmax(lse)``, o =
    ``psum(o e^(lse - M)) / psum(e^(lse - M))``), then ``wo``: each
    position's heads row-parallel and one ``psum`` where ``model`` splits
    the heads, else whole."""
    top = sp.pmax(lses, "model")
    wts = [torch.exp(lse - mx) for lse, mx in zip(lses, top)]
    num = sp.psum([o.float() * w[:, None, :, None]
                   for o, w in zip(outs, wts)], "model")
    den = sp.psum(wts, "model")
    o = [(a / d[:, None, :, None]).to(hk.dtype)
         for a, d, hk in zip(num, den, h)]
    wo = p.gather("wo")
    if heads:
        ys = []
        for k in range(sp.n):
            q_lo, hq = wo[k].shape[0] * sp.index(k)["model"], wo[k].shape[0]
            ys.append(_head_out_partial(o[k][:, :, q_lo:q_lo + hq], wo[k]))
        return _summed(sp, ys, h)
    return [head_out(ok, w) for ok, w in zip(o, wo)]


def cross_decode_sharded(sp, p, h, kvs, layout: str):
    """``cross_decode_attention`` under a mesh, the cross K/V held as
    ``param_sharding.cache_shardings`` lays them out (``layout``):
    ``slots`` (each position a block of the frames' slots, every slot
    valid: every q head on each position, ``ops.decode_mha(return_lse=
    True)`` on the block and the blocks merged by their log-sum-exps as
    ``decode_attention_seq_kv`` merges them, no write), ``heads`` (each
    position its KV heads, ``model`` splitting the q heads too: the
    decode kernel on its heads, ``wo`` row-parallel and one ``psum``) or
    ``whole`` (every position the whole cache and every head).  ``kvs``:
    the positions' (K, V) blocks.  Returns y."""
    heads = p.spec("wq")[1] == "model"
    none = [None] * sp.n
    if layout == "heads":
        if not heads:
            raise ValueError("a cross cache by heads reads q heads split "
                             "over model")
        h = sp.pbroadcast(h, "model")
        ws = {n: p.gather(n) for n in ("wq", "bq") if p.has(n)}
        qs = [proj({n: w[k] for n, w in ws.items()}, h[k], "wq", "bq")
              for k in range(sp.n)]
        ys = []
        for k, (q, (kb, vb), w) in enumerate(zip(qs, kvs, p.gather("wo"))):
            last = torch.full((q.shape[0],), kb.shape[1] - 1,
                              dtype=torch.int32, device=q.device)
            ys.append(_head_out_partial(decode_mha(q, kb, vb, last), w))
        return _summed(sp, ys, h)
    qs = _all_q(sp, p, h, none, 0.0, (), heads)
    if layout == "whole":
        return [head_out(decode_mha(q, kb, vb, torch.full(
            (q.shape[0],), kb.shape[1] - 1, dtype=torch.int32,
            device=q.device)), w)
            for q, (kb, vb), w in zip(qs, kvs, p.gather("wo"))]
    outs, lses = [], []
    for q, (kb, vb) in zip(qs, kvs):
        last = torch.full((q.shape[0],), kb.shape[1] - 1, dtype=torch.int32,
                          device=q.device)
        o, lse = decode_mha(q, kb, vb, last, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return _merged_out(sp, p, outs, lses, h, heads)


__all__ = ["all_kv_heads", "attention", "attention_seq_sharded",
           "attention_sharded", "attn_init", "cache_block", "cache_view",
           "cross_decode_attention", "cross_decode_sharded",
           "decode_attention",
           "decode_attention_seq_kv", "decode_attention_sharded",
           "flat_cache", "init_cache", "kv_seq_sharded", "local_heads",
           "proj"]

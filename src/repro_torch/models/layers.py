"""Shared LM building blocks on tensors, the reference's
``models/layers.py``: initialisers, the per-head projections
(``head_proj``, ``head_out``), ``rmsnorm``, ``layernorm``, the (gated)
MLP, rotary embeddings (M-RoPE included), ``softcap``, the embedding
lookup, the LM head and the training loss (``cross_entropy``), and their
counterparts under a mesh (``mlp_sharded``, ``embed_lookup_sharded``,
``lm_head_sharded``, ``cross_entropy_sharded``).

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


def mlp_hidden(p: Params, x: torch.Tensor, act: str,
               glu: bool) -> torch.Tensor:
    """The MLP's activations before ``w_out``: x [..., d] -> [..., d_ff]
    (the columns ``p``'s ``w_in`` / ``w_gate`` hold)."""
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if glu:
        return _ACT[act](x @ p["w_gate"].to(dt)) * h
    return _ACT[act](h)


def mlp(p: Params, x: torch.Tensor, act: str, glu: bool) -> torch.Tensor:
    return mlp_hidden(p, x, act, glu) @ p["w_out"].to(x.dtype)


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


# ---------------------------------------------------------------------------
# Under a mesh: the reference's FSDP x TP layouts, run position by position
# ---------------------------------------------------------------------------
#
# ``sp`` is the program's ``parallel.sharding.Spmd``, ``p`` a
# ``param_sharding.ShardedTree`` of the layer's weights, activations are
# lists of the positions' blocks: ``[B_loc, S, d]`` rows over the batch
# axes, replicated over ``model`` (``act_btd``); under ``sp.seq_rows``
# (``attn_seq_shard``) ``[B_loc, S / |model|, d]``, a block of the
# sequence's rows a position.  There the norms, the MLP, the embedding
# and the head run row-wise on whole weights, FSDP-only and gathered as
# partial uses (``ShardedTree.gather``), so their gradients sum over
# ``model``; the loss is the mean over every global token that counts.


class _WideProduct(torch.autograd.Function):
    """x [M, K] @ w [K, N], both 16-bit, with a float32 output: on the
    card (and ``meta``) cuBLAS's 16-bit product with a float32 result
    (``torch.mm(..., out_dtype=)``, on the tensor cores), on the CPU the
    product of the upcast operands (exact 16-bit products, float32 sums
    either way).  The backward takes the output's gradient back to the
    operands' dtype and forms dX and dW as the unsharded product's
    backward does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return x.float() @ w.float()
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel block's partial product x [..., k] @ w [k, n]: for
    16-bit x with a float32 result (``_WideProduct``: the tensor cores'
    float32 sums kept), so the ``psum`` over ``model`` adds the partials
    in float32 and the sum is rounded to x's dtype once, as the
    unsharded product is."""
    w = w.to(x.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16):
        return x @ w
    y = _WideProduct.apply(x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[-1])


def mlp_sharded(sp, p, h, act: str, glu: bool):
    """The MLP with ``w_in`` / ``w_gate`` column-parallel and ``w_out``
    row-parallel over ``model`` (``act_btf``; its partial products
    ``row_parallel``), one ``psum`` after; with a d_ff that ``model``
    does not divide, every position runs it whole."""
    tp = p.spec("w_in")[1] == "model"
    if tp:
        h = sp.pbroadcast(h, "model")
    names = ("w_in", "w_out") + (("w_gate",) if glu else ())
    ws = {n: p.gather(n) for n in names}
    pk = [{n: ws[n][k] for n in names} for k in range(sp.n)]
    if not tp:
        return [mlp(q, hk, act, glu) for q, hk in zip(pk, h)]
    ys = [row_parallel(mlp_hidden(q, hk, act, glu), q["w_out"])
          for q, hk in zip(pk, h)]
    return [y.to(x.dtype) for y, x in zip(sp.psum(ys, "model"), h)]


def vocab_slice(sp, k: int, table_block: torch.Tensor) -> int:
    """The first vocabulary id of position ``k``'s rows of a
    vocab-parallel table block."""
    return sp.index(k)["model"] * table_block.shape[0]


def embed_lookup_sharded(sp, p, tokens, dtype: torch.dtype):
    """The vocab-parallel lookup (``w_vd``): each position looks up the
    ids in its slice of the table, zero elsewhere, and one ``psum`` over
    ``model`` sums the slices; a table ``model`` does not split, or one
    gathered whole for the rows of ``sp.seq_rows``, is looked up
    whole."""
    table = p.gather("table")
    if sp.seq_rows or p.spec("table")[0] != "model":
        return [F.embedding(t, w.to(dtype)) for t, w in zip(tokens, table)]
    out = []
    for k, (t, w) in enumerate(zip(tokens, table)):
        ids = t - vocab_slice(sp, k, w)
        inside = (ids >= 0) & (ids < w.shape[0])
        e = F.embedding(torch.where(inside, ids, torch.zeros_like(ids)),
                        w.to(dtype))
        out.append(e * inside[..., None].to(dtype))
    return sp.psum(out, "model")


def lm_head_sharded(sp, table, x, final_cap: float = 0.0,
                    vocab_parallel: bool = True):
    """Each position's logits over its slice of the vocabulary
    (``act_btv``; the softcap on each slice), from the whole table
    blocks ``table``; ``x`` replicated over ``model`` enters through
    ``pbroadcast``."""
    if vocab_parallel:
        x = sp.pbroadcast(x, "model")
    return [lm_head(w, xk, final_cap) for w, xk in zip(table, x)]


def cross_entropy_sharded(sp, logits, labels, mask=None,
                          vocab_parallel: bool = True) -> torch.Tensor:
    """``cross_entropy`` of vocab-parallel logits, the full ``[B, S, V]``
    never gathered: the logsumexp from a ``pmax`` and a ``psum`` over
    ``model``, the label's logit from the position whose slice holds it
    (a ``psum``), and the token mean over the batch axes (``psum`` of
    the masked sums and the weights, or ``pmean`` of the shards' equal
    means).  Under ``sp.seq_rows`` each position's logits are its rows'
    over the whole vocabulary, and the mean is over every token of the
    batch axes and ``model`` (``psum`` of the sums and of the counts:
    the positions may hold different numbers of tokens, a VLM's patch
    rows holding none).  Returns the loss once (``Spmd.unreplicate``)."""
    lg = [t.to(torch.float32) for t in logits]
    if vocab_parallel:
        mx = sp.pmax([t.amax(dim=-1) for t in lg], "model")
        se = sp.psum([torch.exp(t - m[..., None]).sum(-1)
                      for t, m in zip(lg, mx)], "model")
        lse = [m + torch.log(e) for m, e in zip(mx, se)]
        lls = []
        for k, (t, lab) in enumerate(zip(lg, labels)):
            ids = lab.long() - sp.index(k)["model"] * t.shape[-1]
            inside = (ids >= 0) & (ids < t.shape[-1])
            ll = torch.gather(t, -1, torch.where(
                inside, ids, torch.zeros_like(ids))[..., None])[..., 0]
            lls.append(ll * inside.to(torch.float32))
        lls = sp.psum(lls, "model")
    else:
        lse = [torch.logsumexp(t, dim=-1) for t in lg]
        lls = [torch.gather(t, -1, lab[..., None].long())[..., 0]
               for t, lab in zip(lg, labels)]
    nll = [a - b for a, b in zip(lse, lls)]
    batch = sp.batch_axes()
    if sp.seq_rows:
        batch = batch + ("model",)
        if mask is None:
            mask = [torch.ones_like(n) for n in nll]
    if mask is not None:
        ms = [m.to(torch.float32) for m in mask]
        num = sp.psum([torch.sum(n * m) for n, m in zip(nll, ms)], batch)
        den = sp.psum([torch.sum(m) for m in ms], batch)
        loss = [a / torch.clamp(b, min=1.0) for a, b in zip(num, den)]
    else:
        loss = sp.pmean([torch.mean(n) for n in nll], batch)
    return sp.unreplicate(loss)


__all__ = ["apply_rope", "cross_entropy", "cross_entropy_sharded",
           "dense_init", "embed_init", "embed_lookup", "embed_lookup_sharded",
           "head_out", "head_proj", "layernorm", "layernorm_init", "lm_head",
           "lm_head_sharded", "mlp", "mlp_hidden", "mlp_init", "mlp_sharded",
           "mrope_bands",
           "rmsnorm", "rmsnorm_init", "rope_freqs", "row_parallel", "softcap",
           "truncated_normal", "vocab_slice"]

"""Mixture-of-Experts MLP (granite-moe, olmoe): top-k routing with
capacity-based dispatch (the reference's ``models/moe.py``, its
single-device ``moe_apply``).

Tokens are laid into a dense, statically shaped buffer, as in the
reference (GShard style): groups are sequences, so a token's position in
its expert is a cumsum over its own sequence's ``S * k`` picks, and a
pick past the capacity ``cap = max(1, ceil(S k cf / E))`` is dropped (it
adds nothing and gets zero combine weight).  The reference's buffer is
``[B, E, cap, d]``; here it is ``[E, B * cap, d]``, flat row
``e * B * cap + b * cap + pos``, so each expert's rows are contiguous for
the grouped GEMM kernel (``ops.expert_gemm``) with no transposed copy.
The products are the same.  Routing, scatter and combine are plain
PyTorch, as they are outside the Pallas kernel in the reference.
``moe_sharded`` is the reference's expert-parallel path inside the
sharded program: each mesh position dispatches its data shard's picks of
its own experts into an ``[E_loc, cap, d]`` buffer.
``moe_apply_expert_parallel`` runs it over a ``Mesh`` for a whole input.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.moe_matmul.ops import expert_gemm
from repro_torch.models.layers import _ACT, dense_init, truncated_normal
from repro_torch.parallel.param_sharding import shard_params
from repro_torch.parallel.sharding import NamedSharding, P, Spmd, batch_spec

Params = Dict[str, torch.Tensor]


def moe_init(d: int, n_experts: int, d_expert: int, glu: bool,
             generator: torch.Generator, dtype: torch.dtype) -> Params:
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(d_expert)
    p = {
        "router": dense_init(d, n_experts, generator, dtype),
        "w_in": truncated_normal((n_experts, d, d_expert), scale_in,
                                 generator, dtype),
        "w_out": truncated_normal((n_experts, d_expert, d), scale_out,
                                  generator, dtype),
    }
    if glu:
        p["w_gate"] = truncated_normal((n_experts, d, d_expert), scale_in,
                                       generator, dtype)
    return p


def capacity(s: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert per sequence (the reference's formula)."""
    return max(1, int(math.ceil(s * top_k * capacity_factor / n_experts)))


def one_hot(idx: torch.Tensor, e: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, e)`` in ``dtype``, formed as its CUDA kernel forms
    it (zeros, then a scatter of ones) on every device: ``F.one_hot``
    reads the indices' range back to the host on the CPU and takes
    another formulation on ``meta``, so the three devices would run three
    programs (``launch.op_analysis`` counts them alike)."""
    out = torch.zeros((*idx.shape, e), dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx.unsqueeze(-1), 1)


def moe_route(p: Params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float) -> Dict[str, torch.Tensor]:
    """Routing of x [B, S, d]: ``gate`` and ``idx`` [B, S, k] (the top-k
    probabilities in descending order, ties to the lower expert, as
    ``jax.lax.top_k``; gates renormalised), ``pos`` and ``keep``
    [B, S * k] (position in the expert within the sequence, and whether
    it is under the capacity), ``aux`` (the Switch load-balancing loss)
    and ``cap``."""
    dt = x.dtype
    b, s, _ = x.shape
    e = p["router"].shape[1]
    cap = capacity(s, top_k, e, capacity_factor)
    logits = x @ p["router"].to(dt)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=(0, 1))                                     # [E]
    ce = one_hot(idx, e, torch.float32).mean(dim=(0, 1, 2))    # [E]
    aux = e * torch.sum(me * ce)

    idx_flat = idx.reshape(b, s * top_k)
    onehot = one_hot(idx_flat, e, torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, -1, idx_flat[..., None])[..., 0]
    return {"gate": gate, "idx": idx, "pos": pos, "keep": pos < cap,
            "aux": aux, "cap": cap}


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, act: str,
              glu: bool, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss)."""
    dt = x.dtype
    b, s, d = x.shape
    e = p["w_in"].shape[0]
    r = moe_route(p, x, top_k=top_k, capacity_factor=capacity_factor)
    cap, keep = r["cap"], r["keep"]
    idx_flat = r["idx"].reshape(b, s * top_k)
    rows = b * cap                                  # slots of one expert
    n_slots = e * rows

    # --- dispatch: each pick's copy of its token put in its slot, as the
    # reference's scatter (a kept slot takes one pick; dropped picks go
    # to a trash row cut off after).  The gradient is then a gather at the
    # slots and a sum over the k copies: deterministic, where a gather of
    # the tokens would take an atomic bf16 index_add ----------------------
    seq = torch.arange(b, device=x.device)[:, None]
    slot = idx_flat * rows + seq * cap + torch.clamp(r["pos"], max=cap - 1)
    dest = torch.where(keep, slot, torch.full_like(slot, n_slots))
    x_rep = x[:, :, None].expand(b, s, top_k, d).reshape(b * s * top_k, d)
    buf = x.new_zeros((n_slots + 1, d)).index_copy(
        0, dest.reshape(-1), x_rep)[:n_slots].view(e, rows, d)

    # --- expert GEMMs --------------------------------------------------
    h = expert_gemm(buf, p["w_in"].to(dt))
    if glu:
        h = _ACT[act](expert_gemm(buf, p["w_gate"].to(dt))) * h
    else:
        h = _ACT[act](h)
    y_buf = expert_gemm(h, p["w_out"].to(dt)).view(n_slots, d)

    # --- combine -------------------------------------------------------
    y_tok = y_buf.index_select(0, slot.reshape(-1)).view(b, s * top_k, d)
    w = (r["gate"].reshape(b, s * top_k) * keep.to(torch.float32)).to(dt)
    y = (y_tok * w[..., None]).view(b, s, top_k, d).sum(dim=2)
    return y, r["aux"]


# ---------------------------------------------------------------------------
# expert-parallel path
# ---------------------------------------------------------------------------
#
# Activations are model-replicated outside the MLP, so every expert shard
# already holds all of its data shard's tokens: each shard routes them to
# its own E / |model| experts, and one psum over "model" combines the
# shards' outputs.  Capacity counts the data shard's flattened tokens,
# not each sequence's as ``moe_apply`` does, so where the capacity binds
# the two paths drop different picks.


def _route_flat(router: torch.Tensor, xt: torch.Tensor, *, top_k: int,
                e: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing of the flattened tokens xt [T, d] over all ``e`` experts:
    (gate [T, k] renormalised, idx [T, k], the Switch aux loss)."""
    logits = xt @ router.to(xt.dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = one_hot(idx, e, torch.float32).mean(dim=(0, 1))
    return gate, idx, e * torch.sum(me * ce)


def _local_experts(m: int, gate: torch.Tensor, idx: torch.Tensor,
                   xt: torch.Tensor, w_in: torch.Tensor,
                   w_gate: torch.Tensor, w_out: torch.Tensor, *,
                   top_k: int, act: str, glu: bool, e: int, e_loc: int,
                   capacity_factor: float) -> torch.Tensor:
    """The picks of experts [m e_loc, (m + 1) e_loc) among the routed
    tokens xt [T, d] dispatched into an [e_loc, cap, d] buffer, run and
    combined: the partial output [T, d]."""
    dt = xt.dtype
    t, d = xt.shape
    lo = m * e_loc
    idx_f, gate_f = idx.reshape(t * top_k), gate.reshape(t * top_k)
    mine = (idx_f >= lo) & (idx_f < lo + e_loc)
    loc_e = torch.where(mine, idx_f - lo, torch.full_like(idx_f, e_loc))
    # a pick's position in its local expert: the running count of the
    # picks of that expert, scanned along the last dimension of
    # [e_loc + 1, T k] (a scan along the first of [T k, e_loc + 1] runs a
    # thread a column down T k rows on the card)
    hits = (loc_e[None, :] == torch.arange(
        e_loc + 1, device=loc_e.device)[:, None]).to(torch.int32)
    pos = torch.gather(torch.cumsum(hits, dim=1, dtype=torch.int32), 0,
                       loc_e[None, :])[0] - 1
    cap = capacity(t, top_k, e, capacity_factor)
    keep = mine & (pos < cap)
    n_slots = e_loc * cap
    slot = torch.where(keep, loc_e * cap + torch.clamp(pos, max=cap - 1),
                       torch.full_like(loc_e, n_slots))   # trash slot
    # each kept slot takes one pick; the rest go to the trash row, cut off
    x_rep = xt[:, None].expand(t, top_k, d).reshape(t * top_k, d)
    buf = xt.new_zeros((n_slots + 1, d)).index_copy(
        0, slot, x_rep)[:n_slots].view(e_loc, cap, d)
    h = expert_gemm(buf, w_in.to(dt))
    if glu:
        h = _ACT[act](expert_gemm(buf, w_gate.to(dt))) * h
    else:
        h = _ACT[act](h)
    y_buf = expert_gemm(h, w_out.to(dt)).view(n_slots, d)
    y_tok = y_buf.index_select(0, torch.clamp(slot, max=n_slots - 1))
    w = (gate_f * keep.to(torch.float32)).to(dt)
    return (y_tok * w[:, None]).view(t, top_k, d).sum(dim=1)


def moe_sharded(sp, p, h, *, top_k: int, act: str, glu: bool,
                capacity_factor: float = 1.25):
    """The expert-parallel MoE inside the sharded program: each
    position routes its data shard's tokens ``h`` (replicated over
    ``model``) with the router gathered from its FSDP shards, runs its
    E / |model| experts (``w_edf``, ``w_efd``) on their picks, and one
    ``psum`` over ``model`` sums the partial outputs.  The routing is
    replicated over ``model``: the tokens and gates enter the experts'
    computation through ``pbroadcast``.  Returns (y, the positions' aux
    losses, their data shards' own)."""
    e = p.local("w_in")[0].shape[0] * sp.mesh.shape["model"]
    e_loc = p.local("w_in")[0].shape[0]
    router = p.gather("router")
    names = ("w_in", "w_out") + (("w_gate",) if glu else ())
    ws = {n: p.gather(n) for n in names}
    flat = [hk.reshape(-1, hk.shape[-1]) for hk in h]
    routed = [_route_flat(r, xt, top_k=top_k, e=e)
              for r, xt in zip(router, flat)]
    gates = sp.pbroadcast([g for g, _, _ in routed], "model")
    xts = sp.pbroadcast(flat, "model")
    ys = []
    for k in range(sp.n):
        y = _local_experts(sp.index(k)["model"], gates[k], routed[k][1],
                           xts[k], ws["w_in"][k],
                           ws["w_gate"][k] if glu else None,
                           ws["w_out"][k], top_k=top_k, act=act, glu=glu,
                           e=e, e_loc=e_loc,
                           capacity_factor=capacity_factor)
        ys.append(y.view(h[k].shape))
    return sp.psum(ys, "model"), [a for _, _, a in routed]


def moe_apply_expert_parallel(p: Params, x: torch.Tensor, *, top_k: int,
                              act: str, glu: bool, mesh,
                              capacity_factor: float = 1.25
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d] on x's device, aux loss): the
    reference's expert-parallel MoE over ``mesh`` (a ``Mesh`` with a
    ``model`` axis dividing the experts; B split over its batch axes),
    ``moe_sharded`` on every position of ``mesh``: a position holds its
    data shard's tokens and its experts' weights, launches the expert
    GEMM three times (two without GLU) over its [E_loc, cap, d] buffer,
    ``cap`` counted over the data shard's B_loc S tokens; the partial
    outputs are summed over ``model`` in shard order, the aux loss
    averaged over the data shards."""
    sp = Spmd(mesh, one_position=False)
    rows, experts = P(batch_spec(mesh)[0], None, None), P("model", None, None)
    names = ("w_in", "w_out") + (("w_gate",) if glu else ())
    specs = {"x": rows, "router": P(None, None),
             **{n: experts for n in names}}
    held = shard_params(sp, {"x": x, "router": p["router"],
                             **{n: p[n] for n in names}},
                        {n: NamedSharding(mesh, s_) for n, s_ in
                         specs.items()})
    ys, auxes = moe_sharded(sp, held, held.local("x"), top_k=top_k,
                            act=act, glu=glu,
                            capacity_factor=capacity_factor)
    # each data shard's output, and the aux loss, once: their cotangents
    # reach every replica over ``model`` whole, as a replicated output's do
    y = torch.cat([sp.unreplicate([ys[k] for k in g]).to(x.device)
                   for g in sp.groups("model")], dim=0)
    aux = sp.unreplicate(sp.pmean(auxes, sp.batch_axes()))
    return y, aux.to(x.device)


__all__ = ["capacity", "moe_apply", "moe_apply_expert_parallel", "moe_init",
           "moe_route", "moe_sharded"]

"""Leaf-path-based parameter and cache sharding rules (the reference's
``parallel/param_sharding.py``), and a parameter tree held by position
for the sharded program (``shard_params``, ``ShardedTree``,
``gather_weight``).

FSDP(data) x TP(model): weight matrices shard their model-parallel dim on
"model" and (ZeRO-3 style) a second dim on the innermost batch axis.  The
rules read only a leaf's path names (the dict keys on its path), its
shape and its rank, so they take tensors on any device, ``meta`` too.

The port holds a model's layers as the list ``layers`` in layer order,
where the reference stacks them per period slot (``blocks/b{i}``, a
leading layer dimension; ``convert.lm_params_from_arrays``).  A port
layer's leaf therefore takes the reference's stacked spec without its
leading None, which is the spec the reference gives a ``rem`` layer's
leaf of the same name and shape: no leaf here is stacked.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel.sharding import (Mesh, NamedSharding,
                                           PartitionSpec as P, Spmd)
from repro_torch.tree import leaves, unflatten_like

Tree = Any


def _fsdp_axis(mesh: Mesh) -> Optional[str]:
    return "data" if "data" in mesh.axis_names else None


def _spec_for(name: str, shape: Tuple[int, ...], mesh: Mesh,
              fsdp: bool, moe: bool, model_shard: bool = True) -> list:
    """Sharding spec for an unstacked leaf shape.

    ``model_shard=False``: sequence-parallel layout — weights are
    FSDP-only (activations carry the model axis on their seq dim)."""
    fs = _fsdp_axis(mesh) if fsdp else None
    nd = len(shape)

    def fits(axis: Optional[str], dim: int) -> Optional[str]:
        if axis is None or dim >= nd:
            return None
        if axis == "model" and not model_shard and name != "table":
            return None
        return axis if shape[dim] % mesh.shape[axis] == 0 else None

    if name in ("wq", "wk", "wv"):            # [d, heads, hd]
        spec = [fits(fs, 0), fits("model", 1), None]
    elif name == "wo":                         # [heads, hd, d]
        spec = [fits("model", 0), None, fits(fs, 2)]
    elif name in ("w_in", "w_gate", "w_out") and moe:
        # expert weights: expert-parallel on "model" only
        spec = [fits("model", 0), None, None]
    elif name in ("w_in", "w_gate"):           # [d, ff]
        spec = [fits(fs, 0), fits("model", 1)]
    elif name == "w_out":                      # [ff, d]
        spec = [fits("model", 0), fits(fs, 1)]
    elif name in ("table", "w") and nd == 2:   # embedding / head [V, d]
        spec = [fits("model", 0), fits(fs, 1)]
    elif name == "router":                     # [d, E]
        spec = [fits(fs, 0), None]
    elif name == "w_x":                        # rglru in-proj [d, w]
        spec = [fits(fs, 0), fits("model", 1)]
    elif name in ("w_a", "w_i"):               # rglru gates [w, w]
        spec = [None, fits("model", 1)]
    elif name == "conv_w":                     # [K, w]
        spec = [None, fits("model", 1)]
    elif name in ("log_lambda", "b_a", "b_i"):
        spec = [fits("model", 0)]
    elif name == "r":                          # slstm [4, h, hd, hd]
        spec = [None, fits("model", 1), None, None]
    elif name == "w_if":                       # mlstm gates [d, 2h]
        spec = [fits(fs, 0), None]
    elif name in ("bq", "bk", "bv"):           # [h, hd]
        spec = [fits("model", 0), None]
    else:                                      # norms, scalars, misc
        spec = []
    return spec[:nd] + [None] * (nd - len(spec))


def _map_with_names(fn: Callable, tree: Tree, names: Tuple[str, ...] = ()
                    ) -> Tree:
    """``fn(names, leaf)`` over a nest of dicts and lists, ``names`` the
    dict keys on the leaf's path (list positions are not names)."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names) for v in tree)
    return fn(names, tree)


def param_shardings(mesh: Mesh, tree: Tree, fsdp: bool = True,
                    model_shard: bool = True) -> Tree:
    """Parameter (or optimiser-moment) tree -> ``NamedSharding`` tree."""

    def one(names: Tuple[str, ...], leaf) -> NamedSharding:
        shape = tuple(leaf.shape)
        if not shape:
            return NamedSharding(mesh, P())
        spec = _spec_for(names[-1] if names else "", shape, mesh, fsdp,
                         "moe" in names, model_shard)
        return NamedSharding(mesh, P(*spec))

    return _map_with_names(one, tree)


def kv_model_dim(shape: Sequence[int], n_model: int,
                 seq_shard: bool) -> Optional[int]:
    """The dimension of a KV leaf ``[.., B, S, KV, hd]`` that
    ``cache_shardings`` splits over a ``model`` axis of ``n_model``: the
    slots S under ``seq_shard`` where ``model`` divides them, else the KV
    heads where it divides them, else None (held whole)."""
    bd = len(shape) - 4
    if seq_shard and shape[bd + 1] % n_model == 0:
        return bd + 1
    return bd + 2 if shape[bd + 2] % n_model == 0 else None


def state_model_dim(shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dimension of a recurrent-state leaf ``[B, ...]`` that
    ``cache_shardings`` splits over a ``model`` axis of ``n_model``: the
    widest trailing one (the first of the widest) where ``model`` divides
    it, else None."""
    if len(shape) < 2:
        return None
    cand = max(range(1, len(shape)), key=lambda i: shape[i])
    return cand if shape[cand] % n_model == 0 else None


def cache_shardings(mesh: Mesh, tree: Tree,
                    seq_shard: bool = False) -> Tree:
    """Decode-cache tree -> shardings.

    KV leaves [B, S, kv, hd]: batch on the data axes + either kv-heads on
    "model", or (``seq_shard``) the KV sequence on "model" (the
    flash-decode layout used at long context).  Recurrent-state leaves
    shard batch on data and their widest trailing dim on "model".
    """
    b = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bb = b if len(b) > 1 else (b[0] if b else None)
    n_batch = 1
    for a in b:
        n_batch *= mesh.shape[a]

    def one(names: Tuple[str, ...], leaf) -> NamedSharding:
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return NamedSharding(mesh, P())
        name = names[-1] if names else ""
        spec: List[Any] = [None] * nd
        if name in ("k", "v", "cross_k", "cross_v") and nd >= 4:
            bd = nd - 4
            if shape[bd] % n_batch == 0 and shape[bd] > 1:
                spec[bd] = bb
            dim = kv_model_dim(shape, mesh.shape["model"], seq_shard)
        else:
            if shape[0] % n_batch == 0 and shape[0] > 1:
                spec[0] = bb
            dim = state_model_dim(shape, mesh.shape["model"])
        if dim is not None:
            spec[dim] = "model"
        return NamedSharding(mesh, P(*spec))

    return _map_with_names(one, tree)


# ---------------------------------------------------------------------------
# a parameter tree held by position, and each weight's gather at its use
# ---------------------------------------------------------------------------


def _get(tree: Tree, keys: Sequence) -> Tree:
    for k in keys:
        tree = tree[k]
    return tree


def owns(sp: Spmd, spec: Sequence, k: int) -> bool:
    """Whether position ``k`` holds its block of a ``spec`` leaf first:
    index 0 along every axis the spec does not split (the replica that
    writes the block back, and counts it once in a norm).  One
    position's program (``Spmd.one_position``) owns every block it
    holds, as a device of the mesh updates its own."""
    if sp.one_position:
        return True
    named = {a for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))}
    return all(i == 0 for a, i in sp.index(k).items() if a not in named)


def gather_weight(sp: Spmd, ws: List[torch.Tensor], spec: Sequence,
                  partial: Optional[bool] = None) -> List[torch.Tensor]:
    """The positions' stored blocks ``ws`` of a ``spec`` weight made
    whole for use: all-gathered over ``data`` along its FSDP dimension
    (the backward reduce-scatters the gradient back to the shard), or,
    without one, ``pbroadcast`` over ``data`` (the gradient all-reduced);
    ``pbroadcast`` over ``pod`` (each pod computes other rows); and with
    ``partial`` (the positions' uses differ along ``model``, where the
    spec does not split it) ``pbroadcast`` over ``model`` too.  Under
    ``sp.seq_rows`` (the default of ``partial`` there) every use is
    partial, each position's rows its own, and a weight ``model`` splits
    (the embedding table's vocabulary) is all-gathered over it as well:
    each position reads the whole table, and the backward
    reduce-scatters the rows' gradients back."""
    if partial is None:
        partial = sp.seq_rows
    mesh = sp.mesh
    spec = tuple(spec) + (None,) * (ws[0].dim() - len(spec))
    fs = [d for d, e in enumerate(spec) if e == "data"]
    named = {e for e in spec if e is not None}
    for axis in ("pod", "data", "model"):
        if axis not in mesh.shape or mesh.shape[axis] == 1 or \
                axis in named:
            continue
        if axis == "model" and not partial:
            continue
        ws = sp.pbroadcast(ws, axis)
    if fs and mesh.shape["data"] > 1:
        ws = sp.all_gather(ws, "data", fs[0])
    if sp.seq_rows and mesh.shape.get("model", 1) > 1:
        for dim in (d for d, e in enumerate(spec) if e == "model"):
            ws = sp.all_gather(ws, "model", dim)
    return ws


class ShardedTree:
    """A tree held by position: ``blocks[k]`` is position k's tree of
    blocks (``Spmd.positions`` order), ``specs`` the tree of the leaves'
    ``NamedSharding``s (``param_shardings``).  ``sub`` descends into
    both, ``local`` gives a leaf's blocks and ``gather`` its blocks made
    whole for use (``gather_weight``)."""

    def __init__(self, sp: Spmd, blocks: List[Tree], specs: Tree):
        self.sp, self.blocks, self.specs = sp, blocks, specs

    def sub(self, *keys) -> "ShardedTree":
        return ShardedTree(self.sp, [_get(b, keys) for b in self.blocks],
                           _get(self.specs, keys))

    def has(self, key) -> bool:
        return key in self.specs

    def spec(self, *keys) -> Tuple:
        return tuple(_get(self.specs, keys).spec)

    def local(self, *keys) -> List[torch.Tensor]:
        return [_get(b, keys) for b in self.blocks]

    def gather(self, *keys,
               partial: Optional[bool] = None) -> List[torch.Tensor]:
        return gather_weight(self.sp, self.local(*keys), self.spec(*keys),
                             partial)


class _Distribute(torch.autograd.Function):
    """A global leaf's blocks at the positions ``mine`` that own them
    (``owns``); the gradient is those blocks' gradients assembled (a
    replica's cotangent is already the sum over its replicas: the
    collectives' backwards add them, so the other positions' blocks take
    no gradient)."""

    @staticmethod
    def forward(ctx, sp, spec, copy, mine, x):
        ctx.sp, ctx.spec, ctx.shape, ctx.mine = sp, spec, x.shape, mine
        ctx.device = x.device
        out = tuple(sp.block(x, spec, k, copy) for k in mine)
        ctx.blocks = [(b.shape, b.dtype, b.device) for b in out]
        return out

    @staticmethod
    def backward(ctx, *gs):
        sp = ctx.sp
        gs = [torch.zeros(s, dtype=t, device=d) if g is None else g
              for (s, t, d), g in zip(ctx.blocks, gs)]
        if sp.one_position:
            g = gs[0].new_zeros(ctx.shape)
            sp.block(g, ctx.spec, 0, copy=False).copy_(gs[0])
        else:
            full = [None] * sp.n
            for k, gk in zip(ctx.mine, gs):
                full[k] = gk
            g = sp.assemble(full, ctx.spec, ctx.device)
        return None, None, None, None, g


def shard_params(sp: Spmd, params: Tree, specs: Optional[Tree] = None,
                 as_leaves: bool = False) -> ShardedTree:
    """``params`` held by position under ``specs`` (a tree of
    ``NamedSharding``s, default ``param_shardings``): views of each leaf
    where it lies on the position's device (the positions that share a
    card hold no second copy; the dry run's arguments stay its
    arguments), else copies on that device (``Spmd.block``).  Where a
    leaf requires grad the blocks of the positions that own them
    (``owns``) are ``_Distribute``'s outputs, whose gradient reaches the
    leaf; with ``as_leaves`` they are detached leaves of their own that
    require grad (the sharded train step, which updates them on the
    shard).  A replica's block takes no gradient: the collectives'
    backwards sum the replicas' cotangents into its owner's.  Under
    ``sp.seq_rows`` the default specs keep weights FSDP-only
    (``model_shard=False``: the rows carry ``model``)."""
    specs = specs if specs is not None else param_shardings(
        sp.mesh, params, model_shard=not sp.seq_rows)
    copy = False if sp.one_position else None
    flat, flat_specs = leaves(params), leaves(specs)
    per_leaf = []
    for x, ns in zip(flat, flat_specs):
        spec = tuple(ns.spec)
        mine = tuple(k for k in range(sp.n) if owns(sp, spec, k))
        blocks = [sp.block(x.detach(), spec, k, copy) for k in range(sp.n)]
        if as_leaves:
            for k in mine:
                blocks[k].requires_grad_(x.requires_grad)
        elif x.requires_grad and torch.is_grad_enabled():
            for k, b in zip(mine, _Distribute.apply(sp, spec, copy, mine,
                                                    x)):
                blocks[k] = b
        per_leaf.append(blocks)
    blocks = [unflatten_like(params, [b[k] for b in per_leaf])
              for k in range(sp.n)]
    return ShardedTree(sp, blocks, specs)


__all__ = ["ShardedTree", "cache_shardings", "gather_weight",
           "kv_model_dim", "owns", "param_shardings", "shard_params",
           "state_model_dim"]

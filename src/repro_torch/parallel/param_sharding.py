"""Leaf-path-based parameter and cache sharding rules (the reference's
``parallel/param_sharding.py``).

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

from typing import Any, Callable, List, Optional, Tuple

from repro_torch.parallel.sharding import (Mesh, NamedSharding,
                                           PartitionSpec as P)

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
            if seq_shard and shape[bd + 1] % mesh.shape["model"] == 0:
                spec[bd + 1] = "model"      # sequence-sharded KV
            elif shape[bd + 2] % mesh.shape["model"] == 0:
                spec[bd + 2] = "model"      # head-sharded KV
        else:
            if shape[0] % n_batch == 0 and shape[0] > 1:
                spec[0] = bb
            # shard the widest trailing dim on model
            if nd > 1:
                cand = max(range(1, nd), key=lambda i: shape[i])
                if shape[cand] % mesh.shape["model"] == 0:
                    spec[cand] = "model"
        return NamedSharding(mesh, P(*spec))

    return _map_with_names(one, tree)


__all__ = ["cache_shardings", "param_shardings"]

"""Error-feedback int8 gradient compression (the reference's
``optim/grad_compress.py``): q = round(g + e) to int8 with a per-tensor
scale, the residual carried to the next step.  ``psum_compressed``, the
int8 all-reduce across a mesh axis, waits for the sharding items (ROADMAP
queue 1 item 14.9)."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like

Tree = Any


def init_error(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, x - deq


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 payload, float32 scale, new error residual); ``round`` is
    half to even, as ``jnp.round``."""
    x = g.to(torch.float32) + err
    return _quantize(x, torch.max(torch.abs(x)) / 127.0 + 1e-12)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Tree, errors: Tree,
                  groups: Optional[Sequence[Sequence[int]]] = None):
    """(payloads, scales, new errors), each shaped like ``grads``.
    ``groups`` (lists of leaf indices in tree order) share one scale, the
    largest of the group: the layers the reference stacks into one leaf,
    whose per-tensor scale spans them all (default: a scale a leaf)."""
    xs = [g.to(torch.float32) + e
          for g, e in zip(leaves(grads), leaves(errors))]
    scales: List[Optional[torch.Tensor]] = [None] * len(xs)
    for group in groups or [[i] for i in range(len(xs))]:
        top = torch.stack([torch.max(torch.abs(xs[i])) for i in group])
        scale = torch.max(top) / 127.0 + 1e-12
        for i in group:
            scales[i] = scale
    out = [_quantize(x, s) for x, s in zip(xs, scales)]
    return tuple(unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_tree(qs: Tree, scales: Tree) -> Tree:
    return tree_map(decompress, qs, scales)


__all__ = ["compress", "compress_tree", "decompress", "decompress_tree",
           "init_error"]

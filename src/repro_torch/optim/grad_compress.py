"""Error-feedback int8 gradient compression (the reference's
``optim/grad_compress.py``): q = round(g + e) to int8 with a per-tensor
scale, the residual carried to the next step.  ``psum_compressed`` is
the int8 all-reduce across a mesh axis: each shard's payload summed in
int32, in shard order, times the largest of the shards' scales."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel.sharding import pmax, psum
from repro_torch.tree import leaves, tree_map, unflatten_like

Tree = Any


def init_error(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, x - deq


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 + 1e-12, the division correctly rounded on every device:
    CUDA multiplies a tensor divided by a Python number by the number's
    reciprocal instead, which can differ from the quotient by an ulp."""
    return amax / amax.new_tensor(127.0) + 1e-12


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 payload, float32 scale, new error residual); ``round`` is
    half to even, as ``jnp.round``."""
    x = g.to(torch.float32) + err
    return _quantize(x, _scale(torch.max(torch.abs(x))))


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
        scale = _scale(torch.max(top))
        for i in group:
            scales[i] = scale
    out = [_quantize(x, s) for x, s in zip(xs, scales)]
    return tuple(unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_tree(qs: Tree, scales: Tree) -> Tree:
    return tree_map(decompress, qs, scales)


def psum_compressed(grads: Sequence[Tree], errors: Sequence[Tree],
                    groups: Optional[Sequence[Sequence[int]]] = None
                    ) -> Tuple[List[Tree], List[Tree]]:
    """int8 all-reduce with error feedback over the shards of a mesh axis:
    ``grads`` and ``errors`` hold one tree a shard, in mesh order, each on
    its shard's device.  Each shard compresses with its own scale
    (``compress_tree``, ``groups`` as there); the payloads are summed in
    int32 in shard order and the sum multiplied by the largest of the
    shards' scales, as the reference does (its ``pmax`` of the scales).
    Returns the dequantised sum on every shard's device (the same values
    on each) and each shard's new error."""
    packed = [compress_tree(g, e, groups) for g, e in zip(grads, errors)]
    qs = [leaves(p[0]) for p in packed]
    scales = [leaves(p[1]) for p in packed]
    deq: List[List[torch.Tensor]] = [[] for _ in grads]
    for i in range(len(qs[0])):
        summed = psum([q[i].to(torch.int32) for q in qs])
        scale = pmax([s[i] for s in scales])
        for k in range(len(grads)):
            deq[k].append(summed[k].to(torch.float32) * scale[k])
    return ([unflatten_like(grads[k], deq[k]) for k in range(len(grads))],
            [p[2] for p in packed])


__all__ = ["compress", "compress_tree", "decompress", "decompress_tree",
           "init_error", "psum_compressed"]

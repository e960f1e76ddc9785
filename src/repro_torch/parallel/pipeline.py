"""Pipeline-parallel forward: LLHR-planned stages run as a GPipe schedule
(the reference's ``parallel/pipeline.py``).

A ``StagePlan`` (``core.pipeline_opt``: P3's minmax chain DP and P2's
torus assignment) says which contiguous blocks live on which stage;
``stage_params`` groups the blocks' parameters by it and
``pipelined_forward`` runs the pipeline with microbatches:

  for t in range(n_micro + n_stages - 1):         # pipeline schedule
      stage s runs microbatch t - s, if there is one
      its output is handed to stage s + 1         # the one-hop hand-off

Each stage holds only its own blocks' parameters, on its device, and the
hand-off is a copy to the next stage's device (none when both are
entries of one card).  The reference pads shallow stages with zero
blocks that it selects away; here no padding block is computed, so the
values are the same and the launches are only the real blocks'.  The
pipelined forward equals running the blocks microbatch by microbatch.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.parallel.sharding import Mesh
from repro_torch.tree import tree_map

Tree = Any


def stage_params(params_per_block: Sequence[Tree],
                 boundaries: Sequence[int]) -> List[List[Tree]]:
    """Group per-block params into per-stage lists per a StagePlan's
    ``boundaries`` (stage s owns blocks [b[s], b[s+1]))."""
    return [list(params_per_block[a:b])
            for a, b in zip(boundaries[:-1], boundaries[1:])]


def _stage_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The device of each stage: the mesh's entries along ``axis`` at
    index 0 of every other axis."""
    at = tuple(slice(None) if a == axis else 0 for a in mesh.axis_names)
    return list(mesh.devices[at])


def pipelined_forward(block_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
                      per_stage_params: List[List[Tree]],
                      x: torch.Tensor,
                      mesh: Mesh,
                      axis: str = "stage",
                      n_micro: Optional[int] = None) -> torch.Tensor:
    """Run ``x`` through the staged blocks with a GPipe schedule.

    ``block_fn(params, x) -> x`` applies one block.  ``x``: [B, ...] with
    B divisible by ``n_micro`` (default: the number of stages).  The
    mesh's ``axis`` must have one entry a stage.  Returns the output
    [B, ...] on the last stage's device."""
    n_stages = len(per_stage_params)
    if mesh.shape.get(axis) != n_stages:
        raise ValueError(f"{n_stages} stages on a mesh of "
                         f"{dict(mesh.shape)} (axis {axis!r})")
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    devs = _stage_devices(mesh, axis)
    if x.device.type != devs[0].type:
        raise ValueError(f"a mesh of {devs[0].type} devices given a tensor "
                         f"on {x.device}")
    params = [tree_map(lambda t, d=d: t.to(d, non_blocking=True), blocks)
              for blocks, d in zip(per_stage_params, devs)]
    micro = x.chunk(n_micro)
    inbox: List[Optional[torch.Tensor]] = [None] * n_stages
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        nxt: List[Optional[torch.Tensor]] = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            h = micro[m].to(devs[0], non_blocking=True) if s == 0 \
                else inbox[s]
            for p in params[s]:
                h = block_fn(p, h)
            if s == n_stages - 1:
                outs[m] = h
            else:
                nxt[s + 1] = h.to(devs[s + 1], non_blocking=True)
        inbox = nxt
    return torch.cat(outs)


__all__ = ["pipelined_forward", "stage_params"]

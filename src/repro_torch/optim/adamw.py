"""AdamW (the reference's ``optim/adamw.py``) on trees of tensors.

Master params and moments stay float32 whatever the compute dtype; weight
decay is decoupled; global-norm clipping included.  The optimiser state
is a dict ``{"m", "v", "step"}`` of trees shaped like the parameters and
an int32 step.  The update follows the reference's formula and order,
``p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)`` with the bias corrections
``1 - b ** step`` in float32 (``torch.optim.AdamW`` decays first and
places eps elsewhere), but works in place on the parameters, the moments
and the gradients: the reference returns new trees, which on one card
would hold the 2.7B-parameter model's 43.6 GB of state twice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Tree = Any


def init_opt_state(params: Tree) -> Dict[str, Any]:
    """Zero moments (float32, on each parameter's device) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in tree order) of each leaf's sum
    of squares, in float32."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))`` in
    place; returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, opt_state: Dict[str, Any], *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, Dict[str, Any]]:
    """One AdamW step.  Updates ``params`` (float32 leaves in place; other
    dtypes by copy-back), ``opt_state``'s moments in place and advances
    its step; returns (params, opt_state).  ``grads`` are only read."""
    step = opt_state["step"] + 1
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        g32 = g.to(torch.float32)
        m.mul_(b1).add_(g32 * (1 - b1))              # b1 m + (1 - b1) g
        v.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))  # b2 v + (1 - b2) g g
        del g32
        upd = torch.sqrt(v / c2).add_(eps)           # sqrt(v_hat) + eps
        upd = torch.div(m / c1, upd, out=upd)        # m_hat / (...)
        p32 = p if p.dtype == torch.float32 else p.to(torch.float32)
        upd.add_(weight_decay * p32)
        p32.sub_(upd.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
    opt_state["step"] = step
    return params, opt_state


__all__ = ["adamw_update", "clip_by_global_norm", "global_norm",
           "init_opt_state"]

"""Plain PyTorch version of the fused link-geometry kernel.

The planner's geometry stage as four separate [B, U, U] passes from
``repro_torch.core.batch`` (``pairwise_dist_batched`` ->
``power_threshold_batched`` -> ``solve_power_batched`` ->
``rate_matrix_batched``), composed in the order the reference's
``make_plan_fn.geometry`` runs them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channel import RadioParams


def link_geometry_ref(positions: torch.Tensor, active: torch.Tensor,
                      gain_scale: Optional[torch.Tensor], *,
                      params: RadioParams):
    """positions [B, U, 2], active [B, U] bool, gain_scale [B, U, U] or
    None -> (dist [B, U, U], threshold [B, U, U], rate [B, U, U]).

    ``threshold`` is the eq. (7) per-link minimum-power matrix (reused by
    the later used-links tightening); ``rate`` is eq. (5) at the
    first-pass P1 powers — zero on infeasible links, inf on the diagonal.
    """
    from repro_torch.core.batch import (pairwise_dist_batched,
                                        power_threshold_batched,
                                        rate_matrix_batched,
                                        solve_power_batched)
    dist = pairwise_dist_batched(positions)
    th = power_threshold_batched(dist, params, gain_scale=gain_scale)
    pw = solve_power_batched(dist, params, active=active,
                             gain_scale=gain_scale, threshold_matrix=th)
    rate = rate_matrix_batched(dist, pw.power, params, pw.link_feasible,
                               gain_scale=gain_scale)
    return dist, th, rate

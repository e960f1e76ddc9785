"""Public entry for the tropical-DP wavefront step."""
from __future__ import annotations

import torch

from repro_torch.kernels.tropical_dp.ref import dp_step_ref
from repro_torch.kernels.tropical_dp.tropical_dp import tropical_dp_step


#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version; nothing falls back
_BY_DEVICE = {"cuda": tropical_dp_step, "cpu": dp_step_ref}


def dp_wavefront_step(dp: torch.Tensor, tr: torch.Tensor, tr0: torch.Tensor,
                      ct: torch.Tensor, ok: torch.Tensor):
    """One chain-DP wavefront step over every (scenario, source slot).

    ``dp`` [B, M, L, S+1], ``tr`` [B, L, S, S+1] (a = 0 row dead),
    ``tr0`` [B, M, S], ``ct``/``ok`` [L, S] -> (row, pa, ps), each
    [B, M, S].  CUDA tensors launch the kernel (or raise); CPU tensors
    take the plain version.  The two are bitwise identical.
    """
    step = _BY_DEVICE.get(dp.device.type)
    if step is None:
        raise ValueError(f"dp_wavefront_step: unsupported device "
                         f"{dp.device}")
    return step(dp, tr, tr0, ct, ok)

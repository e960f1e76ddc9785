"""LR schedules (the reference's ``optim/schedules.py``) as float32
0-dim tensors, in the reference's operation order.  WSD
(warmup-stable-decay) is first-class because minicpm-2b trains with it
(arXiv:2404.06395)."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def wsd(step, *, peak_lr: float, total_steps: int, warmup_steps: int,
        decay_frac: float = 0.1, floor: float = 0.0) -> torch.Tensor:
    """Warmup -> Stable -> Decay (1-sqrt decay over the final fraction)."""
    step = _step(step)
    decay_steps = torch.clamp(torch.tensor(total_steps * decay_frac,
                                           dtype=_F32), min=1.0)
    decay_start = total_steps - decay_steps
    warm = step / max(warmup_steps, 1)
    decay = 1.0 - torch.sqrt(torch.clamp((step - decay_start) / decay_steps,
                                         0.0, 1.0))
    one = torch.ones((), dtype=_F32)
    scale = torch.where(step < warmup_steps, warm,
                        torch.where(step < decay_start, one, decay))
    return floor + (peak_lr - floor) * scale


def cosine(step, *, peak_lr: float, total_steps: int, warmup_steps: int,
           floor_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, warmup_steps: int = 0,
             **_) -> torch.Tensor:
    step = _step(step)
    warm = torch.where(step < warmup_steps,
                       step / max(warmup_steps, 1), torch.ones((), dtype=_F32))
    return peak_lr * warm


SCHEDULES = {"wsd": wsd, "cosine": cosine, "constant": constant}

__all__ = ["SCHEDULES", "constant", "cosine", "wsd"]

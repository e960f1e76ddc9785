"""Device resolution for the port's entry points.

``None`` means the card.  There is no silent fallback: asking for CUDA on
a machine without it raises, and the CPU runs only when named.  ``meta``
(shapes and dtypes, no data) runs only when named too: the dry run
(``launch.dryrun``) drives the real entry points on it, and each kernel
wrapper has a ``meta`` entry that makes its outputs' shapes without
arithmetic.
"""
from __future__ import annotations

import functools
from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]

#: streaming multiprocessors of an H100 SXM5 (NVIDIA's data sheet): what
#: a wrapper sizes its grid by on ``meta``, where no card answers
H100_SXM_SMS = 132


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: the models' ``init``
    draws each tensor on its generator's device, so with this one they
    make ``meta`` tensors of the right shapes and dtypes and draw
    nothing (torch has no generator on ``meta``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels' wrappers
    size their grids by it); on ``meta`` the H100 SXM's."""
    if torch.device(device).type == "meta":
        return H100_SXM_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


__all__ = ["H100_SXM_SMS", "MetaGenerator", "resolve_device", "sm_count", "DeviceLike"]

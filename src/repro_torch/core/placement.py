"""P3 device description (Section II-A)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Device:
    """One UAV / stage group: caps and throughput (Section II-A)."""

    name: str
    mem_cap: float       # \bar{m}_i  [bytes]
    compute_cap: float   # \bar{c}_i  [MACs per frame]
    throughput: float    # e_i        [MACs per second]


__all__ = ["Device"]

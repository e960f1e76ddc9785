"""Swarm constants (Section IV experimental setup).

Device types follow Section IV: Raspberry-Pi-class devices, 1 GB RAM, with
per-second multiplication throughputs e_i in {560, 512, 256} (interpreted as
MMACs/s per the cited Disabato et al. benchmark — raw ops/s would make even
LeNet take hours, contradicting Fig. 3's second-scale latencies).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.core.placement import Device

# Section IV device throughputs (MMACs/s) and memory (1 GB RAM, of which a
# fraction is available to weights).
RPI_THROUGHPUTS = (560e6, 512e6, 256e6)
RPI_MEM_BYTES = 1 << 30


def make_devices(n: int, mem_frac: float = 1.0,
                 frame_s: float = 60.0,
                 throughputs: Sequence[float] = RPI_THROUGHPUTS,
                 ) -> List[Device]:
    """n UAVs cycling through the three Raspberry-Pi variants.

    ``frame_s`` sets the per-period compute budget (eq. 11b cap):
    \\bar{c}_i = e_i * frame_s — a UAV cannot absorb more MACs per
    optimization period than it can physically execute.
    """
    devs = []
    for i in range(n):
        e = throughputs[i % len(throughputs)]
        devs.append(Device(name=f"uav{i}", mem_cap=RPI_MEM_BYTES * mem_frac,
                           compute_cap=e * frame_s, throughput=e))
    return devs


@dataclass
class FrameStats:
    """One frame of one trajectory (``RolloutTrace.frame_stats``)."""

    t: int
    latency: float
    power: float
    breakdown: Dict[str, float]
    n_requests: int
    feasible: bool
    replanned: bool = False


__all__ = ["RPI_THROUGHPUTS", "RPI_MEM_BYTES", "make_devices", "FrameStats"]

"""Roofline terms of a counted program on one NVIDIA H100 SXM5 80GB (700 W),
the counterpart of the reference's ``launch/roofline.py`` (which holds a
TPU v5e's constants).

  compute    = sum over classes of FLOPs_class_per_device / peak_class
  memory     = bytes_per_device / HBM rate
  collective = collective bytes per device / NVLink rate
               (pod-axis collectives at the pod link's rate)

The counts come from ``launch.op_analysis``: the matrix products of the
aten ops a program runs (by the class of their inputs), their traffic,
the host collectives it charges, and each hand-written kernel's work
(``kernels.work.KERNEL_WORK``).  MODEL_FLOPS = 6 N D (train) or
2 N_active D (inference) comes from the cost model; ``useful_ratio``
catches recomputation, and ``roofline_fraction`` divides it by the bf16
peak, as the reference divides by its one peak.  ``kernel_bound`` gives
one kernel call's least time (``chip_smoke.py``'s bound column).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# NVIDIA H100 SXM5 data sheet (dense, no sparsity), one card:
BF16_FLOPS = 989e12          # bf16 tensor cores, FLOP/s
TF32_FLOPS = 495e12          # TF32 tensor cores, FLOP/s
FP32_FLOPS = 67e12           # fp32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # HBM3, bytes/s
NVLINK_BW = 900e9 / 2        # NVLink 4: 900 GB/s counts both directions
# Assumption, not a data-sheet figure: a ``pod`` axis spans hosts over one
# 400 Gb/s NDR InfiniBand port a GPU, as the DGX H100 has.
POD_BW = 400e9 / 8

#: the peak each class of work is bounded by, FLOP/s
PEAK_BY_CLASS = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS, "fp32": FP32_FLOPS}
#: the reference's names: its one peak (the bf16 one here), its link
#: (ICI: NVLink here) and its cross-pod network (DCN: the pod link here)
PEAK_FLOPS = BF16_FLOPS
ICI_BW = NVLINK_BW
DCN_BW = POD_BW


#: entries a collective record's schedule keeps, as the reference's
SCHEDULE_CAP = 2000


@dataclass
class CollectiveStats:
    """The collectives a program charged (the reference's
    ``CollectiveStats``, which ``parse_collectives`` reads from HLO):
    bytes and counts by kind and the bytes of groups that cross pods,
    each summed over the shards charged, and the first
    ``SCHEDULE_CAP`` collectives in program order."""

    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, float] = field(default_factory=dict)
    pod_bytes: float = 0.0
    schedule: List[str] = field(default_factory=list)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def add(self, kind: str, nbytes: float, group: int, shards: int,
            pod: bool) -> None:
        """One collective over a group of ``group``: ``nbytes`` moved by
        each of the ``shards`` shards charged."""
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + \
            nbytes * shards
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + shards
        if pod:
            self.pod_bytes += nbytes * shards
        if len(self.schedule) < SCHEDULE_CAP:
            self.schedule.append(f"{kind}/{group}: {nbytes / 1e6:.2f} MB"
                                 + (" [pod]" if pod else ""))


@dataclass(frozen=True)
class KernelBound:
    """A kernel call's least time on the card (``kernel_bound``): its
    operations at its class's peak and its bytes at the HBM rate."""

    compute_s: float
    memory_s: float

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger term."""
        return max(self.compute_s, self.memory_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.memory_s >= self.compute_s else "operations"


def kernel_bound(work) -> KernelBound:
    """The bound of one kernel call's work (``kernels.work.KernelWork``)
    on one H100 SXM."""
    return KernelBound(work.flops / PEAK_BY_CLASS[work.peak],
                       work.bytes / HBM_BW)


@dataclass
class Roofline:
    """The reference's roofline on the H100 SXM's constants.  The
    ``*_dev`` counts are per device; ``flops_by_class`` splits
    ``flops_dev`` by the peak that bounds each part (without it all of
    ``flops_dev`` runs at the bf16 peak).  ``coll_bytes_dev`` None means
    the collective term is unknown (``collective_s`` None, and the
    bottleneck and step time are taken over the other two);
    ``collectives`` is the program's record (``CollectiveStats``), its
    schedule included."""

    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: Optional[float]
    pod_bytes_dev: Optional[float]
    n_chips: int
    model_flops: float
    flops_by_class: Optional[Dict[str, float]] = None
    coll_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_count_by_kind: Dict[str, float] = field(default_factory=dict)
    collectives: Optional[CollectiveStats] = None

    @property
    def compute_s(self) -> float:
        if self.flops_by_class is None:
            return self.flops_dev / PEAK_FLOPS
        return sum(f / PEAK_BY_CLASS[c]
                   for c, f in self.flops_by_class.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_dev / HBM_BW

    @property
    def collective_s(self) -> Optional[float]:
        if self.coll_bytes_dev is None:
            return None
        pod = self.pod_bytes_dev or 0.0
        return (self.coll_bytes_dev - pod) / ICI_BW + pod / DCN_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap model: step time = max of the terms."""
        return max(self._terms().values())

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs over every chip)."""
        total = self.flops_dev * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(MODEL_FLOPS / bf16 peak / chips) / step time."""
        ideal = self.model_flops / PEAK_FLOPS / self.n_chips
        return ideal / self.step_s if self.step_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_dev": self.flops_dev, "bytes_dev": self.bytes_dev,
            "flops_by_class": self.flops_by_class,
            "coll_bytes_dev": self.coll_bytes_dev,
            "pod_bytes_dev": self.pod_bytes_dev,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck, "step_s": self.step_s,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
            "coll_bytes_by_kind": dict(self.coll_bytes_by_kind),
            "coll_count_by_kind": dict(self.coll_count_by_kind),
            "schedule": list(self.collectives.schedule)
            if self.collectives is not None else [],
        }


def build_roofline(profile, model_flops: float, n_chips: int,
                   collectives: bool = True,
                   devices_counted: Optional[int] = None) -> Roofline:
    """The roofline of a counted program (``op_analysis.OpProfile``) per
    device: its counts divided by ``devices_counted``, the devices they
    cover (default ``n_chips``: an unsharded program split evenly, or
    every position of a mesh; 1 for one position's program).  The aten
    products by class plus each kernel's ``KERNEL_WORK``, their traffic
    plus the kernels' bytes, and the collectives it charged (summed over
    the shards charged), the pod bytes those whose groups cross pods
    moved.  ``collectives=False``: the program ran unsharded and its
    collective bytes are unknown (the term is None)."""
    n = max(int(n_chips), 1)
    per = max(int(devices_counted or n), 1)
    by_class = {c: f / per for c, f in profile.flops_by_class.items()}
    stats = profile.collectives
    coll = pod = None
    if collectives:
        coll, pod = stats.total_bytes / per, stats.pod_bytes / per
    return Roofline(
        flops_dev=sum(by_class.values()),
        bytes_dev=(profile.traffic_bytes + profile.kernel_bytes) / per,
        coll_bytes_dev=coll, pod_bytes_dev=pod, n_chips=n,
        model_flops=model_flops, flops_by_class=by_class,
        coll_bytes_by_kind={k: v / per for k, v in
                            stats.bytes_by_kind.items()}
        if collectives else {},
        coll_count_by_kind={k: v / per for k, v in
                            stats.count_by_kind.items()}
        if collectives else {},
        collectives=stats if collectives else None)


__all__ = ["BF16_FLOPS", "CollectiveStats", "DCN_BW", "FP32_FLOPS", "HBM_BW",
           "ICI_BW", "KernelBound", "NVLINK_BW", "PEAK_BY_CLASS", "PEAK_FLOPS",
           "POD_BW", "Roofline", "SCHEDULE_CAP", "TF32_FLOPS",
           "build_roofline", "kernel_bound"]

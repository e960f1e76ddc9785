"""RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t``: CUDA kernel +
plain version."""
from repro_torch.kernels.rglru_scan.ops import linear_recurrence

__all__ = ["linear_recurrence"]

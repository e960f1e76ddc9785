"""CNN config dataclasses: the paper's eq. (1)-(3) layer parameterization."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ConvLayerSpec:
    """One CNN layer in the paper's eq (1)-(3) parameterization."""

    name: str
    kind: str                   # 'conv' | 'pool' | 'fc'
    in_channels: int = 0        # n_{j-1}
    out_channels: int = 0       # n_j
    kernel: int = 0             # s_j
    stride: int = 1
    padding: int = 0
    out_spatial: int = 0        # z_j (computed if 0)
    in_features: int = 0        # fc: n_{j-1}
    out_features: int = 0       # fc: n_j


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_channels: int
    layers: Tuple[ConvLayerSpec, ...]
    weight_bits: int = 32       # b in eq (3)

    @property
    def family(self) -> str:
        return "cnn"


__all__ = ["ConvLayerSpec", "CNNConfig"]

"""Per-layer CNN cost model — the paper's eq. (1)-(3), exactly — and the
block kind sequence of an LM stack (``_block_kinds``).

P3 only needs, for every layer j:
  c_j  — compute load (multiplications)                eq. (1)/(2)
  m_j  — weight memory in bytes                        eq. (3)
  K_j  — output/activation size in bits (transfer)     eq. (14)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, CNNConfig


@dataclass(frozen=True)
class LayerCost:
    """Cost vector of one placeable unit (one CNN layer / one block)."""

    name: str
    flops: float            # c_j  (multiply ops; MACs)
    weight_bytes: float     # m_j
    act_bits: float         # K_j: bits transferred to the NEXT layer
    kind: str = "layer"
    # decode-time state carried between steps (KV cache / recurrent state)
    state_bytes: float = 0.0


@dataclass(frozen=True)
class ModelCost:
    name: str
    layers: Tuple[LayerCost, ...]
    input_bits: float        # K_s: source data size (eq. 12)

    @property
    def total_flops(self) -> float:
        return sum(l.flops for l in self.layers)

    @property
    def total_weight_bytes(self) -> float:
        return sum(l.weight_bytes for l in self.layers)


def _conv_out(in_spatial: int, k: int, stride: int, pad: int) -> int:
    return (in_spatial + 2 * pad - k) // stride + 1


def cnn_cost(cfg: CNNConfig, act_bits_per_elem: int = 32) -> ModelCost:
    """Per-layer (c_j, m_j, K_j) for a CNN per eq. (1)-(3)."""
    layers: List[LayerCost] = []
    spatial = cfg.input_hw
    channels = cfg.input_channels
    flat: Optional[int] = None
    for spec in cfg.layers:
        if spec.kind == "conv":
            z = spec.out_spatial or _conv_out(spatial, spec.kernel,
                                              spec.stride, spec.padding)
            n_prev, n_j, s_j = spec.in_channels or channels, spec.out_channels, spec.kernel
            flops = float(n_prev) * s_j ** 2 * n_j * z ** 2        # eq. (1)
            weights = float(n_prev) * s_j ** 2 * n_j + n_j          # + bias
            act = float(n_j) * z ** 2 * act_bits_per_elem
            layers.append(LayerCost(spec.name, flops,
                                    weights * cfg.weight_bits / 8.0, act, "conv"))
            spatial, channels = z, n_j
        elif spec.kind == "pool":
            z = spec.out_spatial or _conv_out(spatial, spec.kernel,
                                              spec.stride, spec.padding)
            # pooling: comparisons only; the paper folds these into the conv
            # layer's UAV, so cost ~ 0 compute, 0 weights.
            act = float(channels) * z ** 2 * act_bits_per_elem
            layers.append(LayerCost(spec.name, 0.0, 0.0, act, "pool"))
            spatial = z
        elif spec.kind == "fc":
            n_prev = spec.in_features or (flat if flat is not None
                                          else channels * spatial ** 2)
            n_j = spec.out_features
            flops = float(n_prev) * n_j                             # eq. (2)
            weights = float(n_prev) * n_j + n_j
            act = float(n_j) * act_bits_per_elem
            layers.append(LayerCost(spec.name, flops,
                                    weights * cfg.weight_bits / 8.0, act, "fc"))
            flat = n_j
        else:
            raise ValueError(f"unknown layer kind {spec.kind}")
    input_bits = float(cfg.input_hw ** 2 * cfg.input_channels * 8)  # 8-bit px
    return ModelCost(cfg.name, tuple(layers), input_bits)


def _block_kinds(cfg: ArchConfig) -> List[str]:
    """Per-layer block kind sequence of an LM stack (the reference's
    ``core/cost_model.py::_block_kinds``): the same strings name the
    planner's units and the model's blocks."""
    kinds: List[str] = []
    pat = cfg.attention.pattern
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            kinds.append("mlstm" if (i % cfg.xlstm_mlstm_every)
                         == cfg.xlstm_mlstm_every - 1 else "slstm")
        elif pat == "griffin":
            kinds.append("attn_local" if i % 3 == 2 else "rglru")
        elif pat == "alternating":
            kinds.append("attn_local" if i % 2 == 0 else "attn_full")
        elif pat == "local":
            kinds.append("attn_local")
        else:
            kinds.append("attn_full")
    return kinds


__all__ = ["LayerCost", "ModelCost", "cnn_cost"]

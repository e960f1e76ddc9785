"""``get_arch(name)``: the architectures the port serves (the dense LMs,
the MoE LMs, recurrentgemma, xlstm, whisper-tiny, qwen2-vl and the
paper's CNNs), by their reference ids; ``get_shape(name)``: the LM
shapes the pipeline planner plans them at; ``iter_cells``: every
(arch, shape, supported) pair."""
from __future__ import annotations

import importlib
from typing import Dict, Union

from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME,
                                      ArchConfig, CNNConfig, ShapeConfig)

_MODULES: Dict[str, str] = {      # the reference registry's order
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
}
_CNNS = {"lenet": "LENET", "alexnet": "ALEXNET"}
LM_ARCHS = tuple(_MODULES)
CNN_ARCHS = tuple(_CNNS)
ALL_ARCHS = LM_ARCHS + CNN_ARCHS


def get_arch(name: str) -> Union[ArchConfig, CNNConfig]:
    if name in _CNNS:
        return getattr(importlib.import_module(f"repro_torch.configs.{name}"),
                       _CNNS[name])
    if name not in _MODULES:
        raise KeyError(f"unknown or unported arch {name!r}; ported: "
                       f"{sorted(_MODULES) + sorted(_CNNS)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def iter_cells(include_skipped: bool = True):
    """Yield every (arch config, shape, supported) cell of the LM archs
    and the four shapes, in the reference's order (40 in all)."""
    for arch_name in LM_ARCHS:
        cfg = get_arch(arch_name)
        for shape in ALL_SHAPES:
            yield cfg, shape, cfg.supports(shape)


__all__ = ["ALL_ARCHS", "CNN_ARCHS", "LM_ARCHS", "get_arch", "get_shape",
           "iter_cells"]

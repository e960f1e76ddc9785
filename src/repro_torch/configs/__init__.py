"""The port's configs: the paper's CNNs (LeNet, AlexNet), the LMs it
serves (dense ``gemma2_9b``, ``phi4_mini_3_8b``, ``qwen1_5_4b``,
``minicpm_2b``; MoE ``olmoe_1b_7b``, ``granite_moe_1b_a400m``; griffin
``recurrentgemma_9b``; xLSTM ``xlstm_350m``; audio ``whisper_tiny``; VLM
``qwen2_vl_2b``; ``registry.get_arch`` by reference id) and
``ServeConfig``."""
from repro_torch.configs.alexnet import ALEXNET
from repro_torch.configs.base import (ArchConfig, AttentionConfig, CNNConfig,
                                      ConvLayerSpec, MoEConfig, ServeConfig)
from repro_torch.configs.lenet import LENET

__all__ = ["ALEXNET", "LENET", "ArchConfig", "AttentionConfig", "CNNConfig",
           "ConvLayerSpec", "MoEConfig", "ServeConfig"]

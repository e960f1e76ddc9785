"""The port's configs: the paper's CNNs (LeNet, AlexNet), the dense LMs it
serves (``gemma2_9b``, ``phi4_mini_3_8b``, ``qwen1_5_4b``, ``minicpm_2b``;
``registry.get_arch`` by reference id) and ``ServeConfig``."""
from repro_torch.configs.alexnet import ALEXNET
from repro_torch.configs.base import (ArchConfig, AttentionConfig, CNNConfig,
                                      ConvLayerSpec, MoEConfig, ServeConfig)
from repro_torch.configs.lenet import LENET

__all__ = ["ALEXNET", "LENET", "ArchConfig", "AttentionConfig", "CNNConfig",
           "ConvLayerSpec", "MoEConfig", "ServeConfig"]

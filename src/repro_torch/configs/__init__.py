"""The paper's CNN configs (LeNet, AlexNet) for the port."""
from repro_torch.configs.alexnet import ALEXNET
from repro_torch.configs.base import CNNConfig, ConvLayerSpec
from repro_torch.configs.lenet import LENET

__all__ = ["ALEXNET", "LENET", "CNNConfig", "ConvLayerSpec"]

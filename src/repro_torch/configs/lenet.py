"""LeNet — the paper's small CNN: '2 convolutional layers and 3 fully
connected layers, trained with 32x32x3 RGB-sized image' (Section IV).
The paper counts it as 5 placeable layers (pools folded into convs)."""
from repro_torch.configs.base import CNNConfig, ConvLayerSpec

LENET = CNNConfig(
    name="lenet",
    input_hw=32,
    input_channels=3,
    layers=(
        ConvLayerSpec("conv1", "conv", in_channels=3, out_channels=6,
                      kernel=5, stride=1, padding=0),          # 28x28x6
        ConvLayerSpec("pool1", "pool", kernel=2, stride=2),    # 14x14x6
        ConvLayerSpec("conv2", "conv", in_channels=6, out_channels=16,
                      kernel=5, stride=1, padding=0),          # 10x10x16
        ConvLayerSpec("pool2", "pool", kernel=2, stride=2),    # 5x5x16
        ConvLayerSpec("fc1", "fc", in_features=400, out_features=120),
        ConvLayerSpec("fc2", "fc", in_features=120, out_features=84),
        ConvLayerSpec("fc3", "fc", in_features=84, out_features=10),
    ),
)

CONFIG = LENET

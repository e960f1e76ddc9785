"""AlexNet — the paper's medium CNN: '5 convolutional layers and 3 fully
connected layers, trained with a 227x227x3 RGB-sized image' (Section IV)."""
from repro_torch.configs.base import CNNConfig, ConvLayerSpec

ALEXNET = CNNConfig(
    name="alexnet",
    input_hw=227,
    input_channels=3,
    layers=(
        ConvLayerSpec("conv1", "conv", in_channels=3, out_channels=96,
                      kernel=11, stride=4, padding=0),         # 55x55x96
        ConvLayerSpec("pool1", "pool", kernel=3, stride=2),    # 27x27x96
        ConvLayerSpec("conv2", "conv", in_channels=96, out_channels=256,
                      kernel=5, stride=1, padding=2),          # 27x27x256
        ConvLayerSpec("pool2", "pool", kernel=3, stride=2),    # 13x13x256
        ConvLayerSpec("conv3", "conv", in_channels=256, out_channels=384,
                      kernel=3, stride=1, padding=1),          # 13x13x384
        ConvLayerSpec("conv4", "conv", in_channels=384, out_channels=384,
                      kernel=3, stride=1, padding=1),          # 13x13x384
        ConvLayerSpec("conv5", "conv", in_channels=384, out_channels=256,
                      kernel=3, stride=1, padding=1),          # 13x13x256
        ConvLayerSpec("pool5", "pool", kernel=3, stride=2),    # 6x6x256
        ConvLayerSpec("fc1", "fc", in_features=9216, out_features=4096),
        ConvLayerSpec("fc2", "fc", in_features=4096, out_features=4096),
        ConvLayerSpec("fc3", "fc", in_features=4096, out_features=1000),
    ),
)

CONFIG = ALEXNET

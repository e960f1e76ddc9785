"""The paper's CNNs (LeNet, AlexNet) in PyTorch: ``models.cnn``."""

"""ResNet-18 for CIFAR, the paper's heavier model (11,173,962 parameters
in 62 leaves with GroupNorm)."""
from repro_torch.configs import base

CONFIG = base.register(base.CNNConfig(
    name="resnet18-cifar",
    kind="resnet18",
    citation="paper §3.2 (ResNet-18, CIFAR-10)",
))

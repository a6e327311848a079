"""MobileNet-style CNN for CIFAR, the paper's lightweight model.

Depthwise-separable convolution stack (Howard et al. 2017), adapted to
32x32 inputs as in the paper's CIFAR-10 experiments.  At width 1.0 it has
3,217,226 parameters in 83 leaves.
"""
from repro_torch.configs import base

CONFIG = base.register(base.CNNConfig(
    name="mobilenet-cifar",
    kind="mobilenet",
    citation="paper §3.2 (MobileNet, CIFAR-10)",
))

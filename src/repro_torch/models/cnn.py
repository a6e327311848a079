"""The paper's CIFAR CNNs as ``nn.Module``s: MobileNet-style (depthwise-
separable) and ResNet-18, GroupNorm in place of BatchNorm as in the
reference (``repro.models.cnn``).

Layouts follow the reference: ``forward`` takes images NHWC, and the
parameters have the reference's shapes, conv weights HWIO and the head as
``x @ w + b``.  The layout of a weight is part of the MLLess semantics:
the filter cuts each flattened gradient into blocks of 256, and an OIHW
weight would put other elements into each block (on reduced MobileNet the
first step's significant fraction read 0.744 with OIHW against the
reference's 0.590).  ``conv_same`` permutes a weight to OIHW for the
convolution.  ``params_to_reference`` / ``params_from_reference`` move
the reference's parameter tree of numpy arrays in and out of a module.
Inside, activations are NCHW tensors.

Three details carry the reference's numerics over:

* JAX ``"SAME"`` padding puts the odd pixel at the end: a stride-2 3x3
  conv on an even input pads (0, 1), where ``padding=1`` would pad (1, 1).
  ``conv_same`` computes the split per call and pads with ``F.pad`` when
  it is uneven.
* GroupNorm uses ``g = min(8, C)`` groups, decreased while ``C % g``, of
  contiguous channels, with biased variance and ``eps=1e-5``.
* Conv weights stay HWIO, as above.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.params import (  # noqa: F401
    params_from_reference, params_to_reference, reference_leaves,
)

_MOBILENET_CFG = [  # (out_channels, stride)
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]
_RESNET_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]  # 2 blocks each


def _same_pads(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x, w, stride=1, groups=1):
    """NCHW conv with JAX ``"SAME"`` padding; ``w`` is HWIO."""
    w = w.permute(3, 2, 0, 1)
    ph = _same_pads(x.shape[2], w.shape[2], stride)
    pw = _same_pads(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]),
                        groups=groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride, groups=groups)


def gn_groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.group_norm(x, gn_groups(x.shape[1]), self.scale,
                            self.bias, eps=1e-5)


class ConvGN(nn.Module):
    """conv -> GroupNorm; weight ``w`` is HWIO, He-normal like the
    reference's ``_conv_init``."""

    def __init__(self, c_in, c_out, k, *, stride=1, groups=1, gen=None):
        super().__init__()
        shape = (k, k, c_in // groups, c_out)
        fan_in = int(np.prod(shape[:-1]))
        self.w = nn.Parameter(torch.randn(shape, generator=gen)
                              * np.sqrt(2.0 / fan_in))
        self.gn = GroupNorm(c_out)
        self.stride, self.groups = stride, groups

    def forward(self, x):
        return self.gn(conv_same(x, self.w, self.stride, self.groups))


class Head(nn.Module):
    def __init__(self, c_in, num_classes, gen=None):
        super().__init__()
        self.w = nn.Parameter(torch.randn((c_in, num_classes), generator=gen)
                              * (1.0 / np.sqrt(c_in)))
        self.b = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x):
        return x.mean(dim=(2, 3)) @ self.w + self.b


class _CNN(nn.Module):
    def forward(self, images):
        """images: (B, H, W, C) float -> logits (B, num_classes)."""
        return self.head(self.features(images.permute(0, 3, 1, 2)))


class _DWBlock(nn.Module):
    def __init__(self, c_in, c_out, stride, gen):
        super().__init__()
        self.dw = ConvGN(c_in, c_in, 3, stride=stride, groups=c_in, gen=gen)
        self.pw = ConvGN(c_in, c_out, 1, gen=gen)

    def forward(self, x):
        return F.relu(self.pw(F.relu(self.dw(x))))


class MobileNet(_CNN):
    def __init__(self, cfg, gen=None):
        super().__init__()
        ch = lambda c: max(8, int(c * cfg.width_mult))
        self.stem = ConvGN(cfg.channels, ch(32), 3, gen=gen)
        blocks, c_in = [], ch(32)
        for c_out, stride in _MOBILENET_CFG:
            blocks.append(_DWBlock(c_in, ch(c_out), stride, gen))
            c_in = ch(c_out)
        self.blocks = nn.ModuleList(blocks)
        self.head = Head(c_in, cfg.num_classes, gen)

    def features(self, x):
        x = F.relu(self.stem(x))
        for blk in self.blocks:
            x = blk(x)
        return x


class _ResBlock(nn.Module):
    def __init__(self, c_in, c_out, stride, gen):
        super().__init__()
        self.c1 = ConvGN(c_in, c_out, 3, stride=stride, gen=gen)
        self.c2 = ConvGN(c_out, c_out, 3, gen=gen)
        self.proj = (ConvGN(c_in, c_out, 1, stride=stride, gen=gen)
                     if stride != 1 or c_in != c_out else None)

    def forward(self, x):
        h = self.c2(F.relu(self.c1(x)))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + h)


class ResNet18(_CNN):
    def __init__(self, cfg, gen=None):
        super().__init__()
        ch = lambda c: max(8, int(c * cfg.width_mult))
        self.stem = ConvGN(cfg.channels, ch(64), 3, gen=gen)
        stages, c_in = [], ch(64)
        for c_out, stride in _RESNET_STAGES:
            stage = []
            for b in range(2):
                stage.append(_ResBlock(c_in, ch(c_out),
                                       stride if b == 0 else 1, gen))
                c_in = ch(c_out)
            stages.append(nn.ModuleList(stage))
        self.stages = nn.ModuleList(stages)
        self.head = Head(c_in, cfg.num_classes, gen)

    def features(self, x):
        x = F.relu(self.stem(x))
        for stage in self.stages:
            for blk in stage:
                x = blk(x)
        return x


def build_cnn(cfg, *, device="cuda", seed: int = 0) -> nn.Module:
    """The model for ``cfg`` on ``device``, weights drawn from ``seed``
    (a ``torch.Generator``; the reference's ``jax.random`` draws cannot be
    reproduced, so parity starts from ``params_from_reference``)."""
    dev = resolve_device(device)
    cls = {"mobilenet": MobileNet, "resnet18": ResNet18}.get(cfg.kind)
    if cls is None:
        raise ValueError(cfg.kind)
    gen = torch.Generator().manual_seed(seed)
    model = cls(cfg, gen).to(dev)
    model.cfg = cfg
    return model

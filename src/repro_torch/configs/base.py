"""Architecture registry (``--arch <id>``) for the CNN configurations.

A copy of the reference's registry, cut to what the port runs: the
``CNNConfig`` of the paper's two CIFAR models.  Configs are pure data;
``repro_torch.models`` interprets them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str
    family: str = "cnn"
    kind: str = "mobilenet"            # mobilenet | resnet18
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    width_mult: float = 1.0
    dtype: str = "float32"
    citation: str = ""

    def reduced(self, **_):
        return dataclasses.replace(self, width_mult=0.25)


_REGISTRY: dict = {}


def register(cfg: CNNConfig) -> CNNConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all():
    import importlib
    for mod in _ALL_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> CNNConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


_ALL_MODULES = ["mobilenet_cifar", "resnet18_cifar"]

"""Deterministic synthetic CIFAR-like data (numpy only).

``cifar_like`` is a verbatim copy of the reference's generator, so the
port and the reference see byte-identical images and labels for a seed:
a 10-class 32x32x3 set whose classes are learnable (class-conditional
frequency/orientation patterns plus noise).
"""
from __future__ import annotations

import numpy as np


def cifar_like(n: int, *, seed: int = 0, num_classes: int = 10,
               image_size: int = 32, channels: int = 3):
    """Returns (images [n,H,W,C] float32 in [-1,1], labels [n] int32)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.meshgrid(np.arange(image_size), np.arange(image_size),
                         indexing="ij")
    imgs = np.empty((n, image_size, image_size, channels), np.float32)
    # class templates: oriented gratings at class-specific frequency/phase
    thetas = np.linspace(0, np.pi, num_classes, endpoint=False)
    freqs = 2 + np.arange(num_classes) % 5
    for c in range(num_classes):
        proj = np.cos(thetas[c]) * xx + np.sin(thetas[c]) * yy
        tmpl = np.sin(2 * np.pi * freqs[c] * proj / image_size)
        idx = labels == c
        k = int(idx.sum())
        base = np.repeat(tmpl[None, :, :, None], channels, axis=3)
        # per-channel class colour cast
        cast = np.sin(np.arange(channels) + c)[None, None, None, :]
        imgs[idx] = 0.6 * base + 0.25 * cast
    imgs += rng.randn(n, image_size, image_size, channels).astype(
        np.float32) * 0.35
    return np.clip(imgs, -1, 1), labels

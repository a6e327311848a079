"""Deterministic synthetic data (numpy only).

Verbatim copies of the reference's generators, so the port and the
reference see byte-identical data for a seed: ``cifar_like``, a 10-class
32x32x3 set whose classes are learnable (class-conditional
frequency/orientation patterns plus noise), and ``token_stream`` /
``lm_batches``, a Markov token stream cut into LM batches.
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


def token_stream(n_tokens: int, vocab: int, *, seed: int = 0):
    """Order-1 Markov chain with a sparse, banded transition structure."""
    rng = np.random.RandomState(seed)
    # each token strongly prefers a small set of successors
    n_succ = 8
    succ = (np.arange(vocab)[:, None] * 7 + rng.randint(
        0, vocab, size=(vocab, n_succ))) % vocab
    out = np.empty(n_tokens, np.int32)
    t = rng.randint(vocab)
    noise = rng.random(n_tokens)
    choices = rng.randint(0, n_succ, size=n_tokens)
    uniform = rng.randint(0, vocab, size=n_tokens)
    for i in range(n_tokens):
        out[i] = t
        if noise[i] < 0.85:
            t = succ[t, choices[i]]
        else:
            t = uniform[i]
    return out


def lm_batches(tokens: np.ndarray, batch: int, seq: int, *, seed: int = 0):
    """Yield dicts of {"tokens","labels"} forever (deterministic order)."""
    n_seq = (len(tokens) - 1) // seq
    rng = np.random.RandomState(seed)
    starts = rng.permutation(n_seq)
    i = 0
    while True:
        idx = [starts[(i + j) % n_seq] for j in range(batch)]
        i += batch
        toks = np.stack([tokens[s * seq:(s + 1) * seq] for s in idx])
        labs = np.stack([tokens[s * seq + 1:(s + 1) * seq + 1] for s in idx])
        yield {"tokens": toks, "labels": labs}

"""Frozen copy of the synthetic LM data of ``repro_torch.data``
(``token_stream`` and ``lm_batches``): a Markov token stream cut into
batches.  Kept here so that a change to the program cannot change what
the benchmark feeds it; ``tests/test_portbench_yardstick.py`` holds its
bytes for a seed."""
from __future__ import annotations

import numpy as np


def token_stream(n_tokens: int, vocab: int, *, seed: int = 0):
    """Order-1 Markov chain with a sparse, banded transition structure:
    ``n_tokens`` int32 ids below ``vocab``."""
    rng = np.random.RandomState(seed)
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
    """Dicts of ``tokens`` and ``labels`` (batch, seq) forever, in a
    fixed order drawn from ``seed``; the labels are the tokens shifted by
    one."""
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


def seed32(seed: int) -> int:
    """A seed of any size folded to numpy's 32-bit range."""
    return int(seed) % (2 ** 32)

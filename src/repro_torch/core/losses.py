"""Losses (``repro.core.losses``)."""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels, tp=None):
    """logits: (B, S, V) any float dtype; labels: (B, S) int.  fp32
    logsumexp minus the gold logit, mean over all tokens.  Under tensor
    parallelism (``tp``, a ``models.tp.TensorParallel``) logits are this
    rank's vocab columns and the loss is vocab-parallel, the same on
    every rank of the group."""
    if tp is not None:
        return torch.mean(tp.cross_entropy(logits, labels))
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def classification_loss(logits, labels):
    """logits: (B, C) any float dtype; labels: (B,) int.  fp32
    logsumexp minus the gold logit, mean over the batch."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def accuracy(logits, labels):
    return (torch.argmax(logits, dim=-1) == labels.long()).float().mean()

"""Losses (``repro.core.losses``)."""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels):
    """logits: (B, S, V) any float dtype; labels: (B, S) int.  fp32
    logsumexp minus the gold logit, mean over all tokens."""
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

"""Training losses (counterpart of :mod:`repro.train.losses`): next-token
cross-entropy with a z-loss regularizer."""

from __future__ import annotations

from typing import Tuple

import torch

from ..sharding.partition import constrain_batch, gather_vocab, pick_last

__all__ = ["next_token_loss"]


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    z_loss: float = 1e-4,
                    ignore_id: int = -100) -> Tuple[torch.Tensor, dict]:
    """``logits (B, S, V)`` vs ``labels (B, S)``; returns ``(loss,
    metrics)``, each a float32 scalar tensor on the logits' device.

    ``labels`` are already aligned (the caller shifts); ``ignore_id``
    positions are masked out (their gather reads label 0).  The z-loss
    (``log^2 Z``) keeps the softmax normaliser from drifting.  Metrics:
    ``ce``, ``z_loss``, ``ppl`` (``exp`` of ``ce`` clipped to [0, 20]) and
    ``tokens`` (the unmasked count)."""
    logits = gather_vocab(logits.float())
    lse = constrain_batch(torch.logsumexp(logits, dim=-1))       # (B, S)
    label_safe = torch.clamp(labels, min=0).long()
    picked = constrain_batch(pick_last(logits, label_safe))
    nll = lse - picked
    mask = (labels != ignore_id).float()
    tokens = mask.sum()
    denom = torch.clamp(tokens, min=1.0)
    ce = (nll * mask).sum() / denom
    zl = ((lse ** 2) * mask).sum() / denom
    loss = ce + z_loss * zl
    metrics = {"ce": ce, "z_loss": zl,
               "ppl": torch.exp(torch.clamp(ce, 0.0, 20.0)),
               "tokens": tokens}
    return loss, metrics

"""Loss functions, weight-mask aware.

Port of `oovrec_tpu/models/losses.py:13-32`. Every loss takes an optional
per-row `weight` (1 real / 0 pad), so a padded fixed-shape batch gives the
value the reference computes on its variable-size batch: padded rows
carry weight 0 and do not count.
"""

from __future__ import annotations

from typing import Optional

import torch


def _wmean(x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    if weight is None:
        return x.mean()
    w = weight.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def bpr_loss(pos_score, neg_score, weight=None, gamma: float = 1e-10):
    """-log(gamma + sigmoid(pos - neg)), mean (`loss.py` BPRLoss)."""
    return _wmean(-torch.log(gamma + _sigmoid(pos_score - neg_score)), weight)


def bce_with_logits(logits, labels, weight=None):
    """Numerically stable binary cross entropy on logits."""
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return _wmean(loss, weight)

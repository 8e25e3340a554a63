"""Loss functions, weight-mask aware.

Port of `oovrec_tpu/models/losses.py:13-41`. Every loss takes an optional
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


def bce(probs, labels, weight=None, eps: float = 1e-8):
    """BCE on probabilities clipped to [eps, 1 - eps] (DCNv2 applies the
    sigmoid before the loss), each log held at ≥ -100 as the reference's
    `nn.BCELoss` holds it. In f32, 1 - 1e-8 rounds to 1, so a saturated
    probability of 1 passes the clip: there the JAX function takes log(0)
    and gives inf (label 0) or 0·(-inf) = NaN (label 1); the port gives
    the reference's value. Wherever the JAX function is finite the two are
    the same (the clipped logs are ≥ log(1e-8) ≈ -18.4)."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return _wmean(-(labels * _log_floor(p) + (1.0 - labels) * _log_floor(1.0 - p)), weight)


def _log_floor(x: torch.Tensor) -> torch.Tensor:
    """max(log x, -100) for x ≥ 0, with a zero gradient (not 0·inf) at
    x = 0."""
    pos = x > 0
    return torch.clamp(torch.where(pos, torch.log(torch.where(pos, x, 1.0)), -100.0), min=-100.0)

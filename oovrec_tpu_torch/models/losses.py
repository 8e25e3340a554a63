"""Loss functions, weight-mask aware.

Port of `oovrec_tpu/models/losses.py:13-53`. Every loss takes an optional
per-row `weight` (1 real / 0 pad), so a padded fixed-shape batch gives the
value the reference computes on its variable-size batch: padded rows
carry weight 0 and do not count. Under the mesh (`parallel/train_step.py:
data_scope`) the means and norms are the global batch's: the sums run over
every data rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from oovrec_tpu_torch.parallel.train_step import (
    batch_mean,
    batch_rows,
    batch_sum,
    batch_vector_norm,
    batch_wmean,
)


def _wmean(x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    if weight is None:
        return batch_mean(x)
    return batch_wmean(x, weight.to(x.dtype))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def bpr_loss(pos_score, neg_score, weight=None, gamma: float = 1e-10):
    """-log(gamma + sigmoid(pos - neg)), mean (`loss.py` BPRLoss)."""
    return _wmean(-torch.log(gamma + _sigmoid(pos_score - neg_score)), weight)


def bce_with_logits(logits, labels, weight=None):
    """Numerically stable binary cross entropy on logits, with the JAX
    function's gradient at a logit of exactly 0 (a dead ReLU head with a
    zero bias): there `jnp.maximum` splits its gradient (½) and `jnp.abs`
    takes the + side (−½ through the log term), so the row's gradient is
    −label, where the clamp (1) and `torch.abs` (0) give 1 − label. The
    last term is 0 in value and moves the gradient by −1 where the logit
    is 0; elsewhere it adds an exact 0, so every other gradient keeps the
    bits of the three terms' sum."""
    return _wmean(bce_with_logits_terms(logits, labels), weight)


def bce_with_logits_terms(logits, labels):
    """`bce_with_logits`' terms, elementwise and unreduced (S3Rec sums
    them under its own masks)."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))) - (logits == 0) * logits)


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


def emb_loss(*embeddings, norm: int = 2, require_pow: bool = False):
    """EmbLoss (`loss.py`): the sum of each tensor's whole norm (or, under
    `require_pow`, of |e|^norm over `norm`) over the rows of the last one;
    padded rows count, as in the JAX function. Each tensor is per-row: under
    the mesh its norm and the row count are the global batch's."""
    batch = batch_rows(embeddings[-1].shape[0])
    total = 0.0
    for e in embeddings:
        if require_pow:
            total = total + batch_sum(e.abs().pow(norm))
        else:
            total = total + batch_vector_norm(e, ord=norm)
    if require_pow:
        total = total / norm
    return total / batch

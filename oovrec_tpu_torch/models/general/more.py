"""EASE, the closed-form item-item model, and MultiVAE.

Port of `oovrec_tpu/models/general/more.py:21-138`.
  * EASE: a traditional model (`models/general/base.py`): B = −P / diag(P)
    column by column, with P = (XᵀX + λI)⁻¹ and a zero diagonal, solved
    once on the host by the JAX package's numpy, copied as it is
    (`ease_state`), so the two states agree bit for bit. `build_estate`
    reads `reg_weight` from the config. Scoring is
    `user_hist_matrix[users] @ ease_B` on the model's device.
  * MultiVAE: trained on user batches (`train_on_users`) over the rows of
    `user_hist_matrix` (a buffer on the card, `HistoryMatrixModel`): the
    row over its L2 norm (floor 1e-12), dropout, the tanh `enc_<i>`,
    `enc_mu` / `enc_logvar`; z = μ + ε·exp(½ logvar) in train mode (μ in
    eval mode); the tanh `dec_<i>` and `dec_out` give the logits. The loss
    is the multinomial log-likelihood plus `anneal_cap` times the KL
    term, a weighted mean over the batch's users: the JAX model's
    annealing is the constant cap, and `total_anneal_steps` is read and
    unused. The keep mask and ε come from the trainer's dropout generator
    (`models/layers.py:RandomDraws`), drawn in the JAX model's order (the
    mask, then ε); a test hands the model JAX's own draws through
    `draws`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.general.base import (
    HistoryMatrixModel,
    HistoryProductRecommender,
    config_values,
    l2_rows,
)
from oovrec_tpu_torch.models.layers import RandomDraws
from oovrec_tpu_torch.models.losses import _wmean
from oovrec_tpu_torch.utils.enums import InputType


def ease_state(train_split, reg_weight: float = 250.0) -> dict:
    """`EASE.build_estate` of the JAX package (`more.py:45-57`)."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    X = np.zeros((train_split.user_num, train_split.item_num), np.float32)
    X[uid, iid] = 1.0
    G = X.T @ X + reg_weight * np.eye(X.shape[1], dtype=np.float32)
    P = np.linalg.inv(G)
    # column-wise division: B_ij = −P_ij / P_jj (`ease.py:48`, the
    # paper's B = I − P·diagMat(1/diag P))
    B = -P / np.diag(P)[None, :]
    np.fill_diagonal(B, 0.0)
    return {"ease_B": B.astype(np.float32), "user_hist_matrix": X}


@register_model
class EASE(HistoryProductRecommender):
    matrix = "ease_B"

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 reg_weight: float = 250.0, ease_B: Optional[np.ndarray] = None,
                 user_hist_matrix: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.reg_weight = float(reg_weight)
        self._init_state(user_hist_matrix, ease_B)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return ease_state(train_split, **config_values(config, {"reg_weight": 250.0}))


def multinomial_nll(logits: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """(B,): −Σ log_softmax(logits) · hist over the items."""
    return -(torch.log_softmax(logits, dim=-1) * hist).sum(dim=1)


def gaussian_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """(B,): KL(N(μ, exp logvar) ‖ N(0, 1))."""
    return -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=1)


def dense_stack(model, prefix: str, widths: Sequence[int]) -> list:
    """xavier-normal Denses `<prefix>_<i>` between consecutive `widths`."""
    layers = []
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        model.add_module(f"{prefix}_{i}", dense(model, n_in, n_out))
        layers.append(getattr(model, f"{prefix}_{i}"))
    return layers


@register_model
class MultiVAE(HistoryMatrixModel):
    input_type = InputType.POINTWISE
    train_on_users = True

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 latent_dim: int = 64, encoder_hidden: Sequence[int] = (256,),
                 dropout_prob: float = 0.5, anneal_cap: float = 0.2,
                 total_anneal_steps: int = 200000, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        hidden = tuple(int(h) for h in encoder_hidden)
        self.latent_dim = int(latent_dim)
        self.dropout_prob = float(dropout_prob)
        self.anneal_cap = float(anneal_cap)
        self.total_anneal_steps = int(total_anneal_steps)
        self.enc_layers = dense_stack(self, "enc", (n_items,) + hidden)
        top = (n_items,) + hidden
        self.enc_mu = dense(self, top[-1], self.latent_dim)
        self.enc_logvar = dense(self, top[-1], self.latent_dim)
        self.dec_layers = dense_stack(self, "dec", (self.latent_dim,) + hidden[::-1])
        self.dec_out = dense(self, ((self.latent_dim,) + hidden[::-1])[-1], n_items)
        self.draws = RandomDraws()

    def _encode(self, x: torch.Tensor, train: bool):
        h = l2_rows(x)
        if train:
            h = self.draws.dropout(h, self.dropout_prob)
        for layer in self.enc_layers:
            h = torch.tanh(layer(h))
        return self.enc_mu(h), self.enc_logvar(h)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for layer in self.dec_layers:
            h = torch.tanh(layer(h))
        return self.dec_out(h)

    def forward(self, hist: torch.Tensor, train: bool = False):
        """(logits, μ, logvar) of the rows `hist`."""
        mu, logvar = self._encode(hist, train)
        if train:
            z = mu + self.draws.normal(mu.shape, mu.device) * torch.exp(0.5 * logvar)
        else:
            z = mu
        return self._decode(z), mu, logvar

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        hist = self.history(batch[self.uid_field])
        logits, mu, logvar = self.forward(hist, train=True)
        per_user = multinomial_nll(logits, hist) + self.anneal_cap * gaussian_kl(mu, logvar)
        return _wmean(per_user, batch.get("weight"))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        return self.forward(self.history(batch[self.uid_field]))[0]

"""RecVAE, ADMMSLIM, SpectralCF and GCMC.

Port of `oovrec_tpu/models/general/more4.py:25-280`.
  * RecVAE (user batches, over `user_hist_matrix`): the normalised row,
    dropout, two swish Denses `enc1` / `enc2`, `mu` / `logvar`; z = μ +
    ε·exp(½ logvar) decoded by `dec`. The loss is the multinomial
    log-likelihood plus γ·|row| times log q(z) − log p(z), the composite
    prior a log-sum-exp of N(0, 1), N(μ, exp logvar) with μ and logvar
    detached, and N(0, 10), weighted by `mixture_weights`; `beta` is read
    and unused, as in the JAX model. The keep mask, then ε, come from the
    trainer's dropout generator (`models/layers.py:RandomDraws`). The
    full sort decodes μ.
  * ADMMSLIM: a traditional model (`models/general/base.py`), SLIM by
    ADMM's closed-form updates in float64 on the host, the JAX package's
    numpy copied as it is (`admmslim_state`), so the two states agree bit
    for bit; `build_estate` reads `lambda1`, `lambda2`, `admm_iter`, `rho`
    and `positive_only` from the config. Scoring is
    `user_hist_matrix[users] @ admm_W` on the model's device.
  * SpectralCF: for each of `n_layers` filters, e ← sigmoid(filter(e +
    Âe)) (bias-free), the layers concatenated; BPR + EmbLoss of the
    propagated rows.
  * GCMC: one graph convolution relu(gcn(Âe)) (bias-free), dropout, the
    `dense` transform; the logit of a pair is (u @ decoder_q)·i with the
    raw (D, D) `decoder_q` in flax's layout; pointwise
    `bce_with_logits` on the label (with its zero-logit gradient,
    `models/losses.py`), `predict` the sigmoid.
The two graph models propagate over LightGCN's edges
(`lightgcn.py:GraphModel`), through the sort-and-segment kernel on the
card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.general.base import (
    HistoryMatrixModel,
    HistoryProductRecommender,
    config_values,
    l2_rows,
)
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, bpr_of
from oovrec_tpu_torch.models.general.more import multinomial_nll
from oovrec_tpu_torch.models.layers import Dropout, RandomDraws
from oovrec_tpu_torch.models.losses import _wmean, bce_with_logits, emb_loss
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import InputType


def log_normal(z: torch.Tensor, mu, logvar: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(z; μ, exp logvar)."""
    return -0.5 * (logvar + (z - mu) ** 2 / torch.exp(logvar) + math.log(2 * math.pi))


@register_model
class RecVAE(HistoryMatrixModel):
    input_type = InputType.POINTWISE
    train_on_users = True

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 latent_dim: int = 64, hidden_dim: int = 128, dropout_prob: float = 0.5,
                 beta: float = 0.2, gamma: float = 0.005,
                 mixture_weights: Sequence[float] = (3 / 20, 3 / 4, 1 / 10), **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.dropout_prob, self.beta, self.gamma = float(dropout_prob), float(beta), float(gamma)
        self.mixture_weights = tuple(float(w) for w in mixture_weights)
        self.enc1 = dense(self, n_items, int(hidden_dim))
        self.enc2 = dense(self, int(hidden_dim), int(hidden_dim))
        self.mu = dense(self, int(hidden_dim), int(latent_dim))
        self.logvar = dense(self, int(hidden_dim), int(latent_dim))
        self.dec = dense(self, int(latent_dim), n_items)
        self.draws = RandomDraws()

    def _encode(self, x: torch.Tensor, train: bool):
        h = l2_rows(x)
        if train:
            h = self.draws.dropout(h, self.dropout_prob)
        h = F.silu(self.enc2(F.silu(self.enc1(h))))
        return self.mu(h), self.logvar(h)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        hist = self.history(batch[self.uid_field])
        mu, logvar = self._encode(hist, train=True)
        z = mu + self.draws.normal(mu.shape, mu.device) * torch.exp(0.5 * logvar)
        ce = multinomial_nll(self.dec(z), hist)
        w1, w2, w3 = (math.log(w) for w in self.mixture_weights)
        zeros = torch.zeros_like(z)
        pz = torch.stack([
            w1 + log_normal(z, 0.0, zeros).sum(-1),
            w2 + log_normal(z, mu.detach(), logvar.detach()).sum(-1),
            w3 + log_normal(z, 0.0, torch.full_like(z, math.log(10.0))).sum(-1),
        ])
        kl = self.gamma * hist.sum(dim=1) * (log_normal(z, mu, logvar).sum(-1)
                                             - torch.logsumexp(pz, dim=0))
        return _wmean(ce + kl, batch.get("weight"))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        return self.dec(self._encode(self.history(batch[self.uid_field]), train=False)[0])

ADMM_DEFAULTS = {"lambda1": 3.0, "lambda2": 200.0, "admm_iter": 30, "rho": 4000.0,
                 "positive_only": True}


def admmslim_state(train_split, lambda1=3.0, lambda2=200.0, admm_iter=30, rho=4000.0,
                   positive_only=True) -> dict:
    """`ADMMSLIM.build_estate` of the JAX package (`more4.py:127-150`)."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    X = np.zeros((train_split.user_num, train_split.item_num), np.float32)
    X[uid, iid] = 1.0
    G = (X.T @ X).astype(np.float64)
    n = G.shape[0]
    P = np.linalg.inv(G + (lambda2 + rho) * np.eye(n))
    B_aux = P @ G
    Gamma = np.zeros((n, n))
    C = np.zeros((n, n))
    for _ in range(admm_iter):
        B_tilde = B_aux + P @ (rho * C - Gamma)
        gamma = np.diag(B_tilde) / np.maximum(np.diag(P), 1e-12)
        B = B_tilde - P * gamma[None, :]
        # soft threshold
        C = np.sign(B + Gamma / rho) * np.maximum(
            np.abs(B + Gamma / rho) - lambda1 / rho, 0.0
        )
        if positive_only:
            C = np.maximum(C, 0.0)
        Gamma = Gamma + rho * (B - C)
    np.fill_diagonal(C, 0.0)
    return {"admm_W": C.astype(np.float32), "user_hist_matrix": X}


@register_model
class ADMMSLIM(HistoryProductRecommender):
    matrix = "admm_W"

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 lambda1: float = 3.0, lambda2: float = 200.0, admm_iter: int = 30,
                 rho: float = 4000.0, positive_only: bool = True,
                 admm_W: Optional[np.ndarray] = None,
                 user_hist_matrix: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.lambda1, self.lambda2, self.rho = float(lambda1), float(lambda2), float(rho)
        self.admm_iter, self.positive_only = int(admm_iter), bool(positive_only)
        self._init_state(user_hist_matrix, admm_W)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return admmslim_state(train_split, **config_values(config, ADMM_DEFAULTS))


@register_model
class SpectralCF(GraphModel):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_layers: int = 4,
                 reg_weight: float = 0.001, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_layers = int(n_layers)
        self.reg_weight = float(reg_weight)
        self.filters = []
        for i in range(self.n_layers):
            self.add_module(f"filter_{i}", dense(self, embedding_size, embedding_size,
                                                 bias=False))
            self.filters.append(getattr(self, f"filter_{i}"))

    def embeddings(self):
        e = self.ego()
        outs = [e]
        for f in self.filters:
            e = torch.sigmoid(f(e + self._prop(e)))
            outs.append(e)
        return self._split(torch.cat(outs, dim=1))

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u, p, n = self._rows(batch, *self.embeddings())
        return bpr_of(u, p, n, batch) + self.reg_weight * emb_loss(u, p, n)


@register_model
class GCMC(GraphModel):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 gcn_output_dim: int = 64, dropout_prob: float = 0.1,
                 label_field: str = "label", **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.label_field = label_field
        self.gcn = dense(self, embedding_size, int(gcn_output_dim), bias=False)
        self.dense = dense(self, int(gcn_output_dim), embedding_size)
        self.drop = Dropout(dropout_prob)
        self.decoder_q = raw_param(self, embedding_size, embedding_size)

    def _encode(self, train: bool = False):
        conv = F.relu(self.gcn(self._prop(self.ego())))
        return self._split(self.dense(self.drop(conv, train)))

    def embeddings(self):
        return self._encode()

    def _logits(self, batch: Batch, ue: torch.Tensor, ie: torch.Tensor) -> torch.Tensor:
        u = gather_rows(ue, batch[self.uid_field])
        i = gather_rows(ie, batch[self.iid_field])
        return ((u @ self.decoder_q) * i).sum(dim=1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        logits = self._logits(batch, *self._encode(train=True))
        return bce_with_logits(logits, batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self._logits(batch, *self._encode()))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        ue, ie = self._encode()
        return (ue[batch[self.uid_field].long()] @ self.decoder_q) @ ie.T

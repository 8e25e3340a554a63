"""ADMMSLIM, SpectralCF and GCMC.

Port of `oovrec_tpu/models/general/more4.py:112-280` (the module's other
model, RecVAE, is not ported yet).
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

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.general.base import HistoryProductRecommender, config_values
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, bpr_of
from oovrec_tpu_torch.models.layers import Dropout
from oovrec_tpu_torch.models.losses import bce_with_logits, emb_loss
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import InputType

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

"""NCEPLRec, DGCF and NCL.

Port of `oovrec_tpu/models/general/more5.py:24-342` (the module's other
models, NNCF and MacridVAE, are not ported yet).
  * NCEPLRec: a traditional model (`models/general/base.py`): an
    NCE-reweighted SVD of the training matrix, then a ridge regression per
    user, solved once on the host by the JAX package's numpy, copied as it
    is (`nceplrec_state`), so the two states agree bit for bit (the
    scores do not depend on the signs of the singular vectors);
    `build_estate` reads `rank`, `beta` and `reg_weight` from the config.
    The state is the (n_users, n_items) score matrix `plrec_scores`.
  * DGCF: the embedding cut into `n_factors` chunks; each layer weighs
    every edge per factor by the softmax over the factors of the dot
    product of its two ends' chunks, propagates each chunk with its
    weights and adds the layer's input; the chunks concatenated; BPR +
    EmbLoss of the propagated rows. An embedding size that `n_factors`
    does not divide is refused at build time (the JAX model asserts).
  * NCL: LightGCN's layers; BPR, the structural contrast (layer
    min(2, K) against layer 0 at the batch's users and positives), the
    prototype contrast of the ego user rows against their k-means centre
    (`kmeans`, on the detached ego user rows) and the EmbLoss of the ego
    rows. The k-means starts from the first k user rows (the padding row
    among them) and runs 4 rounds; `argmin` ties go to the lowest index;
    the counts and sums are one segment sum through the sort-and-segment
    kernel; an empty cluster's centre is 0.
The graph models propagate over LightGCN's edges (`lightgcn.py:GraphModel`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.general.base import TraditionalRecommender, config_values, set_state
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, bpr_of
from oovrec_tpu_torch.models.losses import emb_loss
from oovrec_tpu_torch.ops.embed_grad import gather_rows, segment_sum
from oovrec_tpu_torch.utils.enums import InputType


def nceplrec_state(train_split, rank: int = 64, beta: float = 1.0,
                   reg_weight: float = 15000.0) -> dict:
    """`NCEPLRec.build_estate` of the JAX package (`more5.py:49-66`)."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    X = np.zeros((train_split.user_num, train_split.item_num), np.float32)
    X[uid, iid] = 1.0
    pop = X.sum(axis=0)
    # NCE de-popularization weights
    d = np.maximum(pop, 1.0) ** beta
    D = X * np.log(np.maximum(X.sum() / d, 1.0))[None, :]
    rank = min(rank, min(D.shape) - 1)
    U, s, Vt = np.linalg.svd(D, full_matrices=False)
    Q = Vt[:rank].T * s[:rank][None, :]  # item factors (n_items, r)
    # per-user ridge regression: w_u = (QᵀQ + λI)⁻¹ Qᵀ x_u
    A = np.linalg.inv(Q.T @ Q + reg_weight * np.eye(rank))
    W = X @ Q @ A  # (n_users, r)
    scores = W @ Q.T
    return {"plrec_scores": scores.astype(np.float32)}


@register_model
class NCEPLRec(TraditionalRecommender):
    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, rank: int = 64,
                 beta: float = 1.0, reg_weight: float = 15000.0,
                 plrec_scores: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.rank, self.beta, self.reg_weight = int(rank), float(beta), float(reg_weight)
        set_state(self, "plrec_scores", plrec_scores, (n_users, n_items), torch.float32)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        return self.plrec_scores[batch[self.uid_field].long()]

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return nceplrec_state(train_split, **config_values(
            config, {"rank": 64, "beta": 1.0, "reg_weight": 15000.0}))


@register_model
class DGCF(GraphModel):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_factors: int = 4,
                 n_layers: int = 1, reg_weight: float = 1e-3, **kwargs):
        if embedding_size % int(n_factors):
            raise ValueError(f"DGCF: embedding_size {embedding_size} is not a multiple of "
                             f"n_factors {n_factors}")
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_factors = int(n_factors)
        self.n_layers = int(n_layers)
        self.reg_weight = float(reg_weight)

    def embeddings(self):
        src, dst, w, n = self.edge_src, self.edge_dst, self.edge_weight, self.n_nodes
        chunks = list(self.ego().split(self.embedding_size // self.n_factors, dim=1))
        for _ in range(self.n_layers):
            at_src = [gather_rows(c, src) for c in chunks]
            # factor affinity per edge: the dot product of its ends' chunks
            aff = torch.stack([(a * gather_rows(c, dst)).sum(dim=1)
                               for a, c in zip(at_src, chunks)])
            att = torch.softmax(aff, dim=0) * w  # (F, E)
            chunks = [segment_sum(a * att[f][:, None], dst, n) + c
                      for f, (a, c) in enumerate(zip(at_src, chunks))]
        return self._split(torch.cat(chunks, dim=1))

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u, p, n = self._rows(batch, *self.embeddings())
        return bpr_of(u, p, n, batch) + self.reg_weight * emb_loss(u, p, n)


def kmeans(x: torch.Tensor, k: int, iters: int = 4):
    """(centres (k, D), assignment (n,)) of `x` (no gradient), from its
    first k rows (`_kmeans`, `more5.py:266-282` of the JAX package)."""
    centers = x[:k]
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    xs = torch.cat([x, ones], dim=1)
    for _ in range(iters):
        d = ((x**2).sum(dim=1)[:, None] - 2 * x @ centers.T
             + (centers**2).sum(dim=1)[None, :])
        assign = torch.argmin(d, dim=1)
        sums = segment_sum(xs, assign, k)
        centers = sums[:, :-1] / torch.clamp(sums[:, -1:], min=1.0)
    return centers, assign


def ncl_info_nce(a: torch.Tensor, b: torch.Tensor, tau: float) -> torch.Tensor:
    """NCL's InfoNCE of row-aligned (B, D) views, the rows normalised
    with 1e-12 under the root."""
    a = a / torch.sqrt((a**2).sum(dim=1, keepdim=True) + 1e-12)
    b = b / torch.sqrt((b**2).sum(dim=1, keepdim=True) + 1e-12)
    pos = (a * b).sum(dim=1) / tau
    return (-pos + torch.logsumexp((a @ b.T) / tau, dim=1)).mean()


@register_model
class NCL(GraphModel):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_layers: int = 2,
                 ssl_temp: float = 0.1, ssl_reg: float = 1e-6, proto_reg: float = 1e-6,
                 num_clusters: int = 16, reg_weight: float = 1e-4, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_layers = int(n_layers)
        self.ssl_temp = float(ssl_temp)
        self.ssl_reg = float(ssl_reg)
        self.proto_reg = float(proto_reg)
        self.num_clusters = int(num_clusters)
        self.reg_weight = float(reg_weight)

    def _lightgcn_all(self):
        e = self.ego()
        layers = [e]
        cur = e
        for _ in range(self.n_layers):
            cur = self._prop(cur)
            layers.append(cur)
        return sum(layers) / (self.n_layers + 1), layers

    def embeddings(self):
        return self._split(self._lightgcn_all()[0])

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        final, layers = self._lightgcn_all()
        users, pos = batch[self.uid_field], batch[self.iid_field]
        u, p, ng = self._rows(batch, *self._split(final))
        mf = bpr_of(u, p, ng, batch)

        # structural contrast: layer-0 vs layer-2 representations
        l0, l2 = layers[0], layers[min(2, self.n_layers)]
        items = pos.long() + self.n_users
        ssl = (ncl_info_nce(gather_rows(l2, users), gather_rows(l0, users), self.ssl_temp)
               + ncl_info_nce(gather_rows(l2, items), gather_rows(l0, items), self.ssl_temp))

        # prototype contrast against the k-means centres of the ego users
        centers, assign = kmeans(l0[: self.n_users].detach(), self.num_clusters)
        proto = ncl_info_nce(gather_rows(l0, users), centers[assign[users.long()]],
                             self.ssl_temp)
        reg = emb_loss(*self._ego_rows(batch))
        return (mf + self.ssl_reg * ssl + self.proto_reg * proto
                + self.reg_weight * reg)

"""NCEPLRec, NNCF, DGCF, NCL and MacridVAE.

Port of `oovrec_tpu/models/general/more5.py:24-435`.
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
  * NNCF (pointwise rows): the user's and the item's rows, a convolution
    over the user's item neighbours (`u_conv`) and one over the item's
    user neighbours (`i_conv`), each flax's 1-D `nn.Conv` with SAME
    padding (kernel 2 over 8 positions: one zero at the end), relu and
    the max over the positions; [u ⊙ i, u, i, ci, cu] through the relu
    `mlp_<i>` with dropout after each, then `out`; BCE on logits. The
    neighbour sets (`nncf_neighbors`) are drawn on the host by the JAX
    package's rule, bit for bit: `neigh_num` of each user's training items
    with replacement, then of each item's training users in row order,
    from `host_rng(2020, "nncf_neighbors")`. `build_estate` reads
    `neigh_num` from the config; the JAX `quick_start` passes no config and
    always draws 8 (ROADMAP §3), and the seed stays the keyword's 2020
    (`seed` is not a key of NNCF.yaml). The full sort runs the convs once
    a batch for its users and once for all the items, then the MLP over
    blocks of items (`models/base.py:score_item_blocks`).
  * MacridVAE (user batches, over `user_hist_matrix`): `kfac` concept
    prototypes; each item's concept weights are the softmax at `tau` of
    its normalised row of `item_embedding` against the normalised
    `concepts`; each concept encodes the row weighted by them (normalised,
    dropout, the tanh `enc_<i>`, the normalised `mu`, `logvar`, z = μ +
    ε·exp(½ logvar) in train mode), scores the normalised items at `tau`,
    and its softmax weighted by the concept's weights adds to the mixed
    probabilities; the logits are their log, floored at 1e-12. One keep
    mask and one ε a concept, in that order, from the trainer's dropout
    generator.
The graph models propagate over LightGCN's edges (`lightgcn.py:GraphModel`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from oovrec_tpu_torch.models.base import (
    Batch,
    GeneralRecommender,
    register_model,
    score_item_blocks,
)
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.general.base import (
    HistoryMatrixModel,
    TraditionalRecommender,
    config_values,
    set_state,
)
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, bpr_of
from oovrec_tpu_torch.models.general.more import dense_stack, gaussian_kl
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.models.layers import Dropout, RandomDraws
from oovrec_tpu_torch.models.losses import _wmean, bce_with_logits, emb_loss
from oovrec_tpu_torch.models.sequential.convs import Conv, windows
from oovrec_tpu_torch.ops.embed_grad import gather_rows, segment_sum
from oovrec_tpu_torch.parallel.train_step import batch_mean, global_rows
from oovrec_tpu_torch.utils.enums import InputType
from oovrec_tpu_torch.utils.seeding import host_rng


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


def nncf_neighbors(train_split, neigh_num: int = 8, seed: int = 2020) -> dict:
    """`NNCF.build_estate` of the JAX package (`more5.py:135-155`):
    (user_num, K) item neighbours, then (item_num, K) user neighbours,
    each drawn with replacement from the training rows; a user or item
    without rows keeps zeros. The item lists are the rows' users in row
    order (a stable sort by item), and the draws come in the JAX loop's
    order, so the arrays are the same bit for bit."""
    rng = host_rng(seed, "nncf_neighbors")
    K = int(neigh_num)
    un = np.zeros((train_split.user_num, K), np.int64)
    for u, items in enumerate(train_split.used_ids_per_user()):
        if len(items):
            un[u] = np.asarray(items)[rng.integers(0, len(items), K)]
    uid = np.asarray(train_split.inter[train_split.uid_field])
    iid = np.asarray(train_split.inter[train_split.iid_field])
    order = np.argsort(iid, kind="stable")
    users, items = uid[order], iid[order]
    ids = np.arange(train_split.item_num)
    starts = np.searchsorted(items, ids, side="left")
    ends = np.searchsorted(items, ids, side="right")
    inn = np.zeros((train_split.item_num, K), np.int64)
    for i in range(train_split.item_num):
        n = ends[i] - starts[i]
        if n:
            inn[i] = users[starts[i]:ends[i]][rng.integers(0, n, K)]
    return {"user_neighbors": un, "item_neighbors": inn}


def same_conv_max(x: torch.Tensor, conv: Conv) -> torch.Tensor:
    """flax's 1-D `nn.Conv` (stride 1, SAME padding: (k − 1) // 2 zeros
    before, the rest after) over (B, K, D), relu, max over the K
    positions → (B, C)."""
    k, d, _ = conv.kernel.shape
    lo = (k - 1) // 2
    xp = F.pad(x, (0, 0, lo, k - 1 - lo))
    c = windows(xp, k, 1, x.shape[1]) @ conv.kernel.reshape(k * d, -1) + conv.bias
    return torch.relu(c).amax(dim=1)


@register_model
class NNCF(GeneralRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 neigh_num: int = 8, conv_kernel_size: int = 2, conv_channels: int = 16,
                 mlp_hidden_size: Sequence[int] = (64, 32), dropout_prob: float = 0.2,
                 label_field: str = "label", user_neighbors: Optional[np.ndarray] = None,
                 item_neighbors: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        D, C, k = embedding_size, int(conv_channels), int(conv_kernel_size)
        self.label_field = label_field
        self.neigh_num = int(neigh_num)
        self.user_embedding = self._embed_table(n_users)
        self.item_embedding = self._embed_table(n_items)
        self.u_conv = Conv((k, D, C), self.device, self.generator)
        self.i_conv = Conv((k, D, C), self.device, self.generator)
        hidden = tuple(int(h) for h in mlp_hidden_size)
        self.mlp_layers = dense_stack(self, "mlp", (3 * D + 2 * C,) + hidden)
        self.out = dense(self, ((3 * D + 2 * C,) + hidden)[-1], 1)
        self.drop = Dropout(dropout_prob)
        set_state(self, "user_neighbors", user_neighbors, (n_users, self.neigh_num), torch.int64)
        set_state(self, "item_neighbors", item_neighbors, (n_items, self.neigh_num), torch.int64)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return nncf_neighbors(train_split, **config_values(config, {"neigh_num": 8}))

    def _mlp(self, u, i, ci, cu, train: bool) -> torch.Tensor:
        x = torch.cat([u * i, u, i, ci, cu], dim=-1)
        for layer in self.mlp_layers:
            x = self.drop(torch.relu(layer(x)), train)
        return self.out(x).squeeze(-1)

    def _score(self, users: torch.Tensor, items: torch.Tensor, train: bool = False):
        u = gather_rows(self.user_embedding.weight, users)
        i = gather_rows(self.item_embedding.weight, items)
        ni = gather_rows(self.item_embedding.weight, self.user_neighbors[users.long()])
        nu = gather_rows(self.user_embedding.weight, self.item_neighbors[items.long()])
        return self._mlp(u, i, same_conv_max(ni, self.u_conv), same_conv_max(nu, self.i_conv),
                         train)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        out = self._score(batch[self.uid_field], batch[self.iid_field], train=True)
        return bce_with_logits(out, batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self._score(batch[self.uid_field], batch[self.iid_field]))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        """(B, n_items): the users' and the items' convs once, the MLP over
        blocks of items (at most `FULL_SORT_ELEMS` elements of its input)."""
        users = batch[self.uid_field].long()
        ue, ie = self.user_embedding.weight, self.item_embedding.weight
        u = ue[users]
        ci = same_conv_max(ie[self.user_neighbors[users]], self.u_conv)
        cu_all = same_conv_max(ue[self.item_neighbors], self.i_conv)
        B, D = u.shape

        def block(items):
            T = items.shape[0]
            i, cu = ie[items][None].expand(B, T, D), cu_all[items][None].expand(B, T, -1)
            return self._mlp(u[:, None].expand(B, T, D), i, ci[:, None].expand(B, T, -1), cu,
                             False)

        per_item = B * (3 * D + 2 * ci.shape[1])
        return score_item_blocks(self.n_items, per_item, users.device, block)


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
        (src, src_plan), (dst, dst_plan) = self.planned("edge_src"), self.planned("edge_dst")
        w, n = self.edge_weight, self.n_nodes
        chunks = list(self.ego().split(self.embedding_size // self.n_factors, dim=1))
        for _ in range(self.n_layers):
            at_src = [gather_rows(c, src, plan=src_plan) for c in chunks]
            # factor affinity per edge: the dot product of its ends' chunks
            aff = torch.stack([(a * gather_rows(c, dst, plan=dst_plan)).sum(dim=1)
                               for a, c in zip(at_src, chunks)])
            att = torch.softmax(aff, dim=0) * w  # (F, E)
            chunks = [segment_sum(a * att[f][:, None], dst, n, plan=dst_plan) + c
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
    with 1e-12 under the root: each row of `a` against every row of `b` in
    the global batch, the mean over the global batch's rows."""
    a = a / torch.sqrt((a**2).sum(dim=1, keepdim=True) + 1e-12)
    b = b / torch.sqrt((b**2).sum(dim=1, keepdim=True) + 1e-12)
    pos = (a * b).sum(dim=1) / tau
    every_b, _ = global_rows(b)
    return batch_mean(-pos + torch.logsumexp((a @ every_b.T) / tau, dim=1))


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


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """x / √(Σ x² + 1e-12) along the last axis."""
    return x / torch.sqrt((x ** 2).sum(dim=-1, keepdim=True) + 1e-12)


@register_model
class MacridVAE(HistoryMatrixModel):
    input_type = InputType.POINTWISE
    train_on_users = True

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, kfac: int = 4,
                 latent_dim: int = 32, encoder_hidden: Sequence[int] = (64,),
                 dropout_prob: float = 0.5, tau: float = 0.1, anneal_cap: float = 0.2,
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.kfac, self.latent_dim = int(kfac), int(latent_dim)
        self.dropout_prob, self.tau, self.anneal_cap = (float(dropout_prob), float(tau),
                                                        float(anneal_cap))
        hidden = tuple(int(h) for h in encoder_hidden)
        self.item_embedding = torch.nn.Embedding(n_items, self.latent_dim, device=self.device)
        xavier_normal_(self.item_embedding.weight, self.generator)
        self.concepts = raw_param(self, self.kfac, self.latent_dim)
        self.enc_layers = dense_stack(self, "enc", (n_items,) + hidden)
        top = ((n_items,) + hidden)[-1]
        self.mu = dense(self, top, self.latent_dim)
        self.logvar = dense(self, top, self.latent_dim)
        self.draws = RandomDraws()

    def forward(self, hist: torch.Tensor, train: bool = False):
        """(log of the mixed probabilities, the concepts' μ, their logvar)."""
        items_n = unit_rows(self.item_embedding.weight)
        cates = torch.softmax(items_n @ unit_rows(self.concepts).T / self.tau, dim=1)  # (N, K)
        probs, mus, logvars = None, [], []
        for k in range(self.kfac):
            h = unit_rows(hist * cates[:, k][None, :])
            if train:
                h = self.draws.dropout(h, self.dropout_prob)
            for layer in self.enc_layers:
                h = torch.tanh(layer(h))
            mu = unit_rows(self.mu(h))
            lv = self.logvar(h)
            z = mu + self.draws.normal(mu.shape, mu.device) * torch.exp(0.5 * lv) if train else mu
            pk = torch.exp(torch.log_softmax((z @ items_n.T) / self.tau, dim=1)) * cates[:, k][None]
            probs = pk if probs is None else probs + pk
            mus.append(mu)
            logvars.append(lv)
        return torch.log(torch.clamp(probs, min=1e-12)), mus, logvars

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        hist = self.history(batch[self.uid_field])
        logp, mus, logvars = self.forward(hist, train=True)
        kl = sum(gaussian_kl(mu, lv) for mu, lv in zip(mus, logvars))
        per_user = -(logp * hist).sum(dim=1) + self.anneal_cap * kl
        return _wmean(per_user, batch.get("weight"))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        return self.forward(self.history(batch[self.uid_field]))[0]

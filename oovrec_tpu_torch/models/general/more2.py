"""MultiDAE, CDAE, DMF, SimpleX, and NGCF and SGL, graph models on
LightGCN's edges.

Port of `oovrec_tpu/models/general/more2.py:24-432`. The first four read
the training matrix `user_hist_matrix` (a buffer on the card,
`base.py:HistoryMatrixModel`):
  * MultiDAE (user batches): MultiVAE's encoder without the variational
    part: the normalised row, dropout, the tanh `enc_<i>` and `enc_out`,
    the tanh `dec_<i>` and `dec_out`; the multinomial log-likelihood.
  * CDAE (user batches): dropout of the row (`corruption_ratio`),
    sigmoid(encoder(x) + the user's row of `user_embedding`), `decoder`;
    BCE on logits summed over the items, plus `reg_weight_2` times the
    squared encoder and decoder kernels (`reg_weight_1` is read and
    unused, as in the JAX model).
  * DMF (pointwise rows): relu towers `u_<i>` over the user's row and
    `i_<i>` over the item's column of the matrix (its transpose: 3,707
    rows of 6,041 at ML-1M's shape), the cosine of the two; the loss is
    BCE on the cosine clipped to [1e-6, 1] (a tie at a bound splits its
    gradient as `jnp.clip` does). The full sort runs the item tower over
    every column.
  * SimpleX (pairwise): the user vector γ·e_u + (1 − γ)·(row @ item table)
    / max(|row|, 1); relu(1 − cos(u, pos)) + `negative_weight` ·
    relu(cos(u, neg) − `margin`).
The keep masks of the two autoencoders come from the trainer's dropout
generator (`models/layers.py:RandomDraws`).

The JAX module's `_GraphRecommender` (`:259-271`) is `lightgcn.py:GraphModel`
here: the tables, the edge buffers and `propagate`, whose segment sum
and gathers run the sort-and-segment kernel on the card.

  * NGCF: each layer `side = Âe`, then leaky_relu(gc(side) + gc(e)) +
    leaky_relu(bi(side ⊙ e)) (gc's bias enters twice, as in the JAX
    model), the message dropout, the rows L2-normalised with a floor of
    1e-12; the layers concatenated; BPR + EmbLoss of the propagated rows.
    `node_dropout` is read by nothing, in the JAX model too.
  * SGL: LightGCN's propagation, then InfoNCE between two edge-dropout
    views of it (users at the batch's users, items at its positives),
    BPR and the EmbLoss of the ego rows. The views' masks (an edge is kept
    where a uniform draw exceeds `drop_ratio`) come from the trainer's
    dropout generator (`edge_masks`); `loss_with_masks` is the loss on
    given masks, so a test can hand it JAX's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.general.base import HistoryMatrixModel, l2_rows
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, bpr_of
from oovrec_tpu_torch.models.general.more import dense_stack, multinomial_nll
from oovrec_tpu_torch.models.layers import Dropout, RandomDraws
from oovrec_tpu_torch.models.losses import _wmean, bce_with_logits_terms, emb_loss
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.parallel.train_step import batch_mean
from oovrec_tpu_torch.utils.enums import InputType


@register_model
class MultiDAE(HistoryMatrixModel):
    input_type = InputType.POINTWISE
    train_on_users = True

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 latent_dim: int = 64, encoder_hidden: Sequence[int] = (256,),
                 dropout_prob: float = 0.5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        hidden = tuple(int(h) for h in encoder_hidden)
        self.dropout_prob = float(dropout_prob)
        self.enc_layers = dense_stack(self, "enc", (n_items,) + hidden)
        self.enc_out = dense(self, ((n_items,) + hidden)[-1], int(latent_dim))
        self.dec_layers = dense_stack(self, "dec", (int(latent_dim),) + hidden[::-1])
        self.dec_out = dense(self, ((int(latent_dim),) + hidden[::-1])[-1], n_items)
        self.draws = RandomDraws()

    def forward(self, hist: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = l2_rows(hist)
        if train:
            h = self.draws.dropout(h, self.dropout_prob)
        for layer in self.enc_layers:
            h = torch.tanh(layer(h))
        h = torch.tanh(self.enc_out(h))
        for layer in self.dec_layers:
            h = torch.tanh(layer(h))
        return self.dec_out(h)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        hist = self.history(batch[self.uid_field])
        return _wmean(multinomial_nll(self.forward(hist, train=True), hist), batch.get("weight"))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        return self.forward(self.history(batch[self.uid_field]))


@register_model
class CDAE(HistoryMatrixModel):
    input_type = InputType.POINTWISE
    train_on_users = True

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 corruption_ratio: float = 0.5, reg_weight_1: float = 0.0,
                 reg_weight_2: float = 0.01, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.corruption_ratio = float(corruption_ratio)
        self.reg_weight_1, self.reg_weight_2 = float(reg_weight_1), float(reg_weight_2)
        self.user_embedding = self._embed_table(n_users)
        self.encoder = dense(self, n_items, embedding_size)
        self.decoder = dense(self, embedding_size, n_items)
        self.draws = RandomDraws()

    def forward(self, users: torch.Tensor, hist: torch.Tensor, train: bool = False):
        x = self.draws.dropout(hist, self.corruption_ratio) if train else hist
        h = torch.sigmoid(self.encoder(x) + gather_rows(self.user_embedding.weight, users))
        return self.decoder(h)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        users = batch[self.uid_field]
        hist = self.history(users)
        per_user = bce_with_logits_terms(self.forward(users, hist, train=True), hist).sum(dim=1)
        reg = self.reg_weight_2 * ((self.encoder.weight ** 2).sum()
                                   + (self.decoder.weight ** 2).sum())
        return _wmean(per_user, batch.get("weight")) + reg

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        users = batch[self.uid_field]
        return self.forward(users, self.history(users))


def cosine(a: torch.Tensor, b: torch.Tensor, floor: float = 1e-12) -> torch.Tensor:
    """(..., D) × (..., D) → (...): a·b / (max(‖a‖, floor) · max(‖b‖, floor))."""
    na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=floor)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=floor)
    return (a * b).sum(dim=-1) / (na * nb)


def jnp_clip(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """`jnp.clip`: min(max(x, low), high), a tie's gradient split in half."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, low)), torch.full_like(x, high))


@register_model
class DMF(HistoryMatrixModel):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 user_hidden: Sequence[int] = (64,), item_hidden: Sequence[int] = (64,),
                 label_field: str = "label", **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.label_field = label_field
        self.user_layers = dense_stack(self, "u", (n_items,) + tuple(int(h) for h in user_hidden))
        self.item_layers = dense_stack(self, "i", (n_users,) + tuple(int(h) for h in item_hidden))

    @staticmethod
    def _tower(layers, x: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            x = torch.relu(layer(x))
        return x

    def _towers(self, batch: Batch):
        u = self._tower(self.user_layers, self.history(batch[self.uid_field]))
        i = self._tower(self.item_layers, self.user_hist_matrix.T[batch[self.iid_field].long()])
        return u, i

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        score = jnp_clip(cosine(*self._towers(batch)), 1e-6, 1.0)
        label = batch[self.label_field]
        loss = -(label * torch.log(score) + (1 - label) * torch.log(1 - score + 1e-6))
        return _wmean(loss, batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return cosine(*self._towers(batch))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self._tower(self.user_layers, self.history(batch[self.uid_field]))
        i = self._tower(self.item_layers, self.user_hist_matrix.T)
        return l2_rows(u) @ l2_rows(i).T


@register_model
class SimpleX(HistoryMatrixModel):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 margin: float = 0.9, negative_weight: float = 10.0, gamma: float = 0.5,
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.margin, self.negative_weight = float(margin), float(negative_weight)
        self.gamma = float(gamma)
        self.user_embedding = self._embed_table(n_users)
        self.item_embedding = self._embed_table(n_items)

    def _user_vec(self, users: torch.Tensor) -> torch.Tensor:
        ue = gather_rows(self.user_embedding.weight, users)
        hist = self.history(users)
        agg = hist @ self.item_embedding.weight
        cnt = torch.clamp(hist.sum(dim=1, keepdim=True), min=1.0)
        return self.gamma * ue + (1 - self.gamma) * agg / cnt

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u = self._user_vec(batch[self.uid_field])
        pos = gather_rows(self.item_embedding.weight, batch[self.iid_field])
        neg = gather_rows(self.item_embedding.weight, batch[self.neg_prefix + self.iid_field])
        loss = (torch.relu(1 - cosine(u, pos))
                + self.negative_weight * torch.relu(cosine(u, neg) - self.margin))
        return _wmean(loss, batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        u = self._user_vec(batch[self.uid_field])
        return cosine(u, self.item_embedding.weight[batch[self.iid_field].long()])

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self._user_vec(batch[self.uid_field])
        return l2_rows(u) @ l2_rows(self.item_embedding.weight).T


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """flax's `leaky_relu`: x where x ≥ 0, so its gradient at 0 is 1
    (torch's is the slope there). A node that no edge reaches has a zero
    `side`, so `bi(side ⊙ e)` is exactly 0 while the bias is."""
    return torch.where(x >= 0, x, slope * x)


@register_model
class NGCF(GraphModel):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 hidden_size_list: Sequence[int] = (64, 64, 64), node_dropout: float = 0.0,
                 message_dropout: float = 0.1, reg_weight: float = 1e-5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.hidden_size_list = tuple(int(h) for h in hidden_size_list)
        self.node_dropout = float(node_dropout)
        self.reg_weight = float(reg_weight)
        widths = (embedding_size,) + self.hidden_size_list
        self.gc_layers, self.bi_layers = [], []
        for i, (n_in, h) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"gc_{i}", dense(self, n_in, h))
            self.gc_layers.append(getattr(self, f"gc_{i}"))
        for i, (n_in, h) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"bi_{i}", dense(self, n_in, h))
            self.bi_layers.append(getattr(self, f"bi_{i}"))
        self.mdrop = Dropout(message_dropout)

    def _embeddings(self, train: bool = False):
        e = self.ego()
        outs = [e]
        for gc, bi in zip(self.gc_layers, self.bi_layers):
            side = self._prop(e)
            summed = leaky_relu(gc(side) + gc(e))
            bi_part = leaky_relu(bi(side * e))
            e = self.mdrop(summed + bi_part, train)
            e = l2_rows(e)
            outs.append(e)
        return self._split(torch.cat(outs, dim=1))

    def embeddings(self):
        return self._embeddings()

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u, p, n = self._rows(batch, *self._embeddings(train=True))
        return bpr_of(u, p, n, batch) + self.reg_weight * emb_loss(u, p, n)


def info_nce(a: torch.Tensor, b: torch.Tensor, ids: torch.Tensor, tau: float) -> torch.Tensor:
    """SGL's InfoNCE: rows `ids` of the normalised `a` against the same
    rows of the normalised `b` over all of `b`, the mean over the global
    batch's rows (padding included)."""
    a, b = l2_rows(a), l2_rows(b)
    ai = gather_rows(a, ids)
    pos = (ai * gather_rows(b, ids)).sum(dim=1) / tau
    return batch_mean(-pos + torch.logsumexp((ai @ b.T) / tau, dim=1))


@register_model
class SGL(GraphModel):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_layers: int = 2,
                 ssl_tau: float = 0.5, ssl_weight: float = 0.05, drop_ratio: float = 0.1,
                 reg_weight: float = 1e-5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_layers = int(n_layers)
        self.ssl_tau = float(ssl_tau)
        self.ssl_weight = float(ssl_weight)
        self.drop_ratio = float(drop_ratio)
        self.reg_weight = float(reg_weight)
        self.draws = RandomDraws()

    def _lightgcn(self, edge_mask: Optional[torch.Tensor] = None):
        w = self.edge_weight[:, None]
        if edge_mask is not None:
            w = w * edge_mask[:, None]
        e = self.ego()
        acc, cur = e, e
        for _ in range(self.n_layers):
            cur = self._prop(cur, w)
            acc = acc + cur
        return self._split(acc / (self.n_layers + 1))

    def embeddings(self):
        return self._lightgcn()

    def edge_masks(self) -> torch.Tensor:
        """(2, E) float: the two views' kept edges."""
        u = self.draws.rand((2, self.edge_src.shape[0]), self.edge_src.device)
        return (u > self.drop_ratio).float()

    def loss_with_masks(self, batch: Batch, m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
        users, pos = batch[self.uid_field], batch[self.iid_field]
        u, p, n = self._rows(batch, *self._lightgcn())
        mf = bpr_of(u, p, n, batch)
        u1, i1 = self._lightgcn(m1)
        u2, i2 = self._lightgcn(m2)
        ssl = info_nce(u1, u2, users, self.ssl_tau) + info_nce(i1, i2, pos, self.ssl_tau)
        reg = emb_loss(*self._ego_rows(batch))
        return mf + self.ssl_weight * ssl + self.reg_weight * reg

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        m = self.edge_masks()
        return self.loss_with_masks(batch, m[0], m[1])

"""NGCF and SGL, graph models on LightGCN's edges.

Port of `oovrec_tpu/models/general/more2.py:259-432` (the module's other
models, MultiDAE, CDAE, DMF and SimpleX, are not ported yet). The JAX
module's `_GraphRecommender` (`:259-271`) is `lightgcn.py:GraphModel`
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
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, bpr_of
from oovrec_tpu_torch.models.layers import Dropout, RandomDraws
from oovrec_tpu_torch.models.losses import emb_loss
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import InputType


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """flax's `leaky_relu`: x where x ≥ 0, so its gradient at 0 is 1
    (torch's is the slope there). A node that no edge reaches has a zero
    `side`, so `bi(side ⊙ e)` is exactly 0 while the bias is."""
    return torch.where(x >= 0, x, slope * x)


def l2_rows(x: torch.Tensor, floor: float = 1e-12) -> torch.Tensor:
    """Each row over max(‖row‖, floor)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=floor)


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
    rows of the normalised `b` over all of `b`."""
    a, b = l2_rows(a), l2_rows(b)
    ai = gather_rows(a, ids)
    pos = (ai * gather_rows(b, ids)).sum(dim=1) / tau
    return (-pos + torch.logsumexp((ai @ b.T) / tau, dim=1)).mean()


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

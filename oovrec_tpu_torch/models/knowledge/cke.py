"""CKE: BPR over item + entity embeddings, and a TransR loss on the
batch's knowledge-graph triples.

Port of `oovrec_tpu/models/knowledge/cke.py:18-107`. Each relation r has a
projection W_r (`trans_w`, a raw (n_relations, D·K) leaf as in flax); a
triple's head and tails are projected by W_r, then the projections and
the relation's K-wide embedding are L2-normalised (floor 1e-12) and the
distance is ‖h + r − t‖². The loss is BPR on the interactions, BPR on
the negated distances of (h, r, pos_t) and (h, r, neg_t) weighted by
`kg_weight`, and `reg_weights` times the EmbLoss of the rows of each
part. Items score u · (item + entity), their entity the item's own id.
"""

from __future__ import annotations

from typing import Sequence

import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import raw_param
from oovrec_tpu_torch.models.general.base import l2_rows
from oovrec_tpu_torch.models.knowledge.base import KnowledgeRecommender, lookup
from oovrec_tpu_torch.models.losses import bpr_loss, emb_loss
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import InputType


def transr(model, h: torch.Tensor, r: torch.Tensor, ts: Sequence[torch.Tensor]):
    """The TransR projections: each (B, D) row of `h` and of each tensor
    of `ts` times its relation's W_r (D, K) → (h_r, [t_r, ...])."""
    W = gather_rows(model.trans_w, r).reshape(-1, model.embedding_size, model.kg_embedding_size)
    proj = [torch.einsum("bd,bdk->bk", x, W) for x in (h, *ts)]
    return proj[0], proj[1:]


@register_model
class CKE(KnowledgeRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 kg_embedding_size: int = 64, reg_weights: Sequence[float] = (1e-2, 1e-2),
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.kg_embedding_size = int(kg_embedding_size)
        self.reg_weights = tuple(float(w) for w in reg_weights)
        D, K = embedding_size, self.kg_embedding_size
        self.user_embedding = self._embed_table(n_users)
        self.item_embedding = self._embed_table(n_items)
        self.entity_embedding = self._embed_table(self.n_entities)
        self.relation_embedding = self._embed_table(self.n_relations, K)
        self.trans_w = raw_param(self, self.n_relations, D * K)

    def _item_full(self, ids: torch.Tensor) -> torch.Tensor:
        return lookup(self.item_embedding, ids) + lookup(self.entity_embedding, ids)

    def _kg_score(self, batch: Batch):
        """(pos distances, neg distances, the four normalised rows)."""
        r = batch["kg_relation"]
        ph, (ppt, pnt) = transr(self, lookup(self.entity_embedding, batch["kg_head"]), r,
                                [lookup(self.entity_embedding, batch["kg_pos_tail"]),
                                 lookup(self.entity_embedding, batch["kg_neg_tail"])])
        ph, ppt, pnt, re = (l2_rows(x) for x in (ph, ppt, pnt, lookup(self.relation_embedding, r)))
        pos = ((ph + re - ppt) ** 2).sum(dim=1)
        neg = ((ph + re - pnt) ** 2).sum(dim=1)
        return pos, neg, (ph, re, ppt, pnt)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u = lookup(self.user_embedding, batch[self.uid_field])
        p = self._item_full(batch[self.iid_field])
        n = self._item_full(batch[self.neg_prefix + self.iid_field])
        rec = bpr_loss((u * p).sum(dim=1), (u * n).sum(dim=1), batch.get("weight"))
        pos, neg, kg_rows = self._kg_score(batch)
        kg = bpr_loss(-pos, -neg, batch.get("kg_weight"))
        reg1, reg2 = self.reg_weights
        return rec + kg + reg1 * emb_loss(u, p, n) + reg2 * emb_loss(*kg_rows)

    def predict(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        return (u * self._item_full(batch[self.iid_field])).sum(dim=1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        items = self.item_embedding.weight + self.entity_embedding.weight[:self.n_items]
        return u @ items.T

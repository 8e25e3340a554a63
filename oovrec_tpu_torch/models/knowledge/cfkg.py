"""CFKG: users, items and entities in one TransE space; an interaction is
the triple (user, [UI-Relation], item).

Port of `oovrec_tpu/models/knowledge/cfkg.py:14-79`. The score of (h, r,
t) is (h + r) · t (`loss_function: inner_product`) or −‖h + r − t‖
(`transe`; any other value takes the inner product, as in the JAX
model); the loss is BPR on the interactions' scores, with the last
relation row as r, plus BPR on the batch's triples (`kg_weight`). An
item's entity is the item's own id. `margin` is read and unused, as in
the JAX model.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.knowledge.base import KnowledgeRecommender, lookup
from oovrec_tpu_torch.models.losses import bpr_loss
from oovrec_tpu_torch.utils.enums import InputType


@register_model
class CFKG(KnowledgeRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 loss_function: str = "inner_product", margin: float = 1.0, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.loss_function = loss_function
        self.margin = float(margin)
        self.user_embedding = self._embed_table(n_users)
        self.entity_embedding = self._embed_table(self.n_entities)
        self.relation_embedding = self._embed_table(self.n_relations)

    def _ui_rel(self) -> torch.Tensor:
        return self.relation_embedding.weight[self.n_relations - 1]

    def _score(self, h: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.loss_function == "transe":
            return -torch.linalg.vector_norm(h + r - t, dim=-1)
        return ((h + r) * t).sum(dim=-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u = lookup(self.user_embedding, batch[self.uid_field])
        r_ui = self._ui_rel().expand_as(u)
        rec = bpr_loss(self._score(u, r_ui, lookup(self.entity_embedding, batch[self.iid_field])),
                       self._score(u, r_ui, lookup(self.entity_embedding,
                                                   batch[self.neg_prefix + self.iid_field])),
                       batch.get("weight"))
        h = lookup(self.entity_embedding, batch["kg_head"])
        r = lookup(self.relation_embedding, batch["kg_relation"])
        kg = bpr_loss(self._score(h, r, lookup(self.entity_embedding, batch["kg_pos_tail"])),
                      self._score(h, r, lookup(self.entity_embedding, batch["kg_neg_tail"])),
                      batch.get("kg_weight"))
        return rec + kg

    def predict(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        i = self.entity_embedding.weight[batch[self.iid_field].long()]
        return self._score(u, self._ui_rel().expand_as(u), i)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        ur = u + self._ui_rel()[None, :]
        items = self.entity_embedding.weight[:self.n_items]
        if self.loss_function == "transe":
            return -torch.linalg.vector_norm(ur[:, None, :] - items[None, :, :], dim=-1)
        return ur @ items.T

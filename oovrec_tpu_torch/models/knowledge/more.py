"""KGCN and MKR, the pointwise knowledge models.

Port of `oovrec_tpu/models/knowledge/more.py:21-230`.

  * KGCN: an item's entity row aggregated with its sampled neighbours
    (`kg_neighbors` / `kg_neighbor_rels`, `neighbor_sample_size` a row,
    drawn once on the host by `build_estate`), each neighbour weighted by
    the softmax over the row of the user · relation scores; the
    aggregator `sum` (agg(e + n)), `concat` (agg([e, n])) or `neighbor`
    (agg(n)), relu between hops and tanh after the last. Every hop reads
    the item's own neighbours, as in the JAX model. BCE on the logit u ·
    item; `predict` is its sigmoid.
  * MKR: a user tower (`um_<i>`, relu) and cross&compress units (`cc_<i>`)
    between an item's row and its entity's; BCE on u · v, plus
    `kg_weight` times the mean negated squared error of the KG head:
    `kge_mlp([he, r])` against the tail through `tm_<i>` (relu).

The states. `KGCN.build_estate` makes the adjacency with a stable sort,
not a loop over the triples: each entity's list is its triples in triple
order, a head occurrence before the tail occurrence of the same triple
(a self-loop twice); one `rng.integers(0, len, S)` call an entity in
entity order, the calls of JAX's loop (a single call over all entities
with an array of bounds gave the same draws under numpy 2.0, but that is
numpy's choice, not a contract), from `host_rng(2020,
"kgcn_neighbors")`; an entity without triples points at
itself with relation 0. It reads `neighbor_sample_size` from the config
(the JAX `quick_start` passes no config and keeps 4; ROADMAP.md §3).

The full sorts. JAX vmaps the per-pair score over every item at once. KGCN
scores blocks of items for all the batch's users at once
(`models/base.py:score_item_blocks`, the per-pair operations broadcast
over a (B, T) grid); MKR's user tower reads the user alone and its item
tower the item alone, so each runs once a call and the scores are their
product (at 256 users × 3,706 items the vmap's cross matrices alone
would take 15.5 GB).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from oovrec_tpu_torch.models.base import Batch, register_model, score_item_blocks
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.general.base import config_values, set_state
from oovrec_tpu_torch.models.knowledge.base import KnowledgeRecommender, lookup
from oovrec_tpu_torch.models.losses import bce_with_logits
from oovrec_tpu_torch.parallel.train_step import batch_mean
from oovrec_tpu_torch.utils.enums import InputType
from oovrec_tpu_torch.utils.seeding import host_rng


def kg_neighbors(train_split, neighbor_sample_size: int = 4, seed: int = 2020) -> dict:
    """`KGCN.build_estate` of the JAX package (`more.py:104-131`) without
    its loop over the triples: (n_entities, S) int64 `kg_neighbors` and
    `kg_neighbor_rels`, bit for bit."""
    ds = train_split.parent
    heads, rels, tails = ds.kg_triples
    n_ent = ds.entity_num
    S = int(neighbor_sample_size)
    # triple i adds (tail, rel) to its head's list, then (head, rel) to its
    # tail's: the events in order, sorted stably by owner
    owner = np.stack([heads, tails], axis=1).reshape(-1)
    other = np.stack([tails, heads], axis=1).reshape(-1)
    order = np.argsort(owner, kind="stable")
    other, rel_of = other[order], np.repeat(rels, 2)[order]
    counts = np.bincount(owner, minlength=n_ent)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rng = host_rng(seed, "kgcn_neighbors")
    neigh = np.repeat(np.arange(n_ent, dtype=np.int64)[:, None], S, axis=1)
    nrels = np.zeros((n_ent, S), np.int64)
    linked = np.flatnonzero(counts)
    picks = np.empty((len(linked), S), np.int64)
    for j, e in enumerate(linked):
        picks[j] = rng.integers(0, counts[e], S)
    at = starts[linked][:, None] + picks
    neigh[linked] = other[at]
    nrels[linked] = rel_of[at]
    return {"kg_neighbors": neigh, "kg_neighbor_rels": nrels}


@register_model
class KGCN(KnowledgeRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 neighbor_sample_size: int = 4, n_iter: int = 1, aggregator: str = "sum",
                 kg_neighbors: Optional[np.ndarray] = None,
                 kg_neighbor_rels: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.neighbor_sample_size = int(neighbor_sample_size)
        self.n_iter = int(n_iter)
        self.aggregator = aggregator
        D = embedding_size
        self.user_embedding = self._embed_table(n_users)
        self.entity_embedding = self._embed_table(self.n_entities)
        self.relation_embedding = self._embed_table(self.n_relations)
        self.agg_layers = []
        for i in range(self.n_iter):
            self.add_module(f"agg_{i}", dense(self, 2 * D if aggregator == "concat" else D, D))
            self.agg_layers.append(getattr(self, f"agg_{i}"))
        shape = (self.n_entities, self.neighbor_sample_size)
        set_state(self, "kg_neighbors", kg_neighbors, shape, torch.int64)
        set_state(self, "kg_neighbor_rels", kg_neighbor_rels, shape, torch.int64)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return kg_neighbors(train_split, **config_values(config, {"neighbor_sample_size": 4}))

    def _item_repr(self, u: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """The items' rows as the users `u` see them: `u` (..., D)
        broadcast against `items` (...) → (..., D)."""
        items = items.long()
        e_self = lookup(self.entity_embedding, items)
        for hop, agg in enumerate(self.agg_layers):
            ne = lookup(self.entity_embedding, self.kg_neighbors[items])
            re = lookup(self.relation_embedding, self.kg_neighbor_rels[items])
            score = torch.softmax((u[..., None, :] * re).sum(dim=-1), dim=-1)
            agg_n = (score[..., None] * ne).sum(dim=-2)
            if self.aggregator == "concat":
                e_self = agg(torch.cat([e_self.expand_as(agg_n), agg_n], dim=-1))
            elif self.aggregator == "neighbor":
                e_self = agg(agg_n)
            else:
                e_self = agg(e_self + agg_n)
            e_self = torch.tanh(e_self) if hop == self.n_iter - 1 else torch.relu(e_self)
        return e_self

    def _logits(self, batch: Batch) -> torch.Tensor:
        u = lookup(self.user_embedding, batch[self.uid_field])
        return (u * self._item_repr(u, batch[self.iid_field])).sum(dim=1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        return bce_with_logits(self._logits(batch), batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self._logits(batch))

    def _score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """The logit of each (user, item) pair: the per-pair definition."""
        u = self.user_embedding.weight[users.long()]
        return (u * self._item_repr(u, items)).sum(dim=-1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()][:, None, :]
        per_item = u.shape[0] * max(self.neighbor_sample_size, 2) * self.embedding_size
        return score_item_blocks(self.n_items, per_item, u.device,
                                 lambda items: (u * self._item_repr(u, items[None])).sum(dim=-1))


class CrossCompress(nn.Module):
    """MKR's cross&compress unit (`more.py:134-153` of the JAX package):
    C = v eᵀ, v' = C w_vv + Cᵀ w_ev + b_v, e' = C w_ve + Cᵀ w_ee + b_e."""

    def __init__(self, model: KnowledgeRecommender, dim: int):
        super().__init__()
        for name in ("w_vv", "w_ev", "w_ve", "w_ee"):
            setattr(self, name, raw_param(model, dim, 1))
        self.b_v = nn.Parameter(torch.zeros(dim, device=model.device))
        self.b_e = nn.Parameter(torch.zeros(dim, device=model.device))

    def forward(self, v: torch.Tensor, e: torch.Tensor):
        C = v[:, :, None] * e[:, None, :]
        Ct = C.transpose(1, 2)
        v_out = (C @ self.w_vv + Ct @ self.w_ev).squeeze(-1)
        e_out = (C @ self.w_ve + Ct @ self.w_ee).squeeze(-1)
        return v_out + self.b_v, e_out + self.b_e


@register_model
class MKR(KnowledgeRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 low_layers_num: int = 1, high_layers_num: int = 1, kg_weight: float = 1.0,
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.low_layers_num = int(low_layers_num)
        self.high_layers_num = int(high_layers_num)  # read and unused, as in the JAX model
        self.kg_weight = float(kg_weight)
        D = embedding_size
        self.user_embedding = self._embed_table(n_users)
        self.item_embedding = self._embed_table(n_items)
        self.entity_embedding = self._embed_table(self.n_entities)
        self.relation_embedding = self._embed_table(self.n_relations)
        self.user_mlps, self.tail_mlps, self.cc_units = [], [], []
        for i in range(self.low_layers_num):
            self.add_module(f"um_{i}", dense(self, D, D))
            self.add_module(f"tm_{i}", dense(self, D, D))
            self.add_module(f"cc_{i}", CrossCompress(self, D))
            self.user_mlps.append(getattr(self, f"um_{i}"))
            self.tail_mlps.append(getattr(self, f"tm_{i}"))
            self.cc_units.append(getattr(self, f"cc_{i}"))
        self.kge_mlp = dense(self, 2 * D, D)

    def _user_tower(self, u: torch.Tensor) -> torch.Tensor:
        for um in self.user_mlps:
            u = torch.relu(um(u))
        return u

    def _cross(self, v: torch.Tensor, e: torch.Tensor):
        for cc in self.cc_units:
            v, e = cc(v, e)
        return v, e

    def _low(self, users: torch.Tensor, items: torch.Tensor):
        """(user rows, item rows, entity rows) after the low layers."""
        u = self._user_tower(lookup(self.user_embedding, users))
        v, e = self._cross(lookup(self.item_embedding, items), lookup(self.entity_embedding, items))
        return u, v, e

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u, v, _ = self._low(batch[self.uid_field], batch[self.iid_field])
        rec = bce_with_logits((u * v).sum(dim=1), batch[self.label_field], batch.get("weight"))
        h = batch["kg_head"]
        t = lookup(self.entity_embedding, batch["kg_pos_tail"])
        for tm in self.tail_mlps:
            t = torch.relu(tm(t))
        _, he = self._cross(lookup(self.item_embedding, torch.clamp(h, 0, self.n_items - 1)),
                            lookup(self.entity_embedding, h))
        r = lookup(self.relation_embedding, batch["kg_relation"])
        pred_t = self.kge_mlp(torch.cat([he, r], dim=-1))
        kg_score = -((pred_t - t) ** 2).sum(dim=1)
        kgw = batch.get("kg_weight")
        kg_loss = -batch_mean(kg_score if kgw is None else kg_score * kgw)
        return rec + self.kg_weight * kg_loss

    def _score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """The logit of each (user, item) pair: the per-pair definition."""
        u, v, _ = self._low(users, items)
        return (u * v).sum(dim=1)

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self._score(batch[self.uid_field], batch[self.iid_field]))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self._user_tower(self.user_embedding.weight[batch[self.uid_field].long()])
        v, _ = self._cross(self.item_embedding.weight, self.entity_embedding.weight[:self.n_items])
        return u @ v.T

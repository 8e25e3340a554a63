"""KGAT: attentive propagation over the collaborative knowledge graph
(the users and the entities, the interactions as [UI-Relation] edges).

Port of `oovrec_tpu/models/knowledge/kgat.py:24-161`. The graph
(`build_estate`) is every training interaction both ways and every triple
both ways, as int32 buffers `ckg_src` / `ckg_dst` / `ckg_rel`; the node
table `node_embedding` holds the users first, then the entities. An
edge's attention is π(h, r, t) = (W_r e_t) · tanh(W_r e_h + e_r),
softmaxed over the edges into each destination; each layer sums the
attended source rows at their destinations (`side`), applies the
bi-interaction aggregator leaky_relu(w1(e + side)) + leaky_relu(w2(e ⊙
side)), the message dropout and an L2 normalisation (floor 1e-12); the
layers are concatenated. The loss is BPR on the propagated rows, the
TransR loss on the batch's triples (unnormalised) and `reg_weight` times
the EmbLoss of the propagated batch rows. `predict` and
`full_sort_scores` propagate on every call, as the JAX model does.

What differs from the JAX model, on purpose:
  * the projections: JAX gathers W_r for every edge, an (E, D, K) tensor
    (42 GB at 2.6 M edges and D = K = 64). The port projects every node
    once for every relation, an (R, N, K) table (`_projections`), and
    reads each edge's W_r e_h and W_r e_t from it at (rel, src) and (rel,
    dst) through `gather_rows`. The same function, f32 rounding apart.
    Those rows, rel · N + src and rel · N + dst, are fixed: the
    non-persistent buffers `ckg_src_rows` / `ckg_dst_rows`, derived from
    the edges; they, `ckg_src`, `ckg_dst` and `ckg_rel` each have a plan
    (`ops/embed_grad.py:IndexPlans`), so no edge is sorted in a step;
  * the softmax's shift: the per-destination maximum is a `scatter_reduce`
    `amax` (order-free, so the same bits on every run) and is detached.
    The softmax does not depend on the shift, so the gradient is JAX's
    (which differentiates through `segment_max`) to rounding. The
    denominators and every propagation are `segment_sum` (the
    sort-and-segment kernel on the card, no atomics), so a captured step
    gives the eager step's bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.general.base import l2_rows, set_state
from oovrec_tpu_torch.models.general.more2 import leaky_relu
from oovrec_tpu_torch.models.knowledge.base import KnowledgeRecommender, lookup
from oovrec_tpu_torch.models.knowledge.cke import transr
from oovrec_tpu_torch.models.layers import Dropout
from oovrec_tpu_torch.models.losses import bpr_loss, emb_loss
from oovrec_tpu_torch.ops.embed_grad import IndexPlans, gather_rows, segment_sum
from oovrec_tpu_torch.utils.enums import InputType


def ckg_edges(train_split, config=None) -> dict:
    """The collaborative knowledge graph's edges (`kgat.py:142-161` of the
    JAX package): the interactions user → item and back under the last
    relation, then the triples head → tail and back; nodes are users
    first, then entities."""
    ds = train_split.parent
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    n_users = ds.user_num
    heads, rels, tails = ds.kg_triples
    ui_rel = ds.relation_num - 1
    src = np.concatenate([uid, iid + n_users, heads + n_users, tails + n_users]).astype(np.int32)
    dst = np.concatenate([iid + n_users, uid, tails + n_users, heads + n_users]).astype(np.int32)
    rel = np.concatenate([np.full(len(uid), ui_rel), np.full(len(uid), ui_rel),
                          rels, rels]).astype(np.int32)
    return {"ckg_src": src, "ckg_dst": dst, "ckg_rel": rel}


@register_model
class KGAT(IndexPlans, KnowledgeRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 kg_embedding_size: int = 64, layers: Sequence[int] = (64,),
                 reg_weight: float = 1e-5, mess_dropout: float = 0.1,
                 ckg_src: Optional[np.ndarray] = None, ckg_dst: Optional[np.ndarray] = None,
                 ckg_rel: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.kg_embedding_size = int(kg_embedding_size)
        self.layers = tuple(int(h) for h in layers)
        self.reg_weight = float(reg_weight)
        D, K = embedding_size, self.kg_embedding_size
        self.node_embedding = self._embed_table(n_users + self.n_entities)
        self.relation_embedding = self._embed_table(self.n_relations, K)
        self.trans_w = raw_param(self, self.n_relations, D * K)
        self.agg_w1, self.agg_w2 = [], []
        for i, (n_in, h) in enumerate(zip((D,) + self.layers[:-1], self.layers)):
            self.add_module(f"w1_{i}", dense(self, n_in, h))
            self.add_module(f"w2_{i}", dense(self, n_in, h))
            self.agg_w1.append(getattr(self, f"w1_{i}"))
            self.agg_w2.append(getattr(self, f"w2_{i}"))
        self.mdrop = Dropout(mess_dropout)
        n_edges = 0 if ckg_src is None else len(ckg_src)
        for name, value in (("ckg_src", ckg_src), ("ckg_dst", ckg_dst), ("ckg_rel", ckg_rel)):
            set_state(self, name, value, (n_edges,), torch.int32)
        for name in ("ckg_src", "ckg_dst"):
            self.add_index_plan(name, self.n_nodes)
        self.add_index_plan("ckg_rel", self.n_relations)
        for end in ("src", "dst"):
            self.add_index_plan(
                f"ckg_{end}_rows", self.n_relations * self.n_nodes,
                derive=lambda m, end=end: (m.ckg_rel.long() * m.n_nodes
                                           + getattr(m, f"ckg_{end}").long()),
                sources=("ckg_rel", f"ckg_{end}"))

    build_estate = staticmethod(ckg_edges)

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_entities

    def _projections(self, e: torch.Tensor) -> torch.Tensor:
        """(R·N, K): row r·N + v is W_r e_v."""
        R, D, K = self.n_relations, self.embedding_size, self.kg_embedding_size
        proj = torch.einsum("nd,rdk->rnk", e, self.trans_w.reshape(R, D, K))
        return proj.reshape(R * e.shape[0], K)

    def _attention(self, e: torch.Tensor) -> torch.Tensor:
        """(E,): each edge's attention, softmaxed over its destination's
        edges."""
        n = self.n_nodes
        dst, dst_plan = self.planned("ckg_dst")
        rel, rel_plan = self.planned("ckg_rel")
        proj = self._projections(e)
        (src_rows, src_plan), (dst_rows, dst_rows_plan) = (self.planned("ckg_src_rows"),
                                                           self.planned("ckg_dst_rows"))
        eh = gather_rows(proj, src_rows, plan=src_plan)
        et = gather_rows(proj, dst_rows, plan=dst_rows_plan)
        logits = (et * torch.tanh(eh + lookup(self.relation_embedding, rel, rel_plan))).sum(dim=1)
        dst64 = dst.long()
        shift = torch.full((n,), -torch.inf, device=e.device).scatter_reduce(
            0, dst64, logits.detach(), "amax")
        ex = torch.exp(logits - shift[dst64])
        denom = segment_sum(ex[:, None], dst, n, plan=dst_plan)
        return ex / torch.clamp(gather_rows(denom, dst, plan=dst_plan)[:, 0], min=1e-12)

    def _propagate(self, train: bool = False):
        """(users (U, D + Σ layers), items (n_items, D + Σ layers))."""
        e = self.node_embedding.weight
        att = self._attention(e)[:, None]
        (src, src_plan), (dst, dst_plan) = self.planned("ckg_src"), self.planned("ckg_dst")
        outs, cur = [e], e
        for w1, w2 in zip(self.agg_w1, self.agg_w2):
            side = segment_sum(gather_rows(cur, src, plan=src_plan) * att, dst, self.n_nodes,
                               plan=dst_plan)
            cur = leaky_relu(w1(cur + side)) + leaky_relu(w2(cur * side))
            cur = l2_rows(self.mdrop(cur, train))
            outs.append(cur)
        all_e = torch.cat(outs, dim=1)
        return all_e[:self.n_users], all_e[self.n_users:self.n_users + self.n_items]

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        ue, ie = self._propagate(train=True)
        u = gather_rows(ue, batch[self.uid_field])
        p = gather_rows(ie, batch[self.iid_field])
        n = gather_rows(ie, batch[self.neg_prefix + self.iid_field])
        mf = bpr_loss((u * p).sum(dim=1), (u * n).sum(dim=1), batch.get("weight"))
        rel = batch["kg_relation"]
        ph, (ppt, pnt) = transr(self, lookup(self.node_embedding, self.n_users + batch["kg_head"]),
                                rel, [lookup(self.node_embedding,
                                             self.n_users + batch["kg_pos_tail"]),
                                      lookup(self.node_embedding,
                                             self.n_users + batch["kg_neg_tail"])])
        er = lookup(self.relation_embedding, rel)
        pos = ((ph + er - ppt) ** 2).sum(dim=1)
        neg = ((ph + er - pnt) ** 2).sum(dim=1)
        kg = bpr_loss(-pos, -neg, batch.get("kg_weight"))
        return mf + kg + self.reg_weight * emb_loss(u, p, n)

    def predict(self, batch: Batch) -> torch.Tensor:
        ue, ie = self._propagate()
        return (ue[batch[self.uid_field].long()] * ie[batch[self.iid_field].long()]).sum(dim=1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        ue, ie = self._propagate()
        return ue[batch[self.uid_field].long()] @ ie.T

"""KGIN and MCCLK, the knowledge models on whole-graph aggregation.

Port of `oovrec_tpu/models/knowledge/more3.py:20-279`. Both read the
directed triples and the training interactions (`kg_edges`: int32
`kgin_head` / `kgin_rel` / `kgin_tail`, `kgin_uid` / `kgin_iid` and the
float32 1/deg(user) weights `kgin_w`). Every aggregation is
`ops/embed_grad.py:segment_sum` (the sort-and-segment kernel on the card,
no atomics; the counts too) and every gather with a gradient
`gather_rows`, so a captured step gives the eager step's bits. Each edge
buffer that a sum or a gather reads has its plan (`ops/embed_grad.py:
IndexPlans`; `kgin_iid` into the rows `_user_sum` gathers, the entities
in KGIN, the items in MCCLK), so no edge is sorted in a step.

  * KGIN: the users' softmax over `n_factors` intents (`latent_emb`), each
    intent a softmax mixture of the relations (`disen_weight_att`); each
    hop, an entity is the mean of its (tail ⊙ relation) messages and a
    user the 1/deg-weighted sum of its items' entity rows, gated by its
    intents; message dropout and an L2 normalisation, the hops summed with
    the ego rows. BPR, `reg_weight` times the EmbLoss of the batch rows
    and `sim_decay` times the distance correlation between the intents'
    rows of `disen_weight_att`.
  * MCCLK: the structural view (relation-aware KG aggregation, normalised,
    added to the rows, `n_hops` times), the semantic view (a kNN graph
    over the structural item rows: the top `knn_k` cosine similarities of
    each row kept, and every tie with the k-th, then row-normalised and
    one propagation), the collaborative view (LightGCN-style over the
    interactions, `lightgcn_layer` layers); BPR on the users'
    collaborative rows against the sum of the three item views, plus
    `beta` times `alpha` · the local InfoNCE (structural vs semantic,
    through `pl_1`) and (1 − `alpha`) · the global ones (`pg_0` / `pg_1`,
    and collaborative vs structural through `pl_0` / `pl_1`), each over
    the batch's positive items alone (a batch-sized denominator, as in
    the JAX model).

`predict` and `full_sort_scores` aggregate over the whole graph on every
call, as the JAX models do. The message dropout draws from the trainer's
dropout generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.general.base import l2_rows, set_state
from oovrec_tpu_torch.models.knowledge.base import KnowledgeRecommender, lookup
from oovrec_tpu_torch.models.layers import Dropout
from oovrec_tpu_torch.models.losses import bpr_loss, emb_loss
from oovrec_tpu_torch.ops.embed_grad import IndexPlans, gather_rows, segment_sum
from oovrec_tpu_torch.parallel.train_step import batch_mean, global_rows
from oovrec_tpu_torch.utils.enums import InputType

KG_EDGES = ("kgin_head", "kgin_rel", "kgin_tail", "kgin_uid", "kgin_iid", "kgin_w")


def kg_edges(train_split, config=None) -> dict:
    """`_kg_edge_estate` of the JAX package (`more3.py:23-39`): the
    directed triples and the interactions with 1/deg(user) weights."""
    ds = train_split.parent
    uid = np.asarray(train_split.inter[train_split.uid_field], np.int32)
    iid = np.asarray(train_split.inter[train_split.iid_field], np.int32)
    heads, rels, tails = ds.kg_triples
    deg = np.bincount(uid, minlength=ds.user_num).astype(np.float32)
    w = 1.0 / np.maximum(deg[uid], 1.0)
    return {
        "kgin_head": np.asarray(heads, np.int32),
        "kgin_rel": np.asarray(rels, np.int32),
        "kgin_tail": np.asarray(tails, np.int32),
        "kgin_uid": uid,
        "kgin_iid": iid,
        "kgin_w": w.astype(np.float32),
    }


class KGEdgeModel(IndexPlans, KnowledgeRecommender):
    """The user, entity and relation tables and the `kg_edges` buffers
    with their plans; `iid_rows` is the row count of the tables that
    `_user_sum` gathers at `kgin_iid`."""

    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, **kwargs):
        edges = {k: kwargs.pop(k, None) for k in KG_EDGES}
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        D = embedding_size
        self.user_embedding = self._embed_table(n_users)
        self.entity_embedding = self._embed_table(self.n_entities)
        self.relation_embedding = self._embed_table(self.n_relations)
        for name, value in edges.items():
            n = 0 if value is None else len(value)
            set_state(self, name, value, (n,), torch.float32 if name == "kgin_w" else torch.int32)
        for name, rows in (("kgin_head", self.n_entities), ("kgin_tail", self.n_entities),
                           ("kgin_rel", self.n_relations), ("kgin_uid", n_users),
                           ("kgin_iid", self.iid_rows)):
            self.add_index_plan(name, rows)

    build_estate = staticmethod(kg_edges)

    def _kg_mean(self, ee: torch.Tensor) -> torch.Tensor:
        """Each entity's mean (tail ⊙ relation) message (0 without one)."""
        (tail, tail_plan), (rel, rel_plan) = self.planned("kgin_tail"), self.planned("kgin_rel")
        head, head_plan = self.planned("kgin_head")
        msg = gather_rows(ee, tail, plan=tail_plan) * lookup(self.relation_embedding, rel, rel_plan)
        agg = segment_sum(msg, head, self.n_entities, plan=head_plan)
        ones = torch.ones(len(head), 1, device=ee.device)
        cnt = segment_sum(ones, head, self.n_entities, plan=head_plan)
        return agg / torch.clamp(cnt, min=1.0)

    def _user_sum(self, rows: torch.Tensor) -> torch.Tensor:
        """Each user's 1/deg-weighted sum of its training items' rows."""
        (iid, iid_plan), (uid, uid_plan) = self.planned("kgin_iid"), self.planned("kgin_uid")
        return segment_sum(gather_rows(rows, iid, plan=iid_plan) * self.kgin_w[:, None],
                           uid, self.n_users, plan=uid_plan)

    def _scored_rows(self, batch: Batch, users: torch.Tensor, items: torch.Tensor):
        return (gather_rows(users, batch[self.uid_field]),
                gather_rows(items, batch[self.iid_field]),
                gather_rows(items, batch[self.neg_prefix + self.iid_field]))

    def embeddings(self, train: bool = False):
        raise NotImplementedError

    def predict(self, batch: Batch) -> torch.Tensor:
        ue, ie = self.embeddings()[:2]
        return (ue[batch[self.uid_field].long()] * ie[batch[self.iid_field].long()]).sum(dim=1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        ue, ie = self.embeddings()[:2]
        return ue[batch[self.uid_field].long()] @ ie.T


def _dcov(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 1-D distance covariance of two rows (`kgin.py:195-249`)."""
    da = (a[:, None] - a[None, :]).abs()
    db = (b[:, None] - b[None, :]).abs()
    ca = da - da.mean(0, keepdim=True) - da.mean(1, keepdim=True) + da.mean()
    cb = db - db.mean(0, keepdim=True) - db.mean(1, keepdim=True) + db.mean()
    return torch.sqrt(torch.clamp((ca * cb).mean(), min=1e-12))


@register_model
class KGIN(KGEdgeModel):
    iid_rows = property(lambda self: self.n_entities)  # `_user_sum` gathers entity rows

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_factors: int = 4,
                 context_hops: int = 2, sim_decay: float = 1e-4, reg_weight: float = 1e-5,
                 mess_dropout_rate: float = 0.1, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_factors = int(n_factors)
        self.context_hops = int(context_hops)
        self.sim_decay = float(sim_decay)
        self.reg_weight = float(reg_weight)
        self.latent_emb = raw_param(self, self.n_factors, embedding_size)
        self.disen_weight_att = raw_param(self, self.n_factors, self.n_relations)
        self.mdrop = Dropout(mess_dropout_rate)

    def embeddings(self, train: bool = False):
        """(users (U, D), items (n_items, D)): the ego rows plus every hop's."""
        ue, ee = self.user_embedding.weight, self.entity_embedding.weight
        u_res, e_res = ue, ee
        score = torch.softmax(ue @ self.latent_emb.T, dim=1)
        disen = torch.softmax(self.disen_weight_att, dim=-1) @ self.relation_embedding.weight
        gate = score @ disen
        for _ in range(self.context_hops):
            ee_new = self._kg_mean(ee)
            u_agg = self._user_sum(ee)
            u_new = gate * u_agg + u_agg
            ee = l2_rows(self.mdrop(ee_new, train))
            ue = l2_rows(self.mdrop(u_new, train))
            e_res = e_res + ee
            u_res = u_res + ue
        return u_res, e_res[:self.n_items]

    def _cor_loss(self) -> torch.Tensor:
        t = self.disen_weight_att
        cor = t.new_zeros(())
        for i in range(self.n_factors):
            for j in range(i + 1, self.n_factors):
                cor = cor + _dcov(t[i], t[j]) / torch.sqrt(
                    torch.clamp(_dcov(t[i], t[i]) * _dcov(t[j], t[j]), min=1e-12))
        return cor

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u, p, n = self._scored_rows(batch, *self.embeddings(train=True))
        mf = bpr_loss((u * p).sum(dim=1), (u * n).sum(dim=1), batch.get("weight"))
        return mf + self.reg_weight * emb_loss(u, p, n) + self.sim_decay * self._cor_loss()


def _info_nce(z1: torch.Tensor, z2: torch.Tensor, tau: float) -> torch.Tensor:
    """−mean log softmax of the diagonal of cos(z1, z2) / tau: each row of
    z1 against every row of z2 in the global batch, the diagonal at this
    rank's rows, the mean over the global batch's rows."""
    every, first = global_rows(l2_rows(z2))
    logits = (l2_rows(z1) @ every.T) / tau
    return -batch_mean(torch.log_softmax(logits, dim=1).diagonal(offset=first))


@register_model
class MCCLK(KGEdgeModel):
    iid_rows = property(lambda self: self.n_items)  # `_user_sum` gathers item rows

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_hops: int = 1,
                 lightgcn_layer: int = 2, knn_k: int = 8, tau: float = 0.8, alpha: float = 0.5,
                 beta: float = 0.1, reg_weight: float = 1e-5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_hops = int(n_hops)
        self.lightgcn_layer = int(lightgcn_layer)
        self.knn_k = int(knn_k)
        self.tau = float(tau)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.reg_weight = float(reg_weight)
        D = embedding_size
        for name in ("pl_0", "pl_1", "pg_0", "pg_1"):
            self.add_module(name, dense(self, D, D))

    def _structural_items(self) -> torch.Tensor:
        ee = self.entity_embedding.weight
        for _ in range(self.n_hops):
            ee = l2_rows(self._kg_mean(ee) + ee)
        return ee[:self.n_items]

    def semantic_adjacency(self, item_ent: torch.Tensor) -> torch.Tensor:
        """The row-normalised kNN graph: each row's cosine similarities at
        least its k-th largest (ties with it kept), the rest 0."""
        x = l2_rows(item_ent)
        sim = x @ x.T
        k = min(self.knn_k, sim.shape[1])
        kth = torch.topk(sim, k, dim=1).values[:, -1:]
        adj = torch.where(sim >= kth, sim, torch.zeros_like(sim))
        return adj / torch.clamp(adj.sum(dim=1, keepdim=True), min=1e-12)

    def _collab(self):
        ue, ie = self.user_embedding.weight, self.entity_embedding.weight[:self.n_items]
        u_res, i_res = ue, ie
        (iid, iid_plan), (uid, uid_plan) = self.planned("kgin_iid"), self.planned("kgin_uid")
        ones = torch.ones(len(iid), 1, device=ue.device)
        icnt = segment_sum(ones, iid, self.n_items, plan=iid_plan)
        for _ in range(self.lightgcn_layer):
            u_new = self._user_sum(ie)
            i_new = segment_sum(gather_rows(ue, uid, plan=uid_plan), iid, self.n_items,
                                plan=iid_plan)
            ue, ie = u_new, i_new / torch.clamp(icnt, min=1.0)
            u_res = u_res + ue
            i_res = i_res + ie
        return u_res, i_res

    def embeddings(self, train: bool = False):
        """(users, items, collaborative items, structural items, semantic
        items)."""
        item_struct = self._structural_items()
        item_sem = self.semantic_adjacency(item_struct) @ item_struct
        u_col, item_col = self._collab()
        return u_col, item_col + item_struct + item_sem, item_col, item_struct, item_sem

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        users, items, i_col, i_struct, i_sem = self.embeddings(train=True)
        u, p, n = self._scored_rows(batch, users, items)
        rec = bpr_loss((u * p).sum(dim=1), (u * n).sum(dim=1), batch.get("weight"))
        pos = batch[self.iid_field]
        z_col = self.pl_0(gather_rows(i_col, pos))
        z_struct = self.pl_1(gather_rows(i_struct, pos))
        z_sem = self.pl_1(gather_rows(i_sem, pos))
        local = _info_nce(z_struct, z_sem, self.tau)
        g1 = self.pg_0(gather_rows(i_sem, pos))
        g2 = self.pg_1(gather_rows(i_col + i_struct, pos))
        global_ = _info_nce(g1, g2, self.tau) + _info_nce(z_col, z_struct, self.tau)
        return (rec + self.reg_weight * emb_loss(u, p, n)
                + self.beta * (self.alpha * local + (1 - self.alpha) * global_))

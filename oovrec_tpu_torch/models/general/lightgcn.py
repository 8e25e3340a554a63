"""LightGCN: K rounds of linear propagation over the symmetric-normalised
user-item graph, the mean of the layers, BPR and the EmbLoss regulariser.

Port of `oovrec_tpu/models/general/lightgcn.py:23-99`. The graph is the
edge list of `build_estate` (both directions of every training
interaction, weight 1/√(deg u · deg i)), held as buffers on the model's
device: `edge_src` / `edge_dst` int32, `edge_weight` float32. One round is
`segment_sum(cur[src] · w, dst)` (`propagate`), where the segment sum and
the gather's backward are both the sort-and-segment kernel
(`ops/embed_grad.py`, `csrc/embed_grad.cu` on the card): no atomics, so a
step gives the same bits on every run and a captured step equals the
eager one. Every gather with a gradient (the edge sources, the batch's
users and items) goes through `gather_rows`. The edges' sorts are done
once: `edge_src` and `edge_dst` each have a plan (`ops/embed_grad.py:
IndexPlans`, a non-persistent buffer, rebuilt where the edges change), so
a round's segment sum and gather backward each launch the segment pass
alone. The regulariser reads the
ego embeddings (before propagation). `predict` and `full_sort_scores`
propagate on every call, as the JAX model does.

The graph models of `more2.py`, `more4.py` and `more5.py` build the same
edges (`graph_edges`) and propagate with `propagate`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, GeneralRecommender, register_model
from oovrec_tpu_torch.models.general.base import set_state
from oovrec_tpu_torch.models.losses import bpr_loss, emb_loss
from oovrec_tpu_torch.ops.embed_grad import IndexPlans, SegmentPlan, gather_rows, segment_sum
from oovrec_tpu_torch.utils.enums import InputType


def graph_edges(train_split, config=None) -> dict:
    """Symmetric-normalised bipartite edges, both directions
    (`lightgcn.py:82-99` of the JAX package)."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    n_u = train_split.user_num
    n_i = train_split.item_num
    du = np.zeros(n_u)
    di = np.zeros(n_i)
    np.add.at(du, uid, 1.0)
    np.add.at(di, iid, 1.0)
    w = 1.0 / np.sqrt(np.maximum(du[uid], 1) * np.maximum(di[iid], 1))
    src = np.concatenate([uid, iid + n_u]).astype(np.int32)
    dst = np.concatenate([iid + n_u, uid]).astype(np.int32)
    return {
        "edge_src": src,
        "edge_dst": dst,
        "edge_weight": np.concatenate([w, w]).astype(np.float32),
    }


def propagate(cur: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              n: int, src_plan: Optional[SegmentPlan] = None,
              dst_plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """One round Â·cur: the (n, D) sums of the weighted source rows at
    their destinations; `w` is (E, 1) (or (E, D)); the plans: the edges'
    own (`IndexPlans`)."""
    return segment_sum(gather_rows(cur, src, plan=src_plan) * w, dst, n, plan=dst_plan)


class GraphModel(IndexPlans, GeneralRecommender):
    """User and item tables (xavier-normal, as the JAX models draw them)
    and the edge buffers with their plans."""

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 edge_src: Optional[np.ndarray] = None, edge_dst: Optional[np.ndarray] = None,
                 edge_weight: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.user_embedding = self._embed_table(n_users)
        self.item_embedding = self._embed_table(n_items)
        n_edges = 0 if edge_src is None else len(edge_src)
        set_state(self, "edge_src", edge_src, (n_edges,), torch.int32)
        set_state(self, "edge_dst", edge_dst, (n_edges,), torch.int32)
        set_state(self, "edge_weight", edge_weight, (n_edges,), torch.float32)
        self.add_index_plan("edge_src", self.n_nodes)
        self.add_index_plan("edge_dst", self.n_nodes)

    build_estate = staticmethod(graph_edges)

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    def ego(self) -> torch.Tensor:
        """(n_users + n_items, D): the users' rows, then the items'."""
        return torch.cat([self.user_embedding.weight, self.item_embedding.weight], dim=0)

    def _prop(self, cur: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Â·cur over the model's edges (weights `w` (E, 1) where given)."""
        w = self.edge_weight[:, None] if w is None else w
        (src, src_plan), (dst, dst_plan) = self.planned("edge_src"), self.planned("edge_dst")
        return propagate(cur, src, dst, w, self.n_nodes, src_plan, dst_plan)

    def _split(self, e: torch.Tensor):
        return e[: self.n_users], e[self.n_users:]

    def _rows(self, batch: Batch, ue: torch.Tensor, ie: torch.Tensor):
        """The batch's user, positive and negative rows."""
        return (gather_rows(ue, batch[self.uid_field]), gather_rows(ie, batch[self.iid_field]),
                gather_rows(ie, batch[self.neg_prefix + self.iid_field]))

    def _ego_rows(self, batch: Batch):
        return self._rows(batch, self.user_embedding.weight, self.item_embedding.weight)

    def embeddings(self):
        """(user rows, item rows) that `predict` and `full_sort_scores`
        score."""
        raise NotImplementedError

    def predict(self, batch: Batch) -> torch.Tensor:
        ue, ie = self.embeddings()
        return (ue[batch[self.uid_field].long()] * ie[batch[self.iid_field].long()]).sum(dim=1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        ue, ie = self.embeddings()
        return ue[batch[self.uid_field].long()] @ ie.T


def bpr_of(u: torch.Tensor, p: torch.Tensor, n: torch.Tensor, batch: Batch) -> torch.Tensor:
    return bpr_loss((u * p).sum(dim=1), (u * n).sum(dim=1), batch.get("weight"))


@register_model
class LightGCN(GraphModel):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_layers: int = 2,
                 reg_weight: float = 1e-5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_layers = int(n_layers)
        self.reg_weight = float(reg_weight)

    def propagate(self, w: Optional[torch.Tensor] = None):
        """K rounds of E ← ÂE, the mean of the K + 1 layers."""
        e = self.ego()
        acc, cur = e, e
        for _ in range(self.n_layers):
            cur = self._prop(cur, w)
            acc = acc + cur
        return self._split(acc / (self.n_layers + 1))

    def embeddings(self):
        return self.propagate()

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u, p, n = self._rows(batch, *self.propagate())
        # reg on the EGO embeddings (pre-propagation), reference behavior
        reg = emb_loss(*self._ego_rows(batch))
        return bpr_of(u, p, n, batch) + self.reg_weight * reg

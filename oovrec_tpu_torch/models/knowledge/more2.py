"""KTUP, KGNNLS and RippleNet.

Port of `oovrec_tpu/models/knowledge/more2.py:21-244`.

  * KTUP: TUP for the interactions (a soft preference over the relations
    from the softmax of (u + i) · (pref + relation) / 2, u and i projected
    on the preference's hyperplane, the score −‖u⊥ + pref − i⊥‖²) and
    TransH for the triples, BPR on both (`kg_weight`). An item's row is its
    own plus its entity's.
  * KGNNLS: KGCN plus `ls_weight` times the label-smoothness term, the
    (weighted) mean squared difference between an item's logit and its
    first sampled neighbour's.
  * RippleNet: a user's ripple sets (`ripple_h<hop>` / `ripple_r<hop>` /
    `ripple_t<hop>`, `n_memory` triples a hop, drawn once on the host);
    each hop attends over R_r h with the current item vector, sums the
    attended tails and moves the vector through `transform`; the user row
    is the sum of the hops' outputs. BCE on u · item; `kge_weight` is read
    and unused, as in the JAX model.

`RippleNet.build_estate` walks each user's seeds over the head-only
adjacency as the JAX loop does, without building the candidate list: a
draw p over the seeds' concatenated triples is placed by the cumulative
counts of the seeds (the seed, then its p-th triple in triple order). One
`rng.integers(0, total, n_memory)` call a user and hop, in user order,
from `host_rng(2020, "ripple_sets")`; a user with no candidate keeps his
seeds for the next hop and zeros in the hop's rows. It reads `n_hop` and
`n_memory` from the config (the JAX `quick_start` passes none; ROADMAP.md §3).

The full sorts score blocks of items for all the batch's users
(`models/base.py:score_item_blocks`). KTUP's and KGNNLS's pairs broadcast
over a (B, T) grid, as KGCN's. RippleNet's R_r h depends on the user's
ripple set alone: it is computed once a user and hop (`_memories`), then
each block of items attends over it (the JAX vmap builds the (B, M, D, D)
relation matrices for every item, 124 GB at 256 users).
"""

from __future__ import annotations

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, register_model, score_item_blocks
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.general.base import config_values, set_state
from oovrec_tpu_torch.models.knowledge.base import KnowledgeRecommender, lookup
from oovrec_tpu_torch.models.knowledge.more import KGCN
from oovrec_tpu_torch.models.losses import _wmean, bce_with_logits, bpr_loss
from oovrec_tpu_torch.utils.enums import InputType
from oovrec_tpu_torch.utils.seeding import host_rng


@register_model
class KTUP(KnowledgeRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 use_st_gumbel: bool = False, kg_weight: float = 1.0, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.use_st_gumbel = bool(use_st_gumbel)  # read and unused, as in the JAX model
        self.kg_weight = float(kg_weight)
        D, R = embedding_size, self.n_relations
        self.user_embedding = self._embed_table(n_users)
        self.item_embedding = self._embed_table(n_items)
        self.entity_embedding = self._embed_table(self.n_entities)
        self.pref_embedding = self._embed_table(R)
        self.pref_norm = self._embed_table(R)
        self.relation_embedding = self._embed_table(R)
        self.relation_norm = self._embed_table(R)

    @staticmethod
    def _project(e: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
        norm = norm / torch.sqrt((norm ** 2).sum(dim=-1, keepdim=True) + 1e-12)
        return e - (e * norm).sum(dim=-1, keepdim=True) * norm

    def _item_rows(self, items: torch.Tensor) -> torch.Tensor:
        return (lookup(self.item_embedding, items)
                + lookup(self.entity_embedding, torch.clamp(items, 0, self.n_entities - 1)))

    def _pair_score(self, u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """−‖u⊥ + pref − i⊥‖² of user rows `u` broadcast against item rows
        `i`."""
        pref_t = self.pref_embedding.weight
        logits = (u + i) @ (pref_t + self.relation_embedding.weight).T / 2.0
        probs = torch.softmax(logits, dim=-1)
        pref, norm = probs @ pref_t, probs @ self.pref_norm.weight
        return -((self._project(u, norm) + pref - self._project(i, norm)) ** 2).sum(dim=-1)

    def _rec_score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return self._pair_score(lookup(self.user_embedding, users), self._item_rows(items))

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        users = batch[self.uid_field]
        rec = bpr_loss(self._rec_score(users, batch[self.iid_field]),
                       self._rec_score(users, batch[self.neg_prefix + self.iid_field]),
                       batch.get("weight"))
        rel = batch["kg_relation"]
        w = lookup(self.relation_norm, rel)
        ph, ppt, pnt = (self._project(lookup(self.entity_embedding, batch[k]), w)
                        for k in ("kg_head", "kg_pos_tail", "kg_neg_tail"))
        r = lookup(self.relation_embedding, rel)
        pos = ((ph + r - ppt) ** 2).sum(dim=-1)
        neg = ((ph + r - pnt) ** 2).sum(dim=-1)
        return rec + self.kg_weight * bpr_loss(-pos, -neg, batch.get("kg_weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return self._rec_score(batch[self.uid_field], batch[self.iid_field])

    _score = _rec_score

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()][:, None, :]
        per_item = u.shape[0] * max(self.embedding_size, self.n_relations)
        return score_item_blocks(self.n_items, per_item, u.device,
                                 lambda items: self._pair_score(u, self._item_rows(items)[None]))


@register_model
class KGNNLS(KGCN):
    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 ls_weight: float = 0.5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.ls_weight = float(ls_weight)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        items = batch[self.iid_field].long()
        u = lookup(self.user_embedding, batch[self.uid_field])
        out = (u * self._item_repr(u, items)).sum(dim=1)
        w = batch.get("weight")
        base = bce_with_logits(out, batch[self.label_field], w)
        out_n = (u * self._item_repr(u, self.kg_neighbors[items][:, 0])).sum(dim=1)
        return base + self.ls_weight * _wmean((out - out_n) ** 2, w)


def ripple_sets(train_split, n_hop: int = 2, n_memory: int = 8, seed: int = 2020) -> dict:
    """`RippleNet.build_estate` of the JAX package (`more2.py:211-244`)
    with the candidates indexed, not listed: (n_users, n_memory) int64
    `ripple_h<hop>` / `ripple_r<hop>` / `ripple_t<hop>`, bit for bit."""
    ds = train_split.parent
    heads, rels, tails = ds.kg_triples
    rng = host_rng(seed, "ripple_sets")
    # the head-only adjacency: each head's triples in triple order
    order = np.argsort(heads, kind="stable")
    counts = np.bincount(heads, minlength=ds.entity_num)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_users = train_split.user_num
    seeds = [np.asarray(p, dtype=np.int64) for p in train_split.used_ids_per_user()]
    state = {}
    for hop in range(n_hop):
        H, R, T = (np.zeros((n_users, n_memory), np.int64) for _ in range(3))
        for u in range(n_users):
            lens = counts[seeds[u]]
            ends = np.cumsum(lens)
            total = int(ends[-1]) if len(ends) else 0
            if not total:
                continue
            picks = rng.integers(0, total, n_memory)
            j = np.searchsorted(ends, picks, side="right")
            e = seeds[u][j]
            at = order[starts[e] + picks - (ends[j] - lens[j])]
            H[u], R[u], T[u] = e, rels[at], tails[at]
            seeds[u] = T[u]
        state[f"ripple_h{hop}"], state[f"ripple_r{hop}"], state[f"ripple_t{hop}"] = H, R, T
    return state


@register_model
class RippleNet(KnowledgeRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, n_hop: int = 2,
                 n_memory: int = 8, kge_weight: float = 0.01, **kwargs):
        ripple = {k: kwargs.pop(k) for k in list(kwargs) if k.startswith("ripple_")}
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_hop = int(n_hop)
        self.n_memory = int(n_memory)
        self.kge_weight = float(kge_weight)
        D = embedding_size
        self.entity_embedding = self._embed_table(self.n_entities)
        self.relation_embedding = self._embed_table(self.n_relations, D * D)
        self.transform = dense(self, D, D, bias=False)
        for hop in range(self.n_hop):
            for part in "hrt":
                name = f"ripple_{part}{hop}"
                set_state(self, name, ripple.get(name), (n_users, self.n_memory), torch.int64)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return ripple_sets(train_split, **config_values(config, {"n_hop": 2, "n_memory": 8}))

    def _memories(self, users: torch.Tensor):
        """Each hop's (R_r h (B, M, D), tail rows (B, M, D)) of the users'
        ripple sets."""
        D = self.embedding_size
        users = users.long()
        out = []
        for hop in range(self.n_hop):
            h = getattr(self, f"ripple_h{hop}")[users]
            r = getattr(self, f"ripple_r{hop}")[users]
            t = getattr(self, f"ripple_t{hop}")[users]
            Re = lookup(self.relation_embedding, r).reshape(*h.shape, D, D)
            Rh = torch.einsum("bmde,bme->bmd", Re, lookup(self.entity_embedding, h))
            out.append((Rh, lookup(self.entity_embedding, t)))
        return out

    def _respond(self, memories, v: torch.Tensor) -> torch.Tensor:
        """The user rows for item vectors `v` (..., D), the memories
        (..., M, D) broadcast against them."""
        o_sum = None
        for Rh, te in memories:
            probs = torch.softmax((Rh * v[..., None, :]).sum(dim=-1), dim=-1)
            o = (probs[..., None] * te).sum(dim=-2)
            o_sum = o if o_sum is None else o_sum + o
            v = self.transform(v + o)
        return o_sum

    def _item_rows(self, items: torch.Tensor) -> torch.Tensor:
        return lookup(self.entity_embedding, torch.clamp(items, 0, self.n_entities - 1))

    def _score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """The logit of each (user, item) pair: the per-pair definition."""
        item_e = self._item_rows(items)
        return (self._respond(self._memories(users), item_e) * item_e).sum(dim=1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        out = self._score(batch[self.uid_field], batch[self.iid_field])
        return bce_with_logits(out, batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self._score(batch[self.uid_field], batch[self.iid_field]))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        memories = [(Rh[:, None], te[:, None]) for Rh, te in
                    self._memories(batch[self.uid_field])]
        B = memories[0][0].shape[0] if memories else 1
        per_item = B * self.n_memory * self.embedding_size

        def block(items):
            item_e = self._item_rows(items)[None]
            return (self._respond(memories, item_e) * item_e).sum(dim=-1)

        return score_item_blocks(self.n_items, per_item, self.entity_embedding.weight.device,
                                 block)

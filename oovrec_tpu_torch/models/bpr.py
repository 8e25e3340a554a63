"""BPR — matrix-factorization two-tower trained pairwise.

Port of `oovrec_tpu/models/bpr.py:21-105`: user/item tables and the BPR
loss; OOV rows route through bucket tables (`get_user_embedding`
`bpr.py:48-78`, `get_item_embedding` `bpr.py:94-125` in the reference),
branchless via `inductive.routing.route`, on all three columns of a
training row (user, positive and negative item).
"""

from __future__ import annotations

from oovrec_tpu_torch.models.base import Batch, GeneralRecommender, register_model
from oovrec_tpu_torch.models.losses import bpr_loss
from oovrec_tpu_torch.utils.enums import InputType


@register_model
class BPR(GeneralRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.user_embedding = self._embed_table(self.n_users)
        self.item_embedding = self._embed_table(self.n_items)
        self._setup_oov()

    def user_e(self, ids, batch: Batch):
        return self._route_side(
            "user", self.user_embedding, ids, batch, self.uid_field
        )

    def item_e(self, ids, batch: Batch, field=None):
        return self._route_side(
            "item", self.item_embedding, ids, batch, field or self.iid_field
        )

    def calculate_loss(self, batch: Batch):
        neg_field = self.neg_prefix + self.iid_field
        u = self.user_e(batch[self.uid_field], batch)
        p = self.item_e(batch[self.iid_field], batch)
        n = self.item_e(batch[neg_field], batch, field=neg_field)
        return bpr_loss((u * p).sum(dim=1), (u * n).sum(dim=1), batch.get("weight"))

    def predict(self, batch: Batch):
        u = self.user_e(batch[self.uid_field], batch)
        i = self.item_e(batch[self.iid_field], batch)
        return (u * i).sum(dim=1)

    def full_sort_scores(self, batch: Batch):
        """IV-only full-corpus scores (`bpr.py:158-162`)."""
        u = self.user_e(batch[self.uid_field], batch)
        return u @ self.item_embedding.weight.T

    def all_item_embeddings(self, item_ids, item_buckets=None):
        """Embed the full (IV+OOV) item range once per eval pass
        (the item half of `ind_full_sort_predict`, `bpr.py:151-156`)."""
        batch = {self.iid_field: item_ids}
        if item_buckets is not None:
            batch[self.iid_field + "_bucket"] = item_buckets
        return self.item_e(item_ids, batch)

    def user_tower(self, batch: Batch):
        """(B, D) user embeddings for the fused retrieval kernel."""
        return self.user_e(batch[self.uid_field], batch)

    def item_tower(self):
        """(n_items, D) IV item table for the fused retrieval kernel."""
        return self.item_embedding.weight

    def score_against(self, batch: Batch, all_item_e):
        """user_e @ all_item_eᵀ."""
        u = self.user_e(batch[self.uid_field], batch)
        return u @ all_item_e.T

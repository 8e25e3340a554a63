"""BPR — matrix-factorization two-tower trained pairwise.

Port of `oovrec_tpu/models/bpr.py:21-105`: user/item tables and the BPR
loss; OOV rows route through bucket tables or an embedder
(`get_user_embedding` `bpr.py:48-78`, `get_item_embedding` `bpr.py:94-125`
in the reference), branchless via `inductive.routing.route`, on all three
columns of a training row (user, positive and negative item), with the
model's embedder state and the batch's DHE hashes. The towers and the
retrieval methods are `IDTowerRecommender`'s.
"""

from __future__ import annotations

from oovrec_tpu_torch.models.base import Batch, IDTowerRecommender, register_model
from oovrec_tpu_torch.models.losses import bpr_loss
from oovrec_tpu_torch.utils.enums import InputType


@register_model
class BPR(IDTowerRecommender):
    input_type = InputType.PAIRWISE
    # calculate_loss consumes only (uid, iid, neg_iid, weight): eligible for
    # the device-resident epoch (train/device_epoch.py)
    supports_device_epoch = True

    def sparse_table_fields(self):
        """Sparse fast-path declaration (train/sparse_update.py): the ID
        tables are pure row lookups over these batch fields."""
        return {
            "user": ("user_embedding", [self.uid_field]),
            "item": ("item_embedding", [self.iid_field, self.neg_prefix + self.iid_field]),
        }

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

"""NeuMF: a GMF tower and an MLP tower fused by `predict_layer`, trained
pointwise with BCE on logits.

Port of `oovrec_tpu/models/general/neumf.py:19-84`. Each tower exists only
under its flag (`mf_train`, `mlp_train`), as flax creates a setup module
only when it is called: with `mf_train` off there is no
`user_mf_embedding` / `item_mf_embedding`, with `mlp_train` off no
`user_mlp_embedding` / `item_mlp_embedding` / `mlp_layers`. The tables are
normal(0, 0.01), `predict_layer` xavier-normal. `full_sort_scores` runs
every (user, item) pair of the batch through both towers, as the JAX
model does (948,992 rows at 256 users × 3,707 items).
"""

from __future__ import annotations

from typing import Sequence

import torch

from oovrec_tpu_torch.models.base import Batch, GeneralRecommender, register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.general.base import normal_table
from oovrec_tpu_torch.models.layers import MLPLayers
from oovrec_tpu_torch.models.losses import bce_with_logits
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import InputType


@register_model
class NeuMF(GeneralRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 mf_embedding_size: int = 64, mlp_embedding_size: int = 64,
                 mlp_hidden_size: Sequence[int] = (128, 64), dropout_prob: float = 0.1,
                 mf_train: bool = True, mlp_train: bool = True, label_field: str = "label",
                 **kwargs):
        if not (mf_train or mlp_train):
            raise ValueError("NeuMF: mf_train and mlp_train are both off; no tower is left")
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.label_field = label_field
        self.mf_train, self.mlp_train = bool(mf_train), bool(mlp_train)
        hidden = tuple(int(h) for h in mlp_hidden_size)
        pred_in = 0
        if self.mf_train:
            self.user_mf_embedding = normal_table(self, n_users, mf_embedding_size)
            self.item_mf_embedding = normal_table(self, n_items, mf_embedding_size)
            pred_in += mf_embedding_size
        if self.mlp_train:
            self.user_mlp_embedding = normal_table(self, n_users, mlp_embedding_size)
            self.item_mlp_embedding = normal_table(self, n_items, mlp_embedding_size)
            self.mlp_layers = MLPLayers((2 * mlp_embedding_size,) + hidden, dropout=dropout_prob,
                                        device=self.device, generator=self.generator)
            pred_in += hidden[-1]
        self.predict_layer = dense(self, pred_in, 1)

    def forward(self, user: torch.Tensor, item: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(n,) logits of the (user, item) pairs."""
        parts = []
        if self.mf_train:
            parts.append(gather_rows(self.user_mf_embedding.weight, user)
                         * gather_rows(self.item_mf_embedding.weight, item))
        if self.mlp_train:
            x = torch.cat([gather_rows(self.user_mlp_embedding.weight, user),
                           gather_rows(self.item_mlp_embedding.weight, item)], dim=-1)
            parts.append(self.mlp_layers(x, train=train))
        return self.predict_layer(torch.cat(parts, dim=-1)).squeeze(-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        out = self.forward(batch[self.uid_field], batch[self.iid_field], train=True)
        return bce_with_logits(out, batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self.forward(batch[self.uid_field], batch[self.iid_field]))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        users = batch[self.uid_field]
        B = users.shape[0]
        items = torch.arange(self.n_items, device=users.device)
        u = users.repeat_interleave(self.n_items, output_size=B * self.n_items)
        return self.forward(u, items.repeat(B)).reshape(B, self.n_items)

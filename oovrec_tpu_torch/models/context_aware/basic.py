"""LR, FM and DeepFM.

Port of `oovrec_tpu/models/context_aware/basic.py` (the reference's
`lr.py`, `fm.py`, `deepfm.py`) on the shared context base:
  * LR: the sigmoid of the first-order linear term (its flax tree has no
    field embedding, so neither does the port's model); BCE on it;
  * FM: the first-order term plus the second-order interactions
    (`fm_second_order`), through a sigmoid; BCE on it;
  * DeepFM: FM's logit plus an MLP over the flattened field embeddings
    into one logit (`deep_predict_layer`); BCE on the logits, the sigmoid
    in `predict`.
Each loss reads only split columns and joined features, so all three take
the pointwise and plain device epochs (`supports_device_epoch`, as the
JAX models declare). `calculate_loss` runs in train mode, `predict` in
eval mode (DeepFM's dropout), as the flax models take `train`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import ContextRecommender, FieldSpec, LogitModel, dense
from oovrec_tpu_torch.models.layers import MLPLayers
from oovrec_tpu_torch.models.losses import bce


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """The reference's BaseFactorizationMachine with reduce_sum
    (`basic.py:17-23` of the JAX package): (B, F, D) →
    0.5 · Σ_d [(Σ_f e)² − Σ_f e²], (B, 1)."""
    sum_sq = emb.sum(dim=1) ** 2
    sq_sum = (emb ** 2).sum(dim=1)
    return 0.5 * (sum_sq - sq_sum).sum(dim=1, keepdim=True)


@register_model
class LR(ContextRecommender):
    supports_device_epoch = True

    def __init__(self, fields: FieldSpec, embedding_size: int = 10,
                 spec: Optional[InductiveSpec] = None, **kwargs):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context(fields=False)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        return torch.sigmoid(self.first_order_linear(batch, self.embedder_state)).squeeze(-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        return bce(self.forward(batch, train=True), batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return self.forward(batch, train=False)


@register_model
class FM(ContextRecommender):
    supports_device_epoch = True

    def __init__(self, fields: FieldSpec, embedding_size: int = 10,
                 spec: Optional[InductiveSpec] = None, **kwargs):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        y = self.first_order_linear(batch, self.embedder_state) + fm_second_order(emb)
        return torch.sigmoid(y).squeeze(-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        return bce(self.forward(batch, train=True), batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return self.forward(batch, train=False)


@register_model
class DeepFM(LogitModel):
    supports_device_epoch = True

    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        mlp_hidden_size: Sequence[int] = (128, 128, 128),
        dropout_prob: float = 0.2,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()
        self.mlp_layers = MLPLayers(
            (self.in_feature_num,) + tuple(mlp_hidden_size), dropout=dropout_prob,
            device=self.device, generator=self.generator,
        )
        self.deep_predict_layer = dense(self, int(mlp_hidden_size[-1]), 1)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        y_fm = self.first_order_linear(batch, self.embedder_state) + fm_second_order(emb)
        y_deep = self.deep_predict_layer(
            self.mlp_layers(emb.reshape(emb.shape[0], -1), train=train))
        return (y_fm + y_deep).squeeze(-1)

"""WideDeep.

Port of `oovrec_tpu/models/context_aware/widedeep.py:18-49` (the
reference's `widedeep.py:24-92`): the wide part is the first-order linear
term, the deep part an MLP over the flattened field embeddings into one
logit; the logits add. `calculate_loss` is BCE on the logits in train
mode; `predict` is their sigmoid in eval mode, as the JAX model's
`predict` runs with `train=False`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import ContextRecommender, FieldSpec
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.models.layers import MLPLayers
from oovrec_tpu_torch.models.losses import bce_with_logits


@register_model
class WideDeep(ContextRecommender):
    # as the JAX model declares; the port's device epoch has no pointwise
    # mode yet (train/device_epoch.py), so `auto` takes the host path
    supports_device_epoch = True

    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        mlp_hidden_size: Sequence[int] = (32, 16, 8),
        dropout_prob: float = 0.1,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()
        self.mlp_layers = MLPLayers(
            (self.in_feature_num,) + tuple(mlp_hidden_size), dropout=dropout_prob,
            device=self.device, generator=self.generator,
        )
        self.deep_predict_layer = nn.Linear(int(mlp_hidden_size[-1]), 1, device=self.device)
        xavier_normal_(self.deep_predict_layer.weight, self.generator)
        nn.init.zeros_(self.deep_predict_layer.bias)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        wide = self.first_order_linear(batch, self.embedder_state)
        deep = self.deep_predict_layer(self.mlp_layers(emb.reshape(emb.shape[0], -1), train=train))
        return (wide + deep).squeeze(-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        out = self.forward(batch, train=True)
        return bce_with_logits(out, batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self.forward(batch, train=False))

"""FFM: field-aware factorization machine.

Port of `oovrec_tpu/models/context_aware/ffm.py` (the reference's
`ffm.py`): each field embedding is projected toward every other field by a
per-(field, field) matrix, `field_proj` (F, F, D, D), a raw leaf at the top
of the flax tree that the weight bridge keeps as it is:
e[f→g] = emb[f] @ W[f, g]; a pair f < g scores ⟨e[f→g], e[g→f]⟩, the pairs
in `triu_indices(F, 1)` order. The logit is the first-order term plus the
pairs' sum; BCE on the logits, the sigmoid in `predict`. FFM does not
declare `supports_device_epoch` (the JAX model does not): it trains on the
host path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import FieldSpec, LogitModel, PairMixin
from oovrec_tpu_torch.models.init import xavier_normal_


@register_model
class FFM(PairMixin, LogitModel):
    def __init__(self, fields: FieldSpec, embedding_size: int = 10,
                 spec: Optional[InductiveSpec] = None, **kwargs):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()
        f, d = fields.num_feature_field, embedding_size
        self.field_proj = nn.Parameter(torch.empty(f, f, d, d, device=self.device))
        xavier_normal_(self.field_proj, self.generator)
        self._register_pairs()

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        proj = torch.einsum("bfd,fgde->bfge", emb, self.field_proj)
        a = proj[:, self.pair_i, self.pair_j, :]
        b = proj[:, self.pair_j, self.pair_i, :]
        second = (a * b).sum(dim=(1, 2))
        return self.first_order_linear(batch, self.embedder_state).squeeze(-1) + second

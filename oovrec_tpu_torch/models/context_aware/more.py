"""DCN, AutoInt, FNN, PNN, AFM and FwFM.

Port of `oovrec_tpu/models/context_aware/more.py` (the reference's
`dcn.py`, `autoint.py`, `fnn.py`, `pnn.py`, `afm.py`, `fwfm.py`) on the
shared context base, each forward as the JAX model writes it:
  * DCN: cross layers x_{l+1} = x0 · (x_l · w_l) + b_l + x_l over the
    flattened field embeddings beside an MLP with batch norm, one Dense,
    a sigmoid; `bce` on the probabilities + `reg_weight` · Σ_l ‖w_l‖₂
    (row norms, unsquared). The cross weights are raw (L, d) leaves drawn
    N(0, 1);
  * AutoInt: `att_embedding`, then per layer relu(attention(x, x) +
    v_res(emb)) (the residual projection reads the embeddings in every
    layer), `attn_fc` over the flattened result, plus an MLP (dropout
    `dropout_probs[1]`, the only one used) and the first-order term;
  * FNN: an MLP over the flattened embeddings;
  * PNN: the flattened embeddings ∥ the inner products of the field pairs
    (`use_inner`) ∥ Σ_d (a + b) · K (`use_outer`, K the raw
    `outer_kernel` (P, D), as the JAX model writes it) → MLP → Dense;
    `reg_weight` is read and never used, as in JAX;
  * AFM: the pairs' Hadamard products weighted by a softmax over pairs of
    relu(attn_w(pair)) · `attn_h`, dropout, · `attn_p`, plus the
    first-order term; + `reg_weight` · Σ attn_w.kernel²;
  * FwFM: the pairs' inner products weighted by `pair_weight`, plus the
    first-order term (`dropout_prob` unused, as in JAX).
The pairs are `triu_indices(F, 1)`, built once as buffers (a host copy in
`forward` would break graph capture). A model whose JAX forward never
calls `first_order_linear` has no first-order twin (its flax tree has
none): DCN, FNN, PNN. None declares `supports_device_epoch` (the JAX models
do not): they train on the host path. Only `MLPLayers` follows the
precision policy, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import (
    ContextRecommender,
    FieldSpec,
    LogitModel,
    PairMixin,
    dense,
    raw_param,
)
from oovrec_tpu_torch.models.context_aware.dcnv2 import _norm2
from oovrec_tpu_torch.models.init import normal_init
from oovrec_tpu_torch.models.layers import Dropout, MLPLayers, MultiHeadDotProductAttention
from oovrec_tpu_torch.models.losses import bce


@register_model
class DCN(ContextRecommender):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        cross_layer_num: int = 6,
        mlp_hidden_size: Sequence[int] = (256, 256, 256),
        reg_weight: float = 2.0,
        dropout_prob: float = 0.2,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context(first_order=False)
        d, n = self.in_feature_num, int(cross_layer_num)
        self.cross_layer_num = n
        self.reg_weight = float(reg_weight)
        self.cross_w = raw_param(self, n, d, init=normal_init(1.0))
        self.cross_b = nn.Parameter(torch.zeros(n, d, device=self.device))
        self.mlp_layers = MLPLayers((d,) + tuple(mlp_hidden_size), dropout=dropout_prob,
                                    use_bn=True, device=self.device, generator=self.generator)
        self.predict_layer = dense(self, d + int(mlp_hidden_size[-1]), 1)

    def cross_network(self, x0: torch.Tensor) -> torch.Tensor:
        xl = x0
        for i in range(self.cross_layer_num):
            xlw = (xl * self.cross_w[i][None, :]).sum(dim=1, keepdim=True)
            xl = x0 * xlw + self.cross_b[i][None, :] + xl
        return xl

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        x0 = emb.reshape(emb.shape[0], -1)
        deep = self.mlp_layers(x0, train=train)
        out = self.predict_layer(torch.cat([self.cross_network(x0), deep], dim=-1))
        return torch.sigmoid(out).squeeze(-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        out = self.forward(batch, train=True)
        return (bce(out, batch[self.label_field], batch.get("weight"))
                + self.reg_weight * _norm2(self.cross_w))

    def predict(self, batch: Batch) -> torch.Tensor:
        return self.forward(batch, train=False)


@register_model
class AutoInt(LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        attention_size: int = 16,
        n_layers: int = 3,
        num_heads: int = 2,
        dropout_probs: Sequence[float] = (0.2, 0.2, 0.2),
        mlp_hidden_size: Sequence[int] = (128, 128),
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()
        a, f, dev, gen = int(attention_size), fields.num_feature_field, self.device, self.generator
        self.att_embedding = dense(self, embedding_size, a)
        self.attn_layers = []
        for i in range(int(n_layers)):
            layer = MultiHeadDotProductAttention(a, int(num_heads), a, device=dev, generator=gen)
            self.add_module(f"attn_{i}", layer)
            self.attn_layers.append(layer)
        self.v_res = dense(self, embedding_size, a)
        self.attn_fc = dense(self, f * a, 1)
        self.mlp_layers = MLPLayers((self.in_feature_num,) + tuple(mlp_hidden_size),
                                    dropout=dropout_probs[1], device=dev, generator=gen)
        self.deep_predict_layer = dense(self, int(mlp_hidden_size[-1]), 1)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        x = self.att_embedding(emb)
        for layer in self.attn_layers:
            x = torch.relu(layer(x, x) + self.v_res(emb))
        att_out = self.attn_fc(x.reshape(x.shape[0], -1))
        deep = self.deep_predict_layer(
            self.mlp_layers(emb.reshape(emb.shape[0], -1), train=train))
        y = self.first_order_linear(batch, self.embedder_state) + att_out + deep
        return y.squeeze(-1)


@register_model
class FNN(LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        mlp_hidden_size: Sequence[int] = (128, 128),
        dropout_prob: float = 0.2,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context(first_order=False)
        self.mlp_layers = MLPLayers((self.in_feature_num,) + tuple(mlp_hidden_size),
                                    dropout=dropout_prob, device=self.device,
                                    generator=self.generator)
        self.predict_layer = dense(self, int(mlp_hidden_size[-1]), 1)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        return self.predict_layer(
            self.mlp_layers(emb.reshape(emb.shape[0], -1), train=train)).squeeze(-1)


@register_model
class PNN(PairMixin, LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        mlp_hidden_size: Sequence[int] = (128, 128),
        dropout_prob: float = 0.2,
        use_inner: bool = True,
        use_outer: bool = False,
        reg_weight: float = 0.0,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context(first_order=False)
        self.use_inner, self.use_outer = bool(use_inner), bool(use_outer)
        self.reg_weight = float(reg_weight)  # unused, as in JAX
        n_pairs = self._register_pairs()
        in_size = self.in_feature_num + n_pairs * (self.use_inner + self.use_outer)
        if self.use_outer:
            self.outer_kernel = raw_param(self, n_pairs, embedding_size)
        self.mlp_layers = MLPLayers((in_size,) + tuple(mlp_hidden_size), dropout=dropout_prob,
                                    device=self.device, generator=self.generator)
        self.predict_layer = dense(self, int(mlp_hidden_size[-1]), 1)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        parts = [emb.reshape(emb.shape[0], -1)]
        a, b = self._pairs(emb)
        if self.use_inner:
            parts.append((a * b).sum(dim=-1))
        if self.use_outer:
            parts.append(((a + b) * self.outer_kernel[None]).sum(dim=-1))
        x = torch.cat(parts, dim=1)
        return self.predict_layer(self.mlp_layers(x, train=train)).squeeze(-1)


@register_model
class AFM(PairMixin, LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        attention_size: int = 25,
        dropout_prob: float = 0.3,
        reg_weight: float = 2.0,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()
        self.reg_weight = float(reg_weight)
        self._register_pairs()
        self.attn_w = dense(self, embedding_size, int(attention_size))
        self.attn_h = raw_param(self, int(attention_size), 1)
        self.attn_p = raw_param(self, embedding_size, 1)
        self.dropout = Dropout(dropout_prob)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        emb = self.concat_embed_input_fields(batch)
        a, b = self._pairs(emb)
        pair = a * b  # (B, P, D)
        att = torch.relu(self.attn_w(pair))  # (B, P, A)
        score = torch.softmax((att @ self.attn_h).squeeze(-1), dim=1)  # (B, P)
        weighted = self.dropout((pair * score[:, :, None]).sum(dim=1), train)  # (B, D)
        afm_out = (weighted @ self.attn_p).squeeze(-1)
        return self.first_order_linear(batch, self.embedder_state).squeeze(-1) + afm_out

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        return super().calculate_loss(batch) + self.reg_weight * (self.attn_w.weight ** 2).sum()


@register_model
class FwFM(PairMixin, LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        dropout_prob: float = 0.2,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()
        n_pairs = self._register_pairs()
        self.pair_weight = nn.Parameter(torch.ones(n_pairs, device=self.device))

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        a, b = self._pairs(emb)
        fwfm = ((a * b).sum(dim=-1) * self.pair_weight[None, :]).sum(dim=1)
        return self.first_order_linear(batch, self.embedder_state).squeeze(-1) + fwfm

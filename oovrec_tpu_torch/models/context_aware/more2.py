"""DSSM, FiGNN and EulerNet.

Port of `oovrec_tpu/models/context_aware/more2.py` (the reference's
`dssm.py`, `fignn.py`, `eulernet.py`), each forward as the JAX model
writes it:
  * DSSM: the token fields at `fields.user_token_idx` / `item_token_idx`
    (offset past the token_seq fields, which lead the sparse block) feed
    `user_mlp` / `item_mlp`; the logit is the cosine of the two towers with
    1e-12 inside each root;
  * FiGNN: h0 = relu(attention(att_embedding(emb)) + res_proj(emb)); the
    edge scores leaky_relu(edge_w([h_i ∥ h_j])) (slope 0.01) − 1e9·I, a
    softmax over j; then `n_layers` times state = gru(state, adj · state)
    + h0 with ONE GRU cell shared across layers; the readout
    Σ_f w1(state) · σ(w2(state)). `edge_w` over the pair concat is
    computed as w[:A]·h_i + w[A:]·h_j, which is the same sum without the
    (B, F, F, 2A) pair tensor;
  * EulerNet: r = mu·cos(emb), p = mu·sin(emb); log √(r² + p² + 1e-12)
    and atan2(p, r), one Dropout module (`drop_ex`) applied to both with
    two masks; both mapped by `order_w` (F, F·|order_list|), then
    exp·cos / exp·sin, the other Dropout (`drop_im`) on each, and the
    bias-free Dense `reg` over both flattened. `apply_norm` is read and
    computes nothing, as in JAX.
The index and identity tensors are buffers built once. None of the three
has a first-order twin (their JAX forwards never call it) or declares
`supports_device_epoch`. Only `MLPLayers` (DSSM's towers) follows the
precision policy, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import FieldSpec, LogitModel, dense, raw_param
from oovrec_tpu_torch.models.layers import (
    Dropout,
    GRUCell,
    MLPLayers,
    MultiHeadDotProductAttention,
)


@register_model
class DSSM(LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        mlp_hidden_size: Sequence[int] = (256, 256, 128),
        dropout_prob: float = 0.3,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context(first_order=False)
        n_seq = len(fields.token_seq_names)
        for side, idx in (("user", fields.user_token_idx), ("item", fields.item_token_idx)):
            self.register_buffer(f"_{side}_cells", torch.as_tensor(
                np.asarray(idx, np.int64) + n_seq, device=self.device), persistent=False)
            setattr(self, f"{side}_mlp", MLPLayers(
                (embedding_size * len(idx),) + tuple(mlp_hidden_size), dropout=dropout_prob,
                device=self.device, generator=self.generator))

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        b = emb.shape[0]
        u = self.user_mlp(emb[:, self._user_cells, :].reshape(b, -1), train=train)
        i = self.item_mlp(emb[:, self._item_cells, :].reshape(b, -1), train=train)
        nu = torch.sqrt((u ** 2).sum(dim=1) + 1e-12)
        ni = torch.sqrt((i ** 2).sum(dim=1) + 1e-12)
        return (u * i).sum(dim=1) / (nu * ni)


@register_model
class FiGNN(LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        attention_size: int = 16,
        n_layers: int = 2,
        num_heads: int = 2,
        dropout_probs: Sequence[float] = (0.2, 0.2),
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context(first_order=False)
        a, dev, gen = int(attention_size), self.device, self.generator
        self.n_layers = int(n_layers)
        self.att_embedding = dense(self, embedding_size, a)
        self.self_attn = MultiHeadDotProductAttention(a, int(num_heads), a, device=dev,
                                                      generator=gen)
        self.res_proj = dense(self, embedding_size, a, bias=False)
        self.edge_w = dense(self, 2 * a, 1, bias=False)
        self.gru = GRUCell(a, a, device=dev, generator=gen)
        self.readout_w1 = dense(self, a, 1)
        self.readout_w2 = dense(self, a, 1)
        f = fields.num_feature_field
        self.register_buffer("_eye", torch.eye(f, device=dev), persistent=False)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        b, f, _ = emb.shape
        h0 = torch.relu(self.self_attn(self.att_embedding(emb)) + self.res_proj(emb))  # (B, F, A)
        a = h0.shape[-1]
        w = self.edge_w.weight[0]  # (2A,): [h_i ∥ h_j] · w
        e = (h0 @ w[:a])[:, :, None] + (h0 @ w[a:])[:, None, :]  # (B, F, F)
        e = nn.functional.leaky_relu(e, 0.01) - 1e9 * self._eye[None]
        adj = torch.softmax(e, dim=-1)
        state = h0
        for _ in range(self.n_layers):
            agg = torch.einsum("bfg,bgd->bfd", adj, state)
            new_state, _ = self.gru(state.reshape(b * f, -1), agg.reshape(b * f, -1))
            state = new_state.reshape(b, f, -1) + h0
        return (self.readout_w1(state).squeeze(-1)
                * torch.sigmoid(self.readout_w2(state)).squeeze(-1)).sum(dim=1)


@register_model
class EulerNet(LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        order_list: Sequence[int] = (7,),
        drop_ex: float = 0.3,
        drop_im: float = 0.3,
        apply_norm: bool = False,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context(first_order=False)
        f, n = fields.num_feature_field, len(order_list)
        self.apply_norm = bool(apply_norm)  # read and unused, as in JAX
        self.order_w = raw_param(self, f, f * n)
        self.mu = nn.Parameter(torch.ones(f, device=self.device))
        self.reg = dense(self, 2 * f * n * embedding_size, 1, bias=False)
        self.drop_ex_l = Dropout(drop_ex)
        self.drop_im_l = Dropout(drop_im)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        mu = self.mu[None, :, None]
        r, p = mu * torch.cos(emb), mu * torch.sin(emb)
        log_lam = self.drop_ex_l(torch.log(torch.sqrt(r ** 2 + p ** 2 + 1e-12)), train)
        theta = self.drop_ex_l(torch.atan2(p, r), train)
        o_log = torch.einsum("bfd,fg->bgd", log_lam, self.order_w)
        o_theta = torch.einsum("bfd,fg->bgd", theta, self.order_w)
        r_out = self.drop_im_l(torch.exp(o_log) * torch.cos(o_theta), train)
        p_out = self.drop_im_l(torch.exp(o_log) * torch.sin(o_theta), train)
        b = emb.shape[0]
        both = torch.cat([r_out.reshape(b, -1), p_out.reshape(b, -1)], dim=1)
        return self.reg(both).squeeze(-1)

"""DCNv2.

Port of `oovrec_tpu/models/context_aware/dcnv2.py:23-142` (the reference's
`dcnv2.py:30-267`): a cross network over the flattened field embeddings
x0,

    mixed false:  x_{l+1} = x0 ⊙ (W_l x_l + b_l) + x_l
    mixed true:   low-rank experts on a leading (k) axis,
                  x_{l+1} = x_l + Σ_k g_k(x_l) · x0 ⊙ (U_k tanh(C_k tanh(V_kᵀ x_l)) + b_l),
                  g = softmax over the `gating_<k>` Denses,

and an MLP with batch norm (`MLPLayers(use_bn=True)`), stacked (the MLP
over the cross output) or parallel (the cross output beside the MLP of
x0), into one Dense. `forward` returns the sigmoid; the loss is `bce` on
it plus `reg_weight` · the sum over layers of each cross weight's
Frobenius norm (`_norm2`). The cross network computes in the precision
policy (bf16 operands under `compute_dtype: bfloat16`), the gates'
softmax in f32. The cross weights are drawn N(0, 1) (`normal_init(1.0)`,
the reference's `torch.randn`); a raw (L, d, d) slice is used as
(out, in), so the bridge crosses it untransposed. The model has no
first-order term (the JAX model never calls it, so its tree has none).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import ContextRecommender, FieldSpec
from oovrec_tpu_torch.models.init import normal_init, xavier_normal_
from oovrec_tpu_torch.models.layers import MLPLayers
from oovrec_tpu_torch.models.losses import bce
from oovrec_tpu_torch.utils.precision import compute_dtype


def _norm2(w: torch.Tensor) -> torch.Tensor:
    """RegLoss semantics: the Frobenius norm of each layer's slice, summed."""
    return torch.sqrt((w.reshape(w.shape[0], -1) ** 2).sum(dim=1)).sum()


@register_model
class DCNV2(ContextRecommender):
    # as the JAX model declares; the port's device epoch has no pointwise
    # mode yet (train/device_epoch.py), so `auto` takes the host path
    supports_device_epoch = True

    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 16,
        spec: Optional[InductiveSpec] = None,
        mixed: bool = False,
        structure: str = "stacked",
        cross_layer_num: int = 3,
        expert_num: int = 4,
        low_rank: int = 128,
        mlp_hidden_size: Sequence[int] = (768, 768),
        reg_weight: float = 2.0,
        dropout_prob: float = 0.2,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        if structure not in ("stacked", "parallel"):
            raise ValueError(f"structure must be 'stacked' or 'parallel', not {structure!r}")
        self.mixed, self.structure = bool(mixed), structure
        self.cross_layer_num = int(cross_layer_num)
        self.reg_weight = float(reg_weight)
        self._setup_context(first_order=False)
        d, n_layers, dev, gen = self.in_feature_num, self.cross_layer_num, self.device, self.generator
        init = normal_init(1.0)

        def cross(*shape):
            p = nn.Parameter(torch.empty(shape, device=dev))
            init(p, gen)
            return p

        if self.mixed:
            k, r = int(expert_num), int(low_rank)
            self.cross_layer_u = cross(n_layers, k, d, r)
            self.cross_layer_v = cross(n_layers, k, d, r)
            self.cross_layer_c = cross(n_layers, k, r, r)
            self.gating = []
            for i in range(k):
                g = nn.Linear(d, 1, device=dev)
                xavier_normal_(g.weight, gen)
                nn.init.zeros_(g.bias)
                self.add_module(f"gating_{i}", g)
                self.gating.append(g)
        else:
            self.cross_layer_w = cross(n_layers, d, d)
        self.cross_bias = nn.Parameter(torch.zeros(n_layers, d, device=dev))
        self.mlp_layers = MLPLayers((d,) + tuple(mlp_hidden_size), dropout=dropout_prob,
                                    use_bn=True, device=dev, generator=gen)
        head_in = int(mlp_hidden_size[-1]) + (d if structure == "parallel" else 0)
        self.predict_layer = nn.Linear(head_in, 1, device=dev)
        xavier_normal_(self.predict_layer.weight, gen)
        nn.init.zeros_(self.predict_layer.bias)

    def cross_network(self, x0: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype()
        x0 = x0.to(dt)
        xl = x0
        for i in range(self.cross_layer_num):
            xl_w = xl @ self.cross_layer_w[i].to(dt).T
            xl = x0 * (xl_w + self.cross_bias[i][None, :].to(dt)) + xl
        return xl.float()

    def cross_network_mix(self, x0: torch.Tensor) -> torch.Tensor:
        """The low-rank mixture of experts, the experts batched on a
        leading axis."""
        dt = compute_dtype()
        x0 = x0.to(dt)
        xl = x0
        for i in range(self.cross_layer_num):
            xl_c = torch.tanh(torch.einsum("kdr,bd->bkr", self.cross_layer_v[i].to(dt), xl))
            xl_c = torch.tanh(torch.einsum("krs,bks->bkr", self.cross_layer_c[i].to(dt), xl_c))
            xl_u = torch.einsum("kdr,bkr->bkd", self.cross_layer_u[i].to(dt), xl_c)
            xl_dot = x0[:, None, :] * (xl_u + self.cross_bias[i][None, None, :].to(dt))
            # the gate Denses take the f32 promotion of xl, as flax's do
            gates = torch.cat([g(xl.float()) for g in self.gating], dim=1)  # (B, k)
            gates = torch.softmax(gates, dim=1).to(dt)
            xl = xl + torch.einsum("bkd,bk->bd", xl_dot, gates)
        return xl.float()

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)
        x0 = emb.reshape(emb.shape[0], -1)
        cross = self.cross_network_mix(x0) if self.mixed else self.cross_network(x0)
        if self.structure == "parallel":
            out = self.predict_layer(torch.cat([cross, self.mlp_layers(x0, train=train)], dim=-1))
        else:
            out = self.predict_layer(self.mlp_layers(cross, train=train))
        return torch.sigmoid(out).squeeze(-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        """BCE on the probabilities over the weighted rows + reg_weight ·
        reg, in train mode (dropout on, batch statistics moving)."""
        out = self.forward(batch, train=True)
        if self.mixed:
            reg = (_norm2(self.cross_layer_c) + _norm2(self.cross_layer_v)
                   + _norm2(self.cross_layer_u))
        else:
            reg = _norm2(self.cross_layer_w)
        return bce(out, batch[self.label_field], batch.get("weight")) + self.reg_weight * reg

    def predict(self, batch: Batch) -> torch.Tensor:
        return self.forward(batch, train=False)

"""xDeepFM.

Port of `oovrec_tpu/models/context_aware/xdeepfm.py:19-200`: the CIN
(pairwise Hadamard feature maps + a 1×1 conv over the pair axis per
layer, sum-pooled over D), an MLP over the flattened field embeddings and
the first-order linear term; `predict` is the sigmoid of their sum and
`calculate_loss` is BCE on the logits plus `reg_weight` times a sum of
unsquared Frobenius norms (`_reg_from_scope`).

`fused_cin="auto"` runs each CIN layer through the CUDA kernel
(`ops/cin_fused.py:cin_layer_pooled`) whenever the embeddings lie on the
card, at any width: a layer wider than one launch takes goes through
several (`fwd_plan`, `bwd_plan`), and a shape no split fits raises.
`True` forces the kernel wrapper (on the CPU it takes its plain version);
`False` runs the slab path (`fused_cin_rule`). The JAX rule also asks for
a batch that is a multiple of 128, a limit of its TPU kernel that the
CUDA kernel does not have. The kernel route is differentiable: its
gradient is the CIN backward kernel
(`ops/cin_fused.py:cin_layer_pooled_bwd`); the slab path's is autograd's.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import ContextRecommender, FieldSpec
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.models.layers import MLPLayers
from oovrec_tpu_torch.models.losses import bce_with_logits
from oovrec_tpu_torch.ops.cin_fused import cin_layer_pooled
from oovrec_tpu_torch.utils.precision import compute_dtype


def fused_cin_rule(flag, device_type: str) -> bool:
    """Whether the CIN runs through the kernel wrappers. False / "false":
    the slab path; True / "true": the kernel wrapper; "auto": the kernel
    wrapper on the card, the slab path elsewhere."""
    if flag is False or flag == "false":
        return False
    if flag is True or flag == "true":
        return True
    return device_type == "cuda"


class CinConv(nn.Module):
    """Per-layer CIN conv parameters: `kernel` (H·F, L), pair index
    h·F + f, and `bias` (L,), stored as the flax tree stores them."""

    def __init__(self, in_features: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features, device=device))
        xavier_normal_(self.kernel, generator)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H·F) → (..., L) in the precision policy."""
        dt = compute_dtype()
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


@register_model
class xDeepFM(ContextRecommender):
    # as the JAX model declares: its loss reads only split columns and
    # joined features, which the device epoch's pointwise and plain modes
    # provide (train/device_epoch.py)
    supports_device_epoch = True

    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        mlp_hidden_size: Sequence[int] = (128, 128, 128),
        reg_weight: float = 5e-4,
        dropout_prob: float = 0.2,
        direct: bool = False,
        cin_layer_size: Sequence[int] = (100, 100, 100),
        fused_cin: Any = "auto",
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self.direct = direct
        self.reg_weight = float(reg_weight)
        self.fused_cin = fused_cin
        # non-direct mode keeps every layer at an even size
        # (`xdeepfm.py:50-57` of the reference)
        cin = list(cin_layer_size)
        if not direct:
            cin = [int(x // 2 * 2) for x in cin]
        self._cin_sizes = tuple(cin)

        field_nums = [fields.num_feature_field]
        self.conv1d_list = []
        for i, layer_size in enumerate(self._cin_sizes):
            conv = CinConv(field_nums[0] * field_nums[i], layer_size,
                           device=self.device, generator=self.generator)
            self.add_module(f"conv1d_{i}", conv)
            self.conv1d_list.append(conv)
            field_nums.append(layer_size if direct else layer_size // 2)
        self._field_nums = tuple(field_nums)

        if direct:
            final_len = sum(self._cin_sizes)
        else:
            final_len = sum(self._cin_sizes[:-1]) // 2 + self._cin_sizes[-1]
        self.cin_linear = nn.Linear(final_len, 1, device=self.device)
        xavier_normal_(self.cin_linear.weight, self.generator)
        nn.init.zeros_(self.cin_linear.bias)
        self.mlp_layers = MLPLayers(
            (self.in_feature_num,) + tuple(mlp_hidden_size) + (1,),
            dropout=dropout_prob, device=self.device, generator=self.generator,
        )
        self._setup_context()

    def cin_layer_shapes(self, batch_size: int):
        """(B, H, F, D, L) of each CIN layer at this batch size."""
        f, d = self._field_nums[0], self.embedding_size
        return [(batch_size, h, f, d, l) for h, l in zip(self._field_nums, self._cin_sizes)]

    def _use_fused_cin(self, x: torch.Tensor) -> bool:
        """`fused_cin_rule` for the (B, F, D) embeddings `x`."""
        return fused_cin_rule(self.fused_cin, x.device.type)

    def _layer_modes(self):
        """(n_hidden, pool_all) of each CIN layer."""
        last = len(self._cin_sizes) - 1
        for i, layer_size in enumerate(self._cin_sizes):
            if self.direct:
                yield layer_size, True
            elif i != last:
                yield layer_size // 2, False
            else:
                yield 0, True

    def compressed_interaction_network(self, x: torch.Tensor) -> torch.Tensor:
        """(B, F, D) → (B, final_len) f32: the pooled direct-connect rows of
        every CIN layer (`xdeepfm.py:134-193` of the reference), in the
        precision policy."""
        dt = compute_dtype()
        if self._use_fused_cin(x):
            b0 = x.float().contiguous()
            hidden = b0
            pooled_parts = []
            for conv, (nh, pool_all) in zip(self.conv1d_list, self._layer_modes()):
                hidden, pooled = cin_layer_pooled(
                    hidden, b0, conv.kernel, conv.bias, mxu_dtype=dt,
                    n_hidden=nh, pool_all=pool_all,
                )
                pooled_parts.append(pooled)
            return torch.cat(pooled_parts, dim=1)

        b, _, d = x.shape
        hidden = [x.to(dt)]
        finals = []
        for i, (conv, (nh, pool_all)) in enumerate(
                zip(self.conv1d_list, self._layer_modes())):
            z = torch.einsum("bhd,bmd->bhmd", hidden[-1], hidden[0])
            z = z.reshape(b, self._field_nums[0] * self._field_nums[i], d)
            # conv1d with kernel 1 over channels == dense on the pair axis
            out = torch.relu(conv(z.transpose(1, 2)).transpose(1, 2))
            ps = 0 if pool_all else nh
            finals.append(out[:, ps:])
            if nh:
                hidden.append(out[:, :nh])
        return torch.cat(finals, dim=1).float().sum(dim=-1)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        cin_out = self.cin_linear(self.compressed_interaction_network(emb))
        dnn_out = self.mlp_layers(emb.reshape(emb.shape[0], -1), train=train)
        y = self.first_order_linear(batch, self.embedder_state) + cin_out + dnn_out
        return y.squeeze(-1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        """BCE with logits over the weighted rows + reg_weight · reg, in
        train mode (dropout on), as `xdeepfm.py:174-180` of the JAX
        package."""
        out = self.forward(batch, train=True)
        bce = bce_with_logits(out, batch[self.label_field], batch.get("weight"))
        return bce + self.reg_weight * self._reg_from_scope()

    def _reg_from_scope(self) -> torch.Tensor:
        """Σ ‖W‖ (Frobenius, unsquared) over the CIN conv kernels, the MLP
        Dense kernels (not biases) and every ≥ 2-D leaf of the first-order
        twin (its token, float and OOV bucket tables), in the order of the
        flax tree (`xdeepfm.py:182-197`)."""
        kernels = [conv.kernel for conv in self.conv1d_list]
        kernels += [lin.weight for lin in self.mlp_layers.dense]
        kernels += [p for _, p in sorted(self.first_order_linear.named_parameters())
                    if p.dim() >= 2]
        reg = 0.0
        for k in kernels:
            reg = reg + torch.linalg.vector_norm(k)
        return reg

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self.forward(batch))

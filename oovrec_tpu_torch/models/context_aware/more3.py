"""NFM and KD_DAGFM.

Port of `oovrec_tpu/models/context_aware/more3.py` (the reference's
`nfm.py`, `kd_dagfm.py`):
  * NFM: the bi-interaction 0.5·((Σ_f e)² − Σ_f e²) (B, D) through a
    BatchNorm `bn` (momentum 0.9, not MLPLayers' 0.99), then per hidden
    width a Dense `mlp_<i>`, a BatchNorm `mlp_bn_<i>` (momentum 0.9), a
    sigmoid and dropout; a bias-free `predict_layer` plus the first-order
    term. Its Denses and BatchNorms keep f32 under any precision policy
    (they are not `MLPLayers`), as in JAX;
  * KD_DAGFM: a DAGFM student (`_DAGFMCore`: `connect_layer` (F, F) from
    the identity, per depth `p_<i>` (F, F, D) masked by the upper triangle
    and, for the outer interaction, `q_<i>`; the per-depth states summed
    over D into the Dense `out`) and a CrossNet teacher
    (`_CrossNetTeacher`: x = x0 · cross_i(x) + x, then `out`). `phase`
    picks the loss: `teacher_training` BCE on the teacher,
    `finetuning` BCE on the student, `distillation`
    α·BCE(student) + β·Σ w·(t − s)² / max(Σ w, 1) with the teacher's logit
    detached (JAX's stop_gradient). Both nets are built in every phase;
    the teacher's parameters get no gradient outside `teacher_training`
    and the student's none inside it (a zero gradient in the trainer, as
    in JAX). `forward` is the teacher's logit in `teacher_training`, the
    student's otherwise.
The upper-triangle mask and the identity are built once. Neither model
declares `supports_device_epoch` (the JAX ones do not).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import FieldSpec, LogitModel, dense
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.models.layers import BatchNorm, Dropout
from oovrec_tpu_torch.models.losses import _wmean, bce_with_logits


def fm_no_reduce(emb: torch.Tensor) -> torch.Tensor:
    """Bi-interaction pooling (`more3.py:20-26` of the JAX package):
    (B, F, D) → 0.5 · ((Σ_f e)² − Σ_f e²), (B, D)."""
    return 0.5 * (emb.sum(dim=1) ** 2 - (emb ** 2).sum(dim=1))


@register_model
class NFM(LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        mlp_hidden_size: Sequence[int] = (64, 32, 16),
        dropout_prob: float = 0.2,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        self._setup_context()
        dev = self.device
        self.bn = BatchNorm(embedding_size, momentum=0.9, device=dev)
        self.hidden, self.bns = [], []
        widths = (embedding_size,) + tuple(int(h) for h in mlp_hidden_size)
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            lin = dense(self, n_in, n_out)
            bn = BatchNorm(n_out, momentum=0.9, device=dev)
            self.add_module(f"mlp_{i}", lin)
            self.add_module(f"mlp_bn_{i}", bn)
            self.hidden.append(lin)
            self.bns.append(bn)
        self.drop = Dropout(dropout_prob)
        self.predict_layer = dense(self, widths[-1], 1, bias=False)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        h = self.bn(fm_no_reduce(emb), train)
        for lin, bn in zip(self.hidden, self.bns):
            h = self.drop(torch.sigmoid(bn(lin(h), train)), train)
        out = self.predict_layer(h) + self.first_order_linear(batch, self.embedder_state)
        return out.squeeze(-1)


class _DAGFMCore(nn.Module):
    """The DAGFM student (`more3.py:71-101` of the JAX package)."""

    def __init__(self, field_num: int, embedding_size: int, depth: int = 3,
                 interaction_type: str = "inner", device=None, generator=None):
        super().__init__()
        if interaction_type not in ("inner", "outer"):
            raise ValueError(f"interaction_type must be 'inner' or 'outer', "
                             f"not {interaction_type!r}")
        f, d = field_num, embedding_size
        self.depth, self.interaction_type = int(depth), interaction_type
        self.connect_layer = nn.Parameter(torch.eye(f, device=device))
        self.register_buffer("_adj", torch.triu(torch.ones(f, f, device=device))[:, :, None],
                             persistent=False)
        names = ("p", "q") if interaction_type == "outer" else ("p",)
        for i in range(self.depth):
            for n in names:
                p = nn.Parameter(torch.empty(f, f, d, device=device))
                xavier_normal_(p, generator)
                self.register_parameter(f"{n}_{i}", p)
        self.out = nn.Linear(f * (self.depth + 1), 1, device=device)
        xavier_normal_(self.out.weight, generator)
        nn.init.zeros_(self.out.bias)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        h0 = torch.einsum("fg,bgd->bfd", self.connect_layer, feature)
        ht = h0
        states = [h0.sum(dim=-1)]
        for i in range(self.depth):
            p = getattr(self, f"p_{i}") * self._adj
            if self.interaction_type == "inner":
                aggr = torch.einsum("bfd,fsd->bsd", ht, p)
            else:
                term = torch.einsum("bfd,fsd->bfs", ht, p)
                aggr = torch.einsum("bfs,fsd->bsd", term, getattr(self, f"q_{i}"))
            ht = h0 * aggr
            states.append(ht.sum(dim=-1))
        return self.out(torch.cat(states, dim=-1)).squeeze(-1)


class _CrossNetTeacher(nn.Module):
    """The CrossNet teacher (`more3.py:104-119` of the JAX package)."""

    def __init__(self, in_dim: int, depth: int = 2, device=None, generator=None):
        super().__init__()
        self.cross = []
        for i in range(int(depth)):
            lin = nn.Linear(in_dim, in_dim, device=device)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"cross_{i}", lin)
            self.cross.append(lin)
        self.out = nn.Linear(in_dim, 1, device=device)
        xavier_normal_(self.out.weight, generator)
        nn.init.zeros_(self.out.bias)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for lin in self.cross:
            x = x0 * lin(x) + x
        return self.out(x).squeeze(-1)


PHASES = ("teacher_training", "distillation", "finetuning")


@register_model
class KD_DAGFM(LogitModel):
    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        phase: str = "teacher_training",
        alpha: float = 0.1,
        beta: float = 1.0,
        depth: int = 3,
        interaction_type: str = "inner",
        teacher_depth: int = 2,
        **kwargs,
    ):
        super().__init__(fields, embedding_size, spec, **kwargs)
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, not {phase!r}")
        self.phase, self.alpha, self.beta = phase, float(alpha), float(beta)
        self._setup_context(first_order=False)
        f = fields.num_feature_field
        self.student = _DAGFMCore(f, embedding_size, depth, interaction_type,
                                  device=self.device, generator=self.generator)
        self.teacher = _CrossNetTeacher(f * embedding_size, teacher_depth,
                                        device=self.device, generator=self.generator)

    def forward(self, batch: Batch, train: Optional[bool] = None) -> torch.Tensor:
        emb = self.concat_embed_input_fields(batch)  # (B, F, D)
        if self.phase == "teacher_training":
            return self.teacher(emb.reshape(emb.shape[0], -1))
        return self.student(emb)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        if self.phase != "distillation":
            return super().calculate_loss(batch)
        label, w = batch[self.label_field], batch.get("weight")
        emb = self.concat_embed_input_fields(batch)
        t = self.teacher(emb.reshape(emb.shape[0], -1))
        s = self.student(emb)
        kd = (t.detach() - s) ** 2
        return self.alpha * bce_with_logits(s, label, w) + self.beta * _wmean(kd, w)

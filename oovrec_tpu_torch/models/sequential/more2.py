"""HGN, FOSSIL and TransRec.

Port of `oovrec_tpu/models/sequential/more2.py:18-195`:
  * HGN: feature gating σ(w1(x) + w2(u) + b_g), instance gating
    σ(w3(x_f) + u·w4_kernel) (the raw leaves `b_g` (D,) and `w4_kernel`
    (D, L)) inside the sequence, pooled by `pool_type` (`average`: over
    the gates' sum, floored at 1e-12; `max`: the padding at −1e9), plus
    the user and the sum of the raw item rows;
  * FOSSIL: no `item_embedding`. The tables are `item_src` (the
    sequence side) and `item_dst` (the scored side): the mean of the
    sequence's `item_src` rows over count^alpha, plus the last
    `order_len` items weighted by `user_lambda` + the raw
    `global_lambda` (both zero at init); its own CE loss, `predict` and
    full sort against `item_dst`;
  * TransRec: pairwise BPR over item_bias − ‖last + t_u − item‖, t_u the
    user's `user_t` row plus the raw `global_t`, the raw `item_bias`
    (n_items,). The score takes the direct squared distance; the full
    sort the expanded |q|² + |e|² − 2q·e, each where the JAX package has
    it. Both floor the square at 1e-12 before the root. The host path,
    as in the JAX package (no `supports_device_epoch`).
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.losses import bpr_loss
from oovrec_tpu_torch.models.sequential.base import (
    SequentialRecommender,
    ce_loss,
    inside,
    last_item,
)
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import InputType


def _zeros(weight, generator=None):
    with torch.no_grad():
        return weight.zero_()


def recent(seq: torch.Tensor, lengths: torch.Tensor, K: int):
    """The last K items of each row, the latest first, and whether each
    lies inside the sequence: (B, K) ids (clipped into [0, L)) and (B, K)
    bool."""
    back = lengths.long()[:, None] - 1 - torch.arange(K, device=seq.device)[None, :]
    return seq.gather(1, back.clamp(0, seq.shape[1] - 1)), back >= 0


@register_model
class HGN(SequentialRecommender):
    def __init__(self, *args, pool_type: str = "average", **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.pool_type = pool_type
        self.user_embedding = self._embed_table(self.n_users)
        self.item_embedding = self._embed_table(self.n_items)
        self.w1 = dense(self, D, D, bias=False)
        self.w2 = dense(self, D, D, bias=False)
        self.b_g = raw_param(self, D, init=_zeros)
        self.w3 = dense(self, D, 1, bias=False)
        self.w4_kernel = raw_param(self, D, self.max_seq_length)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        u = gather_rows(self.user_embedding.weight, batch[self.uid_field])
        x = gather_rows(self.item_embedding.weight, seq)  # (B, L, D)
        mask = inside(seq, lengths)
        xf = x * torch.sigmoid(self.w1(x) + self.w2(u)[:, None, :] + self.b_g)
        ig = torch.sigmoid(self.w3(xf).squeeze(-1) + u @ self.w4_kernel) * mask
        xi = xf * ig[:, :, None]
        if self.pool_type == "max":
            pooled = (xi - (1 - mask[:, :, None]) * 1e9).amax(dim=1)
        else:
            pooled = xi.sum(dim=1) / torch.clamp(ig.sum(dim=1, keepdim=True), min=1e-12)
        return u + pooled + (x * mask[:, :, None]).sum(dim=1)


@register_model
class FOSSIL(SequentialRecommender):
    def __init__(self, *args, order_len: int = 3, alpha: float = 0.6, reg_weight: float = 0.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.order_len, self.alpha = int(order_len), float(alpha)
        self.item_src = self._embed_table(self.n_items)
        self.item_dst = self._embed_table(self.n_items)
        self.user_lambda = torch.nn.Embedding(self.n_users, self.order_len, device=self.device)
        _zeros(self.user_lambda.weight)
        self.global_lambda = raw_param(self, self.order_len, init=_zeros)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        mask = inside(seq, lengths)
        src = gather_rows(self.item_src.weight, seq) * mask[:, :, None]
        cnt = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        sim = src.sum(dim=1) / cnt ** self.alpha
        lam = gather_rows(self.user_lambda.weight, batch[self.uid_field]) + self.global_lambda
        ids, valid = recent(seq, lengths, self.order_len)
        markov = (gather_rows(self.item_src.weight, ids) * (lam * valid)[:, :, None]).sum(dim=1)
        return sim + markov

    def full_sort_scores(self, batch):
        return self.seq_output(batch) @ self.item_dst.weight.T

    def predict(self, batch):
        return (self.seq_output(batch)
                * gather_rows(self.item_dst.weight, batch[self.iid_field])).sum(dim=1)

    def calculate_loss(self, batch):
        return ce_loss(self.seq_output(batch, train=True) @ self.item_dst.weight.T,
                       batch[self.iid_field], batch.get("weight"))


@register_model
class TransRec(SequentialRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, *args, loss_type: str = "BPR", **kwargs):
        super().__init__(*args, loss_type=loss_type, **kwargs)
        D = self.embedding_size
        self.item_embedding = self._embed_table(self.n_items)
        self.user_t = self._embed_table(self.n_users)
        self.global_t = raw_param(self, D, init=_zeros)
        self.item_bias = raw_param(self, self.n_items, init=_zeros)

    def _query(self, batch) -> torch.Tensor:
        """(B, D): the last item's row translated by the user's vector."""
        seq, lengths = self._sequence(batch)
        t = gather_rows(self.user_t.weight, batch[self.uid_field]) + self.global_t
        return gather_rows(self.item_embedding.weight, last_item(seq, lengths)) + t

    def _score(self, query, items):
        d = ((query - gather_rows(self.item_embedding.weight, items)) ** 2).sum(dim=-1)
        return self.item_bias[items.long()] - torch.sqrt(torch.clamp(d, min=1e-12))

    def calculate_loss(self, batch):
        q = self._query(batch)
        return bpr_loss(self._score(q, batch[self.iid_field]),
                        self._score(q, batch[self.neg_prefix + self.iid_field]),
                        batch.get("weight"))

    def predict(self, batch):
        return self._score(self._query(batch), batch[self.iid_field])

    def full_sort_scores(self, batch):
        q = self._query(batch)
        dst = self.item_embedding.weight
        d = (q ** 2).sum(dim=1)[:, None] + (dst ** 2).sum(dim=1)[None, :] - 2 * q @ dst.T
        return self.item_bias[None, :] - torch.sqrt(torch.clamp(d, min=1e-12))

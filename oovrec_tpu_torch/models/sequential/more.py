"""NARM, STAMP and FPMC.

Port of `oovrec_tpu/models/sequential/more.py:19-170`:
  * NARM: a scanned GRU over the item embeddings; the last state (global)
    and an additive attention over the states inside the sequence (local)
    concatenated and projected by `b`;
  * STAMP: attention over the item embeddings from the last click, the
    sequence mean and a raw bias `b_a`; tanh(mlp_a) · tanh(mlp_b);
  * FPMC: pairwise BPR over four tables, user·item (`UI`, `IU`) plus
    last item·item (`LI`, `IL`). It takes the host path, as in the JAX
    package (no `supports_device_epoch`).
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.layers import Dropout, GRUCell, gru_scan
from oovrec_tpu_torch.models.losses import bpr_loss
from oovrec_tpu_torch.models.sequential.base import (
    SequentialRecommender,
    gather_last,
    inside,
    last_item,
)
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import InputType


@register_model
class NARM(SequentialRecommender):
    # the loss reads only split columns (+ a sampled negative): device-epoch OK
    supports_device_epoch = True

    def __init__(self, *args, hidden_size: int = 128, dropout_probs: tuple = (0.25, 0.5),
                 **kwargs):
        super().__init__(*args, **kwargs)
        D, H = self.embedding_size, hidden_size
        self.item_embedding = self._embed_table(self.n_items)
        self.gru = GRUCell(D, H, device=self.device, generator=self.generator)
        self.a1 = dense(self, H, H, bias=False)
        self.a2 = dense(self, H, H, bias=False)
        self.v = dense(self, H, 1, bias=False)
        self.b = dense(self, 2 * H, D, bias=False)
        self.emb_dropout = Dropout(dropout_probs[0])
        self.ct_dropout = Dropout(dropout_probs[1])

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        x = self.emb_dropout(gather_rows(self.item_embedding.weight, seq), train)
        _, states = gru_scan(self.gru, x, x.new_zeros(x.shape[0], self.gru.features))
        ht = gather_last(states, lengths)
        q = self.v(torch.sigmoid(self.a1(ht)[:, None, :] + self.a2(states))).squeeze(-1)
        c_local = ((q * inside(seq, lengths))[:, :, None] * states).sum(dim=1)
        c = self.ct_dropout(torch.cat([ht, c_local], dim=1), train)
        return self.b(c)


@register_model
class STAMP(SequentialRecommender):
    # the loss reads only split columns (+ a sampled negative): device-epoch OK
    supports_device_epoch = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.item_embedding = self._embed_table(self.n_items)
        self.w1 = dense(self, D, D, bias=False)
        self.w2 = dense(self, D, D, bias=False)
        self.w3 = dense(self, D, D, bias=False)
        self.w0 = dense(self, D, 1, bias=False)
        self.b_a = torch.nn.Parameter(torch.zeros(D, device=self.device))
        self.mlp_a = dense(self, D, D)
        self.mlp_b = dense(self, D, D)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        x = gather_rows(self.item_embedding.weight, seq)  # (B, L, D)
        mask = inside(seq, lengths)
        last = gather_last(x, lengths)
        ms = (x * mask[:, :, None]).sum(dim=1) / torch.clamp(
            lengths[:, None].float(), min=1.0)
        q = self.w0(torch.sigmoid(self.w1(x) + self.w2(last)[:, None, :]
                                  + self.w3(ms)[:, None, :] + self.b_a)).squeeze(-1)
        ma = ((q * mask)[:, :, None] * x).sum(dim=1) + ms
        return torch.tanh(self.mlp_a(ma)) * torch.tanh(self.mlp_b(last))


@register_model
class FPMC(SequentialRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, *args, loss_type: str = "BPR", **kwargs):
        super().__init__(*args, loss_type=loss_type, **kwargs)
        self.UI = self._embed_table(self.n_users)
        self.IU = self._embed_table(self.n_items)
        self.LI = self._embed_table(self.n_items)
        self.IL = self._embed_table(self.n_items)

    def _score(self, user, last, items):
        mf = (gather_rows(self.UI.weight, user) * gather_rows(self.IU.weight, items)).sum(-1)
        fmc = (gather_rows(self.LI.weight, last) * gather_rows(self.IL.weight, items)).sum(-1)
        return mf + fmc

    def _last_item(self, batch):
        return last_item(*self._sequence(batch))

    def calculate_loss(self, batch):
        user, last = batch[self.uid_field], self._last_item(batch)
        return bpr_loss(self._score(user, last, batch[self.iid_field]),
                        self._score(user, last, batch[self.neg_prefix + self.iid_field]),
                        batch.get("weight"))

    def predict(self, batch):
        return self._score(batch[self.uid_field], self._last_item(batch),
                           batch[self.iid_field])

    def full_sort_scores(self, batch):
        user, last = batch[self.uid_field].long(), self._last_item(batch).long()
        return self.UI.weight[user] @ self.IU.weight.T + self.LI.weight[last] @ self.IL.weight.T

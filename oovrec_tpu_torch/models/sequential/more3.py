"""SHAN, NPE, HRM and CORE.

Port of `oovrec_tpu/models/sequential/more3.py:17-227`:
  * SHAN: a long-term attention over the whole sequence, personalised by
    the user (relu(`long_w`(x)) · u, the padding at −1e9), then a
    short-term one over [long-term, the last `short_item_length` items]
    through `short_w`. The last items come from the
    `Inverse_item_id_list` tail (latest first) when the
    `inverse_itemseq` transform put it in the batch, else by index from
    the sequence: the same items either way;
  * NPE: relu(user) + relu(Σ the sequence's rows), dropout, scored
    against relu(`item_ctx`), with its own CE loss;
  * HRM: the last `high_order` items (dropout on them) pooled by
    `pooling_type_layer_1`, then stacked with the user and pooled by
    `pooling_type_layer_2` (`avg` or `max`);
  * CORE: a weighted mean of the sequence's rows (`ave`: uniform inside
    the sequence; `trm`: a softmax of `w_att`), L2-normalised with ε
    inside the square root (`:201`, `:206`), against the normalised item
    rows over `temperature`. `item_dropout` is read and never applied,
    as in the JAX package; `w_att` exists under `trm` alone, as in the
    flax tree.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.layers import Dropout
from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, ce_loss, inside
from oovrec_tpu_torch.models.sequential.more2 import recent
from oovrec_tpu_torch.ops.embed_grad import gather_rows


@register_model
class SHAN(SequentialRecommender):
    def __init__(self, *args, short_item_length: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.short_item_length = int(short_item_length)
        self.user_embedding = self._embed_table(self.n_users)
        self.item_embedding = self._embed_table(self.n_items)
        self.long_w = dense(self, D, D)
        self.short_w = dense(self, D, D)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        u = gather_rows(self.user_embedding.weight, batch[self.uid_field])
        x = gather_rows(self.item_embedding.weight, seq)
        L, K = seq.shape[1], self.short_item_length
        mask = inside(seq, lengths) > 0
        al = (torch.relu(self.long_w(x)) * u[:, None, :]).sum(dim=-1).masked_fill(~mask, -1e9)
        long_repr = (torch.softmax(al, dim=1)[:, :, None] * x).sum(dim=1)
        ids, valid = recent(seq, lengths, K)
        inv = batch.get("Inverse_" + self.list_field)
        if inv is not None and L >= K:
            ids = inv[:, -K:].flip(1)
        cat = torch.cat([long_repr[:, None, :], gather_rows(self.item_embedding.weight, ids)],
                        dim=1)
        cmask = torch.cat([torch.ones_like(valid[:, :1]), valid], dim=1)
        a = (torch.relu(self.short_w(cat)) * u[:, None, :]).sum(dim=-1).masked_fill(~cmask, -1e9)
        return (torch.softmax(a, dim=1)[:, :, None] * cat).sum(dim=1)


@register_model
class NPE(SequentialRecommender):
    def __init__(self, *args, dropout_prob: float = 0.3, **kwargs):
        super().__init__(*args, **kwargs)
        self.user_embedding = self._embed_table(self.n_users)
        self.item_embedding = self._embed_table(self.n_items)
        self.item_ctx = self._embed_table(self.n_items)
        self.drop = Dropout(dropout_prob)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        mask = inside(seq, lengths)
        u = torch.relu(gather_rows(self.user_embedding.weight, batch[self.uid_field]))
        hist = torch.relu((gather_rows(self.item_embedding.weight, seq)
                           * mask[:, :, None]).sum(dim=1))
        return self.drop(u + hist, train)

    def full_sort_scores(self, batch):
        return self.seq_output(batch) @ torch.relu(self.item_ctx.weight).T

    def predict(self, batch):
        ctx = torch.relu(gather_rows(self.item_ctx.weight, batch[self.iid_field]))
        return (self.seq_output(batch) * ctx).sum(dim=1)

    def calculate_loss(self, batch):
        return ce_loss(self.seq_output(batch, train=True) @ torch.relu(self.item_ctx.weight).T,
                       batch[self.iid_field], batch.get("weight"))


@register_model
class HRM(SequentialRecommender):
    def __init__(self, *args, high_order: int = 2, pooling_type_layer_1: str = "max",
                 pooling_type_layer_2: str = "max", dropout_prob: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        self.high_order = int(high_order)
        self.pooling = (pooling_type_layer_1, pooling_type_layer_2)
        self.user_embedding = self._embed_table(self.n_users)
        self.item_embedding = self._embed_table(self.n_items)
        self.drop = Dropout(dropout_prob)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        ids, valid = recent(seq, lengths, self.high_order)
        win = self.drop(gather_rows(self.item_embedding.weight, ids), train)
        vf = valid.float()[:, :, None]
        if self.pooling[0] == "avg":
            l1 = (win * vf).sum(dim=1) / torch.clamp(vf.sum(dim=1), min=1.0)
        else:
            l1 = (win - (1 - vf) * 1e9).amax(dim=1)
        u = gather_rows(self.user_embedding.weight, batch[self.uid_field])
        both = torch.stack([u, l1], dim=1)
        return both.mean(dim=1) if self.pooling[1] == "avg" else both.amax(dim=1)


def _l2_normalised(x: torch.Tensor) -> torch.Tensor:
    """x / √(Σx² + 1e-12): finite, with a finite gradient, at 0."""
    return x / torch.sqrt((x ** 2).sum(dim=-1, keepdim=True) + 1e-12)


@register_model
class CORE(SequentialRecommender):
    def __init__(self, *args, dnn_type: str = "ave", temperature: float = 0.07,
                 item_dropout: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        self.dnn_type, self.temperature = dnn_type, float(temperature)
        self.item_embedding = self._embed_table(self.n_items)
        if dnn_type == "trm":  # flax creates `w_att` where it is called
            self.w_att = dense(self, self.embedding_size, 1)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        mask = inside(seq, lengths)
        x = gather_rows(self.item_embedding.weight, seq)
        if self.dnn_type == "trm":
            alpha = torch.softmax(self.w_att(x).squeeze(-1).masked_fill(mask == 0, -1e9), dim=1)
        else:
            alpha = mask / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        return _l2_normalised((alpha[:, :, None] * x).sum(dim=1))

    def calculate_loss(self, batch):
        return ce_loss(self._scores(self.seq_output(batch, train=True)), batch[self.iid_field],
                       batch.get("weight"))

    def _scores(self, out: torch.Tensor) -> torch.Tensor:
        return out @ _l2_normalised(self.item_embedding.weight).T / self.temperature

    def full_sort_scores(self, batch):
        return self._scores(self.seq_output(batch))

    def predict(self, batch):
        items = gather_rows(self.item_embedding.weight, batch[self.iid_field])
        return (self.seq_output(batch) * _l2_normalised(items)).sum(dim=1) / self.temperature

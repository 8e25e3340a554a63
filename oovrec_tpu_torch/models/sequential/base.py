"""Sequential recommender base.

Port of `oovrec_tpu/models/sequential/base.py:18-81`: a model reads the
item sequence `item_id_list` (B, L) and its `item_length` and gives a
(B, D) representation (`seq_output`); the base scores it against the item
table:
  * `calculate_loss`: CE over the full item softmax (`out @ tableᵀ`, a
    plain product that the JAX package also computes outside Pallas, then
    `log_softmax`), weighted by `weight`; or, under `loss_type: BPR`, BPR
    against the batch's sampled negative;
  * `predict`: the score of the batch's item; `full_sort_scores`: every
    item's.
`gather_last` takes the state at max(length − 1, 0), the lengths read on
the device (a gather, no host read), so a step stays capturable. Every
lookup of an item sequence goes through `ops/embed_grad.py:gather_rows`,
whose backward is the hand-written segment-sum kernel on the card: the
lists are mostly 0-padding, which torch's `index` backward adds one copy
after another.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import Batch, GeneralRecommender
from oovrec_tpu_torch.models.losses import _wmean, bpr_loss
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import ModelType


def inside(seq: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, L) float: 1 at the positions before each row's length."""
    L = seq.shape[1]
    return (torch.arange(L, device=seq.device)[None, :] < lengths[:, None]).float()


def last_item(seq: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B,): each row's item at max(length − 1, 0)."""
    return seq.gather(1, torch.clamp(lengths.long() - 1, min=0)[:, None]).squeeze(1)


def ce_loss(logits: torch.Tensor, pos: torch.Tensor, w=None) -> torch.Tensor:
    """CE of (B, n_items) logits at the targets `pos`, weighted by `w`."""
    logp = torch.log_softmax(logits, dim=-1)
    return _wmean(-logp.gather(1, pos.long()[:, None]).squeeze(1), w)


def gather_last(states: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, L, D) → (B, D): each row's state at max(length − 1, 0)."""
    idx = torch.clamp(lengths.long() - 1, min=0)
    return states.gather(1, idx[:, None, None].expand(-1, 1, states.shape[-1])).squeeze(1)


class SequentialRecommender(GeneralRecommender):
    """The sequential base: the item table `item_embedding` (n_items rows,
    xavier-normal), the loss and the scores; `seq_output` is each
    model's."""

    model_type = ModelType.SEQUENTIAL

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 max_seq_length: int = 50, loss_type: str = "CE",
                 list_suffix: str = "_list", length_field: str = "item_length",
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.max_seq_length = int(max_seq_length)
        self.loss_type = loss_type
        self.list_field = self.iid_field + list_suffix
        self.length_field = length_field

    def seq_output(self, batch: Batch, train: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def _sequence(self, batch: Batch):
        return batch[self.list_field], batch[self.length_field]

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        out = self.seq_output(batch, train=True)
        table = self.item_embedding.weight
        pos, w = batch[self.iid_field], batch.get("weight")
        if self.loss_type == "BPR":
            neg = batch[self.neg_prefix + self.iid_field]
            return bpr_loss((out * gather_rows(table, pos)).sum(dim=1),
                            (out * gather_rows(table, neg)).sum(dim=1), w)
        return ce_loss(out @ table.T, pos, w)

    def predict(self, batch: Batch) -> torch.Tensor:
        out = self.seq_output(batch)
        return (out * self.item_embedding.weight[batch[self.iid_field].long()]).sum(dim=1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        return self.seq_output(batch) @ self.item_embedding.weight.T

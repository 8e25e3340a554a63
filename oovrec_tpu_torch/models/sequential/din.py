"""DIN and DIEN: the target item's attention over the behavior sequence.

Port of `oovrec_tpu/models/sequential/din.py:26-204`. Both are pointwise
click models under `bce_with_logits`, trained with sampled negatives
(the batch's `label`):
  * DIN: `att_<i>` (sigmoid) and `att_out` score each position from
    [h, t, h − t, h ⊙ t]; a softmax over the positions inside the
    sequence (the others at −1e9) pools the behaviors; [interest, target,
    user] through `mlp_layers` (sigmoid) and `predict_layer` give the
    logit. `predict` is its sigmoid;
  * DIEN: the behaviors are the states of `interest_gru`, a flax
    `GRUCell` scanned over all L positions from a zero carry (the padding
    too); its auxiliary loss, weighted by `alpha`, asks each state h_t
    inside the sequence to score the next item above a negative: the
    batch's presampled `neg_item_id_list` (`dien_neg_sampling:
    presampled`), else a uniform draw in [1, n_items) with the collision
    bump of `:185-188`, from the trainer's dropout generator
    (`models/layers.py:RandomDraws`; a draw from another generator would
    break a CUDA-graph capture). The states are computed once a step and
    serve both losses (the JAX package scans the GRU twice, to the same
    values).

`full_sort_scores` scores every item as the target, as the JAX vmap
does, but over blocks of targets: a block holds at most
`full_sort_elems` elements of the (B, T, L, 4D) attention input. The
vmap materialises it for all n_items at once (about 48 GB at 256 users,
3,706 items, L 50, D 64). The logits are the same function.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import register_model, score_item_blocks
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.layers import GRUCell, MLPLayers, RandomDraws, gru_scan
from oovrec_tpu_torch.models.losses import bce_with_logits
from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, inside
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.parallel.train_step import batch_wmean
from oovrec_tpu_torch.utils.enums import InputType


@register_model
class DIN(SequentialRecommender):
    input_type = InputType.POINTWISE
    full_sort_elems = 1 << 26

    def __init__(self, *args, loss_type: str = "BCE", label_field: str = "label",
                 mlp_hidden_size: tuple = (256, 256, 256), att_hidden: tuple = (80, 40),
                 dropout_prob: float = 0.0, **kwargs):
        super().__init__(*args, loss_type=loss_type, **kwargs)
        D = self.embedding_size
        self.label_field = label_field
        self.item_embedding = self._embed_table(self.n_items)
        self.user_embedding = self._embed_table(self.n_users)
        widths = (4 * D,) + tuple(att_hidden)
        self.att_layers = []
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            lin = dense(self, n_in, n_out)
            self.add_module(f"att_{i}", lin)
            self.att_layers.append(lin)
        self.att_out = dense(self, widths[-1], 1)
        self.mlp_layers = MLPLayers((3 * D,) + tuple(mlp_hidden_size), dropout=dropout_prob,
                                    activation="sigmoid", device=self.device,
                                    generator=self.generator)
        self.predict_layer = dense(self, tuple(mlp_hidden_size)[-1], 1)

    def _behavior_repr(self, seq_e: torch.Tensor) -> torch.Tensor:
        """Hook: DIEN replaces the behaviors' embeddings with GRU states."""
        return seq_e

    def _attention_pool(self, seq_h: torch.Tensor, target_e: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        """(B, L, D) behaviors, (B, T, D) targets → (B, T, D) interests."""
        t = target_e[:, :, None, :].expand(-1, -1, seq_h.shape[1], -1)
        h = seq_h[:, None].expand_as(t)
        x = torch.cat([h, t, h - t, h * t], dim=-1)
        for lin in self.att_layers:
            x = torch.sigmoid(lin(x))
        w = self.att_out(x).squeeze(-1).masked_fill(~mask[:, None, :], -1e9)
        return torch.einsum("btl,bld->btd", torch.softmax(w, dim=-1), seq_h)

    def _click(self, interest, target_e, u, train: bool) -> torch.Tensor:
        """(B, T, D) interests and targets, (B, D) users → (B, T) logits."""
        x = torch.cat([interest, target_e, u[:, None].expand_as(target_e)], dim=-1)
        return self.predict_layer(self.mlp_layers(x, train=train)).squeeze(-1)

    def _forward(self, batch, train: bool):
        """→ (logits (B,), the behaviors' embeddings, their representation)."""
        seq, lengths = self._sequence(batch)
        seq_e = gather_rows(self.item_embedding.weight, seq)
        seq_h = self._behavior_repr(seq_e)
        target_e = gather_rows(self.item_embedding.weight, batch[self.iid_field])[:, None]
        interest = self._attention_pool(seq_h, target_e, inside(seq, lengths) > 0)
        u = gather_rows(self.user_embedding.weight, batch[self.uid_field])
        return self._click(interest, target_e, u, train).squeeze(1), seq_e, seq_h

    def forward(self, batch, train: bool = False) -> torch.Tensor:
        return self._forward(batch, train)[0]

    def calculate_loss(self, batch):
        return bce_with_logits(self.forward(batch, train=True), batch[self.label_field],
                               batch.get("weight"))

    def predict(self, batch):
        return torch.sigmoid(self.forward(batch))

    def _context(self, batch):
        """What every target of a row shares: (behaviors, mask, user)."""
        seq, lengths = self._sequence(batch)
        seq_h = self._behavior_repr(gather_rows(self.item_embedding.weight, seq))
        return (seq_h, inside(seq, lengths) > 0,
                gather_rows(self.user_embedding.weight, batch[self.uid_field]))

    def _score_block(self, context, items: torch.Tensor) -> torch.Tensor:
        seq_h, mask, u = context
        te = self.item_embedding.weight[items][None].expand(seq_h.shape[0], -1, -1)
        return self._click(self._attention_pool(seq_h, te, mask), te, u, False)

    def score_items(self, batch, items: torch.Tensor) -> torch.Tensor:
        """(B, T) logits of each of the (T,) `items` as the target, in one
        block."""
        return self._score_block(self._context(batch), items)

    def full_sort_scores(self, batch):
        """(B, n_items) logits, every item the target, over blocks of
        targets."""
        context = self._context(batch)
        B, L = context[1].shape
        return score_item_blocks(self.n_items, B * L * 4 * self.embedding_size,
                                 context[0].device,
                                 lambda items: self._score_block(context, items),
                                 budget=self.full_sort_elems)


@register_model
class DIEN(DIN):
    def __init__(self, *args, alpha: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.alpha = float(alpha)
        self.interest_gru = GRUCell(D, D, device=self.device, generator=self.generator)
        self.neg_draws = RandomDraws()

    def _behavior_repr(self, seq_e):
        carry = seq_e.new_zeros(seq_e.shape[0], seq_e.shape[-1])
        return gru_scan(self.interest_gru, seq_e, carry)[1]

    def _aux_loss(self, batch, seq_e, seq_h) -> torch.Tensor:
        """BCE of h_t · e(seq_{t+1}) against h_t · e(neg_{t+1}), over the
        positions t where t and t + 1 lie inside the sequence."""
        seq, lengths = self._sequence(batch)
        L = seq.shape[1]
        neg = batch.get(self.neg_prefix + self.list_field)
        if neg is None:
            neg = self.neg_draws.randint(1, self.n_items, seq.shape, seq.device)
            neg = torch.where(neg == seq, neg % (self.n_items - 1) + 1, neg)
        h = seq_h[:, :-1]
        pos_s = (h * seq_e[:, 1:]).sum(dim=-1)
        neg_s = (h * gather_rows(self.item_embedding.weight, neg[:, 1:])).sum(dim=-1)
        valid = (torch.arange(L - 1, device=seq.device)[None, :] + 1
                 < lengths[:, None]).to(h.dtype)
        per = -(torch.nn.functional.logsigmoid(pos_s) + torch.nn.functional.logsigmoid(-neg_s))
        return batch_wmean(per, valid)  # over the global batch's positions

    def calculate_loss(self, batch):
        logits, seq_e, seq_h = self._forward(batch, train=True)
        base = bce_with_logits(logits, batch[self.label_field], batch.get("weight"))
        return base + self.alpha * self._aux_loss(batch, seq_e, seq_h)

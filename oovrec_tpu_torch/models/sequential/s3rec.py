"""S3Rec: self-supervised pretraining of a transformer encoder with four
tasks, then SASRec-style finetuning.

Port of `oovrec_tpu/models/sequential/s3rec.py:29-184`. The item table has
n_items + 1 rows, the last the mask token; the full sort and the CE
logits use the first n_items. Item attributes come from the packed
feature table of the feature-fused models (`featseq.py`, the buffer
`seq_feat_tokens`).

`train_stage: pretrain` (the default) trains the four-task loss on a
batch corrupted on the device:
  * Associated Attribute Prediction at the valid positions left unmasked
    and Masked Attribute Prediction at the masked ones: `aap_norm` /
    `map_norm` of the bidirectional encoding against every attribute,
    under BCE with the attribute multi-hot of the unmasked sequence (a
    scatter of ones; the JAX package sums a (B, L, C, V) one-hot);
  * Masked Item Prediction: `mip_norm` of the encoding scores the masked
    item above a uniform negative in [1, n_items);
  * Segment Prediction: a segment of ⌊L/4⌋ positions (at least 1) from a
    per-row start in [0, max(length − ⌊L/4⌋, 1)), masked; its encoding
    at position −1 scores the segment above the batch neighbour's
    (`roll` by one row of the global batch).
The sum of the weighted terms is divided by the number of valid
positions (both over the global batch under the mesh). The three draws
(the Bernoulli mask, the negatives, the starts) come from the trainer's
dropout generator (`pretrain_draws`), as the JAX package draws them from
its `dropout` stream; the loss given the draws is `pretrain_loss`, so a
test can hand it JAX's own draws.
`finetune` trains the causal encoder's last state under CE over the
items, and in that stage the attribute table and the four heads do not
exist (flax creates only what the stage's loss calls).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.layers import Dropout, LayerNorm, RandomDraws
from oovrec_tpu_torch.models.losses import bce_with_logits_terms
from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, ce_loss, gather_last
from oovrec_tpu_torch.models.sequential.featseq import FeatureSeqMixin
from oovrec_tpu_torch.models.sequential.sasrec import add_blocks
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.parallel.train_step import batch_sum, global_rows

Draws = Dict[str, torch.Tensor]


@register_model
class S3Rec(SequentialRecommender, FeatureSeqMixin):
    def __init__(self, *args, n_layers: int = 2, n_heads: int = 2, inner_size: int = 256,
                 hidden_dropout_prob: float = 0.5, train_stage: str = "pretrain",
                 mask_ratio: float = 0.2, aap_weight: float = 0.2, mip_weight: float = 1.0,
                 map_weight: float = 1.0, sp_weight: float = 0.5,
                 selected_features: Sequence[str] = (), feat_vocab_size: int = 1,
                 feat_slices: Sequence[Tuple[int, int]] = (),
                 seq_feat_tokens: Optional[np.ndarray] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if train_stage not in ("pretrain", "finetune"):
            raise ValueError(f"train_stage [{train_stage}]: pretrain or finetune")
        self.train_stage = train_stage
        self.mask_ratio = float(mask_ratio)
        self.weights = (float(aap_weight), float(mip_weight), float(map_weight),
                        float(sp_weight))
        D = self.embedding_size
        self.mask_token = self.n_items  # the extra row of the item table
        self.item_embedding = self._embed_table(self.n_items + 1)
        self.position_embedding = self._embed_table(self.max_seq_length)
        pretrain = train_stage == "pretrain"
        self._init_features(selected_features, feat_vocab_size, feat_slices, seq_feat_tokens,
                            table=pretrain)
        self.blocks = add_blocks(self, "block", n_layers, n_heads, inner_size,
                                 hidden_dropout_prob)
        self.final_ln = LayerNorm(D, device=self.device)
        self.emb_dropout = Dropout(hidden_dropout_prob)
        if pretrain:
            for name in ("aap_norm", "mip_norm", "map_norm", "sp_norm"):
                self.add_module(name, dense(self, D, D))
            self.draws = RandomDraws()

    def encode(self, seq: torch.Tensor, train: bool, bidirectional: bool) -> torch.Tensor:
        """(B, L) ids → (B, L, D): the blocks under the padding mask (and
        the causal one unless `bidirectional`), then `final_ln`."""
        L = seq.shape[1]
        x = gather_rows(self.item_embedding.weight, seq) + self.position_embedding.weight[:L]
        x = self.emb_dropout(x, train)
        mask = (seq != 0)[:, None, None, :]
        if not bidirectional:
            mask = mask & torch.ones((L, L), dtype=torch.bool, device=seq.device).tril()
        for blk in self.blocks:
            x = blk(x, mask, train)
        return self.final_ln(x)

    def attr_multihot(self, seq: torch.Tensor) -> torch.Tensor:
        """(B, L, V): 1 at each attribute of the position's item; the pad
        attribute and a token past the table (a float field's) 0, as in
        JAX's one-hot."""
        tokens = self.seq_feat_tokens[torch.clamp(seq.long(), max=self.n_items - 1)].long()
        V = self.feat_vocab_size
        mh = torch.zeros(tokens.shape[:2] + (V + 1,), device=seq.device)
        mh = mh.scatter_(-1, torch.clamp(tokens, max=V), 1.0)[..., :V]
        return mh * (torch.arange(V, device=seq.device) != 0)

    def pretrain_draws(self, batch) -> Draws:
        """The Bernoulli item mask (B, L), the MIP negatives in [1,
        n_items) (B, L) and each row's segment start (B,), from the
        dropout generator."""
        seq, lengths = self._sequence(batch)
        B, L = seq.shape
        seg_len = max(L // 4, 1)
        return {"mask": self.draws.rand((B, L), seq.device) < self.mask_ratio,
                "neg": self.draws.randint(1, self.n_items, (B, L), seq.device),
                "start": self.draws.below(torch.clamp(lengths.long() - seg_len, min=1))}

    def pretrain_loss(self, batch, draws: Draws) -> torch.Tensor:
        seq, lengths = self._sequence(batch)
        seq = seq.long()
        B, L = seq.shape
        idx = torch.arange(L, device=seq.device)[None, :]
        valid = (idx < lengths[:, None]) & (seq != 0)
        masked = draws["mask"] & valid
        out = self.encode(torch.where(masked, self.mask_token, seq), True, bidirectional=True)
        feat_table = self.feature_embedding.weight
        attr = self.attr_multihot(seq)
        # AAP at the valid positions left unmasked, MAP at the masked ones
        aap = bce_with_logits_terms(self.aap_norm(out) @ feat_table.T, attr)
        aap_loss = (aap * (valid & ~masked)[..., None]).sum()
        map_ = bce_with_logits_terms(self.map_norm(out) @ feat_table.T, attr)
        map_loss = (map_ * masked[..., None]).sum()
        # MIP: the masked item against a uniform negative
        h = self.mip_norm(out)
        table = self.item_embedding.weight
        diff = ((h * gather_rows(table, seq)).sum(dim=-1)
                - (h * gather_rows(table, draws["neg"])).sum(dim=-1))
        mip_loss = (bce_with_logits_terms(diff, torch.ones_like(diff)) * masked).sum()
        # SP: the segment at each row's start against the neighbour row's
        seg_len = max(L // 4, 1)
        start = draws["start"][:, None]
        in_seg = (idx >= start) & (idx < start + seg_len) & valid
        pos_segment = torch.where(in_seg, seq, 0)
        ctx = self.encode(torch.where(in_seg, self.mask_token, seq), True, True)[:, -1]
        pos_e = self.encode(pos_segment, True, True)[:, -1]
        # the previous row's segment in the global batch (under the mesh the
        # first row's is the last row of the rank before)
        segments, first = global_rows(pos_segment)
        neg_segment = torch.roll(segments, 1, dims=0)[first:first + B]
        neg_e = self.encode(neg_segment, True, True)[:, -1]
        h = self.sp_norm(ctx)
        diff = (h * pos_e).sum(dim=-1) - (h * neg_e).sum(dim=-1)
        sp_loss = bce_with_logits_terms(diff, torch.ones_like(diff)).sum()
        wa, wi, wm, ws = self.weights
        total = wa * aap_loss + wi * mip_loss + wm * map_loss + ws * sp_loss
        return batch_sum(total) / torch.clamp(batch_sum(valid), min=1).to(total.dtype)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        return gather_last(self.encode(seq, train, bidirectional=False), lengths)

    def _items(self) -> torch.Tensor:
        return self.item_embedding.weight[: self.n_items]

    def calculate_loss(self, batch):
        if self.train_stage == "pretrain":
            return self.pretrain_loss(batch, self.pretrain_draws(batch))
        out = self.seq_output(batch, train=True)
        return ce_loss(out @ self._items().T, batch[self.iid_field], batch.get("weight"))

    def predict(self, batch):
        out = self.seq_output(batch)
        return (out * self.item_embedding.weight[batch[self.iid_field].long()]).sum(dim=1)

    def full_sort_scores(self, batch):
        return self.seq_output(batch) @ self._items().T

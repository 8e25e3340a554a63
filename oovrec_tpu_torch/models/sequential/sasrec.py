"""SASRec: a causal transformer over the item sequence; the last
position's state scores the items.

Port of `oovrec_tpu/models/sequential/sasrec.py:44-86`: item plus
position embeddings, dropout, `n_layers` pre-LN blocks
(`models/layers.py:TransformerBlock`, `block_<i>`) under the causal ∧
padding mask, `final_ln`, then the state at length − 1. An all-padding
row (a padded batch row) masks every key and stays finite: the masked
logits sit at the dtype's finite minimum.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.layers import Dropout, LayerNorm, TransformerBlock
from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, gather_last
from oovrec_tpu_torch.ops.embed_grad import gather_rows


def add_blocks(model, prefix: str, n_layers: int, n_heads: int, inner_size: int,
               dropout: float) -> list:
    """`n_layers` pre-LN blocks of the model's width, children
    `<prefix>_<i>` of `model` (flax's names). → the blocks in order."""
    blocks = []
    for i in range(n_layers):
        blk = TransformerBlock(n_heads, model.embedding_size, inner_size, dropout,
                               device=model.device, generator=model.generator)
        model.add_module(f"{prefix}_{i}", blk)
        blocks.append(blk)
    return blocks


@register_model
class SASRec(SequentialRecommender):
    # the loss reads only split columns (+ a sampled negative): device-epoch OK
    supports_device_epoch = True
    extra_item_rows = 0

    def __init__(self, *args, n_layers: int = 2, n_heads: int = 2, inner_size: int = 256,
                 hidden_dropout_prob: float = 0.5, attn_dropout_prob: float = 0.5, **kwargs):
        super().__init__(*args, **kwargs)
        rows = self.extra_item_rows
        self.item_embedding = self._embed_table(self.n_items + rows)
        self.position_embedding = self._embed_table(self.max_seq_length + rows)
        self.blocks = add_blocks(self, "block", n_layers, n_heads, inner_size,
                                 hidden_dropout_prob)
        self.final_ln = LayerNorm(self.embedding_size, device=self.device)
        self.emb_dropout = Dropout(hidden_dropout_prob)

    def mask(self, seq: torch.Tensor) -> torch.Tensor:
        """(B, 1, L, L): key j visible to query i where j ≤ i and seq[j] ≠ 0."""
        L = seq.shape[1]
        causal = torch.ones((L, L), dtype=torch.bool, device=seq.device).tril()
        return (seq != 0)[:, None, None, :] & causal

    def item_inputs(self, seq: torch.Tensor) -> torch.Tensor:
        """(B, L) item ids → (B, L, D), the blocks' input before the
        positions (SASRecF projects the item and its features here)."""
        return gather_rows(self.item_embedding.weight, seq)

    def encode(self, seq: torch.Tensor, train: bool) -> torch.Tensor:
        """(B, L) item ids → (B, L, D) after the blocks and `final_ln`."""
        x = self.item_inputs(seq) + self.position_embedding.weight[: seq.shape[1]]
        x = self.emb_dropout(x, train)
        mask = self.mask(seq)
        for blk in self.blocks:
            x = blk(x, mask, train)
        return self.final_ln(x)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        return gather_last(self.encode(seq, train), lengths)

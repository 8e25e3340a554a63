"""The feature-fused sequence models: GRU4RecF, SASRecF and FDSA.

Port of `oovrec_tpu/models/sequential/featseq.py:29-232`. The item
features of `selected_features` are packed once, on the host, into one
(n_items, C) int32 table (`FeatureSeqMixin.build_estate`): a `token_seq`
field takes `TOKEN_SEQ_CAP` slots (its first tokens), any other field one;
pad tokens stay 0 and every other token is shifted by the sum of the
earlier fields' (num − 1), so all fields share one `feature_embedding`
table of 1 + Σ(num − 1) rows. A `float` field is packed as its values
truncated to integers, as the JAX package packs it, and adds no rows to
the table: a value that lands past its end is refused at build time
(`jnp.take` reads it as NaN in the JAX package; S3Rec's attribute
labels drop it, as JAX's one-hot does). The model holds the
table as its buffer `seq_feat_tokens` (the JAX package passes it in
`estate`): a step gathers the rows of the sequence's items and embeds
them, and each field is the masked mean of its slots (`_feat_seq`).

  * GRU4RecF: GRU4Rec's item GRUs, a `feature_gru` over the fields'
    concatenated means, `dense_fuse` on both states at every position,
    then the state at length − 1;
  * SASRecF: `concat_proj` of [item, features] at every position, then
    SASRec's positions, blocks and `final_ln`;
  * FDSA: SASRec's item branch and a feature branch of its own: the
    fields pooled by `softmax(feat_att(·))` over the fields, the
    positions, the shared `emb_dropout`, `feat_block_<i>` and `feat_ln`;
    `out_proj` of the two states at length − 1.

The three embed features, so `selected_features: []` raises at build
time (the JAX package fails later, stacking no field). They keep the
device epoch of the models they extend: the table is a buffer, and the
epoch's steps read it as the host steps do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.layers import GRUCell, LayerNorm, gru_scan
from oovrec_tpu_torch.models.sequential.base import gather_last
from oovrec_tpu_torch.models.sequential.gru4rec import GRU4Rec
from oovrec_tpu_torch.models.sequential.sasrec import SASRec, add_blocks
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.enums import FeatureType

TOKEN_SEQ_CAP = 5


class FeatureSeqMixin:
    """The packed item-feature table and its lookups. The table is a
    dataset-derived buffer (`utils/jax_params.py:MODEL_STATE`): a model
    rebuilt over another corpus keeps its own (`models/base.py:
    load_params`)."""

    @classmethod
    def derive_kwargs(cls, dataset, config) -> dict:
        """The packed vocabulary's size and each field's columns, from the
        dataset's field types and vocabularies."""
        sel = tuple(config["selected_features"] or ())
        slices, total, col = [], 1, 0
        for f in sel:
            width = TOKEN_SEQ_CAP if dataset.field2type[f] == FeatureType.TOKEN_SEQ else 1
            slices.append((col, col + width))
            col += width
            total += dataset.num(f) - 1  # the fields' pads share row 0
        return {"selected_features": sel, "feat_vocab_size": max(total, 2),
                "feat_slices": tuple(slices)}

    @staticmethod
    def build_estate(dataset, config=None) -> dict:
        """{"seq_feat_tokens": the (item_num, C) int32 table} over the
        dataset's item features (reindexed to item ids). The JAX package
        takes a training split and reads its parent; the port takes the
        dataset itself and builds no split."""
        sel = tuple((config["selected_features"] if config else None) or ())
        feats = dataset.item_feat
        cols, offset = [], 0
        for f in sel:
            ftype = dataset.field2type[f]
            vals = feats[f] if feats is not None and f in feats else None
            width = TOKEN_SEQ_CAP if ftype == FeatureType.TOKEN_SEQ else 1
            block = np.zeros((dataset.item_num, width), np.int64)
            if vals is not None:
                if ftype == FeatureType.TOKEN_SEQ:
                    for i, v in enumerate(vals):
                        toks = np.asarray(v, np.int64)[:width]
                        block[i, : len(toks)] = toks
                else:
                    block[:, 0] = np.asarray(vals).astype(np.int64)
            cols.append(np.where(block > 0, block + offset, 0))
            offset += dataset.num(f) - 1
        if not cols:
            return {"seq_feat_tokens": np.zeros((dataset.item_num, 1), np.int32)}
        return {"seq_feat_tokens": np.concatenate(cols, axis=1).astype(np.int32)}

    def _init_features(self, selected_features: Sequence[str], feat_vocab_size: int,
                       feat_slices: Sequence[Tuple[int, int]],
                       seq_feat_tokens: Optional[np.ndarray], table: bool = True) -> None:
        """The feature attributes, the `feature_embedding` table (where
        `table`) and the `seq_feat_tokens` buffer (zeros of the packed
        width when not given)."""
        self.selected_features = tuple(selected_features)
        self.feat_vocab_size = int(feat_vocab_size)
        self.feat_slices = tuple((int(s), int(e)) for s, e in feat_slices)
        if table:
            self.feature_embedding = self._embed_table(self.feat_vocab_size)
        if seq_feat_tokens is None:
            width = self.feat_slices[-1][1] if self.feat_slices else 1
            seq_feat_tokens = np.zeros((self.n_items, width), np.int32)
        self.register_buffer("seq_feat_tokens", torch.as_tensor(
            np.asarray(seq_feat_tokens, np.int32)).to(self.device))

    def _require_features(self) -> None:
        """Refuse what `_feat_seq` cannot embed: no field, or a token past
        the table's end."""
        if not self.feat_slices:
            raise ValueError(
                f"{type(self).__name__} embeds item features: selected_features is empty "
                "(name at least one item feature field)")
        tokens = self.seq_feat_tokens.cpu().numpy()
        for f, (s, e) in zip(self.selected_features, self.feat_slices):
            top = int(tokens[:, s:e].max()) if tokens[:, s:e].size else 0
            if top >= self.feat_vocab_size:
                raise ValueError(
                    f"feature [{f}] packs token {top} into a table of {self.feat_vocab_size} "
                    "rows (a float field packs its values truncated; the JAX package reads "
                    "such a token as NaN)")

    def _feat_seq(self, seq: torch.Tensor) -> torch.Tensor:
        """(B, L) item ids → (B, L, F, D): each field's masked mean over
        its slots (the denominator at least 1)."""
        tokens = self.seq_feat_tokens[seq.long()]                     # (B, L, C)
        emb = gather_rows(self.feature_embedding.weight, tokens)     # (B, L, C, D)
        valid = (tokens > 0).to(emb.dtype)[..., None]
        outs = []
        for s, e in self.feat_slices:
            block = (emb[:, :, s:e] * valid[:, :, s:e]).sum(dim=2)
            outs.append(block / torch.clamp(valid[:, :, s:e].sum(dim=2), min=1.0))
        return torch.stack(outs, dim=2)


@register_model
class GRU4RecF(GRU4Rec, FeatureSeqMixin):
    def __init__(self, *args, selected_features: Sequence[str] = (), feat_vocab_size: int = 1,
                 feat_slices: Sequence[Tuple[int, int]] = (),
                 seq_feat_tokens: Optional[np.ndarray] = None, **kwargs):
        super().__init__(*args, **kwargs)
        hidden = self.gru_layers[-1].features
        del self.dense  # GRU4Rec's readout, which flax never creates here
        self._init_features(selected_features, feat_vocab_size, feat_slices, seq_feat_tokens)
        self._require_features()
        self.feature_gru = GRUCell(len(self.feat_slices) * self.embedding_size, hidden,
                                   device=self.device, generator=self.generator)
        self.dense_fuse = dense(self, 2 * hidden, self.embedding_size)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        B, L = seq.shape
        x = self.emb_dropout(gather_rows(self.item_embedding.weight, seq), train)
        for cell in self.gru_layers:
            _, x = gru_scan(cell, x, x.new_zeros(B, cell.features))
        f = self._feat_seq(seq).reshape(B, L, -1)
        _, f = gru_scan(self.feature_gru, f, f.new_zeros(B, self.feature_gru.features))
        return gather_last(self.dense_fuse(torch.cat([x, f], dim=-1)), lengths)


@register_model
class SASRecF(SASRec, FeatureSeqMixin):
    def __init__(self, *args, selected_features: Sequence[str] = (), feat_vocab_size: int = 1,
                 feat_slices: Sequence[Tuple[int, int]] = (),
                 seq_feat_tokens: Optional[np.ndarray] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_features(selected_features, feat_vocab_size, feat_slices, seq_feat_tokens)
        self._require_features()
        D = self.embedding_size
        self.concat_proj = dense(self, D * (1 + len(self.feat_slices)), D)

    def item_inputs(self, seq):
        B, L = seq.shape
        item = gather_rows(self.item_embedding.weight, seq)
        feat = self._feat_seq(seq).reshape(B, L, -1)
        return self.concat_proj(torch.cat([item, feat], dim=-1))


@register_model
class FDSA(SASRec, FeatureSeqMixin):
    def __init__(self, *args, n_layers: int = 2, n_heads: int = 2, inner_size: int = 256,
                 hidden_dropout_prob: float = 0.5, selected_features: Sequence[str] = (),
                 feat_vocab_size: int = 1, feat_slices: Sequence[Tuple[int, int]] = (),
                 seq_feat_tokens: Optional[np.ndarray] = None, **kwargs):
        super().__init__(*args, n_layers=n_layers, n_heads=n_heads, inner_size=inner_size,
                         hidden_dropout_prob=hidden_dropout_prob, **kwargs)
        self._init_features(selected_features, feat_vocab_size, feat_slices, seq_feat_tokens)
        self._require_features()
        D = self.embedding_size
        self.feat_att = dense(self, D, 1)
        self.feat_blocks = add_blocks(self, "feat_block", n_layers, n_heads, inner_size,
                                      hidden_dropout_prob)
        self.feat_ln = LayerNorm(D, device=self.device)
        self.out_proj = dense(self, 2 * D, D)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        x = self.encode(seq, train)
        feats = self._feat_seq(seq)                                  # (B, L, F, D)
        w = torch.softmax(self.feat_att(feats), dim=2)               # field attention
        f = (w * feats).sum(dim=2) + self.position_embedding.weight[: seq.shape[1]]
        f = self.emb_dropout(f, train)
        mask = self.mask(seq)
        for blk in self.feat_blocks:
            f = blk(f, mask, train)
        f = self.feat_ln(f)
        return self.out_proj(torch.cat([gather_last(x, lengths), gather_last(f, lengths)],
                                       dim=-1))

"""RepeatNet, GRU4RecKG and KSR.

Port of `oovrec_tpu/models/sequential/more5.py:27-324`.

  * RepeatNet: a GRU over the item sequence, a repeat / explore gate,
    a repeat decoder whose attention over the positions becomes
    probabilities of the history's items, and an explore decoder over
    every item with the history's items at −inf before its softmax; the
    mixture is the output (`full_sort_scores` gives the probabilities),
    and the loss is −log(p[target] + 1e-8), with `joint_train`'s gate
    term. The position probabilities reach the items by `scatter_probs`:
    each row's probabilities summed over equal ids through an (L, L)
    equality mask, in a fixed order (ascending values), kept at an id's
    first position and 0 at its others, then one scatter-add. The CUDA
    scatter-add adds with atomics in no fixed order, so adding the raw
    probabilities of a repeated item could change the sum's bits from run
    to run (a graphed step against an eager one); adding exact zeros
    changes nothing. Each duplicate's gradient is its item's, once (writing
    the sum at every duplicate with `scatter_` would hand the gradient to
    each, multiplied by the item's count).
  * GRU4RecKG: GRU4Rec's item GRUs beside an `entity_gru` over the
    items' entity vectors, `dense_fuse` on both, the state at length − 1;
  * KSR: a GRU's last state, a key-value memory over the KG relations
    written position by position (each step keeps the old memory past the
    row's length), read by the state's attention over the relations;
    items are scored through `dense_i([item table, entity table])`, item 0
    included; CE or BPR.

The entity table `entity_embedding` is a parameter (a raw leaf in the
flax tree) initialised from `pretrained_ent`: the dataset's preloaded
vectors (`preload_weight: {ent_id: <vector field>}`, cut or padded to
item_num rows), or without a preload 0.02 · N(0, 1) from
`numpy.random.default_rng(seed)` (`derive_kwargs`). Under `freeze_kg` the
forward reads it detached, as the JAX package's `stop_gradient`: its
gradient is 0, but it stays a parameter with optimizer slots, so weight
decay moves it as it moves the JAX leaf (the reference freezes it with
`requires_grad = False`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.layers import Dropout, GRUCell, gru_scan
from oovrec_tpu_torch.models.losses import _wmean, bpr_loss
from oovrec_tpu_torch.models.sequential.base import (
    SequentialRecommender,
    ce_loss,
    gather_last,
    inside,
)
from oovrec_tpu_torch.models.sequential.gru4rec import GRU4Rec
from oovrec_tpu_torch.ops.embed_grad import gather_rows


def scatter_probs(probs: torch.Tensor, seq: torch.Tensor, n_items: int) -> torch.Tensor:
    """(B, L) position probabilities → (B, n_items): each item's sum over
    its positions. The sum is a fold in ascending order of the values
    (each row sorted once), so its bits depend neither on where the item
    sits in the row nor on the order of the scatter's adds: it is kept at
    the item's first position of the sorted row, 0 at its others."""
    vals, order = probs.sort(dim=1)
    ids = seq.long().gather(1, order)
    eq = (ids[:, :, None] == ids[:, None, :]).to(probs.dtype)         # (B, L, L)
    summed = torch.zeros_like(vals)
    for j in range(vals.shape[1]):  # exact zeros for the other items' positions
        summed = summed + eq[:, :, j] * vals[:, j, None]
    L = ids.shape[1]
    earlier = torch.ones((L, L), dtype=torch.bool, device=ids.device).tril(-1)
    first = ~((eq > 0) & earlier).any(dim=-1)
    kept = torch.where(first, summed, torch.zeros_like(summed))
    return probs.new_zeros(probs.shape[0], n_items).scatter_add(1, ids, kept)


@register_model
class RepeatNet(SequentialRecommender):
    def __init__(self, *args, hidden_size: int = 64, dropout_prob: float = 0.5,
                 joint_train: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        D, H = self.embedding_size, hidden_size
        self.joint_train = bool(joint_train)
        self.item_embedding = self._embed_table(self.n_items)
        self.gru = GRUCell(D, H, device=self.device, generator=self.generator)
        for name, n_in, n_out, bias in (
                ("w_re", H, H, False), ("u_re", H, H, False), ("v_re", H, 1, False),
                ("w_cre", H, 2, False), ("w_r", H, H, False), ("u_r", H, H, False),
                ("v_r", H, 1, True), ("w_e", H, H, True), ("u_e", H, H, True),
                ("v_e", H, 1, True), ("explore_out", 2 * H, self.n_items, False)):
            self.add_module(name, dense(self, n_in, n_out, bias))
        self.drop = Dropout(dropout_prob)

    def _probs(self, batch, train: bool):
        """→ (the (B, n_items) mixture, the (B, 2) gate, the sequence,
        its (B, L) bool mask)."""
        seq, lengths = self._sequence(batch)
        valid = inside(seq, lengths) > 0
        x = gather_rows(self.item_embedding.weight, seq)
        _, mem = gru_scan(self.gru, x, x.new_zeros(x.shape[0], self.gru.features))
        last = gather_last(mem, lengths)

        def attn(w_last, u_all, v):
            e = v(torch.tanh(self.drop(u_all(mem), train)
                             + self.drop(w_last(last), train)[:, None, :])).squeeze(-1)
            return torch.softmax(e.masked_fill(~valid, -1e9), dim=1)

        a = attn(self.w_re, self.u_re, self.v_re)
        gate = torch.softmax(self.w_cre((a[:, :, None] * mem).sum(dim=1)), dim=-1)
        ar = attn(self.w_r, self.u_r, self.v_r)
        p_repeat = scatter_probs(ar * valid, seq, self.n_items)
        ae = attn(self.w_e, self.u_e, self.v_e)
        ctx = (ae[:, :, None] * mem).sum(dim=1)
        logits = self.drop(self.explore_out(torch.cat([ctx, last], dim=1)), train)
        # history items: adding 0 / 1 counts is exact in any order
        seen = logits.new_zeros(logits.shape).scatter_add(1, seq.long(), valid.to(logits.dtype))
        p_explore = torch.softmax(logits.masked_fill(seen > 0, float("-inf")), dim=-1)
        probs = p_repeat * gate[:, :1] + p_explore * gate[:, 1:]
        return probs, gate, seq, valid

    def calculate_loss(self, batch):
        probs, gate, seq, valid = self._probs(batch, train=True)
        pos = batch[self.iid_field].long()
        nll = -torch.log(probs.gather(1, pos[:, None]).squeeze(1) + 1e-8)
        if self.joint_train:
            is_rep = ((seq == pos[:, None]) & valid).any(dim=1)
            nll = nll - 0.5 * torch.where(is_rep, torch.log(gate[:, 0] + 1e-8),
                                          torch.log(gate[:, 1] + 1e-8))
        return _wmean(nll, batch.get("weight"))

    def predict(self, batch):
        probs = self._probs(batch, train=False)[0]
        return probs.gather(1, batch[self.iid_field].long()[:, None]).squeeze(1)

    def full_sort_scores(self, batch):
        return self._probs(batch, train=False)[0]


class PreloadKGMixin:
    """The entity table from the dataset's preloaded vectors."""

    @classmethod
    def derive_kwargs(cls, dataset, config) -> dict:
        """`pretrained_ent` (item_num, K) and `kg_embedding_size` K: the
        preload cut or padded to item_num rows, or, without one, seeded
        draws at `kg_embedding_size`; `n_relations` from a dataset that
        has relations."""
        ksize = int(config["kg_embedding_size"] or config.get("embedding_size", 64))
        try:
            ent = dataset.get_preload_weight("ent_id")
            ent = np.asarray(ent[: dataset.item_num], np.float32)
            if ent.shape[0] < dataset.item_num:
                ent = np.pad(ent, ((0, dataset.item_num - ent.shape[0]), (0, 0)))
            ksize = ent.shape[1]
        except (ValueError, KeyError, TypeError):
            rng = np.random.default_rng(int(config["seed"] or 2020))
            ent = (0.02 * rng.standard_normal((dataset.item_num, ksize))).astype(np.float32)
        out = {"pretrained_ent": ent, "kg_embedding_size": ksize}
        if hasattr(dataset, "relation_num"):
            out["n_relations"] = int(dataset.relation_num)
        return out

    def _init_entities(self, kg_embedding_size: int, freeze_kg: bool,
                       pretrained_ent: Optional[np.ndarray]) -> None:
        self.kg_embedding_size = int(kg_embedding_size)
        self.freeze_kg = bool(freeze_kg)
        if pretrained_ent is None:
            self.entity_embedding = raw_param(self, self.n_items, self.kg_embedding_size)
        else:
            self.entity_embedding = torch.nn.Parameter(torch.as_tensor(
                np.asarray(pretrained_ent, np.float32)).to(self.device))

    def entity_table(self) -> torch.Tensor:
        table = self.entity_embedding
        return table.detach() if self.freeze_kg else table


@register_model
class GRU4RecKG(GRU4Rec, PreloadKGMixin):
    def __init__(self, *args, kg_embedding_size: int = 64, freeze_kg: bool = True,
                 pretrained_ent: Optional[np.ndarray] = None, **kwargs):
        super().__init__(*args, **kwargs)
        hidden = self.gru_layers[-1].features
        del self.dense  # GRU4Rec's readout, which flax never creates here
        self._init_entities(kg_embedding_size, freeze_kg, pretrained_ent)
        self.entity_gru = GRUCell(self.kg_embedding_size, hidden, device=self.device,
                                  generator=self.generator)
        self.dense_fuse = dense(self, 2 * hidden, self.embedding_size)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        B = seq.shape[0]
        x = self.emb_dropout(gather_rows(self.item_embedding.weight, seq), train)
        for cell in self.gru_layers:
            _, x = gru_scan(cell, x, x.new_zeros(B, cell.features))
        ent = self.emb_dropout(gather_rows(self.entity_table(), seq), train)
        _, ent = gru_scan(self.entity_gru, ent, ent.new_zeros(B, self.entity_gru.features))
        return gather_last(self.dense_fuse(torch.cat([x, ent], dim=-1)), lengths)


@register_model
class KSR(SequentialRecommender, PreloadKGMixin):
    def __init__(self, *args, hidden_size: int = 64, kg_embedding_size: int = 64,
                 n_relations: int = 4, gamma: float = 10.0, dropout_prob: float = 0.3,
                 freeze_kg: bool = True, pretrained_ent: Optional[np.ndarray] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        D, H = self.embedding_size, hidden_size
        self.gamma = float(gamma)
        self.item_embedding = self._embed_table(self.n_items)
        self._init_entities(kg_embedding_size, freeze_kg, pretrained_ent)
        K = self.kg_embedding_size
        self.relation_embedding = raw_param(self, int(n_relations), K)
        self.gru = GRUCell(D, H, device=self.device, generator=self.generator)
        self.dense = dense(self, H, K)
        self.dense_u = dense(self, H + K, D)
        self.dense_i = dense(self, D + K, D)
        self.emb_dropout = Dropout(dropout_prob)

    def memory(self, seq: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, R, K): the gated writes of each position's item entity plus
        each relation, position by position, the memory kept past each
        row's length."""
        ent = gather_rows(self.entity_table(), seq)                        # (B, L, K)
        upd = ent[:, :, None, :] + self.relation_embedding[None, None]     # (B, L, R, K)
        valid = inside(seq, lengths) > 0
        mem = upd.new_zeros(upd.shape[0], upd.shape[2], upd.shape[3])
        for u, v in zip(upd.unbind(1), valid.unbind(1)):
            z = torch.sigmoid((mem * u).sum(dim=-1))[..., None]
            mem = torch.where(v[:, None, None], (1.0 - z) * mem + z * u, mem)
        return mem

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        x = self.emb_dropout(gather_rows(self.item_embedding.weight, seq), train)
        _, h = gru_scan(self.gru, x, x.new_zeros(x.shape[0], self.gru.features))
        h_last = gather_last(h, lengths)
        att = torch.softmax(self.gamma * (self.dense(h_last) @ self.relation_embedding.T),
                            dim=-1)
        u_m = (self.memory(seq, lengths) * att[:, :, None]).sum(dim=1)
        return self.dense_u(torch.cat([h_last, u_m], dim=-1))

    def _item_comb(self, items: torch.Tensor) -> torch.Tensor:
        return self.dense_i(torch.cat([gather_rows(self.item_embedding.weight, items),
                                       gather_rows(self.entity_table(), items)], dim=-1))

    def _all_items_comb(self) -> torch.Tensor:
        return self.dense_i(torch.cat([self.item_embedding.weight, self.entity_table()],
                                      dim=-1))

    def calculate_loss(self, batch):
        out = self.seq_output(batch, train=True)
        pos, w = batch[self.iid_field], batch.get("weight")
        if self.loss_type == "BPR":
            neg = batch[self.neg_prefix + self.iid_field]
            return bpr_loss((out * self._item_comb(pos)).sum(dim=1),
                            (out * self._item_comb(neg)).sum(dim=1), w)
        return ce_loss(out @ self._all_items_comb().T, pos, w)

    def predict(self, batch):
        out = self.seq_output(batch)
        return (out * self._item_comb(batch[self.iid_field])).sum(dim=1)

    def full_sort_scores(self, batch):
        return self.seq_output(batch) @ self._all_items_comb().T

"""Knowledge-based dataset: the interactions plus a knowledge graph.

Port of `oovrec_tpu/data/kg_dataset.py:27-187` over the port's numpy
tables (no pandas). Two more atomic files sit beside the `.inter`:

  <ds>.kg    head_id:token  relation_id:token  tail_id:token
  <ds>.link  item_id:token  entity_id:token

The steps and their order are the JAX package's:

  * the load (`_load_data`): both files, or a `ValueError` naming them;
    the `.kg` fields join `field2type` (they are in no interaction table,
    so the base remap leaves them alone, as the JAX one does);
  * the filtering (`_data_filtering`), after the interactions' own: the
    entity and relation k-core over the triples
    (`entity_kg_num_interval`, `relation_kg_num_interval`; a missing token
    is never counted, as `value_counts` drops NaN), then `_filter_link`:
    the links whose entity is in no triple or whose item is in no
    interaction go, and so do the interactions whose item has no link;
  * the remap (`_remap_id_all`), after the base one: items and entities
    share one id space. A linked entity takes its item's id (for an
    entity linked twice, the last link wins, as `dict(zip(...))` keeps
    it); the other entities follow from `item_num` on, in first-seen
    order over the heads and then the tails. Relations: `[PAD]` = 0, the
    tokens in `np.unique` order from 1, under `kg_reverse_r` a reversed
    copy of every triple with the relation id shifted by the number of
    originals (its token `<rel>_r`), and a trailing `[UI-Relation]`.

`kg_triples` gives the (heads, relations, tails) int64 arrays, and `num`
answers for the entity and relation fields.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict

import numpy as np

from oovrec_tpu_torch.data.atomic import load_atomic_file
from oovrec_tpu_torch.data.dataset import (
    Dataset,
    _as_token,
    _in_interval,
    _parse_interval,
    _take,
)
from oovrec_tpu_torch.utils.enums import FeatureSource


def _tokens(col: np.ndarray) -> np.ndarray:
    """A token column as str (`astype(str)` there: a missing cell is
    "nan")."""
    return np.array([_as_token(v) for v in col], dtype=object)


def _banned(counts: Counter, interval) -> set:
    """The tokens whose count lies outside `interval`."""
    keys = list(counts)
    n = np.array([counts[k] for k in keys], dtype=np.float64)
    return {k for k, ok in zip(keys, _in_interval(n, interval)) if not ok}


class KnowledgeBasedDataset(Dataset):
    def __init__(self, config):
        self.head_field = config.get("HEAD_ENTITY_ID_FIELD", "head_id")
        self.tail_field = config.get("TAIL_ENTITY_ID_FIELD", "tail_id")
        self.relation_field = config.get("RELATION_ID_FIELD", "relation_id")
        self.entity_field = config.get("ENTITY_ID_FIELD", "entity_id")
        self.kg_feat: Dict[str, np.ndarray] = {}
        self.link_feat: Dict[str, np.ndarray] = {}
        super().__init__(config)

    def _load_data(self) -> None:
        super()._load_data()
        path = self._dataset_path()
        token = self.dataset_name
        sep = self.config["field_separator"]
        seq_sep = self.config["seq_separator"]
        kg_path = os.path.join(path, f"{token}.kg")
        link_path = os.path.join(path, f"{token}.link")
        if not os.path.isfile(kg_path) or not os.path.isfile(link_path):
            raise ValueError(f"{token}.kg / {token}.link files are required")
        self.kg_feat, f2t = load_atomic_file(kg_path, sep, seq_sep)
        for f, t in f2t.items():
            self.field2source[f] = FeatureSource.KG
            self.field2type[f] = t
        self.link_feat, _ = load_atomic_file(link_path, sep, seq_sep)

    # ------------------------------------------------------------ filtering

    def _data_filtering(self) -> None:
        super()._data_filtering()
        self._filter_kg_by_triple_num()
        self._filter_link()

    def _filter_kg_by_triple_num(self) -> None:
        """The entity and relation k-core over the triples, repeated until
        no triple goes."""
        e_iv = _parse_interval(self.config["entity_kg_num_interval"])
        r_iv = _parse_interval(self.config["relation_kg_num_interval"])
        if not e_iv and not r_iv:
            return
        kg = self.kg_feat
        h, r, t = self.head_field, self.relation_field, self.tail_field
        while True:
            n = len(kg[h])
            if e_iv:
                counts = Counter(v for v in np.concatenate([kg[h], kg[t]]) if v is not None)
                bad = _banned(counts, e_iv)
                if bad:
                    kg = _take(kg, np.array([a not in bad and b not in bad
                                             for a, b in zip(kg[h], kg[t])], dtype=bool))
            if r_iv:
                bad = _banned(Counter(v for v in kg[r] if v is not None), r_iv)
                if bad:
                    kg = _take(kg, np.array([v not in bad for v in kg[r]], dtype=bool))
            if len(kg[h]) == n:
                break
        self.kg_feat = kg

    def _filter_link(self) -> None:
        """Drop the links whose entity is in no triple or whose item is in
        no interaction, then the interactions whose item has no link (the
        JAX package's own behaviour, `kg_dataset.py:97-113` there)."""
        ents = set(_tokens(self.kg_feat[self.head_field])) | set(
            _tokens(self.kg_feat[self.tail_field]))
        inter_items = _tokens(self.inter_feat[self.iid_field])
        items = set(inter_items)
        link_ents = _tokens(self.link_feat[self.entity_field])
        link_items = _tokens(self.link_feat[self.iid_field])
        keep = np.array([e in ents and i in items for e, i in zip(link_ents, link_items)],
                        dtype=bool)
        self.link_feat = _take(self.link_feat, keep)
        linked = set(link_items[keep])
        self.inter_feat = _take(self.inter_feat,
                                np.array([i in linked for i in inter_items], dtype=bool))

    # ---------------------------------------------------------------- remap

    def _remap_id_all(self) -> None:
        super()._remap_id_all()

        # the entity space: linked entities take their item's id, the
        # others follow in first-seen order over heads, then tails
        item_t2i = self.field2token_id[self.iid_field]
        link = dict(zip(_tokens(self.link_feat[self.entity_field]),
                        _tokens(self.link_feat[self.iid_field])))
        ent2id: Dict[str, int] = {}
        for ent, item_tok in link.items():
            if item_tok in item_t2i:
                ent2id[ent] = item_t2i[item_tok]
        next_id = self.item_num
        heads = _tokens(self.kg_feat[self.head_field])
        tails = _tokens(self.kg_feat[self.tail_field])
        for tok in np.concatenate([heads, tails]):
            if tok not in ent2id:
                ent2id[tok] = next_id
                next_id += 1
        self._entity2id = ent2id
        self.entity_num = next_id
        head_ids = np.array([ent2id[t] for t in heads], np.int64)
        tail_ids = np.array([ent2id[t] for t in tails], np.int64)

        # the relation space: [PAD], the tokens sorted, the reversed copies,
        # [UI-Relation]
        rels = np.array([_as_token(v) for v in self.kg_feat[self.relation_field]], dtype=str)
        uniq, inv = np.unique(rels, return_inverse=True)
        rel_ids = inv.reshape(-1).astype(np.int64) + 1
        vocab = ["[PAD]"] + list(uniq)
        if self.config["kg_reverse_r"]:
            n_orig = len(uniq)
            head_ids, tail_ids = (np.concatenate([head_ids, tail_ids]),
                                  np.concatenate([tail_ids, head_ids]))
            rel_ids = np.concatenate([rel_ids, rel_ids + n_orig])
            vocab += [t + "_r" for t in uniq]
        vocab.append("[UI-Relation]")
        self.kg_feat = {self.head_field: head_ids, self.relation_field: rel_ids,
                        self.tail_field: tail_ids}
        self.field2id_token[self.relation_field] = np.array(vocab)
        self.field2token_id[self.relation_field] = {t: i for i, t in enumerate(vocab)}
        self.relation_num = len(vocab)

    @property
    def kg_triples(self):
        """(heads, relations, tails), int64 arrays in triple order."""
        return tuple(np.asarray(self.kg_feat[f], np.int64)
                     for f in (self.head_field, self.relation_field, self.tail_field))

    def num(self, field: str) -> int:
        if field in (self.entity_field, self.head_field, self.tail_field):
            return self.entity_num
        if field == self.relation_field:
            return self.relation_num
        return super().num(field)

"""InductiveDataset: the `<dataset>_ind` evaluation corpus.

Port of `oovrec_tpu/data/inductive_dataset.py:20-162`: it keeps the OOV
rows (no `_remove_new_samples`), rewrites its categorical ids into the
training dataset's id space, so that row i of its feature tables equals
row i of the training tables for every shared entity, repairs the
mean-imputed floats of shared rows, and splits by benchmark file sizes
(or, without benchmark files, sorts by time under 'TO' first).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from oovrec_tpu_torch.data.dataset import Dataset, DatasetSplit, _rows, _take
from oovrec_tpu_torch.utils.enums import FeatureType


class InductiveDataset(Dataset):
    def __init__(self, config):
        self.orig_dataset: Optional[Dataset] = None
        self._features_remapped = False
        super().__init__(config)

    def _data_processing(self) -> None:
        """`Dataset._data_processing` without `_remove_new_samples`."""
        self._data_filtering()
        self._remap_id_all()
        self._user_item_feat_preparation()
        self._fill_nan()
        self._set_label_by_threshold()
        self._normalize()
        self._discretization()

    def set_orig_dataset(self, orig_dataset: Dataset) -> None:
        self.orig_dataset = orig_dataset

    def remap_features(self) -> None:
        """Rewrite every non-ID token field into the training dataset's ids
        (a token unseen in training → 0, [PAD]); then give shared-entity
        rows whose float was imputed with this corpus' mean the training
        value."""
        if self.orig_dataset is None:
            raise ValueError("The original dataset has not been set.")
        if self._features_remapped:
            return
        orig = self.orig_dataset

        id2id: Dict[str, np.ndarray] = {}
        for field, orig_t2i in orig.field2token_id.items():
            if field in (self.uid_field, self.iid_field):
                continue
            ind_t2i = self.field2token_id.get(field)
            if ind_t2i is None or ind_t2i == orig_t2i:
                continue
            lut = np.zeros(len(ind_t2i), dtype=np.int64)
            for token, ind_id in ind_t2i.items():
                lut[ind_id] = orig_t2i.get(token, 0)
            id2id[field] = lut
            self.field2id_token[field] = orig.field2id_token[field]
            merged = dict(orig_t2i)
            for token in ind_t2i:
                merged.setdefault(token, 0)
            self.field2token_id[field] = merged

        for field, lut in id2id.items():
            for feat_name in ("user_feat", "item_feat"):
                feat = getattr(self, feat_name)
                if feat is None or field not in feat:
                    continue
                ftype = self.field2type[field]
                if ftype == FeatureType.TOKEN:
                    feat[field] = lut[np.asarray(feat[field], np.int64)]
                elif ftype == FeatureType.TOKEN_SEQ:
                    train_feat = getattr(orig, feat_name)
                    maxlen = (
                        max((len(v) for v in train_feat[field]), default=0)
                        if train_feat is not None and field in train_feat
                        else None
                    )
                    col = np.empty(len(feat[field]), dtype=object)
                    for i, v in enumerate(feat[field]):
                        v = lut[np.asarray(v, dtype=np.int64)]
                        if maxlen is not None and len(v) > maxlen:
                            v = v[:maxlen]  # trimmed to the training width
                        col[i] = v
                    feat[field] = col

        for field, ftype in self.field2type.items():
            if ftype != FeatureType.FLOAT:
                continue
            for feat_name in ("user_feat", "item_feat"):
                feat = getattr(self, feat_name)
                train_feat = getattr(orig, feat_name)
                if (feat is None or train_feat is None
                        or field not in feat or field not in train_feat):
                    continue
                n_shared = _rows(train_feat)
                train_vals = train_feat[field][1:n_shared]
                ind_vals = feat[field][1:n_shared]
                mism = train_vals != ind_vals
                if not mism.any():
                    continue
                ind_mism = ind_vals[mism]
                orig_mism = train_vals[mism]
                assert np.all(ind_mism == ind_mism[0]), f"inconsistent imputed values in {field}"
                assert np.all(orig_mism == orig_mism[0]), f"inconsistent training values in {field}"
                col = feat[field].copy()
                col[1:n_shared][mism] = orig_mism[0]
                feat[field] = col

        self._features_remapped = True

    def build(self):
        """remap_features, then split by benchmark file sizes; without
        benchmark files, 'TO' sorts by time (stable) before the base
        split."""
        self.remap_features()

        if self.benchmark_filename_list is not None:
            cumsum = list(np.cumsum(self.file_size_list))
            return [DatasetSplit.view(self, np.arange(start, end))
                    for start, end in zip([0] + cumsum[:-1], cumsum)]

        order = self.config["eval_args"]["order"]
        if order == "TO" and self.time_field in self.inter_feat:
            self.inter_feat = _take(
                self.inter_feat,
                np.argsort(self.inter_feat[self.time_field], kind="stable"))
        return super().build()

    @property
    def n_new_users(self) -> int:
        return self.user_num

    @property
    def n_new_items(self) -> int:
        return self.item_num

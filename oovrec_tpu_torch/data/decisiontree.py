"""Decision-tree dataset: a numpy copy of `oovrec_tpu/data/decisiontree.py`
(reference
`recbole/data/dataset/decisiontree_dataset.py`).

The reference converts token columns to integer hashes so that
xgboost/lightgbm can consume them (`_convert_token_to_hash`). Here token
fields are already dense integer ids after remap, so `tabularize` just
assembles the flat (X, y) design matrix: token ids as categorical ints,
float columns as-is, *_seq columns summarized by their mean."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from oovrec_tpu_torch.data.dataset import Dataset
from oovrec_tpu_torch.utils.enums import FeatureType


class DecisionTreeDataset(Dataset):
    """Same pipeline as `Dataset`; adds the flat-matrix exporter used by
    the exlib (xgboost/lightgbm) models."""

    def tabularize(self, df=None) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        if df is None:
            df = self.inter_feat
        # splits carry dict-of-arrays; the parent dataset a DataFrame
        fields = list(df.keys()) if isinstance(df, dict) else list(df.columns)
        label = self.label_field
        cols, names = [], []
        for field in fields:
            if field == label:
                continue
            ftype = self.field2type.get(field, FeatureType.FLOAT)
            v = df[field]
            vals = v if isinstance(v, np.ndarray) else v.to_numpy()
            if ftype in (FeatureType.TOKEN, FeatureType.FLOAT):
                cols.append(np.asarray(vals, np.float64))
            else:  # *_seq: mean-summarize, empty rows → 0
                cols.append(np.array(
                    [np.mean(v) if np.size(v) else 0.0 for v in vals],
                    np.float64,
                ))
            names.append(field)
        X = np.stack(cols, axis=1) if cols else np.zeros((0, 0))
        n_rows = len(df[fields[0]]) if fields else 0
        if label in fields:
            lv = df[label]
            y = np.asarray(
                lv if isinstance(lv, np.ndarray) else lv.to_numpy(), np.float64
            )
        else:
            y = np.zeros(n_rows)
        return X, y, names


def tabularize_split(split) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Flat design matrix for a DatasetSplit (works with any Dataset by
    borrowing DecisionTreeDataset.tabularize)."""
    ds = split.parent
    return DecisionTreeDataset.tabularize(ds, df=split.inter)

"""Interaction splits as numpy arrays.

Port of `DatasetSplit` (`oovrec_tpu/data/dataset.py:811-849`). The JAX
split is a view over a pandas `Dataset` and derives its counts, field
names and feature tables from it; this one takes them directly. The
optional `user_feat` / `item_feat` tables (field → array indexed by id)
stand in for `split.parent.get_user_feature()` / `get_item_feature()`.
The atomic-file `Dataset` comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class DatasetSplit:
    """One phase's interaction rows: field name → (n,) array."""

    def __init__(
        self,
        inter: Dict[str, np.ndarray],
        user_num: int,
        item_num: int,
        uid_field: str = "user_id",
        iid_field: str = "item_id",
        label_field: str = "label",
        user_feat: Optional[Dict[str, np.ndarray]] = None,
        item_feat: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.inter = {k: np.asarray(v) for k, v in inter.items()}
        self.user_feat = _as_arrays(user_feat)
        self.item_feat = _as_arrays(item_feat)
        self.user_num = int(user_num)
        self.item_num = int(item_num)
        self.uid_field = uid_field
        self.iid_field = iid_field
        self.label_field = label_field

    def __len__(self) -> int:
        return len(self.inter[self.uid_field])

    def used_ids_per_user(self) -> List[np.ndarray]:
        """Per-user arrays of interacted item ids within this split."""
        uid = self.inter[self.uid_field]
        iid = self.inter[self.iid_field]
        order = np.argsort(uid, kind="stable")
        out: List[np.ndarray] = [np.array([], dtype=np.int64)] * self.user_num
        if len(uid) == 0:
            return out
        su, si = uid[order], iid[order]
        bounds = np.flatnonzero(np.diff(su)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(su)]])
        for s, e in zip(starts, ends):
            out[su[s]] = si[s:e]
        return out


def _as_arrays(feat: Optional[Dict[str, np.ndarray]]):
    return None if feat is None else {k: np.asarray(v) for k, v in feat.items()}

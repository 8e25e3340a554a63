"""Interaction splits as numpy arrays.

Port of `DatasetSplit` (`oovrec_tpu/data/dataset.py:811-849`). The JAX
split is a view over a pandas `Dataset` and derives its counts and field
names from it; this one takes them directly. The atomic-file `Dataset`
comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, List

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
    ):
        self.inter = {k: np.asarray(v) for k, v in inter.items()}
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

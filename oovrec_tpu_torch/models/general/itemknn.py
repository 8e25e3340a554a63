"""ItemKNN: item-item cosine similarity of the training matrix, top-k
truncated.

Port of `oovrec_tpu/models/general/itemknn.py:16-56`, a traditional model
(`models/general/base.py`). The similarity is built once on the host by
the JAX package's numpy, copied as it is (`itemknn_state`), so the two
states agree bit for bit: the cosine with `shrink`, a zero diagonal, and
each row cut to its k largest by `np.argpartition` (its ties fall as
numpy's partition puts them). `build_estate` reads `k` and `shrink` from
the config. Scoring is `user_hist_matrix[users] @ item_sim` on the
model's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.general.base import HistoryProductRecommender, config_values


def itemknn_state(train_split, k: int = 100, shrink: float = 0.0) -> dict:
    """`ItemKNN.build_estate` of the JAX package (`itemknn.py:40-56`)."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    n_u, n_i = train_split.user_num, train_split.item_num
    mat = np.zeros((n_u, n_i), dtype=np.float32)
    mat[uid, iid] = 1.0
    # cosine similarity with shrink (`itemknn.py` ComputeSimilarity)
    norms = np.linalg.norm(mat, axis=0)
    sim = mat.T @ mat
    denom = norms[:, None] * norms[None, :] + shrink + 1e-6
    sim = sim / denom
    np.fill_diagonal(sim, 0.0)
    # top-k truncation per row
    if k < n_i:
        idx = np.argpartition(-sim, kth=min(k, n_i - 1), axis=1)[:, k:]
        np.put_along_axis(sim, idx, 0.0, axis=1)
    return {"item_sim": sim.astype(np.float32), "user_hist_matrix": mat}


@register_model
class ItemKNN(HistoryProductRecommender):
    matrix = "item_sim"

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, k: int = 100,
                 shrink: float = 0.0, item_sim: Optional[np.ndarray] = None,
                 user_hist_matrix: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.k, self.shrink = int(k), float(shrink)
        self._init_state(user_hist_matrix, item_sim)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return itemknn_state(train_split, **config_values(config, {"k": 100, "shrink": 0.0}))

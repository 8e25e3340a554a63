"""EASE, the closed-form item-item model.

Port of `oovrec_tpu/models/general/more.py:21-57` (the module's other
model, MultiVAE, is not ported yet). A traditional model
(`models/general/base.py`): B = −P / diag(P) column by column, with
P = (XᵀX + λI)⁻¹ and a zero diagonal, solved once on the host by the
JAX package's numpy, copied as it is (`ease_state`), so the two states
agree bit for bit. `build_estate` reads `reg_weight` from the config.
Scoring is `user_hist_matrix[users] @ ease_B` on the model's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.general.base import HistoryProductRecommender, config_values


def ease_state(train_split, reg_weight: float = 250.0) -> dict:
    """`EASE.build_estate` of the JAX package (`more.py:45-57`)."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    X = np.zeros((train_split.user_num, train_split.item_num), np.float32)
    X[uid, iid] = 1.0
    G = X.T @ X + reg_weight * np.eye(X.shape[1], dtype=np.float32)
    P = np.linalg.inv(G)
    # column-wise division: B_ij = −P_ij / P_jj (`ease.py:48`, the
    # paper's B = I − P·diagMat(1/diag P))
    B = -P / np.diag(P)[None, :]
    np.fill_diagonal(B, 0.0)
    return {"ease_B": B.astype(np.float32), "user_hist_matrix": X}


@register_model
class EASE(HistoryProductRecommender):
    matrix = "ease_B"

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 reg_weight: float = 250.0, ease_B: Optional[np.ndarray] = None,
                 user_hist_matrix: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.reg_weight = float(reg_weight)
        self._init_state(user_hist_matrix, ease_B)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return ease_state(train_split, **config_values(config, {"reg_weight": 250.0}))

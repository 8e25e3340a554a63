"""Pop and Random, the baselines.

Port of `oovrec_tpu/models/general/pop.py:16-71`. Both are traditional
models (`models/general/base.py:TraditionalRecommender`):
  * Pop scores every item by its interaction count in the training split
    (`build_estate`, the buffer `item_cnt`), divided by the largest count
    (at least 1);
  * Random scores uniformly in [0, 1). `jax.random`'s draws cannot be
    matched; the port draws from a fixed `torch.Generator` on the model's
    device (seed 0 for `predict`, 7 for `full_sort_scores`), so every call
    of one shape gives the same scores, as the JAX package's fixed keys
    give.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.general.base import TraditionalRecommender, set_state


@register_model
class Pop(TraditionalRecommender):
    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 item_cnt: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        set_state(self, "item_cnt", item_cnt, (n_items,), torch.int64)

    def _counts(self) -> torch.Tensor:
        cnt = self.item_cnt.float()
        return cnt / torch.clamp(cnt.max(), min=1.0)

    def predict(self, batch: Batch) -> torch.Tensor:
        return self._counts()[batch[self.iid_field].long()]

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        c = self._counts()
        return c.expand(batch[self.uid_field].shape[0], c.shape[0])

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        cnt = np.zeros(train_split.item_num, dtype=np.int64)
        np.add.at(cnt, train_split.inter[train_split.iid_field], 1)
        return {"item_cnt": cnt}


@register_model
class Random(TraditionalRecommender):
    def _uniform(self, shape, seed: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return torch.rand(shape, generator=g, device=self.device)

    def predict(self, batch: Batch) -> torch.Tensor:
        return self._uniform((batch[self.iid_field].shape[0],), 0)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        return self._uniform((batch[self.uid_field].shape[0], self.n_items), 7)

"""Shared pieces of the general models.

  * `TraditionalRecommender`: the models without gradient training (Pop,
    Random and the host solves). As in the JAX package each holds one
    zero parameter `dummy` (1,), so that the optimizer has a tree and the
    bridge a leaf; its loss is `sum(dummy · 0)`. `Trainer.fit` evaluates
    such a model once and trains no epoch.
  * `set_state`: a model's dataset-derived arrays as its buffers on its
    device (`utils/jax_params.py:MODEL_STATE`: they ride the state_dict
    and load from a JAX checkpoint's `estate`, the bridge never carries
    them), zeros of a given shape where the array is not given.
  * `config_values`: the values a state's build reads from the config, in
    the type of their defaults. The JAX driver hands `build_estate` no
    config, so its states keep the keyword defaults whatever the config
    says (ROADMAP §3); the port reads the config, and at the YAML defaults
    the two states are the same.
  * `history_matrix`: the (user_num, item_num) float32 0/1 matrix of a
    training split.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, GeneralRecommender
from oovrec_tpu_torch.utils.enums import InputType, ModelType


def config_values(config: Optional[Mapping[str, Any]], defaults: Dict[str, Any]) -> Dict[str, Any]:
    """`defaults` with each value that `config` holds, in the default's
    type (YAML reads `250` as an int, `1e-05` as a string)."""
    out = dict(defaults)
    if config is None:
        return out
    for name, default in defaults.items():
        value = config[name] if name in config.keys() else None
        if value is None:
            continue
        if isinstance(default, bool):
            value = value.lower() in ("true", "1", "yes") if isinstance(value, str) else bool(value)
        elif isinstance(default, (int, float)):
            value = type(default)(float(value)) if isinstance(default, int) else float(value)
        out[name] = value
    return out


def history_matrix(train_split) -> np.ndarray:
    """(user_num, item_num) float32: 1 where the split has the pair."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    mat = np.zeros((train_split.user_num, train_split.item_num), np.float32)
    mat[uid, iid] = 1.0
    return mat


def set_state(model: torch.nn.Module, name: str, value: Optional[np.ndarray], shape,
              dtype: torch.dtype) -> None:
    """Register `value` (or zeros of `shape`) as the buffer `name`."""
    t = (torch.zeros(shape, dtype=dtype) if value is None
         else torch.as_tensor(np.asarray(value)).to(dtype))
    model.register_buffer(name, t.to(model.device))


class TraditionalRecommender(GeneralRecommender):
    """A model fitted once from the training split (`build_estate`), with
    no gradient training."""

    model_type = ModelType.TRADITIONAL
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.dummy = torch.nn.Parameter(torch.zeros(1, device=self.device))

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        return (self.dummy * 0.0).sum()

    def predict(self, batch: Batch) -> torch.Tensor:
        """The full-sort score of each row's item."""
        s = self.full_sort_scores(batch)
        return s.gather(1, batch[self.iid_field].long()[:, None]).squeeze(1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        raise NotImplementedError


class HistoryProductRecommender(TraditionalRecommender):
    """Scores `user_hist_matrix[users] @ <item-item matrix>`, a plain
    product on the model's device (the JAX package computes it outside
    any Pallas kernel). `matrix` names the item-item buffer."""

    matrix = ""

    def _init_state(self, user_hist_matrix, matrix) -> None:
        set_state(self, "user_hist_matrix", user_hist_matrix, (self.n_users, self.n_items),
                  torch.float32)
        set_state(self, self.matrix, matrix, (self.n_items, self.n_items), torch.float32)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        hist = self.user_hist_matrix[batch[self.uid_field].long()]
        return hist @ getattr(self, self.matrix)

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
  * `l2_rows`, `normal_table`: each row over its L2 norm (floor 1e-12);
    a table drawn normal(0, 0.01), the JAX models' `normal_init(0.01)`.
  * `history_matrix`: the (user_num, item_num) float32 0/1 matrix of a
    training split; `HistoryMatrixModel` keeps it as the buffer
    `user_hist_matrix` and reads a batch's rows of it.
  * `padded_history`: each user's training items in split order, padded
    and cut at `max_len` (`hist_items` / `hist_len`), the state of FISM,
    NAIS and ENMF (`PaddedHistoryModel`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import Batch, GeneralRecommender
from oovrec_tpu_torch.models.init import normal_init
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


def l2_rows(x: torch.Tensor, floor: float = 1e-12) -> torch.Tensor:
    """Each row over max(‖row‖, floor)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=floor)


def normal_table(model: GeneralRecommender, vocab: int, dim: int,
                 std: float = 0.01) -> torch.nn.Embedding:
    """A (vocab, dim) table drawn normal(0, std) from the model's generator."""
    table = torch.nn.Embedding(vocab, dim, device=model.device)
    normal_init(std)(table.weight, model.generator)
    return table


def predict_from_full_sort(model, batch: Batch) -> torch.Tensor:
    """The full-sort score of each row's item (a model whose `predict` is
    its full sort's column)."""
    s = model.full_sort_scores(batch)
    return s.gather(1, batch[model.iid_field].long()[:, None]).squeeze(1)


def history_matrix(train_split) -> np.ndarray:
    """(user_num, item_num) float32: 1 where the split has the pair."""
    uid = train_split.inter[train_split.uid_field]
    iid = train_split.inter[train_split.iid_field]
    mat = np.zeros((train_split.user_num, train_split.item_num), np.float32)
    mat[uid, iid] = 1.0
    return mat


def history_state(train_split, config=None) -> dict:
    """{"user_hist_matrix"}: `MultiVAE.build_estate` of the JAX package
    (`more.py:132-138`), shared by the models that read it."""
    return {"user_hist_matrix": history_matrix(train_split)}


def padded_history(train_split, max_len: int = 200) -> dict:
    """`_HistModel.build_estate` of the JAX package (`more3.py:26-38`):
    (user_num, H) int64 `hist_items`, each user's items in
    `used_ids_per_user` order, the first H kept, H the longest history
    cut at `max_len`; `hist_len` the kept counts."""
    per_user = train_split.used_ids_per_user()
    H = min(max((len(p) for p in per_user), default=1) or 1, max_len)
    hist = np.zeros((train_split.user_num, H), np.int64)
    lens = np.zeros(train_split.user_num, np.int64)
    for u, items in enumerate(per_user):
        items = np.asarray(items)[:H]
        hist[u, : len(items)] = items
        lens[u] = len(items)
    return {"hist_items": hist, "hist_len": lens}


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

    predict = predict_from_full_sort

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


class HistoryMatrixModel(GeneralRecommender):
    """A trained model over rows of the training matrix, kept as the
    buffer `user_hist_matrix` (`history_state`). `predict` is the full
    sort's score of each row's item."""

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 user_hist_matrix: Optional[np.ndarray] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        set_state(self, "user_hist_matrix", user_hist_matrix, (n_users, n_items), torch.float32)

    build_estate = staticmethod(history_state)

    def history(self, users: torch.Tensor) -> torch.Tensor:
        """(B, n_items): the users' rows of the training matrix."""
        return self.user_hist_matrix[users.long()]

    predict = predict_from_full_sort


class PaddedHistoryModel(GeneralRecommender):
    """A model over each user's padded item history (`padded_history`),
    kept as the buffers `hist_items` / `hist_len`."""

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 hist_items: Optional[np.ndarray] = None, hist_len: Optional[np.ndarray] = None,
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        set_state(self, "hist_items", hist_items, (n_users, 1), torch.int64)
        set_state(self, "hist_len", hist_len, (n_users,), torch.int64)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        return padded_history(train_split)

    def padded(self, users: torch.Tensor):
        """(hist (B, H), inside (B, H) bool): the users' items and where
        their histories hold them."""
        users = users.long()
        hist = self.hist_items[users]
        positions = torch.arange(hist.shape[1], device=hist.device)
        inside = positions[None, :] < self.hist_len[users][:, None]
        return hist, inside

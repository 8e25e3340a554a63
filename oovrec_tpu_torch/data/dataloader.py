"""Eval batches: fixed-shape host-side batch assembly.

Port of `oovrec_tpu/data/dataloader.py:38-67, 345-494`: full-sort batches
for retrieval models and plain labelled rows for ranking (VALUE-metric)
models. Every batch has the same shape; the final partial batch is padded
and carries a `weight` column (1 real / 0 pad). Training and
sampled-negative batchers come with later slices.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from oovrec_tpu_torch.data.dataset import DatasetSplit
from oovrec_tpu_torch.data.sampler import Sampler

Batch = Dict[str, np.ndarray]


def _process_info(
    process_index: Optional[int], process_count: Optional[int]
) -> tuple:
    """The (rank, world) pair for per-process data sharding, as the caller
    gives it; one process when it gives none."""
    return int(process_index or 0), int(process_count or 1)


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if len(arr) == n:
        return arr
    pad_shape = (n - len(arr),) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, dtype=arr.dtype)])


def _join_features(
    batch: Batch, ids: np.ndarray, feat: Optional[Dict[str, np.ndarray]],
    id_field: str,
) -> None:
    """Attach per-row user/item feature columns (the reference's `join`)."""
    if feat is None:
        return
    for field, table in feat.items():
        if field == id_field or field.endswith("_len"):
            continue
        batch[field] = table[ids]


class FullSortEvalBatcher:
    """Full-corpus ranking eval batches (FullSortEvalDataLoader analog).

    Emits per batch: `user_id (U,)`, padded `pos_items (U,P)` + `pos_len`,
    padded `hist_items (U,H)` + `hist_len`, and `weight (U,)`. History =
    (cumulative used ids for this phase) minus this split's positives
    (`general_dataloader.py:220-254`).
    """

    def __init__(
        self,
        split: DatasetSplit,
        sampler: Optional[Sampler],
        config,
        phase: str = "test",
        batch_size: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.split = split
        self.config = config
        self.phase = phase
        self.uid_field = split.uid_field
        self.iid_field = split.iid_field
        self.item_num = split.item_num

        bs = batch_size or config["eval_batch_size"]
        self.users_per_batch = max(1, bs // self.item_num)

        pos_per_user = split.used_ids_per_user()
        uids = np.unique(split.inter[self.uid_field])
        uids = uids[uids != 0]

        # per-process user sharding (DistributedSampler semantics): each
        # process keeps its interleaved user slice; batch counts stay
        # uniform across processes
        self.process_index, self.process_count = _process_info(
            process_index, process_count
        )
        self.n_global_users = len(uids)
        all_uids = uids
        if self.process_count > 1:
            self.users_per_batch = max(
                1, self.users_per_batch // self.process_count
            )
            uids = uids[self.process_index :: self.process_count]
        self.uid_list = uids

        if sampler is not None and phase in sampler.used_ids:
            used = sampler.used_ids[phase]
        else:
            used = [np.array([], dtype=np.int64)] * split.user_num

        # pad dims over the GLOBAL user set, so every process emits
        # identically shaped batches
        per_u = {}
        for u in all_uids:
            pos = np.asarray(pos_per_user[u], dtype=np.int64)
            per_u[u] = (pos, np.setdiff1d(used[u], pos))
        self.max_pos = max(
            (len(p) for p, _ in per_u.values()), default=1
        ) or 1
        self.max_hist = max(
            (len(h) for _, h in per_u.values()), default=1
        ) or 1
        self._pos: List[np.ndarray] = [per_u[u][0] for u in self.uid_list]
        self._hist: List[np.ndarray] = [per_u[u][1] for u in self.uid_list]

    def __len__(self) -> int:
        max_local = -(-self.n_global_users // self.process_count)
        if not max_local:
            return 0
        return -(-max_local // self.users_per_batch)

    def __iter__(self) -> Iterator[Batch]:
        U = self.users_per_batch
        for start in range(0, len(self) * U, U):
            sel = slice(start, start + U)
            users = self.uid_list[sel]
            n_real = len(users)
            pos = np.zeros((U, self.max_pos), dtype=np.int64)
            pos_len = np.zeros(U, dtype=np.int64)
            hist = np.zeros((U, self.max_hist), dtype=np.int64)
            hist_len = np.zeros(U, dtype=np.int64)
            for i, (p, h) in enumerate(
                zip(self._pos[sel], self._hist[sel])
            ):
                pos[i, : len(p)] = p
                pos_len[i] = len(p)
                hist[i, : len(h)] = h
                hist_len[i] = len(h)
            weight = np.zeros(U, dtype=np.float32)
            weight[:n_real] = 1.0
            yield {
                "user_id": _pad_to(users, U),
                "pos_items": pos,
                "pos_len": pos_len,
                "hist_items": hist,
                "hist_len": hist_len,
                "weight": weight,
            }


class PlainEvalBatcher:
    """'labeled' eval mode: plain interaction rows with their labels and
    joined user/item features (the reference's NegSampleEvalDataLoader
    'none'-distribution branch, `general_dataloader.py:189-195`). Used by
    VALUE-metric models."""

    def __init__(self, split: DatasetSplit, config,
                 batch_size: Optional[int] = None):
        self.split = split
        self.config = config
        self.label_field = split.label_field
        self.batch_size = batch_size or config["eval_batch_size"]
        self.user_feat = split.user_feat
        self.item_feat = split.item_feat

    def __len__(self) -> int:
        return (len(self.split) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        inter = self.split.inter
        n = len(self.split)
        for start in range(0, n, self.batch_size):
            idx = np.arange(start, min(start + self.batch_size, n))
            batch = {k: v[idx] for k, v in inter.items()}
            _join_features(
                batch, batch[self.split.iid_field], self.item_feat,
                self.split.iid_field,
            )
            _join_features(
                batch, batch[self.split.uid_field], self.user_feat,
                self.split.uid_field,
            )
            w = np.zeros(self.batch_size, np.float32)
            w[: len(idx)] = 1.0
            batch = {k: _pad_to(np.asarray(v), self.batch_size)
                     for k, v in batch.items()}
            batch["weight"] = w
            yield batch

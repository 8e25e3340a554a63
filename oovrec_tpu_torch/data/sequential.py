"""Sequential dataset: next-item augmentation, its splits and eval batches.

Port of `oovrec_tpu/data/sequential.py:21-192` over the port's numpy
tables (no pandas). After the standard processing the interactions are
ordered by (user, time), ties kept in row order (a stable sort), and
every row with a same-user predecessor becomes an example: the window of
up to MAX_ITEM_LIST_LENGTH items before it → its item. The examples are
padded arrays: `item_id_list` (n, L), `item_length`, the target `item_id`
and `uid`, bit for bit those of the JAX loop (`:34-61`), here built
without a loop over rows: a row p of a user whose rows start at s has its
window at max(s, p − L) (the loop's `seq_start`, which moves one row at a
time once the window is full).

DIEN's presampled negatives (`dien_neg_sampling: presampled`): one
uniform negative an interaction, redrawn while it equals the positive at
that position, in the JAX stream's order, then windowed like the items.

`build` is the leave-one-out over each user's examples (`:104-126`): the
last example to test, the one before to valid, the rest to train (two
examples: train and test; one: train). `SeqFullSortEvalBatcher` ranks
each example's target against the full item set, `eval_batch_size //
n_items` examples a batch, the input sequence masked unless `repeatable`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from oovrec_tpu_torch.data.dataset import Dataset, DatasetSplit, _grouped_index


def window_starts(uid_sorted: np.ndarray, max_len: int):
    """For rows sorted by user: (rows that make an example, each one's
    window start). A user's first row makes none."""
    n = len(uid_sorted)
    pos = np.arange(n)
    first = np.ones(n, bool)
    first[1:] = uid_sorted[1:] != uid_sorted[:-1]
    user_start = np.maximum.accumulate(np.where(first, pos, 0))
    rows = pos[~first]
    return rows, np.maximum(user_start[rows], rows - max_len)


def windows(values: np.ndarray, rows: np.ndarray, starts: np.ndarray,
            max_len: int) -> np.ndarray:
    """(len(rows), max_len) int64: values[start:row] left-aligned, 0 after."""
    cols = np.arange(max_len)
    idx = starts[:, None] + cols
    keep = idx < rows[:, None]
    out = np.zeros((len(rows), max_len), np.int64)
    out[keep] = values[idx[keep]]
    return out


class SequentialDataset(Dataset):
    def __init__(self, config):
        self.max_item_list_len = int(config["MAX_ITEM_LIST_LENGTH"])
        self.item_list_length_field = config["ITEM_LIST_LENGTH_FIELD"]
        self.list_suffix = config["LIST_SUFFIX"]
        self.neg_prefix = config.get("NEG_PREFIX") or "neg_"
        super().__init__(config)
        self._augmented = None

    def data_augmentation(self) -> Dict[str, np.ndarray]:
        """The (uid, window, target) examples, built once."""
        if self._augmented is not None:
            return self._augmented
        inter = self.inter_feat
        order = np.lexsort((inter[self.time_field], inter[self.uid_field]))
        uid = np.asarray(inter[self.uid_field], np.int64)[order]
        iid = np.asarray(inter[self.iid_field], np.int64)[order]
        L = self.max_item_list_len
        rows, starts = window_starts(uid, L)
        self._augmented = {
            self.uid_field: uid[rows],
            self.iid_field: iid[rows],
            self.iid_field + self.list_suffix: windows(iid, rows, starts, L),
            self.item_list_length_field: (rows - starts).astype(np.int64),
        }
        if self.config.get("dien_neg_sampling") == "presampled":
            rng = np.random.default_rng(int(self.config.get("seed") or 0))
            neg = np.zeros(len(iid), np.int64)
            pending = np.arange(len(iid))
            while len(pending):
                neg[pending] = rng.integers(1, self.item_num, len(pending))
                pending = pending[neg[pending] == iid[pending]]
            self._augmented[self.neg_prefix + self.iid_field + self.list_suffix] = windows(
                neg, rows, starts, L)
        return self._augmented

    def build(self):
        """Leave-one-out over each user's examples → [train, valid, test]."""
        aug = self.data_augmentation()
        groups = _grouped_index(aug[self.uid_field])
        sizes = np.array([len(g) for g in groups], np.int64)
        order = np.concatenate(groups) if groups else np.zeros(0, np.int64)
        size = np.repeat(sizes, sizes)
        # each example's place from its user's last one (0 = the last)
        from_end = np.repeat(np.cumsum(sizes), sizes) - 1 - np.arange(len(order))
        test = (size >= 2) & (from_end == 0)
        valid = (size >= 3) & (from_end == 1)
        train = ~(test | valid)
        return [SeqDatasetSplit(self, order[m]) for m in (train, valid, test)]


class SeqDatasetSplit(DatasetSplit):
    """A split over the augmented example table, with the parent's counts,
    field names and feature tables."""

    def __init__(self, parent: SequentialDataset, index: np.ndarray):
        index = np.asarray(index, dtype=np.int64)
        aug = parent.data_augmentation()
        super().__init__(
            {k: v[index] for k, v in aug.items()}, parent.user_num, parent.item_num,
            uid_field=parent.uid_field, iid_field=parent.iid_field,
            label_field=parent.label_field,
            user_feat=parent.get_user_feature() if parent.user_feat is not None else None,
            item_feat=parent.get_item_feature() if parent.item_feat is not None else None,
        )
        self.parent, self.index = parent, index
        self.config = parent.config


class SeqFullSortEvalBatcher:
    """Full-sort eval over augmented examples: a row an example, positives
    = {target}, history = the input sequence (none under `repeatable`),
    `weight` 0 on the last batch's padding rows."""

    def __init__(self, split: SeqDatasetSplit, config, batch_size=None):
        self.split = split
        self.config = config
        self.item_num = split.item_num
        bs = batch_size or config["eval_batch_size"]
        self.rows_per_batch = max(1, bs // self.item_num)
        self.repeatable = bool(config["repeatable"])
        self.list_field = split.iid_field + config["LIST_SUFFIX"]
        self.length_field = config["ITEM_LIST_LENGTH_FIELD"]

    def __len__(self) -> int:
        return -(-len(self.split) // self.rows_per_batch)

    def __iter__(self):
        inter = self.split.inter
        n, R = len(self.split), self.rows_per_batch
        for start in range(0, n, R):
            stop = min(start + R, n)
            pad = R - (stop - start)
            batch = {k: v[start:stop] for k, v in inter.items()}
            if pad:
                batch = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                         for k, v in batch.items()}
            batch["pos_items"] = batch[self.split.iid_field][:, None]
            batch["pos_len"] = np.ones(R, np.int64)
            if self.repeatable:
                batch["hist_items"] = np.zeros((R, 1), np.int64)
                batch["hist_len"] = np.zeros(R, np.int64)
            else:
                batch["hist_items"] = batch[self.list_field]
                batch["hist_len"] = batch[self.length_field]
            w = np.zeros(R, np.float32)
            w[: stop - start] = 1.0
            batch["weight"] = w
            yield batch

"""Batchers: fixed-shape host-side batch assembly.

Port of `oovrec_tpu/data/dataloader.py:38-342, 345-855`: training batches
with negative sampling (`TrainBatcher`), with a block of knowledge-graph
triples (`KGTrainBatcher`) or of users (`UserTrainBatcher`), full-sort batches for retrieval
models, plain labelled rows for ranking (VALUE-metric) models and the
sampled-negative eval batches of the `uniN` / `popN` modes
(`NegSampleEvalBatcher`). Every batch has the same shape; the final
partial batch is padded and carries a `weight` column (1 real / 0 pad).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from oovrec_tpu_torch.data.dataset import DatasetSplit
from oovrec_tpu_torch.data.sampler import Sampler
from oovrec_tpu_torch.data.transform import construct_transform
from oovrec_tpu_torch.utils.enums import InputType
from oovrec_tpu_torch.utils.seeding import host_rng

Batch = Dict[str, np.ndarray]


def _process_info(
    process_index: Optional[int], process_count: Optional[int]
) -> tuple:
    """The (rank, world) pair for per-process data sharding: the
    caller's pair; else, under a mesh (`parallel/mesh.py:active_mesh`),
    the rank's (data coordinate, n_data), so the ranks of one model group
    see the same rows (the JAX package's `jax.process_index/count` read,
    `dataloader.py:39-47` there); else one process."""
    if process_count is not None:
        return int(process_index or 0), int(process_count)
    from oovrec_tpu_torch.parallel.mesh import active_mesh

    mesh = active_mesh()
    if mesh is not None:
        return mesh.data_index, mesh.n_data
    return int(process_index or 0), 1


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if len(arr) == n:
        return arr
    pad_shape = (n - len(arr),) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, dtype=arr.dtype)])


def _join_features(
    batch: Batch, ids: np.ndarray, feat: Optional[Dict[str, np.ndarray]],
    id_field: str, prefix: str = "",
) -> None:
    """Attach per-row user/item feature columns (the reference's `join`)."""
    if feat is None:
        return
    for field, table in feat.items():
        if field == id_field or field.endswith("_len"):
            continue
        batch[prefix + field] = table[ids]


class TrainBatcher:
    """Training batches with negative sampling (TrainDataLoader analog).

    Modes as the JAX batcher: `plain` (no sampling: the rows as they are),
    `pairwise` (rows tiled `sample_num` times, a `neg_<item>` column laid
    out column-major, with the negatives' item features) and `pointwise`
    (rows tiled 1 + `sample_num` times, the copies' items replaced by
    negatives with label 0: [positives ∥ negative copies]). The shuffle is
    `host_rng(seed + epoch, "train_shuffle_<phase>")`, so the batches equal
    the JAX batcher's key for key. The feature tables are the split's
    `user_feat` / `item_feat`; the process pair comes from the caller.
    Each batch goes through the config's transform (`data/transform.py`)
    last.

    Dynamic hard negatives (`train_neg_sample_args: {dynamic: true,
    candidate_num: C}`, `dataloader.py:103-107, 147-171` of the JAX
    package): each slot's C candidates come from the sampler's stream as
    one draw of sample_num · C, the scorer the trainer registers
    (`set_model_scorer`) scores them against the row's user, and the
    highest score wins, the first candidate on a tie (`numpy.argmax`).
    Without a scorer, or with C ≤ 1, the draw is the plain one.
    """

    def __init__(
        self,
        split: DatasetSplit,
        sampler: Optional[Sampler],
        config,
        input_type: InputType,
        phase: str = "train",
        neg_sample_args: Optional[dict] = None,
        batch_size: Optional[int] = None,
        shuffle: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.split = split
        self.sampler = sampler
        self.config = config
        self.input_type = input_type
        self.phase = phase
        self.shuffle = shuffle
        self.uid_field = split.uid_field
        self.iid_field = split.iid_field
        self.label_field = split.label_field
        self.neg_prefix = config["NEG_PREFIX"] or "neg_"
        self._epoch = 0

        nsa = neg_sample_args or config["train_neg_sample_args"] or {}
        self.distribution = nsa.get("distribution", "none")
        self.sample_num = (
            int(nsa.get("sample_num", 0)) if self.distribution != "none" else 0
        )
        self.dynamic = bool(nsa.get("dynamic", False))
        self.candidate_num = int(nsa.get("candidate_num", 0) or 0)
        self._scorer = None  # fn(users, items) -> scores, set_model_scorer
        if self.distribution == "none" or self.sample_num == 0:
            self.times = 1
            self.mode = "plain"
        elif input_type == InputType.PAIRWISE:
            self.times = self.sample_num
            self.mode = "pairwise"
        else:
            self.times = 1 + self.sample_num
            self.mode = "pointwise"

        bs = batch_size or config["train_batch_size"]
        if self.mode == "plain":
            self.step = bs
            self.batch_size = bs
        else:
            # the batch holds `step` positives, expanded to step * times rows
            self.step = max(bs // self.times, 1)
            self.batch_size = self.step * self.times

        # per-process data sharding: every process walks the same shuffled
        # order and takes its interleaved slice
        self.process_index, self.process_count = _process_info(
            process_index, process_count
        )
        self.local_step = (
            max(self.step // self.process_count, 1)
            if self.process_count > 1
            else self.step
        )
        self.user_feat = split.user_feat
        self.item_feat = split.item_feat
        self.transform = construct_transform(config, n_items=split.item_num)

    def set_model_scorer(self, fn) -> None:
        """Register the scorer of dynamic negative sampling: `fn(users,
        items)` (two int arrays of one length) → their scores."""
        self._scorer = fn

    def _sample_negs(self, users: np.ndarray) -> np.ndarray:
        """(len(users), sample_num) negatives; in dynamic mode the
        highest-scoring of candidate_num draws a slot."""
        if not (self.dynamic and self.candidate_num > 1 and self._scorer):
            return self.sampler.sample_negatives(self.phase, users, self.sample_num)
        n, c = self.sample_num, self.candidate_num
        cand = self.sampler.sample_negatives(self.phase, users, n * c)
        cand = cand.reshape(len(users), n, c)
        scores = np.asarray(self._scorer(np.repeat(users, n * c), cand.reshape(-1)))
        pick = scores.reshape(len(users), n, c).argmax(axis=2)
        return np.take_along_axis(cand, pick[:, :, None], axis=2)[:, :, 0]

    def __len__(self) -> int:
        n = len(self.split)
        if not n:
            return 0
        max_local = -(-n // self.process_count)
        return max(-(-max_local // self.local_step), 1)

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.split)
        order = np.arange(n)
        if self.shuffle:
            rng = host_rng(
                int(self.config["seed"] or 0) + self._epoch, f"train_shuffle_{self.phase}"
            )
            rng.shuffle(order)
        self._epoch += 1
        local = order[self.process_index :: self.process_count]
        max_local = -(-n // self.process_count)
        n_batches = max(-(-max_local // self.local_step), 1) if n else 0
        for b in range(n_batches):
            idx = local[b * self.local_step : (b + 1) * self.local_step]
            yield self._make_batch(idx)

    def _make_batch(self, idx: np.ndarray) -> Batch:
        inter = self.split.inter
        rows = {k: v[idx] for k, v in inter.items()}
        users = rows[self.uid_field]
        items = rows[self.iid_field]
        n_real = len(idx)

        if self.mode == "pairwise":
            neg = self._sample_negs(users)
            batch: Batch = {
                k: np.tile(v, (self.times,) + (1,) * (v.ndim - 1))
                for k, v in rows.items()
            }
            neg_flat = neg.flatten(order="F")
            batch[self.neg_prefix + self.iid_field] = neg_flat
            _join_features(batch, batch[self.iid_field], self.item_feat, self.iid_field)
            _join_features(batch, neg_flat, self.item_feat, self.iid_field,
                           prefix=self.neg_prefix)
            _join_features(batch, batch[self.uid_field], self.user_feat, self.uid_field)
            weight = np.zeros(self.local_step * self.times, dtype=np.float32)
            weight[: n_real * self.times] = 1.0
            total = self.local_step * self.times
        elif self.mode == "pointwise":
            neg = self._sample_negs(users)
            batch = {
                k: np.tile(v, (self.times,) + (1,) * (v.ndim - 1))
                for k, v in rows.items()
            }
            neg_flat = neg.flatten(order="F")
            batch[self.iid_field] = np.concatenate([items, neg_flat])
            label = np.zeros(n_real * self.times, dtype=np.float32)
            label[:n_real] = 1.0
            batch[self.label_field] = label
            _join_features(batch, batch[self.iid_field], self.item_feat, self.iid_field)
            _join_features(batch, batch[self.uid_field], self.user_feat, self.uid_field)
            weight = np.ones(n_real * self.times, dtype=np.float32)
            total = self.local_step * self.times
        else:
            batch = rows
            _join_features(batch, items, self.item_feat, self.iid_field)
            _join_features(batch, users, self.user_feat, self.uid_field)
            weight = np.ones(n_real, dtype=np.float32)
            total = self.local_step

        batch = {k: _pad_to(np.asarray(v), total) for k, v in batch.items()}
        batch["weight"] = _pad_to(weight, total)
        return self.transform(batch)


class KGTrainBatcher(TrainBatcher):
    """Training batches of a knowledge model (`dataloader.py:303-342` of
    the JAX package): each row batch of `TrainBatcher` (after its
    transform) carries as many knowledge-graph triples, `kg_head`,
    `kg_relation`, `kg_pos_tail`, with a negative tail each from the
    `KGSampler` (`kg_neg_tail`) and `kg_weight` 1. The triples are taken
    in order from a permutation of the whole graph
    (`host_rng(seed, "kg_batcher")`), drawn anew when a batch would run
    past its end; a graph smaller than a batch is tiled to the batch."""

    def __init__(self, *args, kg_dataset=None, kg_sampler=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._kg = kg_dataset.kg_triples
        self.kg_sampler = kg_sampler
        self._kg_rng = host_rng(int(self.config["seed"] or 0), "kg_batcher")
        self._kg_order: Optional[np.ndarray] = None
        self._kg_pos = 0

    def _next_triples(self, n: int):
        heads, rels, tails = self._kg
        total = len(heads)
        if self._kg_order is None or self._kg_pos + n > total:
            self._kg_order = self._kg_rng.permutation(total)
            self._kg_pos = 0
        sel = self._kg_order[self._kg_pos:self._kg_pos + n]
        self._kg_pos += n
        return heads[sel], rels[sel], tails[sel]

    def _make_batch(self, idx: np.ndarray) -> Batch:
        batch = super()._make_batch(idx)
        n = len(batch["weight"])
        h, r, t = self._next_triples(n)
        if len(h) < n:
            reps = -(-n // max(len(h), 1))
            h, r, t = (np.tile(x, reps)[:n] for x in (h, r, t))
        batch["kg_head"] = h
        batch["kg_relation"] = r
        batch["kg_pos_tail"] = t
        batch["kg_neg_tail"] = self.kg_sampler.sample_negatives(h, 1)[:, 0]
        batch["kg_weight"] = np.ones(n, np.float32)
        return batch


class UserTrainBatcher:
    """Batches of the training split's users (`dataloader.py:256-300` of
    the JAX package) for the models that read a user's whole history
    (`train_on_users`: the autoencoders and ENMF): the unique non-zero
    users, shuffled each epoch by `host_rng(seed + epoch, "user_batcher")`,
    `train_batch_size` a batch, the last one padded with user 0 at weight
    0. A batch holds the user ids and `weight`, nothing else."""

    def __init__(self, split: DatasetSplit, config):
        self.split = split
        self.config = config
        self.uid_field = split.uid_field
        self.iid_field = split.iid_field
        self.label_field = split.label_field
        uids = np.unique(split.inter[self.uid_field])
        self.uid_list = uids[uids != 0]
        self.batch_size = config["train_batch_size"]
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.uid_list) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idx) -> Batch:
        """The users at positions `idx` (cycled), at least two rows."""
        sel = self.uid_list[np.asarray(idx) % len(self.uid_list)]
        n = len(sel)
        return {self.uid_field: _pad_to(sel, max(n, 2)),
                "weight": _pad_to(np.ones(n, np.float32), max(n, 2))}

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.uid_list))
        host_rng(int(self.config["seed"] or 0) + self._epoch, "user_batcher").shuffle(order)
        self._epoch += 1
        B = self.batch_size
        for start in range(0, len(order), B):
            sel = self.uid_list[order[start:start + B]]
            yield {self.uid_field: _pad_to(sel, B),
                   "weight": _pad_to(np.ones(len(sel), np.float32), B)}


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


class NegSampleEvalBatcher:
    """Sampled-negative eval batches for the `uniN` / `popN` eval modes
    (the paper's `uni250` protocol). Port of
    `oovrec_tpu/data/dataloader.py:497-780`, batch for batch and key for
    key.

    All of a user's eval rows are in one batch. Each batch holds every
    interaction field expanded per user (positives first, then the
    negative copies, column-major), `label`, `row_user` (the batch-local
    user slot of each row), `positive_u` / `positive_i` /
    `positive_weight`, `n_users`, `slot_users` and `weight`. One process
    packs users into batches by a row budget of `eval_batch_size`; several
    processes each take an interleaved user slice with a fixed users-per-
    batch `step`. A user's negatives come from its own stream,
    `host_rng(seed, "eval_sampling_<phase>_<user>")`, drawn once and
    cached (`eval_candidate_cache`). The process pair is the caller's (one
    process when it gives none).
    """

    def __init__(
        self,
        split: DatasetSplit,
        sampler: Optional[Sampler],
        config,
        phase: str,
        neg_sample_args: dict,
        batch_size: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.split = split
        self.sampler = sampler
        self.config = config
        self.phase = phase
        self.uid_field = split.uid_field
        self.iid_field = split.iid_field
        self.label_field = split.label_field
        self.item_num = split.item_num
        self.distribution = neg_sample_args.get("distribution", "uniform")
        self.sample_num = int(neg_sample_args.get("sample_num", 1))
        self.times = 1 + self.sample_num

        uid = split.inter[self.uid_field]
        order = np.argsort(uid, kind="stable")
        self._order = order
        su = uid[order]
        uniq, starts = np.unique(su, return_index=True)
        ends = np.concatenate([starts[1:], [len(su)]])
        self.uid_list = uniq
        self._slices = list(zip(starts, ends))
        self.uid2items_num = ends - starts

        bs = batch_size or config["eval_batch_size"]
        sizes = np.sort(self.uid2items_num * self.times)[::-1]
        step, acc = 1, int(sizes[0]) if len(sizes) else 1
        for i in range(1, len(sizes)):
            if acc + sizes[i] > bs:
                break
            step += 1
            acc += int(sizes[i])
        self.step = step
        self.max_rows = int(acc)
        self.max_users = step
        self.max_pos = int(
            np.sort(self.uid2items_num)[::-1][:step].sum()
        ) if len(self.uid2items_num) else 1
        # feature columns are joined onto the expanded rows only for models
        # that read them in predict() (context models; the runner decides)
        self.join_features = True

        self.process_index, self.process_count = _process_info(
            process_index, process_count
        )
        self.n_global_users = len(self.uid_list)
        self.slot_offset = 0
        if self.process_count > 1:
            self.step = max(1, self.step // self.process_count)
            sizes_desc = np.sort(self.uid2items_num * self.times)[::-1]
            self.max_rows = int(sizes_desc[: self.step].sum()) or 1
            self.max_users = self.step * self.process_count
            self.slot_offset = self.process_index * self.step
            self.max_pos = int(
                np.sort(self.uid2items_num)[::-1][: self.step].sum()
            ) or 1
            sel = slice(self.process_index, None, self.process_count)
            self.uid_list = self.uid_list[sel]
            self._slices = self._slices[sel]
            max_local = -(-self.n_global_users // self.process_count)
            n_batches = (max_local + self.step - 1) // self.step
            self._groups = [
                (i * self.step, min((i + 1) * self.step, len(self.uid_list)))
                for i in range(n_batches)
            ]
        else:
            # one process: users packed in uid order until the row budget
            row_sizes = self.uid2items_num * self.times
            groups = []
            gstart, acc = 0, 0
            for i, sz in enumerate(row_sizes):
                if i > gstart and acc + int(sz) > bs:
                    groups.append((gstart, i))
                    gstart, acc = i, 0
                acc += int(sz)
            if gstart < len(row_sizes):
                groups.append((gstart, len(row_sizes)))
            self._groups = groups
            self.max_users = max((e - s for s, e in self._groups), default=1) or 1
            self.step = self.max_users
            self.max_rows = int(max(
                (row_sizes[s:e].sum() for s, e in self._groups if e > s), default=1,
            )) or 1
            self.max_pos = int(max(
                (self.uid2items_num[s:e].sum() for s, e in self._groups if e > s),
                default=1,
            )) or 1

        self.user_feat = split.user_feat
        self.item_feat = split.item_feat

    def __len__(self) -> int:
        return len(self._groups)

    def _empty_batch(self) -> Batch:
        """An all-pad batch (weight 0): the tail batches of a process whose
        user slice ran out."""
        inter = self.split.inter
        batch: Batch = {
            k: np.zeros((self.max_rows,) + v.shape[1:], v.dtype)
            for k, v in inter.items()
        }
        batch[self.label_field] = np.zeros(self.max_rows, np.float32)
        batch["row_user"] = np.zeros(self.max_rows, np.int64)
        batch["weight"] = np.zeros(self.max_rows, np.float32)
        if self.join_features:
            _join_features(batch, batch[self.iid_field], self.item_feat, self.iid_field)
            _join_features(batch, batch[self.uid_field], self.user_feat, self.uid_field)
        batch["positive_u"] = np.zeros(self.max_pos, np.int64)
        batch["positive_i"] = np.zeros(self.max_pos, np.int64)
        batch["positive_weight"] = np.zeros(self.max_pos, np.float32)
        batch["n_users"] = np.array(0, dtype=np.int64)
        batch["slot_users"] = np.zeros(self.step, np.int64)
        return batch

    def _user_negs(self, u: int, rows_uid: np.ndarray) -> np.ndarray:
        """User `u`'s negatives, flattened column-major, from its own
        stream: the same set in every eval pass."""
        cache = getattr(self, "_neg_cache", None)
        if cache is None:
            cache = self._neg_cache = {}
        got = cache.get(int(u))
        if got is None:
            u_rng = host_rng(
                int(self.config["seed"] or 0), f"eval_sampling_{self.phase}_{int(u)}",
            )
            got = self.sampler.sample_negatives(
                self.phase, rows_uid, self.sample_num, rng=u_rng,
            ).flatten(order="F").astype(np.int32)
            if self.config.get("eval_candidate_cache", True) is not False:
                cache[int(u)] = got
        return got

    def __iter__(self) -> Iterator[Batch]:
        inter = self.split.inter
        order = self._order
        for bstart, bend in self._groups:
            users = self.uid_list[bstart:bend]
            if len(users) == 0:
                yield self._empty_batch()
                continue
            U = len(users)
            n_pos = self.uid2items_num[bstart:bend].astype(np.int64)
            starts = np.array([self._slices[bstart + i][0] for i in range(U)], np.int64)
            exp = n_pos * self.times
            total = int(exp.sum())
            u_of_row = np.repeat(np.arange(U), exp)
            p = np.arange(total) - np.repeat(np.cumsum(exp) - exp, exp)
            npos_row = n_pos[u_of_row]
            src = order[starts[u_of_row] + p % npos_row]
            batch: Batch = {k: _pad_to(v[src], self.max_rows) for k, v in inter.items()}
            # rows past the positives take the user's negatives (column-major:
            # slot j * n_pos + i is draw j for positive i, that is p - n_pos)
            neg_rows = p >= npos_row
            negs = np.concatenate([
                self._user_negs(
                    users[i],
                    inter[self.uid_field][order[starts[i]: starts[i] + n_pos[i]]],
                )
                for i in range(U)
            ])
            item_col = batch[self.iid_field]
            item_col[:total][neg_rows] = negs
            lab = np.zeros(self.max_rows, np.float32)
            lab[:total] = (~neg_rows).astype(np.float32)
            batch[self.label_field] = lab
            row_user = np.zeros(self.max_rows, np.int64)
            row_user[:total] = u_of_row + self.slot_offset
            batch["row_user"] = row_user
            w = np.zeros(self.max_rows, np.float32)
            w[:total] = 1.0
            batch["weight"] = w
            if self.join_features:
                _join_features(batch, batch[self.iid_field], self.item_feat, self.iid_field)
                _join_features(batch, batch[self.uid_field], self.user_feat, self.uid_field)
            pu = np.repeat(np.arange(U) + self.slot_offset, n_pos)
            pos_src = order[
                np.repeat(starts, n_pos)
                + (np.arange(int(n_pos.sum())) - np.repeat(np.cumsum(n_pos) - n_pos, n_pos))
            ]
            pi = inter[self.iid_field][pos_src]
            batch["positive_u"] = _pad_to(pu, self.max_pos)
            batch["positive_i"] = _pad_to(pi, self.max_pos)
            pw = np.zeros(self.max_pos, dtype=np.float32)
            pw[: len(pu)] = 1.0
            batch["positive_weight"] = pw
            batch["n_users"] = np.array(U, dtype=np.int64)
            batch["slot_users"] = _pad_to(users, self.step)
            yield batch

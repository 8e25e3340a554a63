"""Collector + Evaluator: per-batch accumulation → metric dict.

Equivalent of `recbole/evaluator/collector.py` + `evaluator.py` +
`register.py`. Device batches produce small host arrays
(`pos_idx@maxK ∥ pos_len` rows, or pooled scores/labels); the collector
accumulates them and `Evaluator.evaluate` folds the metric formulas.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from oovrec_tpu_torch.eval.metrics import (
    ITEM_METRICS,
    TOPK_METRICS,
    VALUE_METRICS,
    average_popularity_,
    gauc_,
    gini_index_,
    item_coverage_,
    shannon_entropy_,
    tail_percentage_,
    topk_result,
)


def metrics_needs(metrics) -> set:
    """Which data keys the chosen metrics require (`register.py` analog)."""
    need = set()
    for m in metrics:
        ml = m.lower()
        if ml in TOPK_METRICS:
            need.add("rec.topk")
        if ml in ITEM_METRICS:
            need.update(("rec.items", "data.num_items", "data.count_items"))
        if ml == "gauc":
            need.add("rec.meanrank")
        if ml in VALUE_METRICS:
            need.update(("rec.score", "data.label"))
    return need


class DataStruct:
    """Grow-by-concat tensor store (`collector.py:20-58`)."""

    def __init__(self):
        self._data: Dict[str, List[np.ndarray]] = {}

    def update_tensor(self, name: str, value: np.ndarray) -> None:
        self._data.setdefault(name, []).append(np.asarray(value))

    def get(self, name: str) -> np.ndarray:
        if name not in self._data:
            raise KeyError(f"{name} not in DataStruct")
        chunks = self._data[name]
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=0)

    def has(self, name: str) -> bool:
        return name in self._data


class Collector:
    """Accumulates eval resources batch by batch."""

    def __init__(self, config):
        self.config = config
        self.topk = config["topk"]
        self.maxk = max(self.topk)
        self.eval_type = config["eval_type"]
        self.data_struct = DataStruct()
        self.need = metrics_needs(config["metrics"] or [])
        self._meta: Dict[str, np.ndarray] = {}

    def data_collect(self, train_split) -> None:
        """Dataset-level resources: item totals + train interaction counts
        (`collector.py:79` data_collect)."""
        n_items = train_split.item_num
        counts = np.zeros(n_items, dtype=np.int64)
        np.add.at(counts, train_split.inter[train_split.iid_field], 1)
        self._meta["data.num_items"] = np.int64(n_items)
        self._meta["data.count_items"] = counts

    def collect_meanrank(self, pos_rank_sum, user_len, pos_len, weight=None):
        if weight is not None:
            keep = np.asarray(weight) > 0
            pos_rank_sum = pos_rank_sum[keep]
            user_len = user_len[keep]
            pos_len = pos_len[keep]
        self.data_struct.update_tensor(
            "rec.meanrank",
            np.stack(
                [
                    np.asarray(pos_rank_sum, np.float64),
                    np.asarray(user_len, np.float64),
                    np.asarray(pos_len, np.float64),
                ],
                axis=1,
            ),
        )

    def collect_topk(
        self, pos_idx: np.ndarray, pos_len: np.ndarray, weight=None
    ) -> None:
        """pos_idx (U, maxk) 0/1 hits at each rank; pos_len (U,)."""
        if weight is not None:
            keep = np.asarray(weight) > 0
            pos_idx = pos_idx[keep]
            pos_len = pos_len[keep]
        result = np.concatenate(
            [pos_idx.astype(np.int64), pos_len.reshape(-1, 1).astype(np.int64)],
            axis=1,
        )
        self.data_struct.update_tensor("rec.topk", result)

    def collect_items(self, topk_items: np.ndarray, weight=None) -> None:
        if weight is not None:
            topk_items = topk_items[np.asarray(weight) > 0]
        self.data_struct.update_tensor("rec.items", topk_items)

    def collect_scores(
        self, scores: np.ndarray, labels: np.ndarray, weight=None
    ) -> None:
        if weight is not None:
            keep = np.asarray(weight) > 0
            scores = scores[keep]
            labels = labels[keep]
        self.data_struct.update_tensor("rec.score", scores)
        self.data_struct.update_tensor("data.label", labels)

    def get_data_struct(self) -> DataStruct:
        for k, v in self._meta.items():
            if not self.data_struct.has(k):
                self.data_struct.update_tensor(k, np.asarray(v))
        return self.data_struct


class Evaluator:
    """Metric names → values from a DataStruct (`evaluator.py:27-41`)."""

    def __init__(self, config, decimal_place=None):
        self.config = config
        self.metrics = [m.lower() for m in config["metrics"]]
        self.topk = config["topk"]
        # `decimal_place` override: the multi-process metric map-reduce
        # must average UNROUNDED locals (a weighted mean of 4-decimal
        # roundings carries O(1e-4) bias) — the runner evaluates at full
        # precision pre-reduce and rounds the merged result once
        self.decimal_place = (
            decimal_place if decimal_place is not None
            else config["metric_decimal_place"]
        )

    def evaluate(self, struct: DataStruct) -> "OrderedDict[str, float]":
        result: "OrderedDict[str, float]" = OrderedDict()
        for metric in self.metrics:
            if metric in TOPK_METRICS:
                rec = struct.get("rec.topk")
                pos_idx = rec[:, : -1].astype(bool)
                pos_len = rec[:, -1]
                value = TOPK_METRICS[metric](pos_idx, pos_len)
                result.update(
                    topk_result(metric, value, self.topk, self.decimal_place)
                )
            elif metric in VALUE_METRICS:
                preds = struct.get("rec.score")
                trues = struct.get("data.label")
                result[metric] = round(
                    VALUE_METRICS[metric](preds, trues), self.decimal_place
                )
            elif metric == "gauc":
                mr = struct.get("rec.meanrank")
                result["gauc"] = round(
                    gauc_(mr[:, 0], mr[:, 1], mr[:, 2]), self.decimal_place
                )
            elif metric in ITEM_METRICS:
                items = struct.get("rec.items")
                num_items = int(struct.get("data.num_items"))
                counts = struct.get("data.count_items")
                for k in self.topk:
                    key = f"{metric}@{k}"
                    sub = items[:, :k]
                    if metric == "itemcoverage":
                        result[key] = round(
                            item_coverage_(sub, num_items), self.decimal_place
                        )
                    elif metric == "shannonentropy":
                        result[key] = round(
                            shannon_entropy_(sub), self.decimal_place
                        )
                    elif metric == "giniindex":
                        result[key] = round(
                            gini_index_(sub, num_items), self.decimal_place
                        )
                    elif metric == "averagepopularity":
                        v = average_popularity_(items, counts)
                        result[key] = round(
                            float(v.mean(axis=0)[k - 1]), self.decimal_place
                        )
                    elif metric == "tailpercentage":
                        tail = float(self.config.get("tail_ratio", 0.1))
                        v = tail_percentage_(items, counts, tail)
                        result[key] = round(
                            float(v.mean(axis=0)[k - 1]), self.decimal_place
                        )
            else:
                raise NotImplementedError(f"metric [{metric}] not implemented")
        return result


def meanrank_from_scores(scores: np.ndarray, pos_items: np.ndarray,
                         pos_len: np.ndarray):
    """(pos_rank_sum, user_len, pos_len) per user from a masked score
    matrix — tie-averaged descending ranks (the reference's _average_rank,
    `collector.py:95-135`, equals scipy rankdata 'average' on -scores)."""
    from scipy.stats import rankdata

    ranks = rankdata(-scores, axis=1, method="average")
    U, P = pos_items.shape
    valid = np.arange(P)[None, :] < pos_len[:, None]
    rows = np.arange(U)[:, None]
    pos_ranks = np.where(valid, ranks[rows, pos_items], 0.0)
    pos_rank_sum = pos_ranks.sum(axis=1)
    # reference: desc_scores.argmin(dim=1) == first index of the minimal
    # value in the sorted row == #entries strictly above the row min
    # (with −inf masking that is the count of scoreable items)
    row_min = scores.min(axis=1, keepdims=True)
    user_len = (scores > row_min).sum(axis=1)
    return pos_rank_sum, user_len, pos_len


def calculate_valid_score(valid_result: Dict[str, float], valid_metric: Optional[str]):
    """`recbole/utils/utils.py` calculate_valid_score analog."""
    if valid_metric:
        key = valid_metric.lower()
        for k, v in valid_result.items():
            if k.lower() == key:
                return v
    return next(iter(valid_result.values()))

"""Metric formulas — NumPy re-implementations, value-parity with
`recbole/evaluator/metrics.py` + `base_metric.py`.

Top-k metrics consume `pos_index` (n_users, K) bool — whether the j-th
ranked item is a positive — and `pos_len` (n_users,), and produce per-user
values for every cutoff 1..K; `topk_result` means over users (nan rows
dropped) and rounds. Value metrics consume pooled (preds, trues).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# ----------------------------------------------------------- top-k metrics


def hit_(pos_index: np.ndarray, pos_len=None) -> np.ndarray:
    result = np.cumsum(pos_index, axis=1)
    return (result > 0).astype(int)


def mrr_(pos_index: np.ndarray, pos_len=None) -> np.ndarray:
    """Reciprocal rank of the first hit, as a per-cutoff matrix.

    At cutoff k the value is 1/r where r is the 1-indexed rank of the
    user's first positive, or 0 when the first positive falls beyond k
    (or the user has none inside the window). Fully vectorized: one
    argmax for the first-hit rank, one broadcast comparison for the
    cutoff gating — no per-user Python loop (the reference iterates rows,
    `recbole/evaluator/metrics.py:88-96`; value-identical)."""
    n_users, window = pos_index.shape
    first_hit = pos_index.argmax(axis=1)  # 0-indexed; 0 when row is empty
    has_hit = pos_index[np.arange(n_users), first_hit].astype(bool)
    reciprocal = np.where(has_hit, 1.0 / (first_hit + 1.0), 0.0)
    # value appears from the cutoff that first contains the hit onwards
    visible = np.arange(window)[None, :] >= first_hit[:, None]
    return reciprocal[:, None] * visible


def map_(pos_index: np.ndarray, pos_len: np.ndarray) -> np.ndarray:
    """AP@k = (Σ_{j≤k} P@j · rel_j) / min(k, |positives|, window).

    The denominator clamp is expressed directly as an elementwise min
    instead of the reference's per-row mutated `ranges` array
    (`recbole/evaluator/metrics.py:127-134`; value-identical, including
    truncation of the ideal count to the ranking window)."""
    window = pos_index.shape[1]
    cutoffs = np.arange(1, window + 1, dtype=np.float64)
    precision_at = pos_index.cumsum(axis=1) / cutoffs
    ap_numerator = np.cumsum(precision_at * pos_index, axis=1)
    ideal = np.minimum(pos_len, window).astype(np.float64)
    # a user with zero recorded positives divides by the full window
    # (degenerate but matches the reference's wrap-around clamp there)
    denom = np.where(
        ideal[:, None] > 0,
        np.minimum(cutoffs[None, :], np.maximum(ideal, 1.0)[:, None]),
        float(window),
    )
    return ap_numerator / denom


def recall_(pos_index: np.ndarray, pos_len: np.ndarray) -> np.ndarray:
    return np.cumsum(pos_index, axis=1) / pos_len.reshape(-1, 1)


def ndcg_(pos_index: np.ndarray, pos_len: np.ndarray) -> np.ndarray:
    """Binary-relevance NDCG@k = DCG@k / IDCG@k.

    IDCG@k is read by gather: with per-position gains g_j = 1/log2(j+1)
    and G = cumsum(g), the ideal DCG at cutoff k is G[min(k, n_ideal)]
    where n_ideal = min(|positives|, window) — a (users, window) index
    into one shared prefix-sum vector, replacing the reference's per-row
    overwrite loop (`recbole/evaluator/metrics.py:186-203`;
    value-identical)."""
    n_users, window = pos_index.shape
    gains = 1.0 / np.log2(np.arange(2, window + 2, dtype=np.float64))
    dcg = np.cumsum(pos_index * gains[None, :], axis=1)
    ideal_prefix = np.cumsum(gains)
    n_ideal = np.minimum(pos_len, window)
    # zero-recorded-positive rows divide by the full-window ideal
    # (degenerate but matches the reference's wrap-around clamp there)
    gather = np.where(
        n_ideal[:, None] > 0,
        np.minimum(np.arange(1, window + 1)[None, :], n_ideal[:, None]),
        window,
    )
    idcg = ideal_prefix[gather - 1]
    return dcg / idcg


def precision_(pos_index: np.ndarray, pos_len=None) -> np.ndarray:
    return pos_index.cumsum(axis=1) / np.arange(1, pos_index.shape[1] + 1)


TOPK_METRICS = {
    "hit": hit_,
    "mrr": mrr_,
    "map": map_,
    "recall": recall_,
    "ndcg": ndcg_,
    "precision": precision_,
}

# ----------------------------------------------------------- value metrics


def _binary_clf_curve(trues: np.ndarray, preds: np.ndarray):
    """fps/tps at decreasing thresholds (sklearn-equivalent,
    `recbole/evaluator/utils.py`)."""
    trues = trues == 1
    desc_idx = np.argsort(preds, kind="mergesort")[::-1]
    preds = preds[desc_idx]
    trues = trues[desc_idx]
    distinct = np.where(np.diff(preds))[0]
    threshold_idxs = np.r_[distinct, trues.size - 1]
    tps = np.cumsum(trues)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps


def auc_(preds: np.ndarray, trues: np.ndarray) -> float:
    fps, tps = _binary_clf_curve(trues, preds)
    if len(fps) > 2:
        optimal = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps = fps[optimal]
        tps = tps[optimal]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    if fps[-1] <= 0 or tps[-1] <= 0:
        return float("nan")
    fpr = fps / fps[-1]
    tpr = tps / tps[-1]
    return float(np.trapezoid(tpr, fpr))


def mae_(preds, trues) -> float:
    return float(np.mean(np.abs(trues - preds)))


def rmse_(preds, trues) -> float:
    return float(np.sqrt(np.mean((trues - preds) ** 2)))


def logloss_(preds, trues) -> float:
    eps = 1e-15
    preds = np.clip(np.float64(preds), eps, 1 - eps)
    loss = np.sum(-trues * np.log(preds) - (1 - trues) * np.log(1 - preds))
    return float(loss / len(preds))


VALUE_METRICS = {"auc": auc_, "mae": mae_, "rmse": rmse_, "logloss": logloss_}
SMALLER_METRICS = {"mae", "rmse", "logloss"}

# ------------------------------------------- item-list ("rec.items") metrics


def gauc_(pos_rank_sum, user_len_list, pos_len_list) -> float:
    """Grouped AUC, pos-count weighted (`metrics.py:271-319`)."""
    neg_len_list = user_len_list - pos_len_list
    keep = (pos_len_list != 0) & (neg_len_list != 0)
    user_len_list = user_len_list[keep]
    neg_len_list = neg_len_list[keep]
    pos_len_list = pos_len_list[keep]
    pos_rank_sum = np.asarray(pos_rank_sum).reshape(-1)[keep]
    pair_num = (
        (user_len_list + 1) * pos_len_list
        - pos_len_list * (pos_len_list + 1) / 2
        - pos_rank_sum
    )
    user_auc = pair_num / (neg_len_list * pos_len_list)
    return float((user_auc * pos_len_list).sum() / pos_len_list.sum())


def item_coverage_(item_matrix: np.ndarray, num_items: int) -> float:
    """|∪ recommended| / |I| (`metrics.py:488-499`)."""
    return float(np.unique(item_matrix).shape[0] / num_items)


def average_popularity_(item_matrix: np.ndarray, item_count: np.ndarray):
    """Per-user cumulative mean popularity of recommended items
    (`metrics.py:520-540`); item_count is a dense (n_items,) array."""
    value = item_count[np.minimum(item_matrix, len(item_count) - 1)]
    value = np.where(item_matrix < len(item_count), value, 0)
    return value.cumsum(axis=1) / np.arange(1, value.shape[1] + 1)


def shannon_entropy_(item_matrix: np.ndarray) -> float:
    """−Σ p log p over the recommended-item distribution, divided by the
    number of distinct recommended items (`metrics.py:570-626` get_entropy)."""
    _, counts = np.unique(item_matrix.flatten(), return_counts=True)
    total = item_matrix.size
    p = counts / total
    return float(np.sum(-p * np.log(p)) / len(counts))


def gini_index_(item_matrix: np.ndarray, num_items: int) -> float:
    """(`metrics.py:628-646` get_gini exact)."""
    _, counts = np.unique(item_matrix.flatten(), return_counts=True)
    sorted_count = np.sort(counts)
    num_rec = sorted_count.shape[0]
    total = item_matrix.size
    idx = np.arange(num_items - num_rec + 1, num_items + 1)
    gini = np.sum((2 * idx - num_items - 1) * sorted_count) / total
    return float(gini / num_items)


def tail_percentage_(item_matrix: np.ndarray, item_count: np.ndarray,
                     tail: float = 0.1):
    """Fraction of long-tail items in recommendations (`metrics.py:684-740`)."""
    items = np.arange(1, len(item_count))
    counts = item_count[1:]
    if tail > 1:
        tail_items = set(items[counts <= tail].tolist())
    else:
        order = np.lexsort((items, counts))
        cut = max(int(len(items) * tail), 1)
        tail_items = set(items[order][:cut].tolist())
    in_tail = np.isin(item_matrix, list(tail_items)).astype(np.float64)
    return in_tail.cumsum(axis=1) / np.arange(1, item_matrix.shape[1] + 1)


ITEM_METRICS = {
    "itemcoverage", "averagepopularity", "shannonentropy", "giniindex",
    "tailpercentage",
}


def topk_result(
    metric: str, value: np.ndarray, topk: List[int], decimal_place: int
) -> Dict[str, float]:
    """Mean over users (nan rows dropped), per requested cutoff."""
    out = {}
    nan_rows = np.isnan(value).any(axis=1)
    avg = value[~nan_rows].mean(axis=0)
    for k in topk:
        out[f"{metric}@{k}"] = round(float(avg[k - 1]), decimal_place)
    return out

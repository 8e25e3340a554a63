"""The 7-slice inductive evaluation of a two-tower model, plain.

The protocol (the paper's inductive evaluation, the recommender's
`InductiveEvaluator`): for every test user, four rankings of the corpus with
the user's history left out,

    overall   items 1..N-1, ties in id order
    full      items 1..N-1, ties in a random order
    old       the old items 1..n_old-1
    new       the new items n_old..N-1

and seven slices of users, each judged on one ranking with the positives
that ranking can hold: overall (every user, `overall`), old_users and
new_users (`full`), old_old and new_old (`old`, the old positives), old_new
and new_new (`new`, the new positives); a user without such a positive is
left out of the slice. The metrics are RecBole's at each cutoff: hit,
recall, mrr, ndcg and precision, averaged over the slice's users.

Two numbers judge the program's answers:

  * `topk_gap`: for each user and ranking, the reference scores every item
    and takes its own top-k values t_1 >= ... >= t_k; the program's j-th item
    i_j must score t_j: the gap is t_j - s(i_j), relative to |t_1|, and an
    item that the ranking may not hold, or one given twice, has no score (an
    infinite gap). The widest gap over every position, ranking and user. Ties
    may be broken either way: equal scores give no gap;
  * `slices_off`: the number of slice metrics that differ by more than
    SLICE_TOL from the reference's, computed from the program's own rankings
    and the benchmark's positives.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

SLICES = ("overall", "old_users", "new_users", "old_old", "old_new", "new_old", "new_new")
VARIANTS = ("overall", "full", "old", "new")
# slice -> (ranking, the users it holds)
SLICE_PLAN = {"overall": ("overall", "all"), "old_users": ("full", "old"),
              "new_users": ("full", "new"), "old_old": ("old", "old"),
              "old_new": ("new", "old"), "new_old": ("old", "new"), "new_new": ("new", "new")}
SLICE_TOL = 1e-9
USER_BLOCK = 256  # users scored against the corpus at once


def variant_range(variant: str, n_old: int, n: int) -> Tuple[int, int]:
    if variant == "old":
        return 1, n_old
    if variant == "new":
        return n_old, n
    return 1, n


def topk_gap(user_e: torch.Tensor, items: torch.Tensor, history: List[np.ndarray],
             answers: Dict[str, torch.Tensor], n_old: int) -> float:
    """The widest relative gap of the program's rankings `answers` (variant
    -> (U, k) item ids) for the users whose vectors are `user_e` and whose
    histories are `history`."""
    n = items.shape[0]
    worst = 0.0
    for lo in range(0, user_e.shape[0], USER_BLOCK):
        hi = min(lo + USER_BLOCK, user_e.shape[0])
        s = user_e[lo:hi] @ items.T  # (u, N)
        rows = np.concatenate([np.full(len(h), r) for r, h in enumerate(history[lo:hi])] + [[]])
        cols = np.concatenate([np.asarray(h, np.int64) for h in history[lo:hi]] + [[]])
        s[torch.from_numpy(rows.astype(np.int64)).to(s.device),
          torch.from_numpy(cols.astype(np.int64)).to(s.device)] = -math.inf
        for v in VARIANTS:
            a, b = variant_range(v, n_old, n)
            got = answers[v][lo:hi].long()
            k = got.shape[1]
            t = torch.topk(s[:, a:b], k, dim=1).values
            inside = (got >= a) & (got < b)
            score = torch.where(inside, s.gather(1, got.clamp(0, n - 1)), -math.inf)
            srt = torch.sort(got, dim=1).values
            twice = (srt[:, 1:] == srt[:, :-1]).any(dim=1, keepdim=True)
            score = torch.where(twice, -math.inf, score)
            gap = (t - score) / torch.clamp(t[:, :1].abs(), min=1e-30)
            worst = max(worst, float(gap.max()))
    return worst


def topk_metrics(hits: np.ndarray, pos_len: np.ndarray, topk: Iterable[int],
                 metrics: Iterable[str]) -> Dict[str, float]:
    """RecBole's top-k metrics, means over the users (rows)."""
    hits = hits.astype(np.float64)
    k_all = hits.shape[1]
    out = {}
    ranks = np.arange(1, k_all + 1, dtype=np.float64)
    gains = 1.0 / np.log2(ranks + 1)
    for m in metrics:
        m = m.lower()
        for k in topk:
            h = hits[:, :k]
            if m == "hit":
                v = (h.sum(axis=1) > 0).astype(np.float64)
            elif m == "recall":
                v = h.sum(axis=1) / pos_len
            elif m == "precision":
                v = h.sum(axis=1) / k
            elif m == "mrr":
                first = np.argmax(h, axis=1)
                v = np.where(h.any(axis=1), 1.0 / (first + 1.0), 0.0)
            elif m == "ndcg":
                dcg = (h * gains[:k]).sum(axis=1)
                ideal = np.minimum(pos_len, k)
                idcg = np.cumsum(gains[:k])[ideal - 1]
                v = dcg / idcg
            else:
                raise ValueError(f"metric {m} is not in the reference")
            out[f"{m}@{k}"] = float(v.mean())
    return out


def slice_results(users: np.ndarray, answers: Dict[str, np.ndarray], positives: List[np.ndarray],
                  n_old_users: int, n_old_items: int, topk, metrics) -> Dict[str, Dict[str, float]]:
    """The seven slices' metrics of rankings `answers` (variant -> (U, k)
    item ids, rows in the order of `users`)."""
    old_u = users < n_old_users
    results = {}
    for s in SLICES:
        variant, who = SLICE_PLAN[s]
        rows = np.ones(len(users), bool) if who == "all" else (old_u if who == "old" else ~old_u)
        hits, lens = [], []
        for r in np.flatnonzero(rows):
            p = positives[r]
            if variant == "old":
                p = p[(p >= 1) & (p < n_old_items)]
            elif variant == "new":
                p = p[p >= n_old_items]
            if len(p) == 0:
                continue
            hits.append(np.isin(answers[variant][r], p))
            lens.append(len(p))
        results[s] = (topk_metrics(np.array(hits), np.array(lens), topk, metrics)
                      if hits else {})
    return results


def slices_off(program: Dict[str, Dict[str, float]], reference: Dict[str, Dict[str, float]]) -> int:
    """Metrics that differ by more than SLICE_TOL, or that one side lacks."""
    off = 0
    for s in SLICES:
        a, b = dict(program.get(s, {})), reference.get(s, {})
        off += len(set(a) ^ set(b))
        off += sum(1 for k in set(a) & set(b) if not abs(a[k] - b[k]) <= SLICE_TOL)
    return off

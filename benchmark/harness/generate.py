"""The general generator: every input of a run, made from `--seed`.

Host NumPy, vectorised (no loop over users or rows), from one
`np.random.default_rng(seed)` split into a stream per part, so the same seed
gives the same inputs and another seed the same sizes in another order. What
a configuration or a mix states (corpus sizes, skews, lengths) is read from
their files; nothing here names a cell.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


def streams(seed: int, names) -> Dict[str, np.random.Generator]:
    children = np.random.SeedSequence(int(seed)).spawn(len(names))
    return {n: np.random.default_rng(c) for n, c in zip(names, children)}


def zipf_ids(rng: np.random.Generator, n: int, lo: int, hi: int, exponent: float) -> np.ndarray:
    """n ids in [lo, hi): the id of rank r drawn with weight r^-exponent, the
    ranks laid on the ids by a seeded permutation (popular ids are spread)."""
    size = hi - lo
    w = np.arange(1, size + 1, dtype=np.float64) ** -float(exponent)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    ranks = np.minimum(np.searchsorted(cdf, rng.random(n), side="right"), size - 1)
    return lo + rng.permutation(size)[ranks]


def activity(rng: np.random.Generator, n_users: int, total: int, minimum: int,
             exponent: float) -> np.ndarray:
    """Per-user counts summing to `total`, each at least `minimum`, the rest
    spread with Zipf weights over the users in a seeded order (a heavy
    tail)."""
    extra = total - minimum * n_users
    if extra < 0:
        raise ValueError(f"{total} rows cannot give {n_users} users {minimum} each")
    w = np.arange(1, n_users + 1, dtype=np.float64) ** -float(exponent)
    w = w[rng.permutation(n_users)]
    return minimum + rng.multinomial(extra, w / w.sum())


def interactions(corpus: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The training interactions of old users with old items: (users, items),
    grouped by user."""
    r = streams(seed, ("counts", "items"))
    n_users = corpus["n_old_users"] - 1  # id 0 is the padding id
    counts = activity(r["counts"], n_users, corpus["train_interactions"],
                      corpus["min_per_user"], corpus["user_zipf"])
    users = np.repeat(np.arange(1, n_users + 1, dtype=np.int64), counts)
    items = zipf_ids(r["items"], len(users), 1, corpus["n_old_items"], corpus["item_zipf"])
    return users, items


def ctr_rows(corpus: dict, seed: int):
    """Labelled rows over users and items, old and new, with the schema's
    token features: each user and item feature drawn once per id, each row
    feature per row, 0 (padding) for id 0. Every user has at least
    `min_per_user` rows, the rest spread with Zipf weights; items are
    Zipf-skewed; the rows come in a seeded order. The label comes from a
    seeded logistic teacher (the standardised sum of per-value effects of
    every field, plus unit normal noise), a click where it lies in the top
    `positive_rows / rows` of the rows. → (rows, user features, item
    features)."""
    r = streams(seed, ("users", "items", "counts", "rows", "order", "teacher", "noise"))
    n_u = corpus["n_old_users"] + corpus["n_new_users"]
    n_i = corpus["n_old_items"] + corpus["n_new_items"]
    schema = corpus["schema"]
    dims = dict(zip(schema["token_fields"], schema["token_dims"]))

    def table(rng, n, id_field, fields):
        out = {id_field: np.arange(n)}
        for f in fields:
            v = rng.integers(1, dims[f], n)
            v[0] = 0
            out[f] = v
        return out

    user_feat = table(r["users"], n_u, "user_id", schema["user_features"])
    item_feat = table(r["items"], n_i, "item_id", schema["item_features"])
    n = corpus["rows"]
    counts = activity(r["counts"], n_u - 1, n, corpus["min_per_user"], corpus["user_zipf"])
    order = r["order"].permutation(n)
    rows = {"user_id": np.repeat(np.arange(1, n_u, dtype=np.int64), counts)[order],
            "item_id": zipf_ids(r["rows"], n, 1, n_i, corpus["item_zipf"])}
    for f in schema["row_features"]:
        rows[f] = r["rows"].integers(1, dims[f], n)
    t = r["teacher"]
    z = t.standard_normal(n_u)[rows["user_id"]] + t.standard_normal(n_i)[rows["item_id"]]
    for feats, key in ((user_feat, "user_id"), (item_feat, "item_id")):
        for f, v in feats.items():
            if f != key:
                z = z + t.standard_normal(dims[f])[v[rows[key]]]
    for f in schema["row_features"]:
        z = z + t.standard_normal(dims[f])[rows[f]]
    z = (z - z.mean()) / z.std() + r["noise"].standard_normal(n)
    cut = np.quantile(z, 1.0 - corpus["positive_rows"] / corpus["rows"])
    rows["label"] = (z > cut).astype(np.float32)
    return rows, user_feat, item_feat


def first_unique(rows: np.ndarray) -> np.ndarray:
    """(U, C) candidate ids → (U, C) bool: the first occurrence of each id
    in its row."""
    u, c = rows.shape
    keys = np.arange(u, dtype=np.int64)[:, None] * (int(rows.max()) + 1) + rows
    _, first = np.unique(keys.ravel(), return_index=True)
    mask = np.zeros(u * c, bool)
    mask[first] = True
    return mask.reshape(u, c)


def eval_users(corpus: dict, mix: dict, seed: int,
               near: Callable[[np.ndarray], np.ndarray]):
    """The test users (old and new), each with 1..max_positives held-out
    positives and a training history of at most max_history items, disjoint
    and without repeats. Up to half of a user's positives are drawn from
    `near(users)`, the items that score highest for the user under the
    weights (so every slice has hits to count), the rest by popularity.
    → (users, positives, histories), the lists in the users' order."""
    r = streams(seed, ("users", "lengths", "near", "far"))
    n_test = mix["test_users"]
    n_new = int(round(mix["new_user_share"] * n_test))
    n_old_u = corpus["n_old_users"]
    users = np.sort(np.concatenate([
        1 + r["users"].choice(n_old_u - 1, n_test - n_new, replace=False),
        n_old_u + r["users"].choice(corpus["n_new_users"], n_new, replace=False)]))
    n_pos = r["lengths"].integers(1, mix["max_positives"] + 1, n_test)
    n_hist = np.minimum(mix["max_history"],
                        mix["min_history"] + r["lengths"].geometric(1.0 / mix["mean_history"],
                                                                    n_test) - 1)
    cand_near = near(users)
    m = cand_near.shape[1]
    pick = np.argsort(r["near"].random((n_test, m)), axis=1)
    cand_near = np.take_along_axis(cand_near, pick, axis=1)[:, : mix["max_positives"] // 2]
    # a row keeps n_pos // 2 of its near candidates; the others give way to far draws
    n_total = corpus["n_old_items"] + corpus["n_new_items"]
    width = 2 * (mix["max_positives"] + mix["max_history"])
    far = zipf_ids(r["far"], n_test * width, 1, n_total, corpus["item_zipf"]).reshape(n_test, width)
    keep_near = np.arange(cand_near.shape[1])[None, :] < (n_pos // 2)[:, None]
    cand = np.concatenate([np.where(keep_near, cand_near, far[:, : cand_near.shape[1]]),
                           far[:, cand_near.shape[1]:]], axis=1)
    first = first_unique(cand)
    rank = np.cumsum(first, axis=1) - 1  # the unique candidate's place in its row
    is_pos = first & (rank < n_pos[:, None])
    is_hist = first & (rank >= n_pos[:, None]) & (rank < (n_pos + n_hist)[:, None])
    positives = _rows_of(cand, is_pos)
    histories = _rows_of(cand, is_hist)
    return users, positives, histories


def _rows_of(values: np.ndarray, mask: np.ndarray) -> List[np.ndarray]:
    counts = mask.sum(axis=1)
    flat = values[mask]
    return np.split(flat, np.cumsum(counts)[:-1])

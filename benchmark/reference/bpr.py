"""BPR with random-mapper OOV buckets, plain.

Rendle et al., "BPR: Bayesian Personalized Ranking from Implicit Feedback"
(UAI 2009): a user and an item table, the score is their dot product and the
loss is -log(gamma + sigmoid(s_pos - s_neg)), gamma 1e-10, averaged over the
rows that carry weight (the recommender's `BPRLoss`). The inductive layer
(the random mapper with OOV buckets): an id at or past its table's size, or
one flagged new in the batch, takes the row of its bucket in the side's bucket
table; the bucket of a new id is hash(id - n_original) at evaluation and
hash(id + prime_pad - n_original) for an id flagged by the training OOV
simulation (`hashes.py`). The reference computes the buckets itself and
reads none from the batch.

Parameters are read by the names the benchmark gives them:
`user_embedding.weight`, `item_embedding.weight`, `user_oov_buckets.weight`,
`item_oov_buckets.weight`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.hashes import eval_buckets, simulated_buckets

Params = Dict[str, torch.Tensor]


def _flags(batch, field, ids):
    f = batch.get(field + "_oov")
    return torch.zeros_like(ids, dtype=torch.bool) if f is None else f > 0


def routed(table, buckets_table, ids, new, buckets):
    """Each row's table row, or its bucket row where `new`."""
    n = table.shape[0]
    iv = table[ids.clamp(0, n - 1)]
    return torch.where(new[:, None], buckets_table[buckets], iv)


def training_rows(params: Params, batch: dict, field: str, side: str, spec: dict,
                  flagged: bool = True, dtype=torch.float32) -> torch.Tensor:
    """The routed rows of one id column of a training batch. `flagged`: the
    column may carry the simulation's flags (the negatives never do)."""
    ids = batch[field].long()
    table = params[f"{side}_embedding.weight"]
    new = (ids >= table.shape[0])
    if flagged:
        new = new | _flags(batch, field, ids)
    host = ids.cpu().numpy()
    n_orig = spec[f"n_old_{side}s"]
    n_b = spec[f"n_{side}_buckets"]
    sim = simulated_buckets(host, n_orig, n_b, spec["prime_pad"])
    past = eval_buckets(host, n_orig, n_b)
    flag_host = (_flags(batch, field, ids).cpu().numpy() if flagged
                 else np.zeros(len(host), bool))
    buckets = np.where(flag_host, sim, np.where(host >= n_orig, past, 0))
    b = torch.from_numpy(buckets).to(ids.device)
    return routed(table.to(dtype), params[f"{side}_oov_buckets.weight"].to(dtype), ids, new, b)


def loss(params: Params, batch: dict, spec: dict, dtype=torch.float32, **_) -> torch.Tensor:
    """The BPR loss of one pairwise training batch (`user_id`, `item_id`,
    `neg_item_id`, `weight`, the flags of the OOV simulation)."""
    u = training_rows(params, batch, "user_id", "user", spec, dtype=dtype)
    p = training_rows(params, batch, "item_id", "item", spec, dtype=dtype)
    n = training_rows(params, batch, "neg_item_id", "item", spec, flagged=False, dtype=dtype)
    x = ((u * p).sum(dim=1) - (u * n).sum(dim=1)).float()
    per_row = -torch.log(1e-10 + 1.0 / (1.0 + torch.exp(-x)))
    w = batch["weight"].float()
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def user_vectors(params: Params, users: np.ndarray, spec: dict, device) -> torch.Tensor:
    """(U, D): old users' table rows, new users' bucket rows."""
    users = np.asarray(users, np.int64)
    n_old = spec["n_old_users"]
    b = eval_buckets(users, n_old, spec["n_user_buckets"])
    ids = torch.from_numpy(users).to(device)
    new = ids >= n_old
    return routed(params["user_embedding.weight"], params["user_oov_buckets.weight"], ids, new,
                  torch.from_numpy(np.where(users >= n_old, b, 0)).to(device))


def item_matrix(params: Params, spec: dict, device) -> torch.Tensor:
    """(N, D) over the whole corpus: old items' rows, new items' bucket rows."""
    n_old, n_new = spec["n_old_items"], spec["n_new_items"]
    b = eval_buckets(np.arange(n_old, n_old + n_new), n_old, spec["n_item_buckets"])
    new_rows = params["item_oov_buckets.weight"][torch.from_numpy(b).to(device)]
    return torch.cat([params["item_embedding.weight"][:n_old], new_rows])

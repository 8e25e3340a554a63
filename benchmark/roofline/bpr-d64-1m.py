"""BPR at D 64 over 100,000 x 900,000 (`configs/bpr-d64-1m.json`): the
operations and bytes of its steps, batches and kernel launches."""

from __future__ import annotations

from benchmark.roofline import kernels


def _sizes(cfg: dict):
    c, d = cfg["corpus"], cfg["model_args"]["embedding_size"]
    p = cfg["port"]
    n_params = (c["n_old_users"] + c["n_old_items"]
                + p["n_user_oov_buckets"] + p["n_item_oov_buckets"]) * d
    return c, d, n_params


def train_step(cfg: dict, mix: dict):
    """One pairwise step of B rows: dense Adam over every parameter (the
    tables, 64.03 M floats), the batch's three id columns and their rows
    read once; the dot products and the update's arithmetic as operations."""
    c, d, n_params = _sizes(cfg)
    B = mix["port"]["train_batch_size"]
    flops = 3 * 2 * 2 * B * d + 10 * n_params
    nbytes = kernels.adam_dense(n_params) + 3 * B * (8 + 4 * d) + 4 * B
    return flops, nbytes


def eval_batch_flops(cfg: dict, mix: dict) -> int:
    """One score for each user of a batch against each corpus item."""
    c, d, _ = _sizes(cfg)
    return 2 * mix["users_per_batch"] * (c["n_old_items"] + c["n_new_items"]) * d


def topk_launch(cfg: dict, mix: dict):
    c, d, _ = _sizes(cfg)
    k = max(mix["port"].get("topk", [10]))
    return kernels.topk_launch(mix["users_per_batch"], c["n_old_items"] + c["n_new_items"], d, k)


def gather_bwd_step(cfg: dict, gathers) -> int:
    return sum(kernels.gather_backward(*g) for g in gathers)

"""Batch-level transforms.

Port of `oovrec_tpu/data/transform.py:42-210`: `construct_transform(config)`
keys on `config['transform']`:
  * None / 'Equal': the identity;
  * 'mask_itemseq' / 'MaskItemSequence': BERT4Rec's cloze masking. Each
    position of a row's sequence is masked with `mask_ratio` (one uniform
    position when none is), the mask token is n_items (one extra row of
    the item table), and the masked positions and items ride in
    `mask_index` / `mask_pos_items` / `mask_count` at a fixed capacity;
  * 'inverse_itemseq' / 'InverseItemSequence': each sequence right-aligned
    into `Inverse_<seq_field>`;
  * 'crop_itemseq' / 'CropItemSequence': a random contiguous crop of
    ⌊len·eta⌋ items into `Crop_<seq_field>` and its length field;
  * 'reorder_itemseq' / 'ReorderItemSequence': a random window of
    ⌊len·beta⌋ positions shuffled, into `Reorder_<seq_field>`;
  * 'user_defined' / 'UserDefinedTransform': the callable that
    `config['user_defined_transform']` names ('pkg.module:attr' or a
    dotted path), the identity without one.

The random ones draw from `host_rng(seed, <tag>)` in the JAX transform's
order, so their outputs equal the JAX package's bit for bit: the mask
walks the rows one by one (`rng.random(n)`, then `rng.integers(0, n)`
where nothing was masked), crop and reorder draw once a batch.
"""

from __future__ import annotations

import importlib
from typing import Optional

import numpy as np

from oovrec_tpu_torch.utils.seeding import host_rng


class Equal:
    def __call__(self, batch: dict) -> dict:
        return batch


def _seq_fields(config):
    return config["ITEM_ID_FIELD"] + config["LIST_SUFFIX"], config["ITEM_LIST_LENGTH_FIELD"]


class MaskItemSequence:
    """Cloze masking over the item sequence, at most `max_masked` =
    max(1, ⌊2·L·mask_ratio⌋) positions a row."""

    def __init__(self, config, n_items: int):
        self.mask_ratio = float(config.get("mask_ratio", 0.2))
        self.max_len = int(config["MAX_ITEM_LIST_LENGTH"])
        self.mask_token = n_items
        self.list_field, self.length_field = _seq_fields(config)
        self.rng = host_rng(int(config["seed"] or 0), "mask_item_sequence")
        self.max_masked = max(1, int(self.max_len * self.mask_ratio * 2))

    def __call__(self, batch: dict) -> dict:
        out = dict(batch)
        seq = np.asarray(batch[self.list_field]).copy()
        lengths = np.asarray(batch[self.length_field])
        B = seq.shape[0]
        mask_index = np.zeros((B, self.max_masked), np.int64)
        pos_items = np.zeros((B, self.max_masked), np.int64)
        mask_count = np.zeros(B, np.int64)
        for b in range(B):
            n = int(lengths[b])
            if n == 0:
                continue
            flips = np.flatnonzero(self.rng.random(n) < self.mask_ratio)
            if len(flips) == 0:
                flips = np.array([int(self.rng.integers(0, n))])
            flips = flips[: self.max_masked]
            pos_items[b, : len(flips)] = seq[b, flips]
            mask_index[b, : len(flips)] = flips
            mask_count[b] = len(flips)
            seq[b, flips] = self.mask_token
        out[self.list_field] = seq
        out["mask_index"] = mask_index
        out["mask_pos_items"] = pos_items
        out["mask_count"] = mask_count
        return out


class InverseItemSequence:
    """Right-align each sequence (padding to the front); shapes kept."""

    def __init__(self, config):
        self.list_field, self.length_field = _seq_fields(config)
        self.out_field = "Inverse_" + self.list_field

    def __call__(self, batch: dict) -> dict:
        out = dict(batch)
        seq = np.asarray(batch[self.list_field])
        n = np.asarray(batch[self.length_field]).astype(np.int64)
        L = seq.shape[1]
        src = np.arange(L)[None, :] - (L - n)[:, None]  # out[b, L-n+j] = seq[b, j]
        gathered = np.take_along_axis(seq, np.clip(src, 0, L - 1), axis=1)
        out[self.out_field] = np.where(src >= 0, gathered, 0).astype(seq.dtype)
        return out


class CropItemSequence:
    """Keep ⌊len·eta⌋ items from a uniform offset in [0, len − crop_len],
    left-aligned, with the cropped lengths."""

    def __init__(self, config):
        self.list_field, self.length_field = _seq_fields(config)
        self.out_field = "Crop_" + self.list_field
        self.out_length_field = self.out_field + self.length_field
        self.eta = float(config.get("eta", 0.6))
        self.rng = host_rng(int(config["seed"] or 0), "crop_itemseq")

    def __call__(self, batch: dict) -> dict:
        out = dict(batch)
        seq = np.asarray(batch[self.list_field])
        n = np.asarray(batch[self.length_field]).astype(np.int64)
        B, L = seq.shape
        crop_len = np.floor(n * self.eta).astype(np.int64)
        begin = np.floor(self.rng.random(B) * (n - crop_len + 1)).astype(np.int64)
        pos = np.arange(L)[None, :]
        cropped = np.take_along_axis(seq, np.clip(begin[:, None] + pos, 0, L - 1), axis=1)
        out[self.out_field] = np.where(pos < crop_len[:, None], cropped, 0).astype(seq.dtype)
        out[self.out_length_field] = crop_len
        return out


class ReorderItemSequence:
    """Shuffle a random window of ⌊len·beta⌋ positions: window positions
    sort by `begin + U[0, 1)`, the others keep their index as the key."""

    def __init__(self, config):
        self.list_field, self.length_field = _seq_fields(config)
        self.out_field = "Reorder_" + self.list_field
        self.beta = float(config.get("beta", 0.6))
        self.rng = host_rng(int(config["seed"] or 0), "reorder_itemseq")

    def __call__(self, batch: dict) -> dict:
        out = dict(batch)
        seq = np.asarray(batch[self.list_field])
        n = np.asarray(batch[self.length_field]).astype(np.int64)
        B, L = seq.shape
        rlen = np.floor(n * self.beta).astype(np.int64)
        begin = np.floor(self.rng.random(B) * (n - rlen + 1)).astype(np.int64)
        pos = np.arange(L)[None, :]
        in_window = (pos >= begin[:, None]) & (pos < (begin + rlen)[:, None])
        keys = np.where(in_window, begin[:, None] + self.rng.random((B, L)),
                        pos.astype(np.float64))
        out[self.out_field] = np.take_along_axis(
            seq, np.argsort(keys, axis=1, kind="stable"), axis=1)
        return out


class UserDefinedTransform:
    """The callable named by `config['user_defined_transform']`, called
    with the batch and returning it; the identity without the key."""

    def __init__(self, config):
        path = config.get("user_defined_transform")
        self.fn = None
        if path:
            if ":" in path:
                mod, attr = path.split(":", 1)
            else:
                mod, _, attr = path.rpartition(".")
            self.fn = getattr(importlib.import_module(mod), attr)

    def __call__(self, batch: dict) -> dict:
        return self.fn(batch) if self.fn is not None else batch


def construct_transform(config, n_items: Optional[int] = None):
    name = config["transform"]
    if not name or name == "Equal":
        return Equal()
    if name in ("MaskItemSequence", "mask_itemseq"):
        return MaskItemSequence(config, n_items)
    if name in ("InverseItemSequence", "inverse_itemseq"):
        return InverseItemSequence(config)
    if name in ("CropItemSequence", "crop_itemseq"):
        return CropItemSequence(config)
    if name in ("ReorderItemSequence", "reorder_itemseq"):
        return ReorderItemSequence(config)
    if name in ("UserDefinedTransform", "user_defined"):
        return UserDefinedTransform(config)
    raise NotImplementedError(f"transform [{name}] is not implemented")

"""Embedder state: feature matrices, LSH planes, knn tables, DHE keys.

Port of `oovrec_tpu/inductive/factory.py:32-208` (the counterpart of
`recbole/inductive/get_inductive.py:16-138`, `feature_cache.py` and the
feature-matrix assembly of `lsh_embedder.py:83-106`). The state is built
on the host as numpy arrays, as the JAX package builds it; a model holds
it as buffers on its own device (`EmbedderBuffers`), so it moves with
`model.to(...)` and rides in the model's `state_dict`, the checkpoint.

Keys (present depending on the embedder):
  n_original_users / n_original_items        int64 scalars
  user_feat_mat / item_feat_mat   (n_entities, F) float32, normalised
  user_planes / item_planes       (hash bits, F) float32, LSH hyperplanes
  user_knn_neighbors / item_knn_neighbors   (n_entities, k) int32
  dhe_keys                        (num_hashes, 2) uint64, SipHash keys

Differences from the JAX module: `build_feature_matrix` reads the port's
`Dataset` tables (ordered dicts of numpy columns) where the JAX one reads
pandas frames, and `exact_knn_neighbors` scores the query rows in chunks,
so its memory stays bounded by `KNN_CHUNK_FLOATS`.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.utils.seeding import host_rng

EmbedderState = Dict[str, np.ndarray]

_EPS = 1e-12
# similarities scored at once by `exact_knn_neighbors` (256 MB of f32)
KNN_CHUNK_FLOATS = 1 << 26


def build_feature_matrix(
    feat_table, id_field: str, normalization_type: str = "per-feature"
) -> np.ndarray:
    """hstack all non-ID feature columns with the reference's normalization.

    Mirrors `lsh_embedder.py:83-104`: each column is viewed (n, -1) and
    L2-normalized along the last dim ('per-feature'), or the full hstack is
    row-normalized ('global'), or left raw ('none'). Token ids participate
    as raw float values, exactly like the reference. `feat_table` is a
    `Dataset` feature table: column name → numpy column in file order,
    sequence cells as arrays (padded to the longest row here).
    """
    if feat_table is None:
        raise ValueError("feature matrix requested but no feature file loaded")
    columns = list(feat_table)
    blocks = []
    for c in columns:
        if c == id_field or c.endswith("__bucket"):
            continue  # a bucket column is folded into its value column's block
        if c + "__bucket" in feat_table:
            # discretized numerical feature: the reference's (value, bucket)
            # pair participates as one 2-wide block, normalized together
            pair = np.stack(
                [
                    np.asarray(feat_table[c]).astype(np.float32),
                    np.asarray(feat_table[c + "__bucket"]).astype(np.float32),
                ],
                axis=-1,
            )
            if normalization_type == "per-feature":
                norm = np.linalg.norm(pair, axis=-1, keepdims=True)
                pair = pair / np.maximum(norm, _EPS)
            blocks.append(pair)
            continue
        col = np.asarray(feat_table[c])
        if col.dtype == object:  # seq field: pad to max len
            maxlen = max((len(v) for v in col), default=0)
            arr = np.zeros((len(col), max(maxlen, 1)), dtype=np.float32)
            for i, v in enumerate(col):
                arr[i, : len(v)] = np.asarray(v, dtype=np.float32)
        else:
            arr = col.astype(np.float32).reshape(len(col), -1)
        if normalization_type == "per-feature":
            norm = np.linalg.norm(arr, axis=-1, keepdims=True)
            arr = arr / np.maximum(norm, _EPS)
        blocks.append(arr)
    mat = np.hstack(blocks).astype(np.float32)
    if normalization_type == "global":
        norm = np.linalg.norm(mat, axis=-1, keepdims=True)
        mat = mat / np.maximum(norm, _EPS)
    elif normalization_type not in ("per-feature", "none", "global"):
        raise ValueError(f"Invalid normalization type: {normalization_type}")
    return mat


def exact_knn_neighbors(
    query_feats: np.ndarray, corpus_feats: np.ndarray, k: int,
    exclude_self_rows: bool = False, chunk_rows: Optional[int] = None,
) -> np.ndarray:
    """Exact dot-product top-k neighbor ids (ScaNN replacement).

    The reference uses approximate ScaNN search (`knn_embedder.py:84-93`);
    exact search on normalized features is simpler and strictly more
    accurate. Row 0 of the corpus (PAD) is excluded as a neighbor. The
    query rows are scored `chunk_rows` at a time (by default as many as
    KNN_CHUNK_FLOATS similarities hold); each row's neighbors depend on
    that row's scores alone.
    """
    n_q, n_c = query_feats.shape[0], corpus_feats.shape[0]
    if chunk_rows is None:
        chunk_rows = max(1, KNN_CHUNK_FLOATS // max(n_c, 1))
    kth = min(k, n_c - 1)
    out = np.empty((n_q, min(k, n_c)), dtype=np.int32)
    for a in range(0, n_q, chunk_rows):
        b = min(a + chunk_rows, n_q)
        sims = query_feats[a:b] @ corpus_feats.T  # (rows, N)
        sims[:, 0] = -np.inf
        if exclude_self_rows:
            rows = np.arange(a, min(b, n_c))
            sims[rows - a, rows] = -np.inf
        idx = np.argpartition(-sims, kth=kth, axis=1)[:, :k]
        # order the k by similarity desc
        part = np.take_along_axis(sims, idx, axis=1)
        order = np.argsort(-part, axis=1, kind="stable")
        out[a:b] = np.take_along_axis(idx, order, axis=1)
    return out


class InductiveFeatureCache:
    """Shared feature matrices of one mode (`feature_cache.py:1-22`), keyed
    by the tables they come from: the dataset's path, its id fields and
    the normalization. The JAX cache holds one pair whatever the dataset,
    so a second run in one process on another dataset or normalization
    would get the first run's matrices; this one builds them anew."""

    def __init__(self, mode: str = "transductive"):
        self.mode = mode
        self._mats: dict = {}

    def get(self, key):
        """The (user, item) matrices cached under `key`, or None."""
        return self._mats.get(key)

    def put(self, key, user_feats, item_feats) -> None:
        self._mats[key] = (user_feats, item_feats)


_global_cache = InductiveFeatureCache()


def get_feature_cache(mode: str) -> InductiveFeatureCache:
    """Module-global cache, rebuilt when mode flips (`get_inductive.py:14,46-50`)."""
    global _global_cache
    if _global_cache.mode != mode:
        _global_cache = InductiveFeatureCache(mode)
    return _global_cache


def needs_state(spec: Optional[InductiveSpec]) -> bool:
    """Whether the embedder reads state that `build_embedder_state` builds."""
    return spec is not None and (
        spec.needs_features or spec.embedder in ("lsh", "slsh", "dhe", "fdhe"))


def build_embedder_state(
    spec: InductiveSpec,
    dataset,
    n_original_users: int,
    n_original_items: int,
    mode: str = "transductive",
    seed: int = 2020,
    cache: Optional[InductiveFeatureCache] = None,
    hash_key_dir: str = "./hash_keys",
) -> EmbedderState:
    """Build the non-trainable embedder state for `mode`.

    In 'transductive' mode feature matrices cover the training entities;
    in 'inductive' mode they cover the full `_ind` corpus (old + new rows,
    vocab-reconciled). LSH hyperplanes are drawn once per run from a
    seed-stable stream and must round-trip through checkpoints (the
    reference pickles them, `torch_hash.py:44-50`).
    """
    state: EmbedderState = {
        "n_original_users": np.int64(n_original_users),
        "n_original_items": np.int64(n_original_items),
    }
    if spec.embedder in ("dhe", "fdhe"):
        from oovrec_tpu_torch.inductive.dhe import DHEHasher

        # also written to the reference-compatible hash_keys/<n>.hashes
        state["dhe_keys"] = DHEHasher(spec.dhe_num_hashes, hash_key_dir).keys
    if not spec.needs_features and spec.embedder not in ("lsh", "slsh"):
        return state

    cache = cache or get_feature_cache(mode)
    key = (os.path.join(str(dataset.config["data_path"]), dataset.dataset_name),
           dataset.uid_field, dataset.iid_field, spec.normalization_type)
    cached = cache.get(key)
    if cached is not None:
        user_mat, item_mat = cached
    else:
        user_mat = build_feature_matrix(
            dataset.user_feat, dataset.uid_field, spec.normalization_type
        )
        item_mat = build_feature_matrix(
            dataset.item_feat, dataset.iid_field, spec.normalization_type
        )
        cache.put(key, user_mat, item_mat)
    state["user_feat_mat"] = user_mat
    state["item_feat_mat"] = item_mat

    if spec.embedder in ("lsh", "slsh"):
        rng = host_rng(seed, "lsh_planes")
        if spec.embedder == "lsh":
            u_bits, i_bits = spec.n_user_buckets, spec.n_item_buckets
        else:
            u_bits = int(np.ceil(np.log2(spec.n_user_buckets)))
            i_bits = int(np.ceil(np.log2(spec.n_item_buckets)))
        state["user_planes"] = rng.standard_normal(
            (u_bits, user_mat.shape[1])
        ).astype(np.float32)
        state["item_planes"] = rng.standard_normal(
            (i_bits, item_mat.shape[1])
        ).astype(np.float32)

    if spec.embedder == "knn":
        # neighbors among IV entities only (`knn_embedder.py:84-93` indexes
        # IV rows); every entity (IV + OOV) gets a precomputed neighbor list
        state["user_knn_neighbors"] = exact_knn_neighbors(
            user_mat, user_mat[:n_original_users], spec.knn_neighbors
        )
        state["item_knn_neighbors"] = exact_knn_neighbors(
            item_mat, item_mat[:n_original_items], spec.knn_neighbors
        )
    return state


# the state a checkpoint restores into a model rebuilt over another corpus
# (`oovrec_tpu/cli/inductive_eval.py:146-149`): the planes and the keys;
# the feature matrices and neighbors belong to the corpus
RESTORED_KEYS = ("user_planes", "item_planes", "dhe_keys")


class EmbedderBuffers(nn.Module):
    """An `EmbedderState` as buffers on `device`, looked up by key: float
    arrays as float32, integers as int64 (the uint64 DHE keys as int64
    bit patterns, which `ops/siphash_device.py` hashes with)."""

    def __init__(self, state: Optional[Mapping[str, np.ndarray]] = None, device=None):
        super().__init__()
        for k, v in (state or {}).items():
            v = np.asarray(v)
            if v.dtype == np.uint64:
                v = v.view(np.int64)
            dtype = torch.float32 if v.dtype.kind == "f" else torch.int64
            self.register_buffer(k, torch.as_tensor(v, dtype=dtype, device=device).clone())

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in self._buffers:
            raise KeyError(f"embedder state has no [{key}]; build_embedder_state builds it")
        return self._buffers[key]

    def get(self, key: str, default=None):
        return self._buffers.get(key, default)

    def width(self, side: str) -> int:
        """The feature width F of one side."""
        return int(self[f"{side}_feat_mat"].shape[1])

"""Branchless IV/OOV embedding routing.

Port of `oovrec_tpu/inductive/routing.py:34-145`. Every row computes BOTH
the IV lookup and the OOV embedding, and a `torch.where` on the OOV
predicate selects: static shapes, no boolean-mask partitions.

Embedder semantics (reference file:line):
  bucket  — `user_oov_buckets(mapped - n)` (`bpr.py:76,124`)
  zero    — 0-vector (`zero_embedder.py:36-60`)
  mean    — column-mean of the IV table (`mean_embedder.py:53-61`)
  lsh     — multi-hot sign(feat@planesᵀ); mean of selected bucket rows
            (`lsh_embedder.py:141-179`)
  slsh    — single bucket id = (2**bits).sum() % n_buckets =
            (n_bits + popcount) % n_buckets (`single_lsh_embedder.py:82-101`)
  dnn     — MLP(features) (`dnn_embedder.py:65-90`)
  dhe     — MLP(siphash columns) (`dh_embedder.py:70-152`)
  fdhe    — MLP([siphash ∥ features]) (`feat_dh_embedder.py:108-197`)
  knn     — mean of IV table rows of k nearest feature neighbors
            (`knn_embedder.py:110-144`), neighbors precomputed exactly

The row gathers go through `ops/embed_grad.py:gather_rows`, as the JAX
module's do, and tell it which rows the select throws away: an IV row's
bucket row and an OOV row's clipped IV row. Their cotangent is exactly
zero, so the backward skips them and the gradient stays the same.

`estate` is the model's `EmbedderBuffers` (feature matrices, planes, knn
tables); `mlp` the side's `EmbedderMLP`. `feat_ids` index the feature
matrices and knn tables where `ids` index a reduced table (the sparse
path's row positions, `models/base.py`).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.ops.embed_grad import gather_rows


def oov_embedding(
    spec: InductiveSpec,
    side: str,                              # 'user' | 'item'
    ids: torch.Tensor,                      # (B,) entity ids (feature-matrix rows)
    buckets: Optional[torch.Tensor],        # (B,) host-hashed mapper buckets
    iv_table: torch.Tensor,                 # (n_vocab, D)
    bucket_table: Optional[torch.Tensor],   # (n_buckets, D) or None
    estate: Optional[Mapping[str, torch.Tensor]] = None,
    mlp: Optional[Callable] = None,         # the side's tower: dnn / dhe / fdhe
    dhe_hashes: Optional[torch.Tensor] = None,  # (B, num_hashes) f32
    live: Optional[torch.Tensor] = None,    # (B,) rows the select keeps
) -> torch.Tensor:
    """The OOV embedding of every row (selection happens in `route`)."""
    emb = spec.embedder
    if emb is None:
        return gather_rows(bucket_table, buckets.long(), live)
    if emb == "zero":
        return iv_table.new_zeros((ids.shape[0], iv_table.shape[1]))
    if emb == "mean":
        m = iv_table.detach().mean(dim=0)
        return m.expand(ids.shape[0], iv_table.shape[1])
    if emb == "knn":
        neigh = estate[f"{side}_knn_neighbors"][ids]  # (B, k)
        return iv_table.detach()[neigh].mean(dim=1)
    if emb in ("lsh", "slsh"):
        feats = estate[f"{side}_feat_mat"][ids]       # (B, F)
        planes = estate[f"{side}_planes"]             # (bits, F)
        proj = feats @ planes.T                       # (B, bits)
        bits = (proj >= 0).to(iv_table.dtype)         # sign→{0,1}, 0 counts as 1
        if emb == "lsh":
            denom = bits.sum(dim=1, keepdim=True).clamp(min=1.0)
            return (bits @ bucket_table) / denom
        # slsh: the reference's (2**bits).sum() = n_bits + popcount
        bucket_id = (bits.shape[1] + bits.sum(dim=1).long()) % bucket_table.shape[0]
        return gather_rows(bucket_table, bucket_id, live)
    if emb == "dnn":
        return mlp(estate[f"{side}_feat_mat"][ids])
    if emb == "dhe":
        return mlp(dhe_hashes)
    if emb == "fdhe":
        feats = estate[f"{side}_feat_mat"][ids]
        return mlp(torch.cat([dhe_hashes, feats], dim=-1))
    raise NotImplementedError(f"embedder [{emb}] not supported")


def route(
    spec: Optional[InductiveSpec],
    side: str,
    ids: torch.Tensor,
    oov_flags: Optional[torch.Tensor],
    buckets: Optional[torch.Tensor],
    iv_table: torch.Tensor,
    bucket_table: Optional[torch.Tensor] = None,
    estate: Optional[Mapping[str, torch.Tensor]] = None,
    mlp: Optional[Callable] = None,
    dhe_hashes: Optional[torch.Tensor] = None,
    feat_ids: Optional[torch.Tensor] = None,
    iv_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IV/OOV-routed embedding lookup.

    `oov = (id >= n_vocab) | (flag > 0)`; the IV side clips ids into the
    table (the clipped rows are discarded by the select). `iv_rows`, where
    given, are `iv_table[ids]` already (the sparse path's rows in batch
    order), read without a gather.
    """
    ids = ids.long()
    n_vocab = iv_table.shape[0]
    if spec is None or not spec.active:
        return gather_rows(iv_table, ids) if iv_rows is None else iv_rows
    is_oov = ids >= n_vocab
    if oov_flags is not None:
        is_oov = is_oov | (oov_flags > 0)
    if buckets is None:
        # batches without annotations: the OOV side is still computed
        # (branchless) but never selected unless an id exceeds the vocab —
        # bucket 0 is a safe placeholder
        buckets = torch.zeros_like(ids)
    if spec.embedder in ("dhe", "fdhe") and dhe_hashes is None:
        dhe_hashes = iv_table.new_zeros((ids.shape[0], spec.dhe_num_hashes))
    iv_e = (gather_rows(iv_table, ids.clamp(0, n_vocab - 1), ~is_oov)
            if iv_rows is None else iv_rows)
    oov_e = oov_embedding(
        spec, side, ids if feat_ids is None else feat_ids.long(), buckets, iv_table,
        bucket_table, estate, mlp=mlp, dhe_hashes=dhe_hashes, live=is_oov,
    )
    return torch.where(is_oov[:, None], oov_e.to(iv_e.dtype), iv_e)

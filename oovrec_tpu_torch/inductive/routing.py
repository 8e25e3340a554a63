"""Branchless IV/OOV embedding routing.

Port of `oovrec_tpu/inductive/routing.py:34-145`. Every row computes BOTH
the IV lookup and the OOV embedding, and a `torch.where` on the OOV
predicate selects: static shapes, no boolean-mask partitions.

Embedder semantics (reference file:line):
  bucket  — `user_oov_buckets(mapped - n)` (`bpr.py:76,124`)
  zero    — 0-vector (`zero_embedder.py:36-60`)
  mean    — column-mean of the IV table (`mean_embedder.py:53-61`)
lsh, slsh, dnn, dhe, fdhe and knn read embedder state that
`inductive/factory.py` builds; they come with the slice that ports it.
"""

from __future__ import annotations

from typing import Optional

import torch

from oovrec_tpu_torch.inductive.spec import InductiveSpec

_LATER = ("lsh", "slsh", "dnn", "dhe", "fdhe", "knn")


def oov_embedding(
    spec: InductiveSpec,
    side: str,                              # 'user' | 'item'
    ids: torch.Tensor,                      # (B,) raw ids
    buckets: Optional[torch.Tensor],        # (B,) host-hashed mapper buckets
    iv_table: torch.Tensor,                 # (n_vocab, D)
    bucket_table: Optional[torch.Tensor],   # (n_buckets, D) or None
) -> torch.Tensor:
    """The OOV embedding of every row (selection happens in `route`)."""
    emb = spec.embedder
    if emb is None:
        return bucket_table[buckets.long()]
    if emb == "zero":
        return iv_table.new_zeros((ids.shape[0], iv_table.shape[1]))
    if emb == "mean":
        m = iv_table.detach().mean(dim=0)
        return m.expand(ids.shape[0], iv_table.shape[1])
    if emb in _LATER:
        raise NotImplementedError(
            f"embedder [{emb}] needs the embedder state of "
            "inductive/factory.py, which a later slice of the port brings"
        )
    raise NotImplementedError(f"embedder [{emb}] not supported")


def route(
    spec: Optional[InductiveSpec],
    side: str,
    ids: torch.Tensor,
    oov_flags: Optional[torch.Tensor],
    buckets: Optional[torch.Tensor],
    iv_table: torch.Tensor,
    bucket_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IV/OOV-routed embedding lookup.

    `oov = (id >= n_vocab) | (flag > 0)`; the IV side clips ids into the
    table (the clipped rows are discarded by the select).
    """
    ids = ids.long()
    n_vocab = iv_table.shape[0]
    if spec is None or not spec.active:
        return iv_table[ids]
    is_oov = ids >= n_vocab
    if oov_flags is not None:
        is_oov = is_oov | (oov_flags > 0)
    if buckets is None:
        # batches without annotations: the OOV side is still computed
        # (branchless) but never selected unless an id exceeds the vocab —
        # bucket 0 is a safe placeholder
        buckets = torch.zeros_like(ids)
    iv_e = iv_table[ids.clamp(0, n_vocab - 1)]
    oov_e = oov_embedding(spec, side, ids, buckets, iv_table, bucket_table)
    return torch.where(is_oov[:, None], oov_e.to(iv_e.dtype), iv_e)

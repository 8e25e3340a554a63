"""Model base class and shared plumbing.

Port of `oovrec_tpu/models/base.py:48-177, 205-210` as a `torch.nn.Module`:
user/item ID tables, the OOV bucket tables of the inductive layer, and the
IV/OOV routing (`inductive.routing.route`). Parameters are created on an
explicit `device` and drawn from an explicit `torch.Generator`.

Not ported yet: row-sharded tables and the DHE/DNN embedder towers
(`EmbedderMLP`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from oovrec_tpu_torch.inductive.routing import route
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.utils.device import resolve_device
from oovrec_tpu_torch.utils.enums import InputType, ModelType

Batch = Dict[str, torch.Tensor]


class GeneralRecommender(nn.Module):
    """Two-tower base (user/item ID spaces, optional inductive routing)."""

    model_type = ModelType.GENERAL
    input_type = InputType.POINTWISE

    def __init__(
        self,
        n_users: int,
        n_items: int,
        embedding_size: int = 64,
        spec: Optional[InductiveSpec] = None,
        uid_field: str = "user_id",
        iid_field: str = "item_id",
        neg_prefix: str = "neg_",
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.n_users = n_users
        self.n_items = n_items
        self.embedding_size = embedding_size
        self.spec = spec
        self.uid_field = uid_field
        self.iid_field = iid_field
        self.neg_prefix = neg_prefix
        self.device = resolve_device(device)
        self.generator = generator

    def _embed_table(self, vocab: int) -> nn.Embedding:
        table = nn.Embedding(vocab, self.embedding_size, device=self.device)
        xavier_normal_(table.weight, self.generator)
        return table

    def _setup_oov(self):
        """Create OOV bucket tables per the spec
        (`abstract_recommender.py:134-139`)."""
        spec = self.spec
        if spec is None or not spec.active:
            return
        if spec.trainable_embedder:
            raise NotImplementedError(
                f"embedder [{spec.embedder}] towers come with a later slice"
            )
        if spec.needs_buckets:
            self.user_oov_buckets = self._embed_table(spec.n_user_buckets)
            self.item_oov_buckets = self._embed_table(spec.n_item_buckets)

    def _route_side(self, side: str, iv: nn.Embedding, ids, batch: Batch,
                    field: str):
        """The routed embedding of `ids` on one side.

        Sparse fast path (`train/sparse_update.py`): a batch key
        `_sparse_rows_<side>` carries pre-gathered table rows (n, D) with
        the id fields remapped to row positions; the lookup reads those rows
        and not the table, so autograd yields row gradients. Training only:
        ids are < vocab there, and the embedder must never read the whole
        table (not mean or knn)."""
        spec = self.spec
        active = spec is not None and spec.active
        flags = batch.get(field + "_oov") if active else None
        buckets = batch.get(field + "_bucket") if active else None
        bucket_table = None
        if active and spec.needs_buckets:
            bucket_table = (
                self.user_oov_buckets if side == "user" else self.item_oov_buckets
            ).weight
        table = batch.get("_sparse_rows_" + side)
        if table is None:
            table = iv.weight
        else:
            assert not (active and spec.embedder in ("mean", "knn")), (
                "sparse row override cannot serve whole-table embedders")
        return route(spec, side, ids, flags, buckets, table, bucket_table)

    # Methods models must provide:
    def predict(self, batch: Batch):
        raise NotImplementedError


MODEL_REGISTRY: Dict[str, Any] = {}


def register_model(cls):
    MODEL_REGISTRY[cls.__name__] = cls
    return cls

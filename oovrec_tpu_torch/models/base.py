"""Model base class and shared plumbing.

Port of `oovrec_tpu/models/base.py:31-45, 48-210` as `torch.nn.Module`s:
user/item ID tables, the trainable pieces of the inductive layer (OOV
bucket tables, the `EmbedderMLP` towers of dnn / dhe / fdhe) and the IV/OOV
routing (`inductive.routing.route`). Parameters are created on an explicit
`device` and drawn from an explicit `torch.Generator`.

The embedder state (`inductive/factory.py:build_embedder_state`: feature
matrices, LSH planes, knn tables, DHE keys) lives on the model as buffers
(`self.embedder_state`, an `EmbedderBuffers`) on the model's device, so it
rides in `state_dict()` and the checkpoint, as the JAX trainer saves its
`estate`; the towers' input widths come from it.

Not ported yet: row-sharded tables (ROADMAP queue 1, parallelism).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from oovrec_tpu_torch.inductive.factory import RESTORED_KEYS, EmbedderBuffers, needs_state
from oovrec_tpu_torch.inductive.routing import route
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.ops.siphash_device import dhe_codes_device
from oovrec_tpu_torch.utils.device import resolve_device
from oovrec_tpu_torch.utils.enums import InputType, ModelType

Batch = Dict[str, torch.Tensor]
STATE = "embedder_state"


class EmbedderMLP(nn.Module):
    """The DHE / fDHE / DNN encoder tower: `n_hidden` × (Linear → exact-erf
    GELU), then Linear → Sigmoid (`dh_embedder.py:70-89`,
    `dnn_embedder.py:65-90`). Linears are `Dense_<j>` as in the flax tree,
    xavier-normal from the explicit generator, zero biases."""

    def __init__(self, in_size: int, layer_size: int, out_size: int, n_hidden: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_size] + [layer_size] * n_hidden + [out_size]
        self.dense = []
        for j, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            lin = nn.Linear(n_in, n_out, device=device)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"Dense_{j}", lin)
            self.dense.append(lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for lin in self.dense[:-1]:
            x = nn.functional.gelu(lin(x))  # torch nn.GELU default (erf)
        return torch.sigmoid(self.dense[-1](x))


def tower_inputs(spec: InductiveSpec, state: EmbedderBuffers) -> Dict[str, int]:
    """The input width of each side's tower: the feature width (dnn), the
    hash count (dhe), both (fdhe)."""
    out = {}
    for side in ("user", "item"):
        width = 0
        if spec.embedder in ("dhe", "fdhe"):
            width += spec.dhe_num_hashes
        if spec.embedder in ("dnn", "fdhe"):
            width += state.width(side)
        out[side] = width
    return out


def make_embedder_state(spec: Optional[InductiveSpec],
                        state: Optional[Mapping[str, np.ndarray]], device) -> EmbedderBuffers:
    """The model's state buffers; an embedder that reads state refuses to
    start without it."""
    if needs_state(spec) and spec.active and state is None:
        raise ValueError(
            f"embedder [{spec.embedder}] needs its state: "
            "inductive/factory.py:build_embedder_state builds it")
    return EmbedderBuffers(state, device)


def dhe_hashes_for(batch: Batch, field: str, estate) -> Optional[torch.Tensor]:
    """Host-annotated hashes `<field>_dhe`, or under `dhe_on_device` the
    card's SipHash of the shipped id column `<field>_dhe_id`."""
    dhe = batch.get(field + "_dhe")
    if dhe is None and field + "_dhe_id" in batch:
        dhe = dhe_codes_device(batch[field + "_dhe_id"], estate["dhe_keys"])
    return dhe


def load_params(model: nn.Module, params: Mapping[str, torch.Tensor],
                restore: tuple = RESTORED_KEYS) -> None:
    """Load a saved `state_dict` into `model`: every parameter and
    BatchNorm running statistic, and of the embedder state only the
    `restore` keys (a model rebuilt over another corpus keeps its own
    feature matrices and neighbors)."""
    own = model.state_dict()
    take = {}
    for k, v in params.items():
        head, _, leaf = k.rpartition(".")
        if head.split(".")[-1] == STATE and leaf not in restore:
            continue
        if k not in own:
            raise KeyError(f"checkpoint entry [{k}] has no place in the model")
        take[k] = v
    missing = [k for k in own if k not in take and k.split(".")[-2:-1] != [STATE]]
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    model.load_state_dict(take, strict=False)


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
        embedder_state: Optional[Mapping[str, np.ndarray]] = None,
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
        self.embedder_state = make_embedder_state(spec, embedder_state, self.device)

    def _embed_table(self, vocab: int) -> nn.Embedding:
        table = nn.Embedding(vocab, self.embedding_size, device=self.device)
        xavier_normal_(table.weight, self.generator)
        return table

    def _setup_oov(self):
        """Create OOV bucket tables and embedder towers per the spec
        (`abstract_recommender.py:134-139`)."""
        spec = self.spec
        if spec is None or not spec.active:
            return
        if spec.needs_buckets:
            self.user_oov_buckets = self._embed_table(spec.n_user_buckets)
            self.item_oov_buckets = self._embed_table(spec.n_item_buckets)
        if spec.trainable_embedder:
            widths = tower_inputs(spec, self.embedder_state)
            for side in ("user", "item"):
                setattr(self, f"{side}_oov_mlp", EmbedderMLP(
                    widths[side], spec.dhe_layer_size, self.embedding_size,
                    device=self.device, generator=self.generator))

    def _route_side(self, side: str, iv: nn.Embedding, ids, batch: Batch,
                    field: str):
        """The routed embedding of `ids` on one side.

        Sparse fast path (`train/sparse_update.py`): a batch key
        `_sparse_rows_<side>` carries pre-gathered table rows (n, D) with
        the id fields remapped to row positions; the lookup reads those rows
        and not the table, so autograd yields row gradients; a field's rows
        are the slice at `_sparse_off_<field>`, read without a gather. The
        entity ids ride in `_sparse_ids_<field>` for the feature lookups.
        Training only: ids are < vocab there, and the embedder must never
        read the whole table (not mean or knn)."""
        spec = self.spec
        active = spec is not None and spec.active
        flags = batch.get(field + "_oov") if active else None
        buckets = batch.get(field + "_bucket") if active else None
        bucket_table = mlp = dhe = None
        if active:
            if spec.needs_buckets:
                bucket_table = (
                    self.user_oov_buckets if side == "user" else self.item_oov_buckets
                ).weight
            if spec.trainable_embedder:
                mlp = getattr(self, f"{side}_oov_mlp")
            if spec.embedder in ("dhe", "fdhe"):
                dhe = dhe_hashes_for(batch, field, self.embedder_state)
        table = batch.get("_sparse_rows_" + side)
        iv_rows = None
        if table is None:
            table = iv.weight
        else:
            assert not (active and spec.embedder in ("mean", "knn")), (
                "sparse row override cannot serve whole-table embedders")
            off = batch.get("_sparse_off_" + field)
            if off is not None:  # the field's rows, in batch order: no gather
                iv_rows = table.narrow(0, off, ids.numel())
        return route(spec, side, ids, flags, buckets, table, bucket_table,
                     self.embedder_state, mlp=mlp, dhe_hashes=dhe,
                     feat_ids=batch.get("_sparse_ids_" + field), iv_rows=iv_rows)

    # Methods models must provide:
    def predict(self, batch: Batch):
        raise NotImplementedError


class IDTowerRecommender(GeneralRecommender):
    """Two ID-table towers (`user_embedding`, `item_embedding`) with OOV
    routing on both sides, and the retrieval methods the evaluators call:
    the routed lookups, IV-only full-sort scores, the embedding of the
    whole (IV + OOV) item range and the two towers of the fused top-k
    kernel (`bpr.py:48-162`, `directau.py:37-125` of the JAX package)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.user_embedding = self._embed_table(self.n_users)
        self.item_embedding = self._embed_table(self.n_items)
        self._setup_oov()

    def user_e(self, ids, batch: Batch):
        return self._route_side("user", self.user_embedding, ids, batch, self.uid_field)

    def item_e(self, ids, batch: Batch, field=None):
        return self._route_side("item", self.item_embedding, ids, batch,
                                field or self.iid_field)

    def full_sort_scores(self, batch: Batch):
        """IV-only full-corpus scores of the unnormalised embeddings."""
        u = self.user_e(batch[self.uid_field], batch)
        return u @ self.item_embedding.weight.T

    def all_item_embeddings(self, item_ids, item_buckets=None, item_dhe=None,
                            item_dhe_ids=None):
        """Embed the full (IV+OOV) item range once per eval pass (the item
        half of `ind_full_sort_predict`): `item_dhe` are host hashes,
        `item_dhe_ids` the ids hashed on the model's device."""
        batch = {self.iid_field: item_ids}
        if item_buckets is not None:
            batch[self.iid_field + "_bucket"] = item_buckets
        if item_dhe is not None:
            batch[self.iid_field + "_dhe"] = item_dhe
        if item_dhe_ids is not None:
            batch[self.iid_field + "_dhe_id"] = item_dhe_ids
        return self.item_e(item_ids, batch)

    def user_tower(self, batch: Batch):
        """(B, D) user embeddings for the fused retrieval kernel."""
        return self.user_e(batch[self.uid_field], batch)

    def item_tower(self):
        """(n_items, D) IV item table for the fused retrieval kernel."""
        return self.item_embedding.weight

    def score_against(self, batch: Batch, all_item_e):
        """user_e @ all_item_eᵀ."""
        return self.user_e(batch[self.uid_field], batch) @ all_item_e.T


MODEL_REGISTRY: Dict[str, Any] = {}


def register_model(cls):
    MODEL_REGISTRY[cls.__name__] = cls
    return cls

"""Context-aware (CTR) recommender base: packed field embeddings.

Port of `oovrec_tpu/models/context.py:43-80, 139-417` (the reference's
`ContextRecommender` / `InductiveContextRecommender` and its `FMEmbedding`
/ `FMFirstOrderLinear` layers).

Layout (as the JAX package):
  * all token fields share ONE offset-packed table (Σ dims, D); token
    field order starts [user_id, item_id, ...], so the OOV cells are 0/1;
  * numerical float fields embed as value × table[bucket + offset], the
    bucket defaulting to 1;
  * the concat output is [token ∥ float] along the field axis;
  * a first-order twin of the whole structure with output dim 1 + bias.

Inductive routing: cells 0/1 of the packed lookup are replaced with the
OOV-routed embeddings of `inductive.routing.route` over the IV slice of
the packed table. The first-order twin routes through its OWN dim-1
bucket tables. Module and parameter names follow the flax tree
(`first_order_linear/fo`, `token_embedding_table`, ...), so the weight
bridge maps them one to one; the one rename, `field_embedding` for the
flax `fields`, is declared in `ContextRecommender.flax_names`.

Not ported yet: token_seq / float_seq fields (no serving configuration
has them), `field_spec_from_dataset` (waits for the atomic-file dataset)
and the trainable embedder towers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from oovrec_tpu_torch.inductive.routing import route
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import Batch
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.utils.device import resolve_device
from oovrec_tpu_torch.utils.enums import InputType, ModelType

# token columns a corpus may legitimately lack (PAD-filled when absent):
# the is_new flag column exists only on the original benchmark files
OPTIONAL_TOKEN_COLUMNS = frozenset({"is_new"})


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of the feature fields."""

    token_names: Tuple[str, ...] = ()
    token_dims: Tuple[int, ...] = ()
    float_names: Tuple[str, ...] = ()
    float_dims: Tuple[int, ...] = ()
    token_seq_names: Tuple[str, ...] = ()
    token_seq_dims: Tuple[int, ...] = ()
    float_seq_names: Tuple[str, ...] = ()
    float_seq_dims: Tuple[int, ...] = ()
    # indices (into token_names) of user-side vs item-side fields
    user_token_idx: Tuple[int, ...] = (0,)
    item_token_idx: Tuple[int, ...] = (1,)

    @property
    def num_feature_field(self) -> int:
        return (
            len(self.token_names)
            + len(self.float_names)
            + len(self.token_seq_names)
            + len(self.float_seq_names)
        )

    @property
    def token_offsets(self) -> np.ndarray:
        return np.array((0, *np.cumsum(self.token_dims)[:-1]), dtype=np.int64)

    @property
    def float_offsets(self) -> np.ndarray:
        return np.array((0, *np.cumsum(self.float_dims)[:-1]), dtype=np.int64)


class _FieldEmbedding(nn.Module):
    """The packed token/float embedding block at a given output dim: at
    `embedding_size` for the towers and at dim 1 for the first-order
    twin."""

    def __init__(
        self,
        fields: FieldSpec,
        dim: int,
        spec: Optional[InductiveSpec] = None,
        uid_field: str = "user_id",
        iid_field: str = "item_id",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if fields.token_seq_names or fields.float_seq_names:
            raise NotImplementedError(
                "token_seq / float_seq fields "
                f"{fields.token_seq_names + fields.float_seq_names} come with "
                "the slice that ports the sequence-feature dataset"
            )
        self.fields = fields
        self.dim = dim
        self.spec = spec
        self.uid_field = uid_field
        self.iid_field = iid_field

        def table(vocab):
            t = nn.Embedding(vocab, dim, device=device)
            xavier_normal_(t.weight, generator)
            return t

        if fields.token_dims:
            self.token_embedding_table = table(int(sum(fields.token_dims)))
        if fields.float_dims:
            self.float_embedding_table = table(int(sum(fields.float_dims)))
        if spec is not None and spec.active:
            if spec.trainable_embedder:
                raise NotImplementedError(
                    f"embedder [{spec.embedder}] towers come with a later slice"
                )
            if spec.needs_buckets:
                self.user_oov_buckets = table(spec.n_user_buckets)
                self.item_oov_buckets = table(spec.n_item_buckets)
        dev = self.token_embedding_table.weight.device if fields.token_dims else device
        self.register_buffer(
            "_token_offsets", torch.as_tensor(fields.token_offsets, device=dev),
            persistent=False)
        self.register_buffer(
            "_token_dims",
            torch.as_tensor(np.asarray(fields.token_dims, np.int64), device=dev),
            persistent=False)
        self.register_buffer(
            "_float_offsets", torch.as_tensor(fields.float_offsets, device=dev),
            persistent=False)

    # -- token fields with OOV routing on cells 0/1 ------------------------

    def embed_token_fields(self, batch: Batch) -> Optional[torch.Tensor]:
        f = self.fields
        if not f.token_names:
            return None
        # only KNOWN-optional columns may fall back to [PAD]=0; any other
        # absent column is a data-pipeline bug and must raise
        missing = [
            n for n in f.token_names
            if n not in batch and n not in OPTIONAL_TOKEN_COLUMNS
        ]
        if missing:
            raise KeyError(
                f"token feature column(s) {missing} absent from the batch; "
                f"only {sorted(OPTIONAL_TOKEN_COLUMNS)} may be PAD-filled"
            )
        ref_col = batch[f.token_names[0]]
        ids = torch.stack(
            [batch[n] if n in batch else torch.zeros_like(ref_col)
             for n in f.token_names],
            dim=1,
        ).long()  # (B, F)
        safe = torch.minimum(ids, self._token_dims[None, :] - 1)
        table = self.token_embedding_table.weight
        emb = table[safe + self._token_offsets[None, :]]  # (B, F, dim)

        spec = self.spec
        if spec is not None and spec.active:
            for cell, side, field in (
                (0, "user", self.uid_field),
                (1, "item", self.iid_field),
            ):
                off, n = int(f.token_offsets[cell]), int(f.token_dims[cell])
                bucket_table = None
                if spec.needs_buckets:
                    bucket_table = (
                        self.user_oov_buckets if side == "user" else self.item_oov_buckets
                    ).weight
                emb[:, cell, :] = route(
                    spec, side, batch[field],
                    batch.get(field + "_oov"), batch.get(field + "_bucket"),
                    table[off: off + n], bucket_table,
                )
        return emb

    def embed_float_fields(self, batch: Batch) -> Optional[torch.Tensor]:
        f = self.fields
        if not f.float_names:
            return None
        values = torch.stack([batch[n].float() for n in f.float_names], dim=1)
        buckets = torch.stack(
            [
                batch[n + "__bucket"] if n + "__bucket" in batch
                else torch.ones_like(batch[n], dtype=torch.long)
                for n in f.float_names
            ],
            dim=1,
        ).long()  # (B, F)
        emb = self.float_embedding_table.weight[buckets + self._float_offsets[None, :]]
        return values[..., None] * emb  # (B, F, dim)

    def forward(self, batch: Batch):
        """→ (sparse (B, F_token, dim) | None, dense (B, F_float, dim) | None)."""
        return self.embed_token_fields(batch), self.embed_float_fields(batch)


class FirstOrderLinear(nn.Module):
    """Σ field dim-1 embeddings + bias (`FMFirstOrderLinear`); the
    inductive twin routes user/item through its own dim-1 OOV tables
    (`InductiveFMFirstOrderLinear`)."""

    def __init__(self, fields: FieldSpec, spec=None, uid_field="user_id",
                 iid_field="item_id", device=None, generator=None):
        super().__init__()
        self.fo = _FieldEmbedding(
            fields, 1, spec=spec, uid_field=uid_field, iid_field=iid_field,
            device=device, generator=generator,
        )
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, batch: Batch) -> torch.Tensor:
        sparse, dense = self.fo(batch)
        total = 0.0
        if sparse is not None:
            total = total + sparse.sum(dim=(1, 2))
        if dense is not None:
            total = total + dense.sum(dim=(1, 2))
        return total[:, None] + self.bias  # (B, 1)


class ContextRecommender(nn.Module):
    """Base for CTR towers: packed field embeddings + first-order linear."""

    model_type = ModelType.CONTEXT
    input_type = InputType.POINTWISE
    # torch module name → flax module name, where they differ (`fields` is
    # the FieldSpec here)
    flax_names = {"field_embedding": "fields"}

    def __init__(
        self,
        fields: FieldSpec,
        embedding_size: int = 10,
        spec: Optional[InductiveSpec] = None,
        uid_field: str = "user_id",
        iid_field: str = "item_id",
        label_field: str = "label",
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.fields = fields
        self.embedding_size = embedding_size
        self.spec = spec
        self.uid_field = uid_field
        self.iid_field = iid_field
        self.label_field = label_field
        self.device = resolve_device(device)
        self.generator = generator

    @property
    def n_users(self) -> int:
        return self.fields.token_dims[0]

    @property
    def n_items(self) -> int:
        return self.fields.token_dims[1]

    def _setup_context(self):
        kw = dict(spec=self.spec, uid_field=self.uid_field,
                  iid_field=self.iid_field, device=self.device,
                  generator=self.generator)
        self.field_embedding = _FieldEmbedding(self.fields, self.embedding_size, **kw)
        self.first_order_linear = FirstOrderLinear(self.fields, **kw)

    def concat_embed_input_fields(self, batch: Batch) -> torch.Tensor:
        sparse, dense = self.field_embedding(batch)
        parts = [p for p in (sparse, dense) if p is not None]
        return torch.cat(parts, dim=1)  # (B, num_field, D)

    @property
    def in_feature_num(self) -> int:
        return self.fields.num_feature_field * self.embedding_size

    def calculate_loss(self, batch: Batch):
        raise NotImplementedError(
            f"{type(self).__name__}.calculate_loss comes with the slice that "
            "ports the trainer"
        )

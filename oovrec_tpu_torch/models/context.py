"""Context-aware (CTR) recommender base: packed field embeddings.

Port of `oovrec_tpu/models/context.py:43-80, 139-417` (the reference's
`ContextRecommender` / `InductiveContextRecommender` and its `FMEmbedding`
/ `FMFirstOrderLinear` layers), with the towers of the trainable embedders
(`:151-260`).

Layout (as the JAX package):
  * all token fields share ONE offset-packed table (Σ dims, D); token
    field order starts [user_id, item_id, ...], so the OOV cells are 0/1;
  * numerical float fields embed as value × table[bucket + offset], the
    bucket defaulting to 1;
  * each token_seq field has its own table `token_seq_table_<name>`, its
    rows pooled over the sequence (mean, max or sum; the mask is id != 0;
    max takes 1e9 off the pads, so an all-pad row picks a pad row); each
    float_seq field its own `float_seq_table_<name>`, the values scaling
    the rows of their `<name>__bucket` indices (the values cast to int32
    where no bucket column rides the batch), pooled alike;
  * the concat output is [token_seq ∥ token ∥ float_seq ∥ float] along the
    field axis;
  * a first-order twin of the whole structure with output dim 1 + bias.

The token fields go through `ops/embed_grad.py:packed_gather`, whose
backward sums a small-vocabulary field's repeated rows by segment; the
float and sequence fields through `gather_rows`, whose backward does the
same for the pads that all hit row 0 (and skips them where pooling gives
them no gradient: the mean and sum modes).
Inductive routing: cells 0/1 of the packed lookup are replaced with the
OOV-routed embeddings of `inductive.routing.route` over the IV slice of
the packed table, with the model's embedder state (`embedder_state`
buffers), the side's tower and the batch's DHE hashes; the packed rows of
those cells are thrown away, so their backward skips them. The
first-order twin routes through its OWN dim-1 bucket tables and towers. Module and parameter names follow the flax tree
(`first_order_linear/fo`, `token_embedding_table`, ...), so the weight
bridge maps them one to one; the one rename, `field_embedding` for the
flax `fields`, is declared in `ContextRecommender.flax_names`.

Train/eval switch: `nn.Module.train()` / `eval()`, which the trainer and
the eval runner set; a model's `forward(batch, train=None)` follows the
module's mode unless `train` is given, as the flax models take `train`,
and `calculate_loss` always runs in train mode, as the JAX package's does.

`field_spec_from_dataset` derives the `FieldSpec` from a `Dataset`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from oovrec_tpu_torch.inductive.routing import route
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import (
    Batch,
    EmbedderMLP,
    dhe_hashes_for,
    make_embedder_state,
    tower_inputs,
)
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.models.layers import masked_mean_pool
from oovrec_tpu_torch.models.losses import bce_with_logits
from oovrec_tpu_torch.ops.embed_grad import gather_rows, packed_gather
from oovrec_tpu_torch.utils.device import resolve_device
from oovrec_tpu_torch.utils.enums import FeatureSource, FeatureType, InputType, ModelType

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


def field_spec_from_dataset(dataset, config) -> FieldSpec:
    """The feature fields of a dataset, as the JAX package scans them
    (`oovrec_tpu/models/context.py:83`): user_id and item_id first, then
    the other fields in the dataset's field order; the label is left out,
    and float fields count only when `numerical_features` names them."""
    numerical = set(config["numerical_features"] or [])
    label = config["LABEL_FIELD"]
    sources = {
        FeatureSource.INTERACTION, FeatureSource.USER, FeatureSource.USER_ID,
        FeatureSource.ITEM, FeatureSource.ITEM_ID,
    }
    tn, td, fn, fd, sn, sd, qn, qd = [], [], [], [], [], [], [], []
    uid, iid = config["USER_ID_FIELD"], config["ITEM_ID_FIELD"]
    ordered = [uid, iid] + [f for f in dataset.field2type if f not in (uid, iid)]
    for f in ordered:
        if f == label or dataset.field2source.get(f) not in sources:
            continue
        t = dataset.field2type[f]
        if t == FeatureType.TOKEN:
            tn.append(f)
            td.append(dataset.num(f))
        elif t == FeatureType.TOKEN_SEQ:
            sn.append(f)
            sd.append(dataset.num(f))
        elif t == FeatureType.FLOAT and f in numerical:
            fn.append(f)
            fd.append(dataset.num(f))
        elif t == FeatureType.FLOAT_SEQ and f in numerical:
            qn.append(f)
            qd.append(dataset.num(f))
    uidx, iidx = [], []
    for i, f in enumerate(tn):
        src = dataset.field2source.get(f)
        if src in (FeatureSource.USER, FeatureSource.USER_ID):
            uidx.append(i)
        elif src in (FeatureSource.ITEM, FeatureSource.ITEM_ID):
            iidx.append(i)
    if not uidx:
        uidx = [0]
    if not iidx:
        iidx = [1] if len(tn) > 1 else [0]
    return FieldSpec(
        tuple(tn), tuple(td), tuple(fn), tuple(fd),
        tuple(sn), tuple(sd), tuple(qn), tuple(qd),
        tuple(uidx), tuple(iidx),
    )


def pool_sequence(emb: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """(B, L, dim) rows of a sequence field, (B, L) mask → (B, dim): mean,
    max or sum over the live positions (`context.py:280-333` of the JAX
    package)."""
    m = mask[..., None]
    if mode == "max":  # amax splits the gradient among ties, as jnp.max does
        return torch.amax(emb - (1 - m) * 1e9, dim=1)
    if mode == "sum":
        return (emb * m).sum(dim=1)
    return masked_mean_pool(emb, mask)


class _FieldEmbedding(nn.Module):
    """The packed token/float and sequence embedding block at a given
    output dim: at `embedding_size` for the towers and at dim 1 for the
    first-order twin."""

    def __init__(
        self,
        fields: FieldSpec,
        dim: int,
        spec: Optional[InductiveSpec] = None,
        uid_field: str = "user_id",
        iid_field: str = "item_id",
        device=None,
        generator: Optional[torch.Generator] = None,
        tower_in: Optional[dict] = None,
    ):
        super().__init__()
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
        for kind in ("token_seq", "float_seq"):
            for name, vocab in zip(getattr(fields, f"{kind}_names"),
                                   getattr(fields, f"{kind}_dims")):
                setattr(self, f"{kind}_table_{name}", table(vocab))
        if spec is not None and spec.active:
            if spec.needs_buckets:
                self.user_oov_buckets = table(spec.n_user_buckets)
                self.item_oov_buckets = table(spec.n_item_buckets)
            if spec.trainable_embedder:
                for side in ("user", "item"):
                    setattr(self, f"{side}_oov_mlp", EmbedderMLP(
                        tower_in[side], spec.dhe_layer_size, dim,
                        device=device, generator=generator))
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

    def embed_token_fields(self, batch: Batch, estate=None) -> Optional[torch.Tensor]:
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
        spec = self.spec
        routed = spec is not None and spec.active
        live = None
        if routed:  # cells 0/1 are replaced below: their rows add nothing
            live = torch.ones_like(ids, dtype=torch.bool)
            live[:, :2] = False
        emb = packed_gather(table, safe + self._token_offsets[None, :],
                            f.token_dims, f.token_offsets, live)  # (B, F, dim)

        if routed:
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
                    table[off: off + n], bucket_table, estate,
                    mlp=getattr(self, f"{side}_oov_mlp", None),
                    dhe_hashes=dhe_hashes_for(batch, field, estate),
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
        emb = gather_rows(self.float_embedding_table.weight,
                          buckets + self._float_offsets[None, :])
        return values[..., None] * emb  # (B, F, dim)

    def embed_token_seq_fields(self, batch: Batch, mode: str = "mean") -> Optional[torch.Tensor]:
        """(B, F_token_seq, dim): each field's rows pooled over its ids."""
        names = self.fields.token_seq_names
        if not names:
            return None
        outs = []
        for name in names:
            seq = batch[name].long()  # (B, L)
            live = seq != 0
            rows = gather_rows(getattr(self, f"token_seq_table_{name}").weight, seq,
                               None if mode == "max" else live)
            outs.append(pool_sequence(rows, live.float(), mode))
        return torch.stack(outs, dim=1)

    def embed_float_seq_fields(self, batch: Batch, mode: str = "mean") -> Optional[torch.Tensor]:
        """(B, F_float_seq, dim): each field's value-scaled rows pooled over
        its bucket indices."""
        names = self.fields.float_seq_names
        if not names:
            return None
        outs = []
        for name in names:
            values = batch[name].float()  # (B, L)
            idx = batch.get(name + "__bucket")
            idx = values.to(torch.int32) if idx is None else idx
            idx = idx.long()
            live = idx != 0
            rows = gather_rows(getattr(self, f"float_seq_table_{name}").weight, idx,
                               None if mode == "max" else live)
            outs.append(pool_sequence(values[..., None] * rows, live.float(), mode))
        return torch.stack(outs, dim=1)

    def forward(self, batch: Batch, estate=None):
        """→ (sparse (B, F_sparse, dim) | None, dense (B, F_dense, dim) |
        None): sparse [token_seq ∥ token], dense [float_seq ∥ float]
        (`embed_input_fields` of the reference)."""
        sparse = _cat([self.embed_token_seq_fields(batch),
                       self.embed_token_fields(batch, estate)])
        dense = _cat([self.embed_float_seq_fields(batch), self.embed_float_fields(batch)])
        return sparse, dense


def _cat(parts):
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class FirstOrderLinear(nn.Module):
    """Σ field dim-1 embeddings + bias (`FMFirstOrderLinear`); the
    inductive twin routes user/item through its own dim-1 OOV tables
    (`InductiveFMFirstOrderLinear`)."""

    def __init__(self, fields: FieldSpec, spec=None, uid_field="user_id",
                 iid_field="item_id", device=None, generator=None, tower_in=None):
        super().__init__()
        self.fo = _FieldEmbedding(
            fields, 1, spec=spec, uid_field=uid_field, iid_field=iid_field,
            device=device, generator=generator, tower_in=tower_in,
        )
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, batch: Batch, estate=None) -> torch.Tensor:
        sparse, dense = self.fo(batch, estate)
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
        embedder_state=None,
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
        self.embedder_state = make_embedder_state(spec, embedder_state, self.device)

    @property
    def n_users(self) -> int:
        return self.fields.token_dims[0]

    @property
    def n_items(self) -> int:
        return self.fields.token_dims[1]

    def _setup_context(self, first_order: bool = True, fields: bool = True):
        """The field embedding and the first-order twin, each unless its
        flag is false (a model that never calls it: the flax tree then has
        no such params; LR has only the twin)."""
        spec = self.spec
        tower_in = (tower_inputs(spec, self.embedder_state)
                    if spec is not None and spec.active and spec.trainable_embedder else None)
        kw = dict(spec=spec, uid_field=self.uid_field,
                  iid_field=self.iid_field, device=self.device,
                  generator=self.generator, tower_in=tower_in)
        if fields:
            self.field_embedding = _FieldEmbedding(self.fields, self.embedding_size, **kw)
        if first_order:
            self.first_order_linear = FirstOrderLinear(self.fields, **kw)

    def concat_embed_input_fields(self, batch: Batch) -> torch.Tensor:
        sparse, dense = self.field_embedding(batch, self.embedder_state)
        parts = [p for p in (sparse, dense) if p is not None]
        return torch.cat(parts, dim=1)  # (B, num_field, D)

    @property
    def in_feature_num(self) -> int:
        return self.fields.num_feature_field * self.embedding_size


def dense(module: ContextRecommender, n_in: int, n_out: int, bias: bool = True) -> nn.Linear:
    """A flax `nn.Dense(kernel_init=xavier_normal)`: xavier-normal weight,
    zero bias."""
    lin = nn.Linear(n_in, n_out, bias=bias, device=module.device)
    xavier_normal_(lin.weight, module.generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def raw_param(module: ContextRecommender, *shape, init=xavier_normal_) -> nn.Parameter:
    """A raw flax leaf of `shape` (no module around it), drawn by `init`."""
    p = nn.Parameter(torch.empty(shape, device=module.device))
    init(p, module.generator)
    return p


class PairMixin:
    """The upper-triangle field pairs (i < j) as buffers `pair_i` /
    `pair_j`, in `triu_indices(F, 1)` order, built once (a host copy in
    `forward` would break graph capture)."""

    def _register_pairs(self) -> int:
        f = self.fields.num_feature_field
        iu, ju = torch.triu_indices(f, f, 1, device=self.device)
        self.register_buffer("pair_i", iu, persistent=False)
        self.register_buffer("pair_j", ju, persistent=False)
        return f * (f - 1) // 2

    def _pairs(self, emb: torch.Tensor):
        return emb[:, self.pair_i, :], emb[:, self.pair_j, :]


class LogitModel(ContextRecommender):
    """A model whose forward gives logits: BCE on them in train mode,
    their sigmoid in eval mode."""

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        return bce_with_logits(self.forward(batch, train=True), batch[self.label_field],
                               batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self.forward(batch, train=False))

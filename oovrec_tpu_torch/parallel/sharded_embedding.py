"""Row-sharded embedding tables and their lookup exchanges.

Port of `oovrec_tpu/parallel/sharded_embedding.py`. A table of V rows is
split over the S ranks of a model group (`parallel/mesh.py`); each rank
holds one block and the lookups exchange rows over the group:

  * layout "mod" (`ShardedEmbed` in JAX): row r lives on model rank r % S
    at local row r // S; the full form is the (S, V_pad/S, D)
    `embedding_sharded` array that `to_sharded_layout` builds;
  * layout "block" (the port's `sharded_lookup: gspmd`, the contiguous
    P('model', None) blocks of the JAX rule): row r lives on model rank
    r // rows at local row r % rows; the full form is the dense (V, D)
    table.

The psum exchange (`:57-82` there): every rank gathers the ids it owns
(the others masked to zero) and an all-reduce over the model group
assembles the (b, D) rows. Its backward is the masked local scatter-add,
the backward of `ops/embed_grad.py:gather_rows` (the hand-written
`csrc/embed_grad.cu` on the card) with the rows of other owners skipped.

The all-to-all exchange (`:85-165` there): each model rank takes its b/S
slice of the batch, sorts it by owner (stable), and asks each owner for at
most C = ⌈f·(b/S)/S⌉ rows: an id all-to-all, the owners' local gathers,
a row all-to-all back, and an all-gather of the S slices. Ids past an
owner's capacity go to a discard row, get zero rows and are counted
(`overflow`, summed over the group); their cotangents go nowhere. The
backward runs the same exchange in reverse: the own slice of the
all-gather's cotangent, a row all-to-all to the owners, and the masked
scatter-add there.

Gradients: every rank of a model group computes the same loss from the
same rows, so a cotangent that reaches an all-reduce or an all-gather is
already the whole one on each rank: the all-reduce passes it through and
the all-gather keeps this rank's slice. Summing over the data group
(`parallel/train_step.py`) adds the other data coordinates' rows.

`COLLECTIVES` counts the collectives each exchange makes, forward and
backward. Without a process group (one rank) no collective runs.
"""

from __future__ import annotations

import collections
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.parallel.mesh import Mesh, ROWS, _rule

COLLECTIVES: collections.Counter = collections.Counter()


def _live(group) -> bool:
    return group is not None and dist.is_initialized()


# ------------------------------------------------------------ collectives


class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the cotangent passes through (module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        if _live(group):
            dist.all_reduce(y, group=group)
            COLLECTIVES["all_reduce"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    """The group's blocks stacked along axis 0 in rank order; the
    backward keeps this rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n, ctx.index = x.shape[0], 0
        if not _live(group):
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        COLLECTIVES["all_gather"] += 1
        ctx.index = dist.get_rank(group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


class _AllToAll(torch.autograd.Function):
    """Block t of axis 0 to group rank t, block t of the result from group
    rank t; the same exchange takes the cotangents back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if not _live(group):
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    COLLECTIVES["all_to_all"] += 1
    return out


def _sum_ints(x: torch.Tensor, group) -> torch.Tensor:
    if _live(group):
        dist.all_reduce(x, group=group)
        COLLECTIVES["all_reduce"] += 1
    return x


# ------------------------------------------------------------ layouts


def to_sharded_layout(table: np.ndarray, n_shards: int) -> np.ndarray:
    """Dense (V, D) → mod-sharded (S, V_pad/S, D) layout."""
    V, D = table.shape
    Vp = -(-V // n_shards) * n_shards
    padded = np.zeros((Vp, D), table.dtype)
    padded[:V] = table
    # shard s holds rows r with r % S == s, ordered by r // S
    return np.stack([padded[s::n_shards] for s in range(n_shards)], axis=0)


def from_sharded_layout(sharded: np.ndarray, vocab: int) -> np.ndarray:
    S, rows, D = sharded.shape
    out = np.zeros((S * rows, D), sharded.dtype)
    for s in range(S):
        out[s::S] = sharded[s]
    return out[:vocab]


def _owner_local(ids: torch.Tensor, S: int, rows: int, layout: str):
    if layout == "mod":
        return ids % S, ids // S
    return ids // rows, ids % rows


# ------------------------------------------------------------ exchanges


def psum_lookup(table_local: torch.Tensor, ids: torch.Tensor, group, S: int, s: int,
                layout: str = "mod") -> torch.Tensor:
    """(b,) ids → (b, D) rows; `table_local` is this rank's (rows, D)
    block, `s` its rank in the model group of size S."""
    rows = table_local.shape[0]
    owner, local = _owner_local(ids.long(), S, rows, layout)
    hit = owner == s
    got = gather_rows(table_local, local.clamp(0, rows - 1), hit)
    return _AllReduceSum.apply(got * hit[:, None].to(got.dtype), group)


def alltoall_lookup(table_local: torch.Tensor, ids: torch.Tensor, group, S: int, s: int,
                    capacity_factor: float = 2.0, layout: str = "mod"):
    """(b,) ids, b divisible by S → ((b, D) rows, overflow count over the
    group, an int64 tensor)."""
    b = ids.shape[0]
    if b % S:
        raise ValueError(f"per-data-shard batch {b} must divide the model axis {S}")
    bs = b // S
    C = max(1, int(np.ceil(capacity_factor * bs / S)))
    rows, D = table_local.shape
    dev = ids.device
    my_ids = ids.long()[s * bs:(s + 1) * bs]
    owner, local = _owner_local(my_ids, S, rows, layout)
    order = torch.argsort(owner, stable=True)   # ties keep batch order
    s_owner, s_local = owner[order], local[order]
    start = torch.searchsorted(s_owner, torch.arange(S, device=dev))
    pos = torch.arange(bs, device=dev) - start[s_owner]
    valid = pos < C
    # (S + 1, C): overflowed ids land in the discard row; -1 marks a slot
    # that carries no request
    buf = torch.full((S + 1, C), -1, dtype=torch.int64, device=dev)
    buf[torch.where(valid, s_owner, S), torch.where(valid, pos, 0)] = s_local
    req = _all_to_all(buf[:S].contiguous(), group)    # row t: what peer t asks of me
    live = req >= 0
    got = gather_rows(table_local, req.clamp(0, rows - 1).reshape(-1), live.reshape(-1))
    resp = _AllToAll.apply(got.view(S, C, D), group)  # row t: owner t's rows for me
    # column C reads zeros: an overflowed id's row, whose cotangent is dropped
    ext = torch.cat([resp, resp.new_zeros((S, 1, D))], dim=1)
    got_sorted = ext[s_owner, torch.where(valid, pos, C)]
    block = got_sorted[torch.argsort(order)]
    out = _AllGather.apply(block, group)             # (b, D) in batch order
    overflow = _sum_ints((~valid).sum().reshape(1), group)[0]
    return out, overflow


def make_lookup(mesh: Mesh, kind: str = "auto", capacity_factor: float = 2.0,
                layout: str = "mod"):
    """lookup(table_local (rows, D), ids (b,)) → (b, D) through the
    exchange `kind` (`sharded_lookup`): psum, alltoall, or auto (all-to-all
    at S ≥ 4, psum below, by the JAX package's traffic count)."""
    S, s, group = mesh.n_model, mesh.model_index, mesh.model_group
    if kind == "auto":
        kind = "alltoall" if S >= 4 else "psum"
    if kind == "psum":
        return lambda table, ids: psum_lookup(table, ids, group, S, s, layout)
    if kind == "alltoall":
        return lambda table, ids: alltoall_lookup(table, ids, group, S, s, capacity_factor,
                                                  layout)[0]
    raise ValueError(f"unknown sharded_lookup kind [{kind}]")


# ------------------------------------------------------------ the module


class ShardedEmbedding(nn.Module):
    """A (V, D) table held as this rank's block and looked up through the
    exchange (`kind`: psum | alltoall | auto).

    Layout "mod" (JAX `ShardedEmbed`, `:176-242` there): the parameter
    `embedding_sharded` (1, ⌈V/S⌉, D), this rank's slice of the (S, ⌈V/S⌉,
    D) layout; it initialises at the logical (V_pad, D) shape and folds,
    so xavier's fan is the dense table's. Layout "block" (`shard_tables`,
    under `gspmd`): the parameter `weight_shard` (V/S, D), rows
    [s·V/S, (s+1)·V/S) of the dense table.

    `dense()` and `weight` give the logical (V, D) table, all-gathered over
    the model group (the full sort, mean / knn embedders, a model that
    reads its table whole). A state dict may hold the full form
    (`full_key`: the (S, ⌈V/S⌉, D) layout or the dense (V, D) table) or
    this rank's block; loading takes this rank's block of either (and, for
    the mod layout, of a dense (V, D) `weight`, folded)."""

    def __init__(self, num_embeddings: int, features: int, mesh: Mesh, kind: str = "auto",
                 layout: str = "mod", capacity_factor: float = 2.0, device=None,
                 generator: Optional[torch.Generator] = None,
                 dense: Optional[torch.Tensor] = None):
        super().__init__()
        S, s = mesh.n_model, mesh.model_index
        rows = -(-num_embeddings // S)
        if layout == "block" and rows * S != num_embeddings:
            raise ValueError(f"a block-sharded table needs {S} | {num_embeddings} rows")
        self.num_embeddings, self.features = num_embeddings, features
        self.mesh, self.kind, self.layout = mesh, kind, layout
        self.lookup = make_lookup(mesh, kind, capacity_factor, layout)
        if dense is None:
            # the models package imports this module: its init comes late
            from oovrec_tpu_torch.models.init import xavier_normal_

            dense = torch.empty(S * rows, features, device=device)
            xavier_normal_(dense, generator)
        elif dense.shape[0] < S * rows:
            dense = torch.cat([dense, dense.new_zeros((S * rows - dense.shape[0], features))])
        with torch.no_grad():
            if layout == "mod":
                block = dense.view(rows, S, features)[:, s].unsqueeze(0)
            else:
                block = dense[s * rows:(s + 1) * rows]
        self.local_key = "embedding_sharded" if layout == "mod" else "weight_shard"
        self.full_key = "embedding_sharded" if layout == "mod" else "weight"
        self.register_parameter(self.local_key, nn.Parameter(block.detach().clone()))

    @property
    def local_table(self) -> torch.Tensor:
        """This rank's block as a (rows, D) table."""
        p = getattr(self, self.local_key)
        return p[0] if self.layout == "mod" else p

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        flat = ids.reshape(-1)
        # the all-to-all slices the ids over the model group
        pad = (-flat.shape[0]) % self.mesh.n_model
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        out = self.lookup(self.local_table, flat)
        if pad:
            out = out[: ids.numel()]
        return out.reshape(tuple(ids.shape) + (self.features,))

    def gather_full(self, local: torch.Tensor) -> torch.Tensor:
        """The full form of a tensor laid out like this rank's block (the
        parameter, a moment of the optimizer): every rank's block stacked
        along axis 0."""
        return _AllGather.apply(local, self.mesh.model_group)

    def dense(self) -> torch.Tensor:
        full = self.gather_full(getattr(self, self.local_key))
        if self.layout == "mod":
            S, rows, D = full.shape
            full = full.transpose(0, 1).reshape(S * rows, D)
        return full[: self.num_embeddings]

    @property
    def weight(self) -> torch.Tensor:
        return self.dense()

    def block_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full-form tensor."""
        s = self.mesh.model_index
        if self.layout == "mod":
            return full[s:s + 1]
        rows = getattr(self, self.local_key).shape[0]
        return full[s * rows:(s + 1) * rows]

    def full_shape(self) -> tuple:
        local = tuple(getattr(self, self.local_key).shape)
        return (local[0] * self.mesh.n_model,) + local[1:]

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        param = getattr(self, self.local_key)
        full, local = prefix + self.full_key, prefix + self.local_key
        dense = prefix + "weight"
        value = None
        if full in state_dict and tuple(state_dict[full].shape) == self.full_shape():
            value = self.block_of(state_dict[full])
        elif local in state_dict and tuple(state_dict[local].shape) == tuple(param.shape):
            value = state_dict[local]
        elif self.layout == "mod" and dense in state_dict and tuple(
                state_dict[dense].shape) == (self.num_embeddings, self.features):
            # a dense (V, D) table folded into the layout
            layout = to_sharded_layout(state_dict[dense].detach().cpu().numpy(),
                                       self.mesh.n_model)
            value = self.block_of(torch.from_numpy(layout))
        if value is None:
            missing_keys.append(local)
            return
        with torch.no_grad():
            param.copy_(value)


def sharded_tables(model: Optional[nn.Module]) -> Dict[str, ShardedEmbedding]:
    """`<module path>.<local key>` → its `ShardedEmbedding`, over `model`."""
    out = {}
    for name, mod in (model.named_modules() if model is not None else ()):
        if isinstance(mod, ShardedEmbedding):
            out[(name + "." if name else "") + mod.local_key] = mod
    return out


def full_shapes(model: nn.Module) -> Dict[str, tuple]:
    """The model's state_dict shapes in the full form (each sharded
    table's block as its whole)."""
    tables = sharded_tables(model)
    out = {}
    for k, v in model.state_dict().items():
        mod = tables.get(k)
        if mod is None:
            out[k] = tuple(v.shape)
        else:
            out[k[: -len(mod.local_key)] + mod.full_key] = mod.full_shape()
    return out


def block_state(model: nn.Module, tree):
    """A full-form state tree (`host_copy`'s) with each sharded table's
    entry cut to this rank's block, under the parameter's own name."""
    tables = {k[: -len(m.local_key)] + m.full_key: (k, m) for k, m in sharded_tables(model).items()}

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            hit = tables.get(k)
            if hit is not None and isinstance(v, torch.Tensor) and v.dim() > 0:
                out[hit[0]] = hit[1].block_of(v)
            else:
                out[k] = walk(v)
        return out

    return walk(tree)


def shard_tables(model: nn.Module, mesh: Mesh, row_shard_threshold: int = 4096,
                 kind: str = "auto", capacity_factor: float = 2.0) -> Dict[str, str]:
    """`sharded_lookup: gspmd` under a model axis: every `nn.Embedding`
    attribute of a module whose table the JAX rule row-shards becomes a
    block-layout `ShardedEmbedding` with the same rows. → the replaced
    modules' paths and their new parameter names."""
    done = {}
    if mesh.n_model == 1:
        return done
    for pname, parent in list(model.named_modules()):
        for name, child in list(parent.named_children()):
            if type(child) is not nn.Embedding:
                continue
            if _rule(mesh.n_model, "embedding", tuple(child.weight.shape),
                     row_shard_threshold) != ROWS:
                continue
            table = ShardedEmbedding(
                child.num_embeddings, child.embedding_dim, mesh, kind=kind, layout="block",
                capacity_factor=capacity_factor, dense=child.weight.detach())
            setattr(parent, name, table)
            path = f"{pname}.{name}" if pname else name
            done[path] = f"{path}.{table.local_key}"
    return done


# ------------------------------------------------------ checkpoint layouts


def reconcile_layouts(target_tree, raw_state, dense_key: str = "embedding") -> None:
    """Convert stored embedding-table layouts IN PLACE inside a restored
    state tree so it matches the current tree (`:245-311` there, bit for
    bit): stored sharded → target dense `dense_key` (V, D); stored dense →
    target sharded (S, rows, D); sharded → sharded with another S (through
    the dense form). Works on any nested dict (params and optimizer
    subtrees that mirror them); scalar leaves are renamed only."""

    def dense_of(stored: np.ndarray, vocab: int) -> np.ndarray:
        return from_sharded_layout(np.asarray(stored), vocab)

    def walk(tgt, raw):
        if not isinstance(tgt, dict) or not isinstance(raw, dict):
            return
        if dense_key in tgt and "embedding_sharded" in raw:
            stored = raw.pop("embedding_sharded")
            if np.ndim(stored) == 3 and np.ndim(tgt[dense_key]) == 2:
                v = int(np.shape(tgt[dense_key])[0])
                raw[dense_key] = dense_of(stored, v)
            else:  # scalar / structural leaves (per-param adam counts)
                raw[dense_key] = stored
        elif "embedding_sharded" in tgt and dense_key in raw:
            stored = raw.pop(dense_key)
            shp = np.shape(tgt["embedding_sharded"])
            if np.ndim(stored) == 2 and len(shp) == 3:
                s, rows = int(shp[0]), int(shp[1])
                raw["embedding_sharded"] = to_sharded_layout(np.asarray(stored), s)[:, :rows]
            else:
                raw["embedding_sharded"] = stored
        elif (
            "embedding_sharded" in tgt
            and "embedding_sharded" in raw
            and np.ndim(raw["embedding_sharded"]) == 3
            and tuple(np.shape(tgt["embedding_sharded"]))
            != tuple(np.shape(raw["embedding_sharded"]))
        ):
            s, rows, _d = np.shape(tgt["embedding_sharded"])
            stored = np.asarray(raw["embedding_sharded"])
            dense = dense_of(stored, stored.shape[0] * stored.shape[1])
            raw["embedding_sharded"] = to_sharded_layout(dense, int(s))[:, : int(rows)]
        for k, sub in tgt.items():
            if k in raw:
                walk(sub, raw[k])

    walk(target_tree, raw_state)


def _nest(flat: Mapping[str, object]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def reconcile_state(target_shapes: Mapping[str, tuple], raw: Mapping[str, object]) -> dict:
    """`reconcile_layouts` on a flat state dict of the port (dotted names,
    torch's `weight` for a dense table): → `raw` with each stored table
    layout converted to the one `target_shapes` (`full_shapes`) names.
    Tensors come back as tensors."""
    placeholders = {k: np.broadcast_to(np.zeros((), np.float32), s)
                    for k, s in target_shapes.items()}
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in raw.items()}
    nested = _nest(arrays)
    reconcile_layouts(_nest(placeholders), nested, dense_key="weight")
    out = {}
    for k, v in _flatten(nested).items():
        orig = raw.get(k)
        if isinstance(orig, torch.Tensor) and v is arrays.get(k):
            out[k] = orig
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(np.ascontiguousarray(v))
        else:
            out[k] = v
    return out

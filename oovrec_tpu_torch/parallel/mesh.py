"""The ('data', 'model') mesh over ranks, and the placement rules.

Port of `oovrec_tpu/parallel/mesh.py`. The JAX package lays its named mesh
over devices and lets XLA insert the collectives; the port lays it over
ranks (one process, one device each) and makes the collectives itself:

  data  — the batch axis. Rank r sits at data coordinate r // n_model;
          its rows of every global batch are the data coordinate's block
          (`place_batch`), and the gradients are summed over the ranks that
          share its model coordinate (its *data group*).
  model — the row-sharding axis of big embedding tables. Rank r sits at
          model coordinate r % n_model; the ranks that share its data
          coordinate (its *model group*) see the same rows and hold one
          block each of a sharded table (`parallel/sharded_embedding.py`).

The groups are made once per mesh shape (`make_mesh` caches them), on
every rank in the same order, as `torch.distributed.new_group` requires.
Without a process group (one process) a mesh of one rank has no groups
and every collective is the identity.

`param_sharding` makes the JAX rule's decisions (`:69-97` there) on a
flax-style tree: a 2-D leaf of at least `row_shard_threshold` rows
divisible by n_model is row-sharded, a ShardedEmbed `embedding_sharded`
(S, V/S, D) leaf shards its axis 0, every other leaf is replicated. The
port shards only embedding tables (`port_placement`): under
`sharded_lookup: gspmd` the `nn.Embedding` tables the rule picks become
contiguous row blocks behind the exchange of `sharded_embedding.py`; any
other 2-D parameter the rule picks (a Dense kernel, a raw leaf) stays
replicated, with the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from oovrec_tpu_torch.parallel.distributed import world_size

REPLICATED: Tuple = ()
ROWS: Tuple = ("model", None)
SHARDED_LAYOUT: Tuple = ("model", None, None)


@dataclass
class Mesh:
    """The ranks' ('data', 'model') grid as this rank sees it."""

    n_data: int
    n_model: int
    rank: int = 0
    data_group: Any = None    # ranks sharing this rank's model coordinate
    model_group: Any = None   # ranks sharing this rank's data coordinate

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def data_src(self) -> int:
        """The global rank at data coordinate 0 of this rank's data group."""
        return self.model_index


_MESHES: Dict[Tuple[int, int, int], Mesh] = {}
_ACTIVE: Optional[Mesh] = None


def make_mesh(n_data: int = -1, n_model: int = 1, world: Optional[int] = None) -> Mesh:
    """The (n_data, n_model) mesh over the process group's ranks (n_data
    -1: every rank left); its groups are made on the first call for a
    shape and reused after."""
    global _ACTIVE
    n = world if world is not None else world_size()
    if n_model <= 0:
        n_model = 1
    if n_data <= 0:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover {n} devices")
    key = (n_data, n_model, n)
    if key not in _MESHES:
        rank = dist.get_rank() if dist.is_initialized() else 0
        mesh = Mesh(n_data, n_model, rank)
        if dist.is_initialized():
            data_ranks = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
            model_ranks = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
            for ranks in data_ranks:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.data_group = g
            for ranks in model_ranks:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.model_group = g
        _MESHES[key] = mesh
    _ACTIVE = _MESHES[key]
    return _ACTIVE


def active_mesh() -> Optional[Mesh]:
    """The mesh this process made last (None before any)."""
    return _ACTIVE


def clear_meshes() -> None:
    """Forget every mesh (a process that tears its group down)."""
    global _ACTIVE
    _MESHES.clear()
    _ACTIVE = None


def mesh_from_config(config) -> Mesh:
    m = config.get("mesh", {}) or {}
    return make_mesh(int(m.get("data", -1)), int(m.get("model", 1)))


def mesh_active(config) -> bool:
    """The mesh path engages when the user asks for it: `use_mesh: true`,
    an explicit data-axis size, or a model axis > 1. The defaults (data -1 /
    model 1) keep the single-device path."""
    if config.get("use_mesh"):
        return True
    m = config.get("mesh", {}) or {}
    return int(m.get("model", 1) or 1) > 1 or int(m.get("data", -1) or -1) > 0


def maybe_mesh_from_config(config) -> Optional[Mesh]:
    return mesh_from_config(config) if mesh_active(config) else None


# ------------------------------------------------------------- placement


def _rule(n_model: int, leaf: str, shape: Tuple[int, ...], threshold: int) -> Tuple:
    if n_model > 1 and len(shape) == 2 and shape[0] >= threshold and shape[0] % n_model == 0:
        return ROWS
    if n_model > 1 and leaf == "embedding_sharded" and len(shape) == 3 and shape[0] == n_model:
        return SHARDED_LAYOUT
    return REPLICATED


def param_sharding(mesh: Mesh, params, row_shard_threshold: int = 4096):
    """The JAX rule's PartitionSpec of every leaf of a nested dict of
    arrays, as tuples: ('model', None) row-sharded, ('model', None, None) a
    sharded layout, () replicated."""

    def walk(tree, leaf_name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _rule(mesh.n_model, leaf_name, tuple(np.shape(tree)), row_shard_threshold)

    return walk(params, "")


def port_placement(mesh: Mesh, model: torch.nn.Module, row_shard_threshold: int = 4096
                   ) -> Dict[str, str]:
    """How the port places each parameter of `model` under `mesh`, by name:
    'sharded' (a sharded table's block, or an `nn.Embedding` the rule picks,
    which `shard_tables` will turn into one), 'replicated', or
    'replicated (rule: rows)' for a 2-D parameter the JAX rule row-shards
    that is not an embedding table."""
    from oovrec_tpu_torch.parallel.sharded_embedding import ShardedEmbedding

    out: Dict[str, str] = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(mod, ShardedEmbedding):
                out[name] = "sharded"
            elif isinstance(mod, torch.nn.Embedding) and _rule(
                    mesh.n_model, "embedding", tuple(p.shape), row_shard_threshold) == ROWS:
                out[name] = "sharded"
            elif p.dim() == 2 and _rule(mesh.n_model, pname, tuple(p.shape),
                                        row_shard_threshold) == ROWS:
                out[name] = "replicated (rule: rows)"
            else:
                out[name] = "replicated"
    return out


# ------------------------------------------------------------- batches


def pad_batch(batch, multiple: int):
    """Zero-pad every array's leading (batch) axis to a multiple; every
    batcher emits a `weight` column that zero-masks pad rows, so losses
    and metrics are unaffected."""

    def pad(v):
        v = np.asarray(v)
        if v.ndim >= 1 and v.shape[0] % multiple:
            extra = (-v.shape[0]) % multiple
            v = np.concatenate([v, np.zeros((extra,) + v.shape[1:], v.dtype)])
        return v

    return {k: pad(v) for k, v in batch.items()}


def data_rows(mesh: Mesh, batch):
    """This rank's rows of a global batch (numpy arrays or tensors): the
    leading axis zero-padded to a multiple of n_data, then the data
    coordinate's block. Scalars ride as they are."""
    n, d = mesh.n_data, mesh.data_index
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                out[k] = v
                continue
            extra = (-v.shape[0]) % n
            if extra:
                v = torch.cat([v, v.new_zeros((extra,) + tuple(v.shape[1:]))])
        else:
            v = np.asarray(v)
            if v.ndim == 0:
                out[k] = v
                continue
            extra = (-v.shape[0]) % n
            if extra:
                v = np.concatenate([v, np.zeros((extra,) + v.shape[1:], v.dtype)])
        b = v.shape[0] // n
        out[k] = v[d * b:(d + 1) * b]
    return out


def place_batch(mesh: Mesh, batch, device, local: bool = False):
    """A host batch on `device` as this rank's rows: the data coordinate's
    block of a global batch, or the batch as it is when the loader already
    gives this rank's slice (`local`: a loader sharded by data
    coordinate, `data/dataloader.py:_process_info`). The ranks of one
    model group see the same rows."""
    from oovrec_tpu_torch.data.transfer import to_device_batch

    return to_device_batch(batch if local else data_rows(mesh, batch), device)


def local_rows(shards) -> np.ndarray:
    """This process's rows from its shards of a leading-axis-sharded
    array, in shard order: `shards` is a list of (index, array) pairs,
    `index` a tuple of slices. Shards replicated over the second mesh axis
    carry the same index range and appear once."""
    if not isinstance(shards, (list, tuple)):
        return np.asarray(shards)
    ordered = sorted(shards, key=lambda s: s[0][0].start or 0)
    seen = set()
    parts = []
    for index, data in ordered:
        key = tuple((sl.start, sl.stop) for sl in index)
        if key in seen:
            continue
        seen.add(key)
        parts.append(np.asarray(data))
    return np.concatenate(parts, axis=0)


def host_copy(tree, model: Optional[torch.nn.Module] = None):
    """A state tree (a state_dict, an optimizer state) as host tensors in
    the dense layout: each sharded table's block gathered over the model
    group into its full form (`ShardedEmbedding.full_key`), every other
    tensor copied to the CPU. Every rank of a model group must call it."""
    from oovrec_tpu_torch.parallel.sharded_embedding import sharded_tables

    tables = sharded_tables(model) if model is not None else {}

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                mod = tables.get(k)
                if mod is not None and isinstance(v, torch.Tensor):
                    out[k[: -len(mod.local_key)] + mod.full_key] = mod.gather_full(v).cpu()
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, torch.Tensor):
            return node.detach().to("cpu", copy=True)
        return node

    return walk(tree)

"""The mesh training step: the global batch's step on every rank.

Port of `oovrec_tpu/parallel/train_step.py` and of the JAX trainer's mesh
step (`train/trainer.py:90-100, 171-211` there). JAX differentiates one
loss over the whole data-sharded batch, which `pad_batch` pads to a
multiple of the data axis with weight-0 rows; every reduction over the
batch axis in a loss is therefore global. Here each rank holds its data
coordinate's rows (`parallel/mesh.py:place_batch`), and while the step
runs (`data_scope`) the losses reduce over the data group with
differentiable collectives:

  * `batch_sum` / `batch_mean` / `batch_std`: a sum over every rank's
    rows; a mean whose count is the padded global batch's (an unweighted
    `.mean()` counts the padded rows, as in JAX); a column's deviation;
  * `batch_wmean`: Σwx / Σw with both sums global (`models/losses.py:
    _wmean`);
  * `batch_vector_norm`: one p-norm of a per-row tensor over the global
    batch, the sum of |x|^p all-reduced before the root (`emb_loss`);
  * `global_rows`: the global batch's rows of a per-row tensor (an
    all-gather in rank order) and this rank's row offset, for in-batch
    terms (in-batch negatives, a uniformity over row pairs, the previous
    row of the batch);
  * BatchNorm takes the global batch's moments (`models/layers.py`).

Every rank's loss is then the global batch's loss. The collectives'
backward sums the cotangents over the group, so autograd on each rank
gives the gradient of the ranks' n_data equal losses summed; the step
differentiates loss / n_data and sums the gradients over the data group
(`allreduce_grads`, one flattened all-reduce): a replicated parameter's and
a sharded table's block alike, since the ranks of a data group share the
model coordinate. A term that depends on the parameters alone (a
`reg_weight` penalty, a propagation over the whole graph) comes out once
the same way. The model group's exchanges (`sharded_embedding.py`) keep
their own convention. The optimizer's moments have each parameter's own
shape, so a sharded table's moments are its block's (`opt_state_sharding`).

A draw that feeds a computation every rank repeats (SGL's edge masks)
comes from the trainer's dropout generator, which every rank seeds alike,
so it is the same on every rank; a per-row draw has the local rows'
shape, the same on every rank, so the generators stay in step.

Outside the scope, or at one rank, each helper is the plain op, the scale
is exactly 1.0 and the step is the plain step bit for bit. The step runs
eagerly (the graph capture of `train/cuda_graph.py` does not take the
NCCL collectives yet).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from oovrec_tpu_torch.parallel.distributed import group_size
from oovrec_tpu_torch.parallel.mesh import REPLICATED, Mesh

_DATA_GROUP: List = []


@contextlib.contextmanager
def data_scope(group):
    """While the block runs, the batch reductions of the losses and the
    BatchNorm moments are taken over `group` (the data group)."""
    _DATA_GROUP.append(group)
    try:
        yield
    finally:
        _DATA_GROUP.pop()


def data_group():
    """The group the batch reductions run over, or None (outside the
    scope, or a group of one rank)."""
    g = _DATA_GROUP[-1] if _DATA_GROUP else None
    return g if group_size(g) > 1 else None


class _GroupSum(torch.autograd.Function):
    """A sum over `group`; the backward sums the cotangents over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GroupRows(torch.autograd.Function):
    """The group's blocks stacked along axis 0 in rank order; the backward
    sums the cotangents over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n, ctx.index = group, x.shape[0], dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over `group` that autograd differentiates (its backward sums
    the cotangents over the group)."""
    return _GroupSum.apply(x, group)


def batch_sum(x: torch.Tensor, dim: Optional[int] = None, keepdim: bool = False
              ) -> torch.Tensor:
    """Σ x over every rank's rows: the whole sum, or along `dim` (0, the
    batch axis) as `x.sum(dim)`."""
    g = data_group()
    s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return s if g is None else _GroupSum.apply(s, g)


def batch_mean(x: torch.Tensor, dim: Optional[int] = None, keepdim: bool = False
               ) -> torch.Tensor:
    """The mean of a per-row tensor over the padded global batch, whole or
    along `dim` (0, the batch axis): every rank's x has the same shape, so
    the count is n_data times the local one."""
    g = data_group()
    if g is None:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    count = (x.numel() if dim is None else x.shape[dim]) * dist.get_world_size(g)
    return batch_sum(x, dim, keepdim) / count


def batch_std(x: torch.Tensor) -> torch.Tensor:
    """The population standard deviation of each column of a per-row (B,
    F) tensor over the padded global batch, as (1, F): the global mean,
    then the global mean of the squared deviations."""
    if data_group() is None:
        return x.std(dim=0, correction=0, keepdim=True)
    mean = batch_mean(x, dim=0, keepdim=True)
    return torch.sqrt(batch_mean((x - mean) ** 2, dim=0, keepdim=True))


def batch_wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ x·w / max(Σ w, 1) over the global batch (`w` in x's dtype)."""
    g = data_group()
    if g is None:
        return (x * w).sum() / torch.clamp(w.sum(), min=1.0)
    sums = _GroupSum.apply(torch.stack([(x * w).sum(), w.sum()]), g)
    return sums[0] / torch.clamp(sums[1], min=1.0)


def batch_vector_norm(x: torch.Tensor, ord: float = 2) -> torch.Tensor:
    """‖x‖_ord of a per-row tensor taken whole over the global batch: the
    sum of |x|^ord over every rank's rows, then the root."""
    g = data_group()
    if g is None:
        return torch.linalg.vector_norm(x.reshape(-1), ord=ord)
    return _GroupSum.apply(x.abs().pow(ord).sum(), g) ** (1.0 / ord)


def batch_rows(n: int) -> int:
    """The global batch's row count for `n` rows on each rank."""
    g = data_group()
    return n if g is None else n * dist.get_world_size(g)


def global_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(the global batch's rows of the per-row tensor `x`, in rank order;
    this rank's first row in them): (x, 0) outside the scope."""
    g = data_group()
    if g is None:
        return x, 0
    return _GroupRows.apply(x, g), dist.get_rank(g) * x.shape[0]


def allreduce_grads(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Every gradient summed over `group`, in one flattened all-reduce."""
    if group is None or not dist.is_initialized() or not grads:
        return grads
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    return list(_unflatten_dense_tensors(flat, grads))


def mesh_step(trainer, batch: Dict[str, torch.Tensor], trainable: Optional[set] = None,
              count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of the global batch from this rank's rows `batch`: the
    trainer's parameters and optimizer state update in place. → the global
    batch's loss (the same on every rank)."""
    mesh: Mesh = trainer.mesh
    group = mesh.data_group if group_size(mesh.data_group) > 1 else None
    params = trainer.params
    names = list(params)
    with data_scope(group):
        loss = trainer.model.calculate_loss(batch)
    scaled = loss if group is None else loss / group_size(group)
    grads = torch.autograd.grad(scaled, [params[n] for n in names], allow_unused=True)
    grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
    grads = allreduce_grads(grads, group)
    trainer.optimizer.step(params, dict(zip(names, grads)), trainer.opt_state,
                           trainable=trainable, count=count)
    return loss.detach()


def broadcast_state(model: torch.nn.Module, mesh: Mesh) -> None:
    """Every rank starts from the same numbers: each parameter and buffer
    broadcast over the data group from its data coordinate 0, and a
    replicated one then over the model group from model coordinate 0 (a
    sharded table's block differs across the model group by design)."""
    if not dist.is_initialized():
        return
    from oovrec_tpu_torch.parallel.sharded_embedding import sharded_tables

    sharded = set(sharded_tables(model))
    model_src = mesh.data_index * mesh.n_model
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            dist.broadcast(t.data, src=mesh.data_src(), group=mesh.data_group)
            if name not in sharded:
                dist.broadcast(t.data, src=model_src, group=mesh.model_group)


def opt_state_sharding(opt_state, p_shard: Dict[str, tuple]):
    """The placement of each leaf of an optimizer state: a subtree keyed
    by parameter names mirrors `p_shard` (each parameter's placement), a
    structural leaf (a count) is replicated (`:60-80` there)."""
    if isinstance(opt_state, dict):
        if opt_state and all(k in p_shard for k in opt_state):
            return {k: p_shard[k] for k in opt_state}
        return {k: opt_state_sharding(v, p_shard) for k, v in opt_state.items()}
    return REPLICATED


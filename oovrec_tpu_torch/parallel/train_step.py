"""The mesh training step: the global batch's step on every rank.

Port of `oovrec_tpu/parallel/train_step.py` and of the JAX trainer's mesh
step (`train/trainer.py:90-100, 171-211` there). JAX differentiates one
loss over the whole data-sharded batch; here each rank holds its data
coordinate's rows (`parallel/mesh.py:place_batch`) and

  * scales its loss by its share of the batch's weight, w_local / Σ w
    with the sum all-reduced over the data group, so the shares add up to
    `models/losses.py:_wmean` of the global batch (padded rows weigh 0; a
    rank of padding alone has a zero share and a zero weighted sum): a
    per-row weighted mean splits exactly, and a term that depends on the
    parameters alone (a `reg_weight` penalty) comes out once, the shares
    summing to 1;
  * runs the BatchNorm layers on the global batch's moments
    (`batch_stats_over`: their sums all-reduced over the data group inside
    autograd, `torch.distributed.nn.functional.all_reduce`);
  * sums every gradient over the data group (`allreduce_grads`, one
    flattened all-reduce): a replicated parameter's and a sharded table's
    block alike, since the ranks of a data group share the model
    coordinate;
  * steps the optimizer, whose moments have each parameter's own shape, so
    a sharded table's moments are its block's (`opt_state_sharding`).

A model whose loss has a term that is not a per-row weighted mean (an
in-batch contrastive term, a uniformity term over batch pairs, a VAE's
batch terms) cannot be split so; `mesh_refusal` names it from the model's
`mesh_loss` attribute and the trainer refuses it at init.

The step runs eagerly (the graph capture of `train/cuda_graph.py` does
not take the NCCL collectives yet). At one rank the share is 1.0 and the
all-reduces copy, so the step is the plain step bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from oovrec_tpu_torch.parallel.distributed import group_size
from oovrec_tpu_torch.parallel.mesh import REPLICATED, Mesh

_STATS_GROUP: List = []


def mesh_refusal(model) -> Optional[str]:
    """Why the mesh cannot split `model`'s loss, or None when it can: the
    class declares `mesh_loss = "row_mean"` where its loss is a per-row
    weighted mean (plus parameter-only terms); a string of another value
    is the reason."""
    kind = type(model).__dict__.get("mesh_loss")  # a subclass declares its own
    if kind == "row_mean":
        return None
    if kind:
        return kind
    return ("its loss is not declared a per-row weighted mean (`mesh_loss`), so the "
            "ranks' shares of it cannot be summed into the global batch's loss")


@contextlib.contextmanager
def batch_stats_over(group):
    """BatchNorm layers take the moments of the batch summed over `group`
    while the block runs (`models/layers.py:BatchNorm`)."""
    _STATS_GROUP.append(group)
    try:
        yield
    finally:
        _STATS_GROUP.pop()


def batch_stats_group():
    """The group the BatchNorm moments are summed over, or None."""
    g = _STATS_GROUP[-1] if _STATS_GROUP else None
    return g if group_size(g) > 1 else None


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over `group` that autograd differentiates (its backward sums
    the cotangents over the group)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def loss_share(weight: torch.Tensor, group) -> torch.Tensor:
    """Σ w_local / Σ_group Σ w (1 / group size for a batch of padding
    alone): the factor that turns this rank's `_wmean` into its share of
    the global batch's; the shares sum to 1."""
    w = weight.float().sum()
    total = w.clone()
    if group is not None and dist.is_initialized():
        dist.all_reduce(total, group=group)
    return torch.where(total > 0, w / torch.clamp(total, min=1e-30),
                       torch.ones_like(w) / group_size(group))


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
    group = mesh.data_group
    params = trainer.params
    names = list(params)
    with batch_stats_over(group):
        loss = trainer.model.calculate_loss(batch)
    scaled = loss * loss_share(batch["weight"], group)
    grads = torch.autograd.grad(scaled, [params[n] for n in names], allow_unused=True)
    grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
    grads = allreduce_grads(grads, group)
    trainer.optimizer.step(params, dict(zip(names, grads)), trainer.opt_state,
                           trainable=trainable, count=count)
    total = scaled.detach().clone()
    if group is not None and dist.is_initialized():
        dist.all_reduce(total, group=group)
    return total


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


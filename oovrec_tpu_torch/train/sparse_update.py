"""Row-sparse Adam for big embedding tables (`learner: sparse_adam`).

Port of `oovrec_tpu/train/sparse_update.py:48-297` as plain functions on
tensors. Under `learner: sparse_adam` a row whose gradient is identically
zero this step gets no update and its moments do not advance.
`train/optimizers.py` does that over dense gradients (a sweep of the
whole table every step); this module is the O(touched rows) form the
device-resident epoch uses:

  1. `gather_rows_for_batch`: each big table's rows for this batch are
     gathered into an (n, D) leaf and the batch's id fields remapped to
     row positions; the model reads them through its `_sparse_rows_<side>`
     batch override, so autograd yields row gradients and no dense (V, D)
     gradient is formed.
  2. `sparse_adam_update_table`: duplicate ids coalesced (a stable sort and
     a segmented sum in a fixed order: the same bits on every run, where
     `index_add_` on the card would sum in atomic order), then kernel 6
     (`ops/sparse_rows.py`) steps the touched rows in place, with the bias
     correction of the optimizer's shared count, exactly
     `scale_by_lazy_adam`'s semantics.

The JAX package's pytree surgery (`prune_tables`, `merge_tables`,
`split_/merge_lazy_opt_state`) is plain dict selection here: the trainer's
parameters and Adam moments are name → tensor dicts, and the tables'
moments are the optimizer state's own tensors, updated in place.

Training-time invariant: ids handed to the reduced lookup are < vocab
(OOV simulation flags ride separate `_oov` columns).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from oovrec_tpu_torch.ops.sparse_rows import (
    B1,
    B2,
    EPS,
    sparse_adam_rows_kernel,
    sparse_adam_rows_plain,
)

IMPLS = ("auto", "pallas", "xla", "dense")


class SparseTableState(NamedTuple):
    """A table's Adam moments: views of the optimizer state's tensors."""

    mu: torch.Tensor  # (V, D) float32
    nu: torch.Tensor  # (V, D) float32


def init_sparse_state(table: torch.Tensor) -> SparseTableState:
    return SparseTableState(torch.zeros_like(table), torch.zeros_like(table))


def coalesce_rows(ids: torch.Tensor, rows: torch.Tensor):
    """Sort ids (stable) and sum duplicate rows. → (sid, gsum): `sid` sorted
    with duplicates kept (static shape), `gsum[i]` the full segment sum for
    sid[i], so every duplicate position carries the same row. The sum runs
    over each run in ascending position order (`torch.segment_reduce` with a
    length at the first position of each run and 0 elsewhere): no host
    sync, the same bits on every run."""
    sid, order = torch.sort(ids, stable=True)
    sg = rows[order]
    n = sid.shape[0]
    first = torch.searchsorted(sid, sid)
    last = torch.searchsorted(sid, sid, right=True)
    head = first == torch.arange(n, device=sid.device)
    lengths = torch.where(head, last - first, torch.zeros_like(first))
    sums = torch.segment_reduce(sg, "sum", lengths=lengths, unsafe=True)
    return sid, sums[first]


def sparse_adam_update_table(
    table: torch.Tensor,
    state: SparseTableState,
    ids: torch.Tensor,
    grows: torch.Tensor,
    count: int,
    lr: float,
    b1: float = B1,
    b2: float = B2,
    eps: float = EPS,
    impl: str = "pallas",
) -> Tuple[torch.Tensor, SparseTableState]:
    """One lazy-Adam step on the rows `ids` of `table` given their row
    gradients `grows` (duplicates allowed; they are coalesced). `count` is
    the optimizer's shared post-increment step number. Untouched rows keep
    their bits. `table` and the moments update in place.

    impl: 'pallas' is kernel 6 (`sparse_adam_rows_kernel`: the CUDA kernel
    on the card, its plain version on the CPU); 'xla' is the plain gather /
    where / write-back (`sparse_adam_rows_plain`) on any device."""
    sid, g = coalesce_rows(ids, grows)
    step = sparse_adam_rows_kernel if impl == "pallas" else sparse_adam_rows_plain
    with torch.no_grad():
        step(table, state.mu, state.nu, sid, g, count, lr, b1, b2, eps)
    return table, state


def gather_rows_for_batch(
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    table_map: Dict[str, Tuple[str, List[str]]],
):
    """Prepare a batch for the sparse fast path. `table_map` is the model's
    `sparse_table_fields()`: `{side: (module name, [id fields])}`, each
    module an embedding whose `<name>.weight` is indexed only by those
    fields.

    → (rows, new_batch, gathered):
      * rows[side]: the gathered (n, D) table rows of the side's id fields,
        concatenated, a leaf that requires grad;
      * new_batch: the batch with those fields remapped to row positions
        (the caller sets `_sparse_rows_<side>` to rows[side]), each field's
        first position as `_sparse_off_<field>` (its rows are one slice of
        rows[side], which the model reads without a gather) and the entity
        ids kept as `_sparse_ids_<field>`, which the embedders' feature
        lookups read (the JAX function drops them, so its lsh, dnn and fdhe
        look features up by row position);
      * gathered[side]: the ids aligned with rows, the scatter targets of
        `sparse_adam_update_table`.
    """
    new_batch = dict(batch)
    rows: Dict[str, torch.Tensor] = {}
    gathered: Dict[str, torch.Tensor] = {}
    for side, (name, fields) in table_map.items():
        table = params[name + ".weight"]
        ids = torch.cat([batch[f].reshape(-1).long() for f in fields])
        rows[side] = table.detach()[ids].requires_grad_()
        off = 0
        for f in fields:
            m = batch[f].numel()
            new_batch[f] = torch.arange(off, off + m, device=ids.device).reshape(batch[f].shape)
            new_batch["_sparse_ids_" + f] = batch[f]
            new_batch["_sparse_off_" + f] = off
            off += m
        gathered[side] = ids
    return rows, new_batch, gathered


def sparse_epoch_table_map(trainer, model, spec, frozen: bool):
    """Eligibility of the device epoch's sparse fast path: the model's table
    map, or None. It needs `learner: sparse_adam` with no weight decay,
    clipping or torch-faithful Adam (the rule must be exactly the lazy
    Adam), tables that are plain embeddings among the trainer's
    parameters, an embedder that never reads the whole table (not mean or
    knn) and an unfrozen pass (a frozen sub-epoch leaves the tables alone
    through the dense freeze)."""
    cfg, opt = trainer.config, trainer.optimizer
    if (
        opt.rule != "lazy_adam"
        or opt.weight_decay
        or opt.max_norm is not None
        or frozen
        or cfg["sparse_update_impl"] == "dense"
    ):
        return None
    m = sparse_table_map(model)
    if not m:
        return None
    if spec is not None and spec.active and spec.embedder in ("mean", "knn"):
        return None
    for _side, (name, _f) in m.items():
        if name + ".weight" not in trainer.params:
            return None
    return m


def resolve_sparse_impl(cfg) -> str:
    """`sparse_update_impl: auto|pallas|xla`: `auto` is kernel 6 ('pallas'),
    which on the card launches the CUDA kernel whatever the table sizes.
    (The JAX rule's 2.5M-row crossover measured the TPU's whole-operand
    scatter; the CUDA kernel touches only the batch's rows.) 'xla' is the
    plain write-back, taken only when the config names it."""
    impl = cfg["sparse_update_impl"] or "auto"
    if impl not in IMPLS:
        raise ValueError(f"sparse_update_impl must be one of {IMPLS}, not {impl!r}")
    return "xla" if impl == "xla" else "pallas"


def sparse_table_map(model) -> Dict[str, Tuple[str, List[str]]]:
    """The model's sparse-table declaration (empty: the model does not
    support the sparse fast path)."""
    fn = getattr(model, "sparse_table_fields", None)
    if fn is None:
        return {}
    return fn() if callable(fn) else dict(fn)

"""Row gathers whose backward sums each row's cotangents without
serialising on a repeated row, and the edge segment sum.

Port of `oovrec_tpu/ops/embed_grad.py:90` (`gather_rows`) and `:161`
(`packed_gather`): custom-gradient gathers `table[ids]` whose backward is
the scatter-add adjoint (the cotangents of one id summed into its row).
The same sum is the forward of `segment_sum`, the graph models' edge
propagation (`jax.ops.segment_sum` in the JAX package), whose backward is
the gather: one propagation layer launches the kernel twice a training
step, once for the segment sum and once for the gather of its messages.
The JAX module's one-hot matmul backward is a TPU workaround
(`_use_onehot` is false off the TPU, `:27-37`) and is not ported; nor is
its per-field split of the packed backward, which only chose between the
two TPU forms.

What the backward fixes on the card. torch's `table[ids]` backward
(`index_put_(accumulate=True)`, its `indexing_backward_kernel`) sorts the
ids and then adds the duplicates of one id one after another in one warp:
8,192 copies of one row take milliseconds. Branchless routing makes such
rows: every IV row gathers the placeholder bucket 0, and a small-vocabulary
token field repeats a few rows a whole batch long. Three things answer it:

  * a sort-and-segment sum: a stable sort of the ids, the sorted positions
    cut into fixed-size chunks whose run pieces are summed in order, the
    pieces of a run that crosses chunks added in chunk order; no float
    atomics, so the same bits on every run;
  * a plan (`SegmentPlan`, `build_plan`) for ids that never change, a
    graph's edges: the sort done once, so a call is the segment pass
    alone. A model holds its plans as non-persistent buffers
    (`IndexPlans`), rebuilt where its index buffers change;
  * `live`: rows that the caller's select throws away (the bucket row of
    an IV row, the clipped IV row of an OOV row in `inductive/routing.py`;
    the routed cells of `models/context.py`) carry an exactly-zero
    cotangent. They are skipped, so they add nothing and cost no sum. The
    gradient is the same.

The backward is `scatter_rows_kernel`: on a CUDA tensor the hand-written
kernel `csrc/embed_grad.cu` (with a plan its segment pass; without, a
one-block radix sort at n <= 16,384 or the device-wide sort above it, then
the pass), on a CPU tensor its plain version `scatter_rows_plain`,
PyTorch's sort-and-segment `embedding_dense_backward` with the discarded
rows sent to a padding row that it skips, with or without a plan.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from oovrec_tpu_torch.ops.launches import register
from oovrec_tpu_torch.utils.cuda_build import check, load_kernel

PLAN_CHUNK = 128   # sorted positions a group of the segment pass walks, with a plan
SMALL_CHUNK = 16   # ... at n <= SMALL_MAX without one (the one-block sort)
LARGE_CHUNK = 128  # ... above SMALL_MAX without one (the device-wide sort)
SMALL_MAX = 16384  # the most positions a call sorts in one block (`csrc/embed_grad.cu`)
SLICE_FLOATS = 512  # columns a group of the pass walks: a wider row takes ceil(D / this) slices


def scatter_rows_plain(g: torch.Tensor, ids: torch.Tensor, n_rows: int,
                       live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain version: `embedding_dense_backward` (stable sort,
    segment sums) with the rows where `live` is false sent to row n_rows,
    a padding row that it skips; the view drops it."""
    ids = ids.long()
    if live is None:
        return torch.ops.aten.embedding_dense_backward(g, ids, n_rows, -1, False)
    sent = torch.where(live, ids, n_rows)
    return torch.ops.aten.embedding_dense_backward(g, sent, n_rows + 1, n_rows,
                                                   False)[:n_rows]


def chunk_spans(sk: torch.Tensor, chunk: int, dead: int) -> torch.Tensor:
    """(n_chunks, 2) int32 of sorted keys `sk` cut into chunks of `chunk`:
    the first chunk of the run each chunk begins inside (-1 where it begins
    a run) and the last chunk of the run its last position goes on into
    (-1 where that run ends in it). Keys equal to `dead` make no run.
    `csrc/embed_grad.cu:chunk_span`, for every chunk at once."""
    n = sk.numel()
    s = torch.arange(0, n, chunk, device=sk.device)
    e = torch.clamp(s + chunk, max=n)
    kf, kl = sk[s], sk[e - 1]
    began = (kf != dead) & (s > 0) & (sk[torch.clamp(s - 1, min=0)] == kf)
    goes_on = (kl != dead) & (e < n) & (sk[torch.clamp(e, max=n - 1)] == kl)
    first = torch.searchsorted(sk, kf) // chunk
    last = (torch.searchsorted(sk, kl, right=True) - 1) // chunk
    return torch.stack([torch.where(began, first, -1),
                        torch.where(goes_on, last, -1)], dim=1).to(torch.int32)


class SegmentPlan:
    """The sort of a fixed index vector of n ids into n_rows rows, done
    once: one int32 tensor `packed` holding, in order, `perm` (n: the
    positions in stable order of their ids), `keys` (n: the sorted ids),
    `spans` (n_chunks x 2, 8-byte aligned for the kernel's int2 loads:
    `chunk_spans`, the split of heavy rows into chunks), `counters`
    (n_chunks, zero between calls: the segment pass's count of a crossing
    run's finished chunks) and `offsets` (n_rows + 1: where each row's
    positions begin)."""

    def __init__(self, packed: torch.Tensor, n: int, n_rows: int, chunk: int):
        self.packed, self.n, self.n_rows, self.chunk = packed, n, n_rows, chunk
        self.n_chunks = -(-n // chunk)

    @staticmethod
    def length(n: int, n_rows: int, chunk: int) -> int:
        return 2 * n + n_rows + 1 + 3 * -(-n // chunk)

    def _part(self, start: int, length: int) -> torch.Tensor:
        return self.packed[start:start + length]

    @property
    def perm(self) -> torch.Tensor:
        return self._part(0, self.n)

    @property
    def keys(self) -> torch.Tensor:
        return self._part(self.n, self.n)

    @property
    def spans(self) -> torch.Tensor:
        return self._part(2 * self.n, 2 * self.n_chunks).view(-1, 2)

    @property
    def counters(self) -> torch.Tensor:
        return self._part(2 * self.n + 2 * self.n_chunks, self.n_chunks)

    @property
    def offsets(self) -> torch.Tensor:
        return self._part(2 * self.n + 3 * self.n_chunks, self.n_rows + 1)

    def matches(self, ids: torch.Tensor) -> bool:
        """Whether this plan is the sort of `ids` (a host read): its sorted
        keys are `ids` taken in its order."""
        if ids.numel() != self.n or ids.device != self.packed.device:
            return False
        return bool(torch.equal(ids.reshape(-1)[self.perm.long()].to(torch.int32), self.keys))


def plan_packed_plain(ids: torch.Tensor, n_rows: int, chunk: Optional[int] = None
                      ) -> torch.Tensor:
    """The plan's integers from PyTorch's own operations (the CPU's build,
    and what the card's build is held against)."""
    chunk = chunk or PLAN_CHUNK
    keys = ids.reshape(-1).long()
    perm = torch.argsort(keys, stable=True)
    sk = keys[perm]
    offsets = torch.searchsorted(sk, torch.arange(n_rows + 1, device=keys.device))
    n_chunks = -(-keys.numel() // chunk)
    return torch.cat([perm, sk, chunk_spans(sk, chunk, n_rows).reshape(-1).long(),
                      torch.zeros(n_chunks, dtype=torch.long, device=keys.device), offsets]
                     ).to(torch.int32)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def build_plan(ids: torch.Tensor, n_rows: int, chunk: Optional[int] = None) -> SegmentPlan:
    """The plan of a fixed (n,) int32 or int64 index vector into n_rows
    rows, on the ids' device: on a CUDA tensor by the kernel's own sort
    (`build_plan.launches` counts the builds), on a CPU tensor by
    `plan_packed_plain`. Refused during a CUDA graph capture: a plan is
    built outside it, never quietly inside a replay."""
    if _capturing():
        raise RuntimeError("a segment plan cannot be built during a CUDA graph capture")
    chunk = chunk or PLAN_CHUNK
    ids = ids.reshape(-1)
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be int32 or int64, not {ids.dtype}")
    n = ids.numel()
    if n >= 2**31 or n_rows >= 2**31 - 1 or n_rows <= 0:
        raise ValueError(f"n={n} or {n_rows} rows outside the kernel's int32 range")
    if ids.device.type == "cpu" or n == 0:
        return SegmentPlan(plan_packed_plain(ids, n_rows, chunk), n, n_rows, chunk)
    lib = _kernel_library()
    plan = SegmentPlan(torch.empty(SegmentPlan.length(n, n_rows, chunk), dtype=torch.int32,
                                   device=ids.device), n, n_rows, chunk)
    ids = ids.contiguous()
    large = n > SMALL_MAX
    scratch = torch.empty(2 * n if large else 1, dtype=torch.int32, device=ids.device)
    temp_bytes = _sort_bytes(n) if large else 0
    temp = torch.empty(max(temp_bytes, 1), dtype=torch.uint8, device=ids.device)
    with torch.cuda.device(ids.device):
        err = lib.embed_grad_sort(
            ids.data_ptr(), ids.element_size(), None, n, n_rows, chunk, int(not large),
            scratch.data_ptr(), scratch.data_ptr() + 4 * n, plan.perm.data_ptr(),
            plan.keys.data_ptr(), plan.spans.data_ptr(), plan.counters.data_ptr(),
            plan.n_chunks, plan.offsets.data_ptr(), temp.data_ptr(), temp_bytes,
            torch.cuda.current_stream().cuda_stream)
    check(err, "embed_grad_sort")
    build_plan.launches += 1
    return plan


register(build_plan, "plan_tables")


def _check_arguments(g, ids, n_rows, live, plan):
    if g.dim() != 2 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous (n, D) float32 tensor, not {g.dtype} "
                         f"{tuple(g.shape)}")
    n = g.shape[0]
    if ids.shape != (n,) or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be (n,) int32 or int64, not {ids.dtype} {tuple(ids.shape)}")
    if live is not None and (live.shape != (n,) or live.dtype != torch.bool):
        raise ValueError(f"live must be (n,) bool, not {live.dtype} {tuple(live.shape)}")
    if plan is not None:
        if live is not None:
            raise ValueError("a call with a plan takes no live mask")
    for name, t in (("ids", ids), ("live", live),
                    ("plan", None if plan is None else plan.packed)):
        if t is not None and t.device != g.device:
            raise ValueError(f"{name} must lie on {g.device}, not {t.device}")
    if n >= 2**31 or n_rows >= 2**31 - 1:
        raise ValueError(f"n={n} or {n_rows} rows exceed the kernel's int32 range")


def scatter_rows_kernel(g: torch.Tensor, ids: torch.Tensor, n_rows: int,
                        live: Optional[torch.Tensor] = None,
                        plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """(n_rows, D) table gradient of the (n, D) cotangents `g` of the (n,)
    ids, the rows where `live` is false left out; `plan` (the ids' own,
    `build_plan`) skips the sort. CPU tensors take the plain version;
    CUDA tensors launch `csrc/embed_grad.cu` (`scatter_rows_kernel.
    launches` counts the launches of its segment pass) or raise."""
    if plan is not None and (plan.n != ids.numel() or plan.n_rows != n_rows):
        raise ValueError(f"a plan of {plan.n} ids into {plan.n_rows} rows for {ids.numel()} "
                         f"ids into {n_rows}")
    if g.device.type == "cpu":
        return scatter_rows_plain(g, ids, n_rows, live)
    _check_arguments(g, ids, n_rows, live, plan)
    n, d = g.shape
    if n == 0:
        return g.new_zeros((n_rows, d))
    if plan is None:
        return _sorted_call(g, ids, n_rows, live, n <= SMALL_MAX)
    out = g.new_empty((n_rows, d))
    parts = g.new_empty((2, plan.n_chunks, d))
    slices = -(-d // SLICE_FLOATS)  # the plan holds one slice's counters; others' are zeroed here
    counters = plan.counters if slices == 1 else torch.zeros(
        slices * plan.n_chunks, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        err = _kernel_library().embed_grad_pass(
            g.data_ptr(), n, d, n_rows, plan.chunk, plan.perm.data_ptr(),
            plan.keys.data_ptr(), plan.spans.data_ptr(), plan.offsets.data_ptr(),
            counters.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream)
    check(err, "embed_grad_pass")
    scatter_rows_kernel.launches += 1
    return out


register(scatter_rows_kernel, "segment_pass")


def _sorted_call(g: torch.Tensor, ids: torch.Tensor, n_rows: int,
                 live: Optional[torch.Tensor], small: bool) -> torch.Tensor:
    """`scatter_rows_kernel` without a plan on a CUDA tensor, on the route
    `small` names: the one-block sort (n <= the kernel's BLOCK_MAX) or the
    device-wide one (`chip_smoke.py` times both at the same n)."""
    n, d = g.shape
    stream = torch.cuda.current_stream(g.device).cuda_stream
    out = g.new_empty((n_rows, d))
    ids = ids.contiguous()
    live = None if live is None else live.contiguous()
    chunk = SMALL_CHUNK if small else LARGE_CHUNK
    n_chunks = -(-n // chunk)
    own = small and n_rows <= n  # the pass writes the empty rows too: no memset
    # keys_in, pos_in (the device-wide sort's input) | perm | sk | spans (8-byte aligned:
    # after 2n or 4n ints) | counters (one a chunk for each slice of D) | offsets
    lengths = (0 if small else n, 0 if small else n, n, n, 2 * n_chunks if small else 0,
               -(-d // SLICE_FLOATS) * n_chunks, n_rows + 1 if own else 0)
    ints = torch.empty(sum(lengths), dtype=torch.int32, device=g.device)
    ptrs, at = [], 0
    for length in lengths:
        ptrs.append(ints.data_ptr() + 4 * at if length else None)
        at += length
    temp_bytes = 0 if small else _sort_bytes(n)
    temp = torch.empty(max(temp_bytes, 1), dtype=torch.uint8, device=g.device)
    parts = g.new_empty((2, n_chunks, d))
    with torch.cuda.device(g.device):
        err = _kernel_library().embed_grad_backward(
            g.data_ptr(), ids.data_ptr(), ids.element_size(),
            None if live is None else live.data_ptr(), n, d, n_rows, chunk, int(small), *ptrs,
            temp.data_ptr(), temp_bytes, parts[0].data_ptr(), parts[1].data_ptr(),
            out.data_ptr(), stream)
    check(err, "embed_grad_backward")
    scatter_rows_kernel.launches += 1
    return out


def sort_arrays(ids: torch.Tensor, n_rows: int, live: Optional[torch.Tensor] = None,
                chunk: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The kernel's sort of a call on the card (no segment pass): `perm`,
    `keys`, and at n <= SMALL_MAX the one-block sort's `spans` and
    `offsets`; the discarded rows under key n_rows. For checks against
    `plan_packed_plain`; counts no launch."""
    n = ids.numel()
    if ids.device.type != "cuda" or not 0 < n <= SMALL_MAX:
        raise ValueError(f"the one-block sort takes 1..{SMALL_MAX} ids on the card, not {n} "
                         f"on {ids.device}")
    chunk = chunk or SMALL_CHUNK
    plan = SegmentPlan(torch.empty(SegmentPlan.length(n, n_rows, chunk), dtype=torch.int32,
                                   device=ids.device), n, n_rows, chunk)
    perm, keys, spans, counters, offsets = (plan.perm, plan.keys, plan.spans, plan.counters,
                                            plan.offsets)
    ids = ids.contiguous()
    with torch.cuda.device(ids.device):
        err = _kernel_library().embed_grad_sort(
            ids.data_ptr(), ids.element_size(), None if live is None else live.data_ptr(), n,
            n_rows, chunk, 1, None, None, perm.data_ptr(), keys.data_ptr(), spans.data_ptr(),
            counters.data_ptr(), plan.n_chunks, offsets.data_ptr(), None, 0,
            torch.cuda.current_stream().cuda_stream)
    check(err, "embed_grad_sort")
    return {"perm": perm, "keys": keys, "spans": spans, "offsets": offsets}


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library with its C signatures (once per process)."""
    lib = load_kernel("embed_grad")
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.embed_grad_block_max.argtypes = []
    lib.embed_grad_block_max.restype = i
    if lib.embed_grad_block_max() < SMALL_MAX:
        raise RuntimeError(f"csrc/embed_grad.cu sorts fewer than SMALL_MAX {SMALL_MAX} "
                           "positions in one block")
    lib.embed_grad_slice_floats.argtypes = []
    lib.embed_grad_slice_floats.restype = i
    if lib.embed_grad_slice_floats() != SLICE_FLOATS:
        raise RuntimeError(f"csrc/embed_grad.cu slices rows by another width than {SLICE_FLOATS}")
    lib.embed_grad_sort_bytes.argtypes = [i, ctypes.POINTER(sz)]
    lib.embed_grad_sort_bytes.restype = i
    lib.embed_grad_sort.argtypes = [p, i, p, i, i, i, i, p, p, p, p, p, p, i, p, p, sz, p]
    lib.embed_grad_sort.restype = i
    lib.embed_grad_pass.argtypes = [p, i, i, i, i, p, p, p, p, p, p, p, p, p]
    lib.embed_grad_pass.restype = i
    lib.embed_grad_backward.argtypes = [p, p, i, p, i, i, i, i, i, p, p, p, p, p, p, p, p,
                                        sz, p, p, p, p]
    lib.embed_grad_backward.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sort_bytes(n: int) -> int:
    """Bytes of device-wide radix-sort scratch for n pairs (a host-side
    query)."""
    out = ctypes.c_size_t(0)
    check(_kernel_library().embed_grad_sort_bytes(n, ctypes.byref(out)), "embed_grad_sort_bytes")
    return int(out.value)


def scatter_rows(g: torch.Tensor, ids: torch.Tensor, n_rows: int,
                 live: Optional[torch.Tensor] = None,
                 plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """The adjoint of `table[ids]`: (n, D) cotangents `g` of the (n,) ids
    summed into an (n_rows, D) table; the rows where `live` is false add
    nothing. `plan`: the ids' own."""
    return scatter_rows_kernel(g.contiguous(), ids, n_rows, live, plan)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, live, plan):
        ctx.n_rows = table.shape[0]
        ctx.plan = plan
        ctx.save_for_backward(ids, live)
        # advanced indexing gives a fresh tensor, not a view, so a caller
        # may write into the result in place
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        ids, live = ctx.saved_tensors
        g, ids = g.reshape(-1, g.shape[-1]), ids.reshape(-1)
        if ctx.plan is None:
            dtable = scatter_rows(g, ids, ctx.n_rows, None if live is None else live.reshape(-1))
        else:
            dtable = scatter_rows(g, ids, ctx.n_rows, plan=ctx.plan)
        return dtable, None, None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                live: Optional[torch.Tensor] = None,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """`table[ids]` (ids of any shape) whose backward sums the cotangents
    of each id by sort and segment. `live` (ids' shape, bool): false where
    the caller throws the row away, so its (zero) cotangent is skipped.
    `plan`: the plan of the fixed `ids` into `table`'s rows, so the
    backward does not sort them (no `live` with it)."""
    return _GatherRows.apply(table, ids, live, plan)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, dst, n_rows, plan):
        ctx.save_for_backward(dst)
        return scatter_rows(msg, dst, n_rows, plan=plan)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return g.index_select(0, dst), None, None, None


def segment_sum(msg: torch.Tensor, dst: torch.Tensor, n_rows: int,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """`jax.ops.segment_sum(msg, dst, num_segments=n_rows)` for (n, D)
    rows: each destination row is the sum of its messages, a row no
    message reaches is 0. The forward is `scatter_rows` (the sort-and-
    segment kernel on the card, no float atomics: the same bits on every
    run; with `plan`, the plan of the fixed `dst`, no sort), the backward
    the gather `g[dst]`."""
    return _SegmentSum.apply(msg, dst, n_rows, plan)


def packed_gather(table: torch.Tensor, ids: torch.Tensor, dims: Sequence[int],
                  offsets: Sequence[int], live: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """`table[ids]` for an offset-packed (B, F) id matrix over one table of
    Σ dims rows (`ids` already carry the offsets). The backward is
    `gather_rows`' over the whole matrix: a small-vocabulary field's
    repeated rows are summed by segment, not one after another."""
    if len(dims) != ids.shape[-1] or len(offsets) != ids.shape[-1]:
        raise ValueError(f"{ids.shape[-1]} id columns for {len(dims)} fields")
    if int(sum(dims)) != table.shape[0]:
        raise ValueError(f"table of {table.shape[0]} rows for fields of {sum(dims)}")
    return gather_rows(table, ids, live)


class IndexPlans:
    """A module's plans of its fixed index buffers (a mixin of
    `nn.Module`). `add_index_plan(name, n_rows)` plans the buffer `name`
    into n_rows rows; with `derive`, the ids are `derive(module)`, kept as
    the non-persistent buffer `name`, from the buffers `sources`. Each plan
    is the non-persistent buffer `<name>_plan`: `state_dict`, the bridge's
    state and every checkpoint keep their keys. `planned(name)` → (ids,
    plan). A plan follows its ids: after `load_state_dict`, `.to()` and
    `jax_params.set_embedder_state` (`refresh_index_plans`), and at
    `planned` where a source buffer was replaced or written in place, it
    is checked against the ids (a host read) and rebuilt, in place where
    its size holds, where they differ; during a CUDA graph capture that
    raises instead."""

    def add_index_plan(self, name: str, n_rows: int,
                       derive: Optional[Callable[["IndexPlans"], torch.Tensor]] = None,
                       sources: Tuple[str, ...] = ()) -> None:
        specs = self.__dict__.setdefault("_plan_specs", {})
        if not specs:
            self.register_load_state_dict_post_hook(
                lambda module, _incompatible: module.refresh_index_plans())
        specs[name] = (int(n_rows), derive, tuple(sources) if derive else (name,))
        self._refresh_plan(name, force=True)

    def planned(self, name: str) -> Tuple[torch.Tensor, SegmentPlan]:
        """The ids of `name` and their plan, fresh."""
        self._refresh_plan(name)
        n_rows = self._plan_specs[name][0]
        ids = getattr(self, name)
        return ids, SegmentPlan(getattr(self, f"{name}_plan"), ids.numel(), n_rows, PLAN_CHUNK)

    def refresh_index_plans(self) -> None:
        for name in self.__dict__.get("_plan_specs", {}):
            self._refresh_plan(name)

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        self.refresh_index_plans()
        return out

    def _plan_sources(self, name: str):
        return [getattr(self, s) for s in self._plan_specs[name][2]]

    def _refresh_plan(self, name: str, force: bool = False) -> None:
        marks: Dict[str, list] = self.__dict__.setdefault("_plan_marks", {})
        sources = self._plan_sources(name)
        mark = marks.get(name)
        if not force and mark is not None and all(
                ref() is t and t._version == version for t, (ref, version) in zip(sources, mark)):
            return
        if _capturing():
            raise RuntimeError(f"the index buffers of the plan {name!r} changed: it cannot be "
                               "rebuilt during a CUDA graph capture")
        n_rows, derive, _ = self._plan_specs[name]
        if derive is not None:
            ids = derive(self).contiguous()
            old = self._buffers.get(name)
            if (old is not None and old.shape == ids.shape and old.dtype == ids.dtype
                    and old.device == ids.device):
                old.copy_(ids)
            else:
                self.register_buffer(name, ids, persistent=False)
        ids = getattr(self, name)
        key = f"{name}_plan"
        old = self._buffers.get(key)
        if (old is None or old.numel() != SegmentPlan.length(ids.numel(), n_rows, PLAN_CHUNK)
                or not SegmentPlan(old, ids.numel(), n_rows, PLAN_CHUNK).matches(ids)):
            packed = build_plan(ids, n_rows).packed
            if old is not None and old.shape == packed.shape and old.device == packed.device:
                old.copy_(packed)  # a captured graph keeps reading this buffer
            else:
                self.register_buffer(key, packed, persistent=False)
        marks[name] = [(weakref.ref(t), t._version) for t in self._plan_sources(name)]

"""Row gathers whose backward sums each row's cotangents without
serialising on a repeated row.

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
token field repeats a few rows a whole batch long. Two things answer it:

  * a sort-and-segment sum: a stable sort of the ids, the sorted positions
    cut into fixed-size chunks whose run pieces are summed in order, the
    pieces of a run that crosses chunks added in chunk order; no atomics,
    so the same bits on every run;
  * `live`: rows that the caller's select throws away (the bucket row of
    an IV row, the clipped IV row of an OOV row in `inductive/routing.py`;
    the routed cells of `models/context.py`) carry an exactly-zero
    cotangent. They are skipped, so they add nothing and cost no sum. The
    gradient is the same.

The backward is `scatter_rows_kernel`: on a CUDA tensor the hand-written
kernel `csrc/embed_grad.cu` (a radix sort over the bits the table needs,
then chunked segment sums), on a CPU tensor its plain version
`scatter_rows_plain`, PyTorch's sort-and-segment `embedding_dense_backward`
with the discarded rows sent to a padding row that it skips.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from oovrec_tpu_torch.ops.launches import register
from oovrec_tpu_torch.utils.cuda_build import check, load_kernel

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


def scatter_rows_kernel(g: torch.Tensor, ids: torch.Tensor, n_rows: int,
                        live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_rows, D) table gradient of the (n, D) cotangents `g` of the (n,)
    ids, the rows where `live` is false left out. CPU tensors take the
    plain version; CUDA tensors launch `csrc/embed_grad.cu`
    (`scatter_rows_kernel.launches` counts the launches) or raise."""
    if g.device.type == "cpu":
        return scatter_rows_plain(g, ids, n_rows, live)
    if g.dim() != 2 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous (n, D) float32 tensor, not {g.dtype} "
                         f"{tuple(g.shape)}")
    n, d = g.shape
    if ids.shape != (n,) or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be (n,) int32 or int64, not {ids.dtype} {tuple(ids.shape)}")
    if live is not None and (live.shape != (n,) or live.dtype != torch.bool):
        raise ValueError(f"live must be (n,) bool, not {live.dtype} {tuple(live.shape)}")
    for name, t in (("ids", ids), ("live", live)):
        if t is not None and t.device != g.device:
            raise ValueError(f"{name} must lie on {g.device}, not {t.device}")
    if n >= 2**31 or n_rows >= 2**31 - 1:
        raise ValueError(f"n={n} or {n_rows} rows exceed the kernel's int32 range")
    lib, chunk = _kernel_library()
    ids = ids.contiguous()
    live = None if live is None else live.contiguous()
    out = g.new_empty((n_rows, d))
    n_chunks = -(-n // chunk)
    keys = torch.empty(2 * n, dtype=torch.int32, device=g.device)
    pos = torch.empty(2 * n, dtype=torch.int32, device=g.device)
    head = g.new_empty((n_chunks, d))
    tail = g.new_empty((n_chunks, d))
    temp_bytes = _sort_bytes(n)
    temp = torch.empty(max(temp_bytes, 1), dtype=torch.uint8, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.embed_grad_backward(
            g.data_ptr(), ids.data_ptr(), ids.element_size(),
            None if live is None else live.data_ptr(), n, d, n_rows, out.data_ptr(),
            keys.data_ptr(), pos.data_ptr(), head.data_ptr(), tail.data_ptr(),
            temp.data_ptr(), temp_bytes, stream)
    check(err, "embed_grad_backward")
    scatter_rows_kernel.launches += 1
    return out


register(scatter_rows_kernel, "segment_runs")


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library with its C signatures and its chunk length
    (once per process)."""
    lib = load_kernel("embed_grad")
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.embed_grad_chunk.argtypes = []
    lib.embed_grad_chunk.restype = i
    lib.embed_grad_sort_bytes.argtypes = [i, ctypes.POINTER(sz)]
    lib.embed_grad_sort_bytes.restype = i
    lib.embed_grad_backward.argtypes = [p, p, i, p, i, i, i, p, p, p, p, p, p, sz, p]
    lib.embed_grad_backward.restype = i
    return lib, int(lib.embed_grad_chunk())


@functools.lru_cache(maxsize=None)
def _sort_bytes(n: int) -> int:
    """Bytes of radix-sort scratch for n pairs (a host-side query)."""
    lib, _ = _kernel_library()
    out = ctypes.c_size_t(0)
    check(lib.embed_grad_sort_bytes(n, ctypes.byref(out)), "embed_grad_sort_bytes")
    return int(out.value)


def scatter_rows(g: torch.Tensor, ids: torch.Tensor, n_rows: int,
                 live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The adjoint of `table[ids]`: (n, D) cotangents `g` of the (n,) ids
    summed into an (n_rows, D) table; the rows where `live` is false add
    nothing."""
    return scatter_rows_kernel(g.contiguous(), ids, n_rows, live)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, live):
        ctx.n_rows = table.shape[0]
        ctx.save_for_backward(ids, live)
        # advanced indexing gives a fresh tensor, not a view, so a caller
        # may write into the result in place
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        ids, live = ctx.saved_tensors
        d = g.shape[-1]
        dtable = scatter_rows(g.reshape(-1, d), ids.reshape(-1), ctx.n_rows,
                              None if live is None else live.reshape(-1))
        return dtable, None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`table[ids]` (ids of any shape) whose backward sums the cotangents
    of each id by sort and segment. `live` (ids' shape, bool): false where
    the caller throws the row away, so its (zero) cotangent is skipped."""
    return _GatherRows.apply(table, ids, live)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, dst, n_rows):
        ctx.save_for_backward(dst)
        return scatter_rows(msg, dst, n_rows)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return g.index_select(0, dst), None, None


def segment_sum(msg: torch.Tensor, dst: torch.Tensor, n_rows: int) -> torch.Tensor:
    """`jax.ops.segment_sum(msg, dst, num_segments=n_rows)` for (n, D)
    rows: each destination row is the sum of its messages, a row no
    message reaches is 0. The forward is `scatter_rows` (the sort-and-
    segment kernel on the card, no atomics: the same bits on every run),
    the backward the gather `g[dst]`."""
    return _SegmentSum.apply(msg, dst, n_rows)


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

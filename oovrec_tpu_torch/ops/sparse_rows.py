"""Row-sparse lazy Adam: an in-place step on the touched rows of a table.

Port of `oovrec_tpu/ops/sparse_rows.py` (kernel 6). Given the sorted row
ids `ids` (n,) of a (V, D) table and their coalesced gradient rows `g`
(n, D) — every duplicate id carries the same full row sum
(`train/sparse_update.py:coalesce_rows`) — each distinct row whose
gradient is not all zeros takes one lazy-Adam step:

    m' = b1·m + (1-b1)·g,   v' = b2·v + (1-b2)·g·g
    p' = p - lr · (m'/bc0) / (sqrt(v'/bc1) + eps)

with bc = [1 - b1^c, 1 - b2^c] from the shared post-increment count c.
Rows that are not touched keep their values and moments. p, mu and nu
are updated in place and returned (the JAX kernel aliases them as outputs
of a donated call).

On a CUDA tensor `sparse_adam_rows_kernel` launches the hand-written
kernel in `csrc/sparse_rows.cu` (one warp per position, duplicates skip
themselves, no atomics, no padding); on a CPU tensor it runs
`sparse_adam_rows_plain`, the gather / where / write-back of
`sparse_update.py:114-132`: the same function, the kernel's reference in
`chip_smoke.py`. Both take the bias corrections as two f32 values computed
on the host and the hyper-parameters as the f32 values torch's scalar
operations use, and the kernel rounds every operation as the plain
version does, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from oovrec_tpu_torch.ops.launches import register
from oovrec_tpu_torch.utils.cuda_build import check, load_kernel

B1, B2, EPS = 0.9, 0.999, 1e-8


def bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32, as optax computes it, held as a Python
    float (no device transfer)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _check_inputs(p, mu, nu, ids, g):
    if p.dim() != 2 or mu.shape != p.shape or nu.shape != p.shape:
        raise ValueError(
            f"p {tuple(p.shape)}, mu {tuple(mu.shape)}, nu {tuple(nu.shape)} "
            "must be one (V, D) shape"
        )
    if ids.dim() != 1 or g.dim() != 2 or g.shape != (ids.shape[0], p.shape[1]):
        raise ValueError(
            f"ids {tuple(ids.shape)} and g {tuple(g.shape)} must be (n,) and "
            f"(n, {p.shape[1]})"
        )
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, not {ids.dtype}")
    for name, t in (("p", p), ("mu", mu), ("nu", nu), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")


def sparse_adam_rows_plain(p, mu, nu, ids, g, count: int, lr: float,
                           b1: float = B1, b2: float = B2, eps: float = EPS):
    """Gather, lazy-Adam step, write back; same contract as the kernel.
    The bias corrections divide as 0-dim tensors on the tables' device:
    a CUDA division by a Python scalar multiplies by its reciprocal, which
    the kernel's true division would not match."""
    _check_inputs(p, mu, nu, ids, g)
    ids = ids.long()
    bc0 = g.new_full((), bias_correction(b1, count))
    bc1 = g.new_full((), bias_correction(b2, count))
    touched = (g != 0).any(dim=1, keepdim=True)
    m_r, v_r, p_r = mu[ids], nu[ids], p[ids]
    new_m = torch.where(touched, b1 * m_r + (1 - b1) * g, m_r)
    new_v = torch.where(touched, b2 * v_r + (1 - b2) * g * g, v_r)
    step = torch.where(touched, (new_m / bc0) / (torch.sqrt(new_v / bc1) + eps), 0.0)
    # duplicate ids write identical rows: the order of the writes is moot
    p.index_copy_(0, ids, p_r - lr * step)
    mu.index_copy_(0, ids, new_m)
    nu.index_copy_(0, ids, new_v)
    return p, mu, nu


def sparse_adam_rows_kernel(p, mu, nu, ids, g, count: int, lr: float,
                            b1: float = B1, b2: float = B2, eps: float = EPS):
    """(p, mu, nu) updated in place at the sorted `ids` from the coalesced
    row gradients `g`; `count` is the shared post-increment step count.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`sparse_adam_rows_kernel.launches` counts the launches) or raise.
    Unsorted ids raise on the CPU; on the card the kernel checks them
    itself and traps (a device fault, like a failed device-side assert),
    so the check reads nothing back and costs no launch.
    """
    if p.device.type == "cpu":
        if ids.numel() > 1 and not bool((ids[1:] >= ids[:-1]).all()):
            raise ValueError("ids must be sorted ascending")
        return sparse_adam_rows_plain(p, mu, nu, ids, g, count, lr, b1, b2, eps)
    _check_inputs(p, mu, nu, ids, g)
    for name, t in (("p", p), ("mu", mu), ("nu", nu), ("ids", ids), ("g", g)):
        if t.device != p.device:
            raise ValueError(f"{name} must lie on {p.device}, not {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = g.shape
    if p.numel() >= 2**31 or n >= 2**31:
        raise ValueError(f"table {tuple(p.shape)} or n={n} exceeds the kernel's int32 range")
    lib = _kernel_library()
    f = ctypes.c_float
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sparse_adam_rows_launch(
            p.data_ptr(), mu.data_ptr(), nu.data_ptr(), ids.data_ptr(),
            ids.element_size(), g.data_ptr(), n, d,
            f(lr), f(b1), f(1 - b1), f(b2), f(1 - b2), f(eps),
            f(bias_correction(b1, count)), f(bias_correction(b2, count)), stream,
        )
    check(err, "sparse_adam_rows_launch")
    sparse_adam_rows_kernel.launches += 1
    return p, mu, nu


register(sparse_adam_rows_kernel, "sparse_adam_rows_kernel")


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library with its C signature (once per process)."""
    lib = load_kernel("sparse_rows")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sparse_adam_rows_launch.argtypes = [p, p, p, p, i, p, i, i] + [f] * 8 + [p]
    lib.sparse_adam_rows_launch.restype = ctypes.c_int
    return lib

"""Fused CIN layer (xDeepFM), forward.

Port of `oovrec_tpu/ops/cin_fused.py`. One CIN layer computes, per batch
row b and embedding lane d,

    conv[b, l, d] = relu( Σ_{h,f} A[b,h,d]·B0[b,f,d]·W[h·F+f, l] + bias[l] )

(pairwise Hadamard feature maps and a 1×1 conv over the pair axis). On a
CUDA tensor the wrappers launch the hand-written kernel in
`csrc/cin_fused.cu`, which forms the Hadamard slab in shared memory and
never writes it to device memory. On a CPU tensor they run the plain
versions, which materialise the slab: the same function, the kernel's
reference in `chip_smoke.py`.

Layout: batch-major, row-major. A (B, H, D), B0 (B, F, D), hidden
(B, nh, D), pooled (B, L - ps): the model's (B, F, D) embeddings go in as
they are and each layer's `hidden` is the next layer's A. (The JAX
kernels ride a batch-minor (H, D, B) layout, a TPU lane choice.) I/O is
f32 in both precision modes; `mxu_dtype` bf16 rounds A, B0 and W to bf16,
then each product A·B0 to bf16, and accumulates in f32.

Forward only: the backward kernels come with xDeepFM training.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from oovrec_tpu_torch.utils.cuda_build import check, load_kernel


def _is_bf16(mxu_dtype) -> bool:
    if mxu_dtype in (torch.bfloat16, "bfloat16", "bf16"):
        return True
    if mxu_dtype in (torch.float32, "float32", None):
        return False
    raise ValueError(f"mxu_dtype must be float32 or bfloat16, not {mxu_dtype}")


def _shapes(a, b0, w, bias):
    if a.dim() != 3 or b0.dim() != 3 or w.dim() != 2 or bias.dim() != 1:
        raise ValueError(
            f"a {tuple(a.shape)}, b0 {tuple(b0.shape)}, w {tuple(w.shape)}, "
            f"bias {tuple(bias.shape)} must be (B,H,D), (B,F,D), (H·F,L), (L,)"
        )
    B, H, D = a.shape
    F = b0.shape[1]
    L = w.shape[1]
    if b0.shape[0] != B or b0.shape[2] != D or w.shape[0] != H * F or bias.shape[0] != L:
        raise ValueError(
            f"a {tuple(a.shape)}, b0 {tuple(b0.shape)}, w {tuple(w.shape)}, "
            f"bias {tuple(bias.shape)} do not agree"
        )
    return B, H, F, D, L


def _pool_start(L: int, n_hidden: int, pool_all: bool) -> int:
    if not 0 <= n_hidden <= L:
        raise ValueError(f"n_hidden={n_hidden} outside [0, {L}]")
    return 0 if pool_all else n_hidden


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def cin_layer_plain(a, b0, w, bias, mxu_dtype="float32") -> torch.Tensor:
    """Plain version of `cin_layer`: relu(conv) (B, L, D) f32 through the
    materialised Hadamard slab (the math of `cin_layer_reference`,
    operands rounded as the kernel rounds them)."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    a, b0, w = a.float(), b0.float(), w.float()
    if _is_bf16(mxu_dtype):
        a, b0, w = _round_bf16(a), _round_bf16(b0), _round_bf16(w)
        z = _round_bf16(a[:, :, None, :] * b0[:, None, :, :])
    else:
        z = a[:, :, None, :] * b0[:, None, :, :]
    z = z.reshape(B, H * F, D)
    o = torch.einsum("bkd,kl->bld", z, w)
    return torch.relu(o + bias.float()[None, :, None])


def cin_layer_pooled_plain(a, b0, w, bias, mxu_dtype="float32",
                           n_hidden: int = 0, pool_all: bool = False):
    """Plain version of `cin_layer_pooled`: slab, slice, sum over D."""
    L = w.shape[1]
    ps = _pool_start(L, n_hidden, pool_all)
    o = cin_layer_plain(a, b0, w, bias, mxu_dtype)
    hidden = o[:, :n_hidden].contiguous() if n_hidden else None
    return hidden, o[:, ps:].sum(dim=2)


def _launch(a, b0, w, bias, mxu_dtype, n_hidden, ps):
    """Kernel launch for CUDA tensors: checks, allocates, launches or raises."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    for name, t in (("a", a), ("b0", b0), ("w", w), ("bias", bias)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must lie on {a.device}, not {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _kernel_library()
    if D > lib.cin_fused_max_depth():
        raise ValueError(f"D={D} exceeds the kernel's row tile ({lib.cin_fused_max_depth()})")
    bf16 = _is_bf16(mxu_dtype)
    hidden = torch.empty((B, n_hidden, D), dtype=torch.float32, device=a.device)
    pooled = torch.empty((B, L - ps), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cin_fused_launch(
            a.data_ptr(), b0.data_ptr(), w.data_ptr(), bias.data_ptr(),
            B, H, F, D, L, n_hidden, ps, int(bf16),
            hidden.data_ptr() if n_hidden else None,
            pooled.data_ptr() if L > ps else None,
            stream,
        )
    check(err, "cin_fused_launch")
    return hidden, pooled


def cin_layer_pooled(a, b0, w, bias, mxu_dtype="float32",
                     n_hidden: int = 0, pool_all: bool = False):
    """One CIN layer, split-free → `(hidden, pooled)`.

    a (B, H, D), b0 (B, F, D), w (H·F, L), bias (L,) f32.
    hidden = relu(conv)[:, :n_hidden] (B, n_hidden, D), the next layer's
    input (`None` when n_hidden == 0); pooled = Σ_D relu(conv)[:, ps:]
    (B, L - ps) with ps = 0 if pool_all else n_hidden: the sum-pooled
    direct-connect rows the model feeds `cin_linear`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`cin_layer_pooled.launches` counts the launches) or raise.
    """
    if a.device.type == "cpu":
        return cin_layer_pooled_plain(a, b0, w, bias, mxu_dtype, n_hidden, pool_all)
    ps = _pool_start(w.shape[1], n_hidden, pool_all)
    hidden, pooled = _launch(a, b0, w, bias, mxu_dtype, n_hidden, ps)
    cin_layer_pooled.launches += 1
    return (hidden if n_hidden else None), pooled


cin_layer_pooled.launches = 0


def cin_layer(a, b0, w, bias, mxu_dtype="float32") -> torch.Tensor:
    """relu(conv) (B, L, D) for one CIN layer: `cin_layer_pooled` with every
    row hidden and none pooled. CPU tensors take the plain version; CUDA
    tensors launch the kernel (`cin_layer.launches`) or raise."""
    if a.device.type == "cpu":
        return cin_layer_plain(a, b0, w, bias, mxu_dtype)
    L = w.shape[1]
    hidden, _ = _launch(a, b0, w, bias, mxu_dtype, L, L)
    cin_layer.launches += 1
    return hidden


cin_layer.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library with its C signatures (once per process)."""
    lib = load_kernel("cin_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cin_fused_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p, p, p]
    lib.cin_fused_launch.restype = ctypes.c_int
    lib.cin_fused_max_depth.argtypes = []
    lib.cin_fused_max_depth.restype = ctypes.c_int
    return lib

"""Fused CIN layer (xDeepFM), forward and backward.

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

Backward: `cin_layer_pooled` and `cin_layer` are `torch.autograd.Function`s
whose backward is a second hand-written kernel (`csrc/cin_fused_bwd.cu`,
wrappers `cin_layer_pooled_bwd` / `cin_layer_bwd`, plain versions
`cin_layer_pooled_bwd_plain` / `cin_layer_bwd_plain`): it recomputes the
pre-activation, masks the incoming gradient by `pre > 0` (0 at pre == 0)
and returns dA, dB0, dW and dbias, the VJP of the JAX package's custom
VJPs (`cin_fused.py:193-212, 435-460`). Under bf16 the gradient of the
pre-activation is rounded to bf16 before the dW and dz products; dbias
sums it unrounded. An output whose gradient is `None` (an unused hidden)
counts as zero, as the JAX backward's zero fill does.
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


def cin_layer_pooled_bwd_plain(a, b0, w, bias, gh, gp, mxu_dtype="float32",
                               n_hidden: int = 0, pool_all: bool = False):
    """Plain version of `cin_layer_pooled_bwd`: the VJP formulas on the
    materialised slab. gh (B, n_hidden, D) and gp (B, L - ps) may be None
    (a zero gradient). → (da (B,H,D), db0 (B,F,D), dw (H·F,L), dbias (L,))."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    ps = _pool_start(L, n_hidden, pool_all)
    bf16 = _is_bf16(mxu_dtype)
    a, b0, w = a.float(), b0.float(), w.float()
    if bf16:
        a, b0, w = _round_bf16(a), _round_bf16(b0), _round_bf16(w)
        z = _round_bf16(a[:, :, None, :] * b0[:, None, :, :])
    else:
        z = a[:, :, None, :] * b0[:, None, :, :]
    z = z.reshape(B, H * F, D)
    pre = torch.einsum("bkd,kl->bld", z, w) + bias.float()[None, :, None]
    g = torch.zeros_like(pre)
    if n_hidden and gh is not None:
        g[:, :n_hidden] = gh.float()
    if L > ps and gp is not None:
        g[:, ps:] += gp.float()[:, :, None]
    dpre = torch.where(pre > 0, g, torch.zeros_like(g))
    dr = _round_bf16(dpre) if bf16 else dpre
    dw = torch.einsum("bkd,bld->kl", z, dr)
    dbias = dpre.sum(dim=(0, 2))
    dz = torch.einsum("kl,bld->bkd", w, dr).reshape(B, H, F, D)
    da = (dz * b0[:, None, :, :]).sum(dim=2)
    db0 = (dz * a[:, :, None, :]).sum(dim=1)
    return da, db0, dw, dbias


def cin_layer_bwd_plain(a, b0, w, bias, g, mxu_dtype="float32"):
    """Plain version of `cin_layer_bwd`: `cin_layer_pooled_bwd_plain` with
    every row hidden and none pooled."""
    L = w.shape[1]
    return cin_layer_pooled_bwd_plain(a, b0, w, bias, g, None, mxu_dtype, L, False)


def _check_cuda(a, named):
    for name, t in named:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must lie on {a.device}, not {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(a, b0, w, bias, mxu_dtype, n_hidden, ps):
    """Forward kernel launch for CUDA tensors: checks, allocates, launches
    or raises."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    _check_cuda(a, (("a", a), ("b0", b0), ("w", w), ("bias", bias)))
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


def _launch_bwd(a, b0, w, bias, gh, gp, mxu_dtype, n_hidden, ps):
    """Backward kernel launch for CUDA tensors: checks, allocates the
    outputs and the workspace, launches or raises."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    _check_cuda(a, (("a", a), ("b0", b0), ("w", w), ("bias", bias),
                    ("gh", gh), ("gp", gp)))
    if gh is not None and tuple(gh.shape) != (B, n_hidden, D):
        raise ValueError(f"gh {tuple(gh.shape)} must be {(B, n_hidden, D)}")
    if gp is not None and tuple(gp.shape) != (B, L - ps):
        raise ValueError(f"gp {tuple(gp.shape)} must be {(B, L - ps)}")
    lib = _bwd_library()
    if D > lib.cin_bwd_max_depth():
        raise ValueError(f"D={D} exceeds the kernel's row tile ({lib.cin_bwd_max_depth()})")
    if lib.cin_bwd_smem_bytes(H, F, L) > lib.cin_bwd_max_smem():
        raise ValueError(f"H={H}, F={F}, L={L}: the dA/dB0 tiles exceed shared memory")
    bf16 = _is_bf16(mxu_dtype)
    dev = a.device
    da = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    db0 = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    dw = torch.empty((H * F, L), dtype=torch.float32, device=dev)
    dbias = torch.empty((L,), dtype=torch.float32, device=dev)
    work = torch.empty((lib.cin_bwd_workspace_floats(B, H, F, D, L),),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cin_bwd_launch(
            a.data_ptr(), b0.data_ptr(), w.data_ptr(), bias.data_ptr(),
            gh.data_ptr() if gh is not None and n_hidden else None,
            gp.data_ptr() if gp is not None and L > ps else None,
            B, H, F, D, L, n_hidden, ps, int(bf16),
            da.data_ptr(), db0.data_ptr(), dw.data_ptr(), dbias.data_ptr(),
            work.data_ptr(), stream,
        )
    check(err, "cin_bwd_launch")
    return da, db0, dw, dbias


def _pooled_forward(a, b0, w, bias, mxu_dtype, n_hidden, pool_all):
    """CPU: the plain version; CUDA: the kernel, counted on
    `cin_layer_pooled.launches`."""
    if a.device.type == "cpu":
        return cin_layer_pooled_plain(a, b0, w, bias, mxu_dtype, n_hidden, pool_all)
    ps = _pool_start(w.shape[1], n_hidden, pool_all)
    hidden, pooled = _launch(a, b0, w, bias, mxu_dtype, n_hidden, ps)
    cin_layer_pooled.launches += 1
    return (hidden if n_hidden else None), pooled


def cin_layer_pooled_bwd(a, b0, w, bias, gh, gp, mxu_dtype="float32",
                         n_hidden: int = 0, pool_all: bool = False):
    """VJP of `cin_layer_pooled` → (da, db0, dw, dbias), all f32.

    gh (B, n_hidden, D) is the gradient of `hidden`, gp (B, L - ps) that of
    `pooled`; either may be None (zero). CPU tensors take the plain
    version; CUDA tensors launch the backward kernel
    (`cin_layer_pooled_bwd.launches` counts the launches) or raise.
    """
    if a.device.type == "cpu":
        return cin_layer_pooled_bwd_plain(a, b0, w, bias, gh, gp, mxu_dtype,
                                          n_hidden, pool_all)
    ps = _pool_start(w.shape[1], n_hidden, pool_all)
    out = _launch_bwd(a, b0, w, bias, gh, gp, mxu_dtype, n_hidden, ps)
    cin_layer_pooled_bwd.launches += 1
    return out


cin_layer_pooled_bwd.launches = 0


def cin_layer_bwd(a, b0, w, bias, g, mxu_dtype="float32"):
    """VJP of `cin_layer` → (da, db0, dw, dbias): the backward kernel with
    every row hidden and none pooled. CPU tensors take the plain version;
    CUDA tensors launch the kernel (`cin_layer_bwd.launches`) or raise."""
    if a.device.type == "cpu":
        return cin_layer_bwd_plain(a, b0, w, bias, g, mxu_dtype)
    L = w.shape[1]
    out = _launch_bwd(a, b0, w, bias, g, None, mxu_dtype, L, L)
    cin_layer_bwd.launches += 1
    return out


cin_layer_bwd.launches = 0


def _contiguous(t):
    return None if t is None else t.float().contiguous()


class _CinPooled(torch.autograd.Function):
    """`cin_layer_pooled` with the backward kernel as its gradient. Both
    outputs are tensors ((B, 0, D) when n_hidden == 0) and gradients are
    not materialised, so an unused output's gradient arrives as None."""

    @staticmethod
    def forward(ctx, a, b0, w, bias, mxu_dtype, n_hidden, pool_all):
        hidden, pooled = _pooled_forward(a, b0, w, bias, mxu_dtype, n_hidden, pool_all)
        if hidden is None:
            hidden = a.new_empty((a.shape[0], 0, a.shape[2]))
        ctx.save_for_backward(a, b0, w, bias)
        ctx.cfg = (mxu_dtype, n_hidden, pool_all)
        ctx.set_materialize_grads(False)
        return hidden, pooled

    @staticmethod
    def backward(ctx, gh, gp):
        mxu_dtype, n_hidden, pool_all = ctx.cfg
        if gh is None and gp is None:
            return (None,) * 7
        a, b0, w, bias = ctx.saved_tensors
        da, db0, dw, dbias = cin_layer_pooled_bwd(
            a, b0, w, bias, _contiguous(gh) if n_hidden else None,
            _contiguous(gp), mxu_dtype, n_hidden, pool_all)
        return da, db0, dw, dbias, None, None, None


class _CinLayer(torch.autograd.Function):
    """`cin_layer` with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, a, b0, w, bias, mxu_dtype):
        if a.device.type == "cpu":
            out = cin_layer_plain(a, b0, w, bias, mxu_dtype)
        else:
            L = w.shape[1]
            out, _ = _launch(a, b0, w, bias, mxu_dtype, L, L)
            cin_layer.launches += 1
        ctx.save_for_backward(a, b0, w, bias)
        ctx.mxu_dtype = mxu_dtype
        return out

    @staticmethod
    def backward(ctx, g):
        a, b0, w, bias = ctx.saved_tensors
        da, db0, dw, dbias = cin_layer_bwd(a, b0, w, bias, g.float().contiguous(),
                                           ctx.mxu_dtype)
        return da, db0, dw, dbias, None


def cin_layer_pooled(a, b0, w, bias, mxu_dtype="float32",
                     n_hidden: int = 0, pool_all: bool = False):
    """One CIN layer, split-free → `(hidden, pooled)`.

    a (B, H, D), b0 (B, F, D), w (H·F, L), bias (L,) f32.
    hidden = relu(conv)[:, :n_hidden] (B, n_hidden, D), the next layer's
    input (`None` when n_hidden == 0); pooled = Σ_D relu(conv)[:, ps:]
    (B, L - ps) with ps = 0 if pool_all else n_hidden: the sum-pooled
    direct-connect rows the model feeds `cin_linear`. Differentiable: the
    gradient is `cin_layer_pooled_bwd`.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (`cin_layer_pooled.launches` counts the forward launches) or raise.
    """
    hidden, pooled = _CinPooled.apply(a, b0, w, bias, mxu_dtype, int(n_hidden),
                                      bool(pool_all))
    return (hidden if n_hidden else None), pooled


cin_layer_pooled.launches = 0


def cin_layer(a, b0, w, bias, mxu_dtype="float32") -> torch.Tensor:
    """relu(conv) (B, L, D) for one CIN layer: `cin_layer_pooled` with every
    row hidden and none pooled. Differentiable through `cin_layer_bwd`. CPU
    tensors take the plain versions; CUDA tensors launch the kernels
    (`cin_layer.launches` counts the forward launches) or raise."""
    return _CinLayer.apply(a, b0, w, bias, mxu_dtype)


cin_layer.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built forward kernel library with its C signatures (once per
    process)."""
    lib = load_kernel("cin_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cin_fused_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p, p, p]
    lib.cin_fused_launch.restype = ctypes.c_int
    lib.cin_fused_max_depth.argtypes = []
    lib.cin_fused_max_depth.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    """The built backward kernel library with its C signatures."""
    lib = load_kernel("cin_fused_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cin_bwd_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                   p, p, p, p, p, p]
    lib.cin_bwd_launch.restype = ctypes.c_int
    lib.cin_bwd_max_depth.argtypes = []
    lib.cin_bwd_max_depth.restype = i
    lib.cin_bwd_smem_bytes.argtypes = [i, i, i]
    lib.cin_bwd_smem_bytes.restype = ll
    lib.cin_bwd_max_smem.argtypes = []
    lib.cin_bwd_max_smem.restype = ll
    lib.cin_bwd_workspace_floats.argtypes = [i, i, i, i, i]
    lib.cin_bwd_workspace_floats.restype = ll
    return lib

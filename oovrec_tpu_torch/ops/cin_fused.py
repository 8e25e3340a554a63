"""Fused CIN layer (xDeepFM), forward and backward.

Port of `oovrec_tpu/ops/cin_fused.py`. One CIN layer computes, per batch
row b and embedding lane d,

    conv[b, l, d] = relu( Σ_{h,f} A[b,h,d]·B0[b,f,d]·W[h·F+f, l] + bias[l] )

(pairwise Hadamard feature maps and a 1×1 conv over the pair axis). On a
CUDA tensor the wrappers launch the hand-written kernel in
`csrc/cin_fused.cu`, which forms the Hadamard slab in shared memory and
never writes it to device memory. On a CPU tensor they run the plain
versions, which materialise the slab: the same function, the kernel's
reference in `chip_smoke.py`. The kernels' launch geometry is plain Python
(`fwd_geometry`, `bwd_geometry`: one launch). A layer wider than one launch
takes (D > 128 lanes, a row tile beyond shared memory, or L > 128 columns
in the backward) goes through several launches of the same kernel, over
spans of D and, in the backward, groups of columns (`fwd_plan`,
`bwd_plan`); only a shape that no split fits raises.

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
from typing import NamedTuple

import torch

from oovrec_tpu_torch.ops.launches import add_operations, register
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


def cin_operations(B: int, H: int, F: int, D: int, L: int, backward: bool = False) -> int:
    """The operations `FlopCounterMode` counts in one layer's plain version:
    the pair-axis product, 2·B·H·F·D·L, once forward and three times
    backward (the recomputed pre-activation, dW and dz); the Hadamard slab,
    the ReLU mask and the sums over D count nothing there. A launch adds
    it to the open tallies (`ops/launches.py`)."""
    return (6 if backward else 2) * B * H * F * D * L


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


@functools.lru_cache(maxsize=None)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(a, b0, w, bias, mxu_dtype, n_hidden, ps):
    """Forward kernel launch for CUDA tensors: checks, computes the
    geometry, allocates, launches or raises."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    _check_cuda(a, (("a", a), ("b0", b0), ("w", w), ("bias", bias)))
    geo = fwd_geometry(B, H, F, D, L)
    lib = _kernel_library()
    bf16 = _is_bf16(mxu_dtype)
    hidden = torch.empty((B, n_hidden, D), dtype=torch.float32, device=a.device)
    pooled = torch.empty((B, L - ps), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cin_fused_launch(
            a.data_ptr(), b0.data_ptr(), w.data_ptr(), bias.data_ptr(),
            B, H, F, D, L, n_hidden, ps, int(bf16), geo.tb,
            hidden.data_ptr() if n_hidden else None,
            pooled.data_ptr() if L > ps else None,
            stream,
        )
    check(err, "cin_fused_launch")
    return hidden, pooled


MAX_SMEM = 232448   # shared memory a block may take on the H100


def _a4(n: int) -> int:
    return -(-n // 4) * 4


def _cols(L: int) -> int:
    """Columns a block covers in one pass: 16 threads × RN, RN = ⌈L / 16⌉
    rounded up to 2 / 4 / 7 / 8 (at most 128)."""
    c = -(-L // 16)
    return 16 * (2 if c <= 2 else 4 if c <= 4 else 7 if c <= 7 else 8)


# The forward kernel's blocking (csrc/cin_fused.cu), mirrored so that its
# launch geometry is plain Python the CPU tests and the model's `auto` rule
# reach; `_kernel_library` checks the kernel's shared memory agrees.
FWD_ROWS = 128      # (b, d) rows a block owns at most
FWD_KC = 32         # pair rows a chunk of the ring


def fwd_smem(tb: int, H: int, F: int, D: int, L: int) -> int:
    """Shared memory (bytes) of a forward block of `tb` batch rows: the A
    and B0 tiles, bias, the region that the ring (two z chunks and two W
    chunks) and the output tile of a pass share, the (h·D, f·D) table."""
    lp = _cols(L)
    region = max(2 * FWD_KC * (FWD_ROWS + lp), FWD_ROWS * (lp + 1))
    return 4 * (_a4(tb * H * D) + _a4(tb * F * D) + _a4(L) + region) + 8 * H * F


class FwdGeometry(NamedTuple):
    tb: int            # batch rows a block owns (blocks: ⌈B / tb⌉)
    cols: int          # columns one pass covers
    passes: int        # column passes a block makes: ⌈L / cols⌉
    smem: int          # bytes of shared memory a block


@functools.lru_cache(maxsize=1024)
def fwd_geometry(B: int, H: int, F: int, D: int, L: int) -> FwdGeometry:
    """The forward kernel's launch geometry, or ValueError for a shape it
    does not take. A block owns the most whole batch rows (≤ 128 rows
    (b, d)) whose tiles fit in shared memory, and covers the L columns in
    passes of `cols`. (Fewer rows a block, for more blocks, did not make
    the published widths faster on the H100: a block's time hardly
    depends on its rows.)"""
    if D > FWD_ROWS:
        raise ValueError(f"D={D} exceeds the forward kernel's row tile ({FWD_ROWS})")
    tb = min(FWD_ROWS // D, B)
    while tb and fwd_smem(tb, H, F, D, L) > MAX_SMEM:
        tb -= 1
    if not tb:
        raise ValueError(f"H={H}, F={F}, D={D}, L={L}: the forward's row tiles "
                         "exceed shared memory")
    cols = _cols(L)
    return FwdGeometry(tb, cols, -(-L // cols), fwd_smem(tb, H, F, D, L))


def _spans(n: int, size: int):
    """[(start, end)] of n in spans of `size`, the last one shorter."""
    return tuple((i, min(n, i + size)) for i in range(0, n, size))


def _d_spans(D: int, fits):
    """The fewest even spans of D, each ≤ 128 lanes, whose every width
    `fits` (raises ValueError where it does not)."""
    for n in range(-(-D // FWD_ROWS), D + 1):
        spans = _spans(D, -(-D // n))
        try:
            for width in {d1 - d0 for d0, d1 in spans}:
                fits(width)
        except ValueError:
            continue
        return spans
    raise ValueError(f"D={D}: no span of D fits the kernel")


@functools.lru_cache(maxsize=1024)
def fwd_plan(B: int, H: int, F: int, D: int, L: int):
    """The D spans the forward's launches cover: one span where
    `fwd_geometry` takes the layer whole, else the fewest even spans that
    it takes (a layer is separable over D). ValueError where none fits
    (a pair axis whose offset table alone exceeds shared memory)."""
    try:
        return _d_spans(D, lambda d: fwd_geometry(B, H, F, d, L))
    except ValueError:
        raise ValueError(f"B={B}, H={H}, F={F}, D={D}, L={L}: no span of D fits "
                         "the forward kernel's shared memory") from None


# The backward kernel's blocking (csrc/cin_fused_bwd.cu), mirrored so that
# its launch geometry is plain Python the CPU tests reach;
# `_bwd_library` checks the kernel's shared memory agrees.
BWD_ROWS = 128      # launch 1: (b, d) rows per block at most
BWD_KC = 32         # launch 1: pair chunk of pre; launch 2: rows per chunk
BWD_DZ = 64         # launch 1: dz columns per sub-tile
BWD_DW_TILE = 128   # launch 2: pair columns per block
BWD_MAX_L = 128


def bwd_row_smem(tb: int, H: int, F: int, D: int, L: int) -> int:
    """Shared memory (bytes) of the backward's launch 1 at `tb` batch rows
    a block: the A and B0 tiles, gh then dpre (L × 132), gp, bias, the
    larger of the pre phase (a z chunk and two W chunks) and the dz phase
    (the W rows of two h groups, at a pitch whose quarter is odd, and the
    dz tile of one group), the dB0 sums and the pair-offset table."""
    tms = BWD_ROWS + 4
    kc2 = max(1, BWD_DZ // F) * F
    kc2p = -(-kc2 // BWD_DZ) * BWD_DZ
    pitch = _a4(L) if _a4(L) // 4 % 2 else _a4(L) + 4
    phase = max(BWD_KC * tms + 2 * BWD_KC * _cols(L),
                2 * kc2p * pitch + _a4(BWD_ROWS * ((kc2 + 1) | 1)))
    return 4 * (_a4(tb * H * D) + _a4(tb * F * D) + L * tms + _a4(tb * L) + _a4(L)
                + phase + _a4(BWD_ROWS * F) + _a4(H * F))


class BwdGeometry(NamedTuple):
    tb: int            # batch rows a launch-1 block owns (blocks: ⌈B / tb⌉)
    ms: int            # rows (b, d) of one dW slice, a multiple of BWD_KC
    slices: int
    k_tiles: int       # launch 2's blocks along the pair axis
    workspace: int     # f32 elements: dpre (B·D, L) and the partials


@functools.lru_cache(maxsize=1024)
def bwd_geometry(B: int, H: int, F: int, D: int, L: int, n_sm: int = 132) -> BwdGeometry:
    """The backward kernel's launch geometry, or ValueError for a shape it
    does not take. Launch 1: the most whole batch rows (≤ 128 rows (b, d))
    whose tiles fit in shared memory. Launch 2: the B·D rows in slices of
    ms rows, about 2 × n_sm blocks with the pair tiles."""
    if D > BWD_ROWS:
        raise ValueError(f"D={D} exceeds the backward kernel's row tile ({BWD_ROWS})")
    if L > BWD_MAX_L:
        raise ValueError(f"L={L} exceeds the backward kernel's columns ({BWD_MAX_L})")
    if H * D >= 2**15 or F * D >= 2**16 or B * max(H, F) * D >= 2**31:
        raise ValueError(f"B={B}, H={H}, F={F}, D={D}: offsets exceed the kernel's 32 bits")
    tb = min(BWD_ROWS // D, B)
    while tb and bwd_row_smem(tb, H, F, D, L) > MAX_SMEM:
        tb -= 1
    if not tb:
        raise ValueError(f"H={H}, F={F}, D={D}, L={L}: the backward's row tiles "
                         "exceed shared memory")
    M, HF = B * D, H * F
    k_tiles = -(-HF // BWD_DW_TILE)
    slices = max(1, min(-(-2 * n_sm // k_tiles), -(-M // BWD_KC)))
    ms = -(-(-(-M // slices)) // BWD_KC) * BWD_KC
    slices = -(-M // ms)
    return BwdGeometry(tb, ms, slices, k_tiles,
                       M * L + slices * HF * L + slices * L)


@functools.lru_cache(maxsize=1024)
def bwd_plan(B: int, H: int, F: int, D: int, L: int):
    """(column groups, D spans) the backward's launches cover: L in the
    fewest even groups of ≤ 128 columns, D as in `fwd_plan`, each pair
    taken by `bwd_geometry`. A group's dpre, dW and dbias need only its own
    columns; its dz, and so dA and dB0, is one part of a sum over groups.
    ValueError where no split fits."""
    cols = _spans(L, -(-L // -(-L // BWD_MAX_L)))
    widths = {l1 - l0 for l0, l1 in cols}

    def fits(d):
        for lw in widths:
            bwd_geometry(B, H, F, d, lw)

    try:
        return cols, _d_spans(D, fits)
    except ValueError:
        raise ValueError(f"B={B}, H={H}, F={F}, D={D}, L={L}: no span of D fits "
                         "the backward kernel") from None


def bwd_dw_sliced_plain(a, b0, dpre, ms: int, mxu_dtype="float32"):
    """dW and dbias as the backward kernel orders them: f32 partials over
    slices of ms rows (b, d) in ascending row order, then the partials
    summed in ascending slice order. dpre (B, L, D) unrounded. On
    integer-valued inputs it equals `cin_layer_pooled_bwd_plain`'s dW and
    dbias bit for bit."""
    B, H, D = a.shape
    F = b0.shape[1]
    bf16 = _is_bf16(mxu_dtype)
    a, b0 = a.float(), b0.float()
    if bf16:
        a, b0 = _round_bf16(a), _round_bf16(b0)
        z = _round_bf16(a[:, :, None, :] * b0[:, None, :, :])
    else:
        z = a[:, :, None, :] * b0[:, None, :, :]
    z = z.reshape(B, H * F, D).permute(0, 2, 1).reshape(B * D, H * F)   # rows (b, d)
    rows = dpre.float().permute(0, 2, 1).reshape(B * D, -1)
    rr = _round_bf16(rows) if bf16 else rows
    dw = dbias = None
    for m0 in range(0, B * D, ms):
        pw = z[m0:m0 + ms].T @ rr[m0:m0 + ms]
        pb = rows[m0:m0 + ms].sum(dim=0)
        dw = pw if dw is None else dw + pw
        dbias = pb if dbias is None else dbias + pb
    return dw, dbias


def _launch_bwd(a, b0, w, bias, gh, gp, mxu_dtype, n_hidden, ps):
    """Backward kernel launch for CUDA tensors: checks, computes the
    geometry, allocates the outputs and the workspace, launches or raises."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    _check_cuda(a, (("a", a), ("b0", b0), ("w", w), ("bias", bias),
                    ("gh", gh), ("gp", gp)))
    if gh is not None and tuple(gh.shape) != (B, n_hidden, D):
        raise ValueError(f"gh {tuple(gh.shape)} must be {(B, n_hidden, D)}")
    if gp is not None and tuple(gp.shape) != (B, L - ps):
        raise ValueError(f"gp {tuple(gp.shape)} must be {(B, L - ps)}")
    geo = bwd_geometry(B, H, F, D, L, _n_sm(a.device))
    lib = _bwd_library()
    bf16 = _is_bf16(mxu_dtype)
    dev = a.device
    da = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    db0 = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    dw = torch.empty((H * F, L), dtype=torch.float32, device=dev)
    dbias = torch.empty((L,), dtype=torch.float32, device=dev)
    work = torch.empty((geo.workspace,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cin_bwd_launch(
            a.data_ptr(), b0.data_ptr(), w.data_ptr(), bias.data_ptr(),
            gh.data_ptr() if gh is not None and n_hidden else None,
            gp.data_ptr() if gp is not None and L > ps else None,
            B, H, F, D, L, n_hidden, ps, int(bf16), geo.tb, geo.ms, geo.slices,
            da.data_ptr(), db0.data_ptr(), dw.data_ptr(), dbias.data_ptr(),
            work.data_ptr(), stream,
        )
    check(err, "cin_bwd_launch")
    return da, db0, dw, dbias


def _d_span(t, d0, d1, whole):
    return t if whole else t[:, :, d0:d1].contiguous()


def forward_split(a, b0, w, bias, mxu_dtype, n_hidden, ps, run):
    """One layer over the D spans of `fwd_plan`: `run(a, b0, w, bias,
    mxu_dtype, n_hidden, ps) → (hidden, pooled)` computes a span (a kernel
    launch; the tests pass a plain version); the hidden spans are joined
    along D, the pooled parts added in ascending span order."""
    spans = fwd_plan(*_shapes(a, b0, w, bias))
    whole = len(spans) == 1
    hs, pooled = [], None
    for d0, d1 in spans:
        h, p = run(_d_span(a, d0, d1, whole), _d_span(b0, d0, d1, whole), w, bias,
                   mxu_dtype, n_hidden, ps)
        hs.append(h)
        pooled = p if pooled is None else pooled + p
    return (hs[0] if whole else torch.cat(hs, dim=2)), pooled


def backward_split(a, b0, w, bias, gh, gp, mxu_dtype, n_hidden, ps, run):
    """The VJP over the column groups and D spans of `bwd_plan`: `run(a,
    b0, w, bias, gh, gp, mxu_dtype, n_hidden, ps) → (da, db0, dw, dbias)`
    computes one (group, span) (a kernel launch; the tests pass a plain
    version). A group takes its columns of W, bias, gh and gp, and its own
    n_hidden and pool start (hidden rows are a prefix of L, pooled rows a
    suffix). dA and dB0 add the groups' parts in ascending group order, dW
    and dbias the spans' parts in ascending span order."""
    B, H, F, D, L = _shapes(a, b0, w, bias)
    cols, spans = bwd_plan(B, H, F, D, L)
    whole_l, whole_d = len(cols) == 1, len(spans) == 1
    a_d = [(_d_span(a, d0, d1, whole_d), _d_span(b0, d0, d1, whole_d)) for d0, d1 in spans]
    da = db0 = None
    dws, dbs = [], []
    for l0, l1 in cols:
        nh = max(0, min(n_hidden, l1) - l0)
        pg = min(max(ps - l0, 0), l1 - l0)
        w_g = w if whole_l else w[:, l0:l1].contiguous()
        bias_g = bias if whole_l else bias[l0:l1].contiguous()
        gp_g = None
        if gp is not None and pg < l1 - l0:
            gp_g = gp if whole_l else gp[:, l0 + pg - ps:l1 - ps].contiguous()
        parts = []
        for (d0, d1), (a_s, b0_s) in zip(spans, a_d):
            gh_s = None
            if gh is not None and nh:
                gh_s = gh if whole_l and whole_d else gh[:, l0:l0 + nh, d0:d1].contiguous()
            parts.append(run(a_s, b0_s, w_g, bias_g, gh_s, gp_g, mxu_dtype, nh, pg))
        da_g = parts[0][0] if whole_d else torch.cat([p[0] for p in parts], dim=2)
        db0_g = parts[0][1] if whole_d else torch.cat([p[1] for p in parts], dim=2)
        dw_g, dbias_g = parts[0][2], parts[0][3]
        for p in parts[1:]:
            dw_g, dbias_g = dw_g + p[2], dbias_g + p[3]
        da = da_g if da is None else da + da_g
        db0 = db0_g if db0 is None else db0 + db0_g
        dws.append(dw_g)
        dbs.append(dbias_g)
    if whole_l:
        return da, db0, dws[0], dbs[0]
    return da, db0, torch.cat(dws, dim=1), torch.cat(dbs)


def _counted(launch, counter):
    """`launch`, adding one to `counter.launches` at each launch."""
    def run(*args):
        out = launch(*args)
        counter.launches += 1
        return out
    return run


def _pooled_forward(a, b0, w, bias, mxu_dtype, n_hidden, pool_all):
    """CPU: the plain version; CUDA: the kernel, each launch counted on
    `cin_layer_pooled.launches`."""
    if a.device.type == "cpu":
        return cin_layer_pooled_plain(a, b0, w, bias, mxu_dtype, n_hidden, pool_all)
    ps = _pool_start(w.shape[1], n_hidden, pool_all)
    add_operations(cin_operations(*_shapes(a, b0, w, bias)))
    hidden, pooled = forward_split(a, b0, w, bias, mxu_dtype, n_hidden, ps,
                                   _counted(_launch, cin_layer_pooled))
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
    add_operations(cin_operations(*_shapes(a, b0, w, bias), backward=True))
    return backward_split(a, b0, w, bias, gh, gp, mxu_dtype, n_hidden, ps,
                          _counted(_launch_bwd, cin_layer_pooled_bwd))


register(cin_layer_pooled_bwd, "cin_bwd_rows_kernel")


def cin_layer_bwd(a, b0, w, bias, g, mxu_dtype="float32"):
    """VJP of `cin_layer` → (da, db0, dw, dbias): the backward kernel with
    every row hidden and none pooled. CPU tensors take the plain version;
    CUDA tensors launch the kernel (`cin_layer_bwd.launches`) or raise."""
    if a.device.type == "cpu":
        return cin_layer_bwd_plain(a, b0, w, bias, g, mxu_dtype)
    L = w.shape[1]
    add_operations(cin_operations(*_shapes(a, b0, w, bias), backward=True))
    return backward_split(a, b0, w, bias, g, None, mxu_dtype, L, L,
                          _counted(_launch_bwd, cin_layer_bwd))


register(cin_layer_bwd, "cin_bwd_rows_kernel")


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
            add_operations(cin_operations(*_shapes(a, b0, w, bias)))
            out, _ = forward_split(a, b0, w, bias, mxu_dtype, L, L,
                                   _counted(_launch, cin_layer))
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


register(cin_layer_pooled, "cin_fused_kernel")


def cin_layer(a, b0, w, bias, mxu_dtype="float32") -> torch.Tensor:
    """relu(conv) (B, L, D) for one CIN layer: `cin_layer_pooled` with every
    row hidden and none pooled. Differentiable through `cin_layer_bwd`. CPU
    tensors take the plain versions; CUDA tensors launch the kernels
    (`cin_layer.launches` counts the forward launches) or raise."""
    return _CinLayer.apply(a, b0, w, bias, mxu_dtype)


register(cin_layer, "cin_fused_kernel")


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built forward kernel library with its C signatures (once per
    process); raises if its shared memory differs from `fwd_smem`."""
    lib = load_kernel("cin_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cin_fused_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p]
    lib.cin_fused_launch.restype = ctypes.c_int
    lib.cin_fused_smem.argtypes = [i, i, i, i, i]
    lib.cin_fused_smem.restype = ctypes.c_longlong
    for shape in ((12, 50, 7, 10, 100), (2, 50, 39, 10, 100), (18, 7, 7, 7, 33),
                  (1, 100, 7, 128, 200), (128, 3, 3, 1, 20)):
        if lib.cin_fused_smem(*shape) != fwd_smem(*shape):
            raise RuntimeError(f"cin_fused shared memory at {shape} differs from the wrapper's")
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    """The built backward kernel library with its C signatures; raises if
    its shared memory differs from `bwd_row_smem`."""
    lib = load_kernel("cin_fused_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cin_bwd_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                                   p, p, p, p, p, p]
    lib.cin_bwd_launch.restype = ctypes.c_int
    lib.cin_bwd_row_smem.argtypes = [i, i, i, i, i]
    lib.cin_bwd_row_smem.restype = ll
    for shape in ((12, 50, 7, 10, 100), (2, 50, 39, 10, 100), (18, 7, 7, 7, 33)):
        if lib.cin_bwd_row_smem(*shape) != bwd_row_smem(*shape):
            raise RuntimeError(f"cin_fused_bwd shared memory at {shape} differs from the wrapper's")
    return lib

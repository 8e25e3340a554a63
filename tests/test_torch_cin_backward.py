"""The port's CIN backward (`oovrec_tpu_torch/ops/cin_fused.py`) against
the JAX package's custom VJPs.

`cin_layer_pooled_bwd_plain` / `cin_layer_bwd_plain` (what the wrappers
run on the CPU, and the CUDA kernel's reference on the card) against
`jax.vjp` of the JAX kernels (Pallas, interpret mode on the CPU) and of
`cin_layer_reference`, at the cases of `tests/test_cin_fused.py:91-145`
transposed to batch-major, to the JAX test's 2e-4; against torch autograd
of the port's plain forward; and the autograd route of the wrappers
(`torch.autograd.Function`) against the plain backward. Inputs and
gradients come from numpy with a seed.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.ops import cin_fused as jax_cin  # noqa: E402
from oovrec_tpu_torch.ops import cin_fused  # noqa: E402
from oovrec_tpu_torch.ops.cin_fused import (  # noqa: E402
    cin_layer,
    cin_layer_bwd,
    cin_layer_bwd_plain,
    cin_layer_pooled,
    cin_layer_pooled_bwd,
    cin_layer_pooled_bwd_plain,
    cin_layer_pooled_plain,
)

CASES = [
    # H, F, D, B, L, nh, pool_all
    (5, 7, 4, 16, 6, 3, False),     # mid layer (split halves)
    (5, 5, 8, 32, 10, 10, True),    # direct mode (hidden == all)
    (7, 7, 16, 128, 100, 0, True),  # last layer (pooled only)
    (7, 7, 16, 128, 100, 50, False),
]
TOL = 2e-4  # tests/test_cin_fused.py:143, f32 sums in another order


def _inputs(H, F, D, B, L, nh, ps, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, H, D)).astype(np.float32)
    b0 = rng.standard_normal((B, F, D)).astype(np.float32)
    w = (rng.standard_normal((H * F, L)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(L) * 0.1).astype(np.float32)
    gh = rng.standard_normal((B, nh, D)).astype(np.float32)
    gp = rng.standard_normal((B, L - ps)).astype(np.float32)
    return (a, b0, w, bias), gh, gp


def _jax(a, b0, w, bias):
    """numpy batch-major → the JAX kernels' batch-minor (·, D, B)."""
    return (jnp.asarray(a.transpose(1, 2, 0)), jnp.asarray(b0.transpose(1, 2, 0)),
            jnp.asarray(w), jnp.asarray(bias))


def _np_grads(da, db0, dw, dbias):
    """JAX gradients → numpy batch-major."""
    return (np.asarray(da).transpose(2, 0, 1), np.asarray(db0).transpose(2, 0, 1),
            np.asarray(dw), np.asarray(dbias))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _close(got, want, tol=TOL, scaled=False):
    """Each gradient to `tol` (absolute and relative); `scaled` takes the
    absolute part relative to max(1, the gradient's largest magnitude),
    for sums of B·D terms in two orders."""
    for name, g, w in zip(("da", "db0", "dw", "dbias"), got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        atol = tol * max(1.0, float(np.abs(w).max())) if scaled else tol
        np.testing.assert_allclose(g, w, rtol=tol, atol=atol, err_msg=name)


@pytest.mark.parametrize("H,F,D,B,L,nh,pool_all", CASES)
def test_pooled_backward_matches_jax_kernel_and_reference(H, F, D, B, L, nh, pool_all):
    ps = 0 if pool_all else nh
    inputs, gh, gp = _inputs(H, F, D, B, L, nh, ps)
    gh_j = jnp.asarray(gh.transpose(1, 2, 0))
    gp_j = jnp.asarray(gp.T)

    _, vjp = jax.vjp(lambda *x: jax_cin.cin_layer_pooled(*x, n_hidden=nh, pool_all=pool_all),
                     *_jax(*inputs))
    want_kernel = _np_grads(*vjp((gh_j if nh else None, gp_j)))

    def ref(*x):
        out = jax_cin.cin_layer_reference(*x)
        return out[:nh], jnp.sum(out[ps:], axis=1)

    _, vjp_ref = jax.vjp(ref, *_jax(*inputs))
    want_ref = _np_grads(*vjp_ref((gh_j, gp_j)))

    got = cin_layer_pooled_bwd_plain(*_t(*inputs), _t(gh)[0] if nh else None,
                                     _t(gp)[0] if L > ps else None,
                                     n_hidden=nh, pool_all=pool_all)
    _close(got, want_kernel)
    _close(got, want_ref)
    # the wrapper takes the plain version on the CPU and counts nothing
    wrapped = cin_layer_pooled_bwd(*_t(*inputs), _t(gh)[0] if nh else None, _t(gp)[0],
                                   n_hidden=nh, pool_all=pool_all)
    assert all(torch.equal(x, y) for x, y in zip(wrapped, got))
    assert cin_layer_pooled_bwd.launches == 0


@pytest.mark.parametrize("H,F,D,B,L,nh,pool_all", CASES)
def test_pooled_backward_matches_torch_autograd(H, F, D, B, L, nh, pool_all):
    """The explicit formulas equal autograd of the plain forward, and the
    differentiable wrapper (`torch.autograd.Function`) returns them."""
    ps = 0 if pool_all else nh
    inputs, gh, gp = _inputs(H, F, D, B, L, nh, ps, seed=1)
    gh_t, gp_t = _t(gh, gp)
    plain = cin_layer_pooled_bwd_plain(*_t(*inputs), gh_t if nh else None, gp_t,
                                       n_hidden=nh, pool_all=pool_all)

    leaves = [x.requires_grad_() for x in _t(*inputs)]
    h, p = cin_layer_pooled_plain(*leaves, n_hidden=nh, pool_all=pool_all)
    outs, cots = ([h, p], [gh_t, gp_t]) if nh else ([p], [gp_t])
    auto = torch.autograd.grad(outs, leaves, cots)
    _close(plain, [x.numpy() for x in auto], tol=1e-5, scaled=True)

    leaves = [x.requires_grad_() for x in _t(*inputs)]
    h, p = cin_layer_pooled(*leaves, n_hidden=nh, pool_all=pool_all)
    fn = torch.autograd.grad([h, p] if nh else [p], leaves, cots)
    assert all(torch.equal(x, y) for x, y in zip(fn, plain))


def test_unused_hidden_gradient_is_zero():
    """A hidden output no loss reads gets no gradient: the Function passes
    None, which the backward takes as zeros (the JAX backward's fill)."""
    H, F, D, B, L, nh = 5, 7, 4, 16, 6, 3
    inputs, _, gp = _inputs(H, F, D, B, L, nh, nh, seed=2)
    leaves = [x.requires_grad_() for x in _t(*inputs)]
    _, p = cin_layer_pooled(*leaves, n_hidden=nh)
    got = torch.autograd.grad([p], leaves, [_t(gp)[0]])
    zeros = cin_layer_pooled_bwd_plain(*_t(*inputs), torch.zeros(B, nh, D), _t(gp)[0],
                                       n_hidden=nh)
    none = cin_layer_pooled_bwd_plain(*_t(*inputs), None, _t(gp)[0], n_hidden=nh)
    for x, y, z in zip(got, zeros, none):
        assert torch.equal(x, y) and torch.equal(y, z)


@pytest.mark.parametrize("H,F,D,B,L", [(5, 7, 4, 16, 6), (7, 7, 16, 128, 100)])
def test_cin_layer_backward_matches_jax_kernel(H, F, D, B, L):
    """Kernel 3: the VJP of `cin_layer` (every row hidden)."""
    inputs, g, _ = _inputs(H, F, D, B, L, L, L, seed=3)
    _, vjp = jax.vjp(jax_cin.cin_layer, *_jax(*inputs))
    want = _np_grads(*vjp(jnp.asarray(g.transpose(1, 2, 0))))
    _, vjp_ref = jax.vjp(jax_cin.cin_layer_reference, *_jax(*inputs))
    want_ref = _np_grads(*vjp_ref(jnp.asarray(g.transpose(1, 2, 0))))
    got = cin_layer_bwd_plain(*_t(*inputs), _t(g)[0])
    _close(got, want)
    _close(got, want_ref)
    leaves = [x.requires_grad_() for x in _t(*inputs)]
    fn = torch.autograd.grad([cin_layer(*leaves)], leaves, [_t(g)[0]])
    assert all(torch.equal(x, y) for x, y in zip(fn, got))
    assert all(torch.equal(x, y) for x, y in zip(cin_layer_bwd(*_t(*inputs), _t(g)[0]), got))
    assert cin_layer_bwd.launches == 0


def test_mask_at_zero_pre_activation():
    """Integer inputs put pre == 0 on many elements: the gradient is 0
    there (`pre > 0`), as autograd of relu gives."""
    rng = np.random.default_rng(4)
    B, H, F, D, L, nh = 64, 3, 3, 4, 8, 4
    a = rng.integers(-1, 2, (B, H, D)).astype(np.float32)
    b0 = rng.integers(-1, 2, (B, F, D)).astype(np.float32)
    w = rng.integers(-1, 2, (H * F, L)).astype(np.float32)
    bias = np.zeros(L, np.float32)
    gh = rng.integers(-3, 4, (B, nh, D)).astype(np.float32)
    gp = rng.integers(-3, 4, (B, L - nh)).astype(np.float32)
    pre = torch.einsum("bkd,kl->bld", _t(a[:, :, None] * b0[:, None])[0].reshape(B, -1, D),
                       _t(w)[0])
    assert int((pre == 0).sum()) > B  # the case under test happens often
    got = cin_layer_pooled_bwd_plain(*_t(a, b0, w, bias), *_t(gh, gp), n_hidden=nh)
    leaves = [x.requires_grad_() for x in _t(a, b0, w, bias)]
    h, p = cin_layer_pooled_plain(*leaves, n_hidden=nh)
    auto = torch.autograd.grad([h, p], leaves, _t(gh, gp))
    assert all(torch.equal(x, y) for x, y in zip(got, auto))


def test_bf16_backward_close_to_jax_kernel():
    """bf16 operands, bf16-rounded pre-activation gradient, f32
    accumulation: the JAX kernel's order, to a bf16 tolerance (the JAX
    kernel also moves bf16 I/O at this block shape)."""
    H, F, D, B, L, nh = 7, 7, 16, 128, 100, 50
    inputs, gh, gp = _inputs(H, F, D, B, L, nh, nh, seed=5)
    a, b0, w, bias = inputs
    a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    b0 = np.asarray(jnp.asarray(b0, jnp.bfloat16), np.float32)
    io = jax_cin.cin_io_dtype(D, B, "bfloat16")
    ja, jb0, jw, jbias = _jax(a, b0, w, bias)
    _, vjp = jax.vjp(lambda *x: jax_cin.cin_layer_pooled(
        *x, mxu_dtype="bfloat16", n_hidden=nh), ja.astype(io), jb0.astype(io), jw, jbias)
    want = _np_grads(*[np.asarray(x, np.float32) for x in vjp(
        (jnp.asarray(gh.transpose(1, 2, 0), io), jnp.asarray(gp.T)))])
    got = cin_layer_pooled_bwd_plain(*_t(a, b0, w, bias), *_t(gh, gp),
                                     mxu_dtype="bfloat16", n_hidden=nh)
    for name, g, wv in zip(("da", "db0", "dw", "dbias"), got, want):
        scale = max(1.0, float(np.abs(wv).max()))
        np.testing.assert_allclose(g.numpy(), wv, rtol=0.05, atol=0.02 * scale, err_msg=name)
    f32 = cin_layer_pooled_bwd_plain(*_t(a, b0, w, bias), *_t(gh, gp), n_hidden=nh)
    assert not torch.equal(got[2], f32[2])  # really the bf16 arithmetic


def test_backward_refuses_what_it_cannot_take():
    """The backward kernel route raises on tensors off the card instead of
    falling back; shapes are checked; importing builds nothing."""
    from oovrec_tpu_torch.utils import cuda_build

    inputs, gh, gp = _inputs(3, 3, 4, 5, 6, 3, 3, seed=6)
    with pytest.raises(ValueError, match="must lie on"):
        cin_fused._launch_bwd(*_t(*inputs), *_t(gh, gp), "float32", 3, 3)
    with pytest.raises(ValueError, match="do not agree"):
        cin_layer_pooled_bwd_plain(*_t(*inputs[:3]), torch.zeros(5), None, None)
    assert "cin_fused_bwd" not in cuda_build.LIBRARIES._libs


# The backward kernel's launch geometry is Python (`bwd_geometry`); the
# kernel derives each block's rows from it as below. The shapes are
# `chip_smoke.py`'s CIN_CASES (B, H, F, D, L).
GEOMETRY_CASES = [
    (8192, 7, 7, 10, 100), (8192, 50, 7, 10, 100), (1000, 7, 7, 10, 100),
    (4096, 50, 7, 16, 100), (512, 50, 39, 10, 100), (256, 39, 39, 10, 100),
    (37, 50, 7, 10, 100), (1000, 50, 7, 10, 100), (300, 7, 7, 7, 33),
    (301, 16, 7, 7, 33), (37, 7, 7, 7, 33),
]


@pytest.mark.parametrize("B,H,F,D,L", GEOMETRY_CASES)
@pytest.mark.parametrize("n_sm", [132, 7])
def test_bwd_geometry_covers_each_row_once_in_order(B, H, F, D, L, n_sm):
    geo = cin_fused.bwd_geometry(B, H, F, D, L, n_sm)
    # launch 1: block i owns batch rows [i·tb, min(B, (i+1)·tb)), ≤ 128 rows (b, d)
    assert 0 < geo.tb * D <= cin_fused.BWD_ROWS
    assert cin_fused.bwd_row_smem(geo.tb, H, F, D, L) <= cin_fused.MAX_SMEM
    owned = [b for i in range(-(-B // geo.tb))
             for b in range(i * geo.tb, min(B, (i + 1) * geo.tb))]
    assert owned == list(range(B))
    # launch 2: slice s walks rows (b, d) [s·ms, min(M, (s+1)·ms)) ascending,
    # in chunks of BWD_KC; no slice is empty
    M = B * D
    assert geo.ms % cin_fused.BWD_KC == 0 and geo.slices <= 65535
    walked = []
    for s in range(geo.slices):
        lo, hi = s * geo.ms, min(M, (s + 1) * geo.ms)
        assert hi > lo
        walked += range(lo, hi)
    assert walked == list(range(M))
    assert geo.k_tiles == -(-H * F // cin_fused.BWD_DW_TILE)
    assert geo.workspace == M * L + geo.slices * (H * F * L + L)


def test_bwd_geometry_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="D=129"):
        cin_fused.bwd_geometry(8, 3, 3, 129, 10)
    with pytest.raises(ValueError, match="L=129"):
        cin_fused.bwd_geometry(8, 3, 3, 10, 129)
    with pytest.raises(ValueError, match="shared memory"):
        cin_fused.bwd_geometry(8, 1000, 39, 10, 100)
    # the largest tile that fits: F = 39, H = 50 keeps whole rows in shared memory
    assert cin_fused.bwd_geometry(512, 50, 39, 10, 100).tb >= 1


def _integer_case(B, H, F, D, L, nh, ps, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 2, (B, H, D)).astype(np.float32)
    b0 = rng.integers(-1, 2, (B, F, D)).astype(np.float32)
    w = rng.integers(-2, 3, (H * F, L)).astype(np.float32)
    bias = rng.integers(-2, 3, L).astype(np.float32)
    gh = rng.integers(-3, 4, (B, nh, D)).astype(np.float32)
    gp = rng.integers(-3, 4, (B, L - ps)).astype(np.float32)
    return _t(a, b0, w, bias, gh, gp)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,F,D,L,nh,pool_all", [
    (300, 7, 7, 7, 33, 16, False), (301, 16, 7, 7, 33, 0, True),
    (64, 50, 7, 10, 100, 50, False), (37, 50, 7, 10, 100, 100, True),
    (16, 50, 39, 10, 100, 50, False),
])
def test_sliced_dw_equals_plain_bitwise_on_integers(B, H, F, D, L, nh, pool_all, mxu):
    """dW and dbias summed as the kernel sums them (f32 partials over slices
    of ms rows (b, d), then the partials in ascending slice order) equal
    the plain backward's bit for bit on integer inputs, at the kernel's own
    slice length and at the shortest one."""
    ps = 0 if pool_all else nh
    a, b0, w, bias, gh, gp = _integer_case(B, H, F, D, L, nh, ps, seed=B + H + L)
    want = cin_layer_pooled_bwd_plain(a, b0, w, bias, gh if nh else None, gp, mxu,
                                      n_hidden=nh, pool_all=pool_all)
    aa, bb, ww = (a, b0, w) if mxu == "float32" else (
        cin_fused._round_bf16(a), cin_fused._round_bf16(b0), cin_fused._round_bf16(w))
    z = (aa[:, :, None] * bb[:, None]).reshape(B, H * F, D)
    pre = torch.einsum("bkd,kl->bld", z, ww) + bias[None, :, None]
    g = torch.zeros_like(pre)
    g[:, :nh] = gh
    g[:, ps:] += gp[:, :, None]
    dpre = torch.where(pre > 0, g, torch.zeros_like(g))
    geo = cin_fused.bwd_geometry(B, H, F, D, L, n_sm=132)
    for ms in {geo.ms, cin_fused.BWD_KC}:
        dw, dbias = cin_fused.bwd_dw_sliced_plain(a, b0, dpre, ms, mxu)
        assert torch.equal(dw, want[2]) and torch.equal(dbias, want[3])
    assert want[2].abs().max() > 0 and want[3].abs().max() > 0


# Layers one launch does not take (L > 128, D > 128, rows beyond shared
# memory) go through several, over groups of columns and spans of D
# (`bwd_plan`): a group takes its own columns of W, bias, gh and gp; dA and
# dB0 add the groups' parts, dW and dbias the spans' parts.
BWD_SPLIT_CASES = [
    # B, H, F, D, L, nh, ps, column groups, D spans
    (5, 7, 7, 10, 200, 100, 100, 2, 1),    # a mid layer at cin_layer_size 200
    (4, 16, 7, 10, 200, 200, 0, 2, 1),     # direct mode
    (4, 16, 7, 10, 200, 200, 200, 2, 1),   # `cin_layer`: every row hidden
    (3, 7, 7, 200, 100, 0, 0, 1, 2),       # the last layer at D = 200
    (3, 6, 3, 130, 300, 150, 150, 3, 2),
    (2, 350, 7, 128, 100, 50, 50, 1, 3),   # A's rows beyond shared memory
    (6, 50, 7, 10, 100, 50, 50, 1, 1),     # the published widths: one launch
]


@pytest.mark.parametrize("B,H,F,D,L,nh,ps,n_cols,n_spans", BWD_SPLIT_CASES)
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_backward_split_equals_the_whole_vjp(B, H, F, D, L, nh, ps, n_cols, n_spans, mxu):
    """`backward_split` with the plain backward as its launch equals the
    plain backward of the whole layer: bit for bit on integer inputs, to
    1e-4 on random ones."""
    cols, spans = cin_fused.bwd_plan(B, H, F, D, L)
    assert (len(cols), len(spans)) == (n_cols, n_spans)
    assert all(l1 - l0 <= cin_fused.BWD_MAX_L for l0, l1 in cols)

    def plain(a, b0, w, bias, gh, gp, mxu_dtype, n_hidden, pool_start):
        return cin_layer_pooled_bwd_plain(a, b0, w, bias, gh, gp, mxu_dtype, n_hidden,
                                          pool_all=pool_start == 0)

    for exact in (True, False):
        if exact:
            a, b0, w, bias, gh, gp = _integer_case(B, H, F, D, L, nh, ps, seed=B + L)
        else:
            inputs, gh, gp = _inputs(H, F, D, B, L, nh, ps, seed=B + L)
            a, b0, w, bias = _t(*inputs)
            gh, gp = _t(gh, gp)
        gh, gp = (gh if nh else None), (gp if L > ps else None)
        got = cin_fused.backward_split(a, b0, w, bias, gh, gp, mxu, nh, ps, plain)
        want = plain(a, b0, w, bias, gh, gp, mxu, nh, ps)
        for g, w_ in zip(got, want):
            assert g.shape == w_.shape
            if exact:
                assert torch.equal(g, w_)
            else:
                np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-4, atol=1e-4)
        assert want[2].abs().max() > 0


def test_bwd_plan_refuses_only_what_no_split_fits():
    assert cin_fused.bwd_plan(8192, 100, 7, 10, 200) == (((0, 100), (100, 200)), ((0, 10),))
    assert cin_fused.bwd_plan(8192, 50, 7, 10, 129)[0] == ((0, 65), (65, 129))
    with pytest.raises(ValueError, match="no span of D fits"):
        cin_fused.bwd_plan(8, 1000, 39, 10, 100)

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

"""The port's CIN layer (`oovrec_tpu_torch/ops/cin_fused.py`) against the
JAX package's `cin_layer_pooled` / `cin_layer` (Pallas, interpret mode on
the CPU) and `cin_layer_reference`.

Inputs come from numpy with a seed; the JAX side takes them batch-minor
(H, D, B), the port batch-major (B, H, D). On the CPU the port's wrappers
run their plain versions (the CUDA kernel is held against the same plain
versions on the card by `chip_smoke.py`). Tolerances: f32 rtol/atol 1e-5
(sums of ≤ 49 products taken in another order); the bf16 policy at the
JAX test's own bf16 tolerance (`tests/test_cin_fused.py`).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.ops import cin_fused as jax_cin  # noqa: E402
from oovrec_tpu_torch.ops import cin_fused  # noqa: E402
from oovrec_tpu_torch.ops.cin_fused import (  # noqa: E402
    cin_layer,
    cin_layer_plain,
    cin_layer_pooled,
    cin_layer_pooled_plain,
)

POOLED_CASES = [
    # H, F, D, B, L, nh, pool_all
    (5, 7, 4, 16, 6, 3, False),     # mid layer (split halves)
    (5, 5, 8, 32, 10, 10, True),    # direct mode (hidden == all)
    (7, 7, 16, 128, 100, 0, True),  # last layer (pooled only)
    (7, 7, 16, 128, 100, 50, False),
    (7, 7, 10, 16, 100, 50, False),  # the serving depth D = 10
]


def _inputs(H, F, D, B, L, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, H, D)).astype(np.float32)
    b0 = rng.standard_normal((B, F, D)).astype(np.float32)
    w = (rng.standard_normal((H * F, L)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(L) * 0.1).astype(np.float32)
    return a, b0, w, bias


def _jax(a, b0, w, bias, dtype=jnp.float32):
    """numpy (B, ·, D) → JAX batch-minor (·, D, B)."""
    return (jnp.asarray(a.transpose(1, 2, 0), dtype),
            jnp.asarray(b0.transpose(1, 2, 0), dtype),
            jnp.asarray(w), jnp.asarray(bias))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _hidden_np(h):
    """JAX hidden (nh, D, B) → (B, nh, D)."""
    return np.asarray(h, np.float32).transpose(2, 0, 1)


@pytest.mark.parametrize("H,F,D,B,L,nh,pool_all", POOLED_CASES)
def test_cin_layer_pooled_matches_jax(H, F, D, B, L, nh, pool_all):
    a, b0, w, bias = _inputs(H, F, D, B, L)
    jh, jp = jax_cin.cin_layer_pooled(*_jax(a, b0, w, bias), n_hidden=nh,
                                      pool_all=pool_all)
    ref = np.asarray(jax_cin.cin_layer_reference(*_jax(a, b0, w, bias)))
    ps = 0 if pool_all else nh
    th, tp = cin_layer_pooled(*_torch(a, b0, w, bias), n_hidden=nh,
                              pool_all=pool_all)
    assert tp.shape == (B, L - ps) and tp.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp).T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), ref[ps:].sum(axis=1).T, rtol=1e-5, atol=1e-5)
    if nh:
        assert th.shape == (B, nh, D) and th.is_contiguous()
        np.testing.assert_allclose(th.numpy(), _hidden_np(jh), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(th.numpy(), _hidden_np(ref[:nh]), rtol=1e-5, atol=1e-5)
    else:
        assert th is None and jh is None


@pytest.mark.parametrize("H,F,D,B,L", [(5, 7, 4, 16, 6), (7, 7, 16, 128, 100),
                                       (7, 7, 10, 16, 100)])
def test_cin_layer_matches_jax(H, F, D, B, L):
    a, b0, w, bias = _inputs(H, F, D, B, L, seed=1)
    want = _hidden_np(jax_cin.cin_layer(*_jax(a, b0, w, bias)))
    got = cin_layer(*_torch(a, b0, w, bias))
    assert got.shape == (B, L, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), _hidden_np(jax_cin.cin_layer_reference(*_jax(a, b0, w, bias))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,F,D,B,L,nh,pool_all", [
    (7, 7, 16, 128, 100, 50, False),
    (5, 7, 4, 16, 6, 3, False),
    (7, 7, 10, 16, 100, 0, True),
])
def test_cin_layer_pooled_bf16_policy(H, F, D, B, L, nh, pool_all):
    """bf16 operands, f32 accumulation: the JAX kernel's order (operands
    cast, then the product). Inputs are bf16 values on both sides, as the
    JAX kernel takes them under the bf16 policy."""
    a, b0, w, bias = _inputs(H, F, D, B, L, seed=2)
    a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    b0 = np.asarray(jnp.asarray(b0, jnp.bfloat16), np.float32)
    io = jax_cin.cin_io_dtype(D, B, "bfloat16")
    jh, jp = jax_cin.cin_layer_pooled(*_jax(a, b0, w, bias, io), mxu_dtype="bfloat16",
                                      n_hidden=nh, pool_all=pool_all)
    th, tp = cin_layer_pooled(*_torch(a, b0, w, bias), mxu_dtype=torch.bfloat16,
                              n_hidden=nh, pool_all=pool_all)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp).T, rtol=0.1, atol=0.3)
    if nh:
        np.testing.assert_allclose(th.numpy(), _hidden_np(jh), rtol=0.1, atol=0.15)
    # and it is really the bf16 arithmetic, not the f32 one
    _, tp32 = cin_layer_pooled(*_torch(a, b0, w, bias), n_hidden=nh, pool_all=pool_all)
    assert not torch.equal(tp, tp32)
    plain = cin_layer_plain(*_torch(a, b0, w, bias), mxu_dtype="bfloat16")
    ps = 0 if pool_all else nh
    assert torch.equal(tp, plain[:, ps:].sum(dim=2))


def test_cpu_tensors_take_the_plain_version():
    a, b0, w, bias = _torch(*_inputs(7, 7, 10, 12, 20, seed=3))
    before = (cin_layer_pooled.launches, cin_layer.launches)
    got = cin_layer_pooled(a, b0, w, bias, n_hidden=10)
    want = cin_layer_pooled_plain(a, b0, w, bias, n_hidden=10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(cin_layer(a, b0, w, bias), cin_layer_plain(a, b0, w, bias))
    assert (cin_layer_pooled.launches, cin_layer.launches) == before == (0, 0)
    with pytest.raises(ValueError, match="do not agree"):
        cin_layer_pooled(a, b0[:, :3], w, bias)
    with pytest.raises(ValueError, match="n_hidden"):
        cin_layer_pooled(a, b0, w, bias, n_hidden=21)
    with pytest.raises(ValueError, match="mxu_dtype"):
        cin_layer_pooled(a, b0, w, bias, mxu_dtype="float16")


# The forward kernel's launch geometry is Python (`fwd_geometry`): blocks of
# `tb` batch rows, passes of `cols` columns. The shapes (B, H, F, D, L) are
# `chip_smoke.py`'s CIN_CASES, then the edges of the geometry: L = 128 / 129
# / 200, D = 1 / 7 / 128, B = 1.
FWD_GEOMETRY_CASES = [
    (8192, 7, 7, 10, 100), (8192, 50, 7, 10, 100), (1000, 7, 7, 10, 100),
    (4096, 50, 7, 16, 100), (512, 50, 39, 10, 100), (256, 39, 39, 10, 100),
    (37, 50, 7, 10, 100), (1000, 50, 7, 10, 100), (300, 7, 7, 7, 33),
    (301, 16, 7, 7, 33), (37, 7, 7, 7, 33), (1000, 100, 7, 10, 100),
    (1000, 50, 7, 10, 128), (500, 50, 7, 10, 129), (700, 50, 7, 10, 200),
    (300, 50, 7, 1, 100), (300, 50, 7, 7, 100), (20, 50, 7, 128, 100),
    (1, 50, 7, 10, 100), (1, 7, 7, 128, 200),
]


def _exact(B, H, F, D, L, seed):
    """Integer inputs: every product and sum exact in f32, in any order."""
    rng = np.random.default_rng(seed)
    return _torch(rng.integers(-1, 2, (B, H, D)).astype(np.float32),
                  rng.integers(-1, 2, (B, F, D)).astype(np.float32),
                  rng.integers(-2, 3, (H * F, L)).astype(np.float32),
                  rng.integers(-3, 4, L).astype(np.float32))


@pytest.mark.parametrize("B,H,F,D,L", FWD_GEOMETRY_CASES)
def test_fwd_geometry_covers_each_row_and_column_once_in_order(B, H, F, D, L):
    """The plain forward computed tile by tile over the geometry's blocks of
    batch rows and passes of columns, then assembled, equals the whole
    layer (two full blocks and a ragged one where B allows)."""
    geo = cin_fused.fwd_geometry(B, H, F, D, L)
    assert 0 < geo.tb * D <= cin_fused.FWD_ROWS
    assert geo.smem == cin_fused.fwd_smem(geo.tb, H, F, D, L) <= cin_fused.MAX_SMEM == 232448
    assert geo.cols in (32, 64, 112, 128) and geo.cols >= min(L, 128)
    assert geo.passes == -(-L // geo.cols) and (L <= 128) == (geo.passes == 1)
    # the published widths keep two blocks an SM
    if (H, F, D, L) == (50, 7, 10, 100) and B >= 12:
        assert geo.tb == 12 and 2 * (geo.smem + 1024) <= 233472
    b = min(B, 2 * geo.tb + max(1, geo.tb // 2))
    a, b0, w, bias = _exact(b, H, F, D, L, seed=B + L)
    rows = []
    for i in range(-(-b // geo.tb)):
        rb = slice(i * geo.tb, min(b, (i + 1) * geo.tb))
        rows.append(torch.cat([
            cin_layer_plain(a[rb], b0[rb], w[:, p * geo.cols:(p + 1) * geo.cols],
                            bias[p * geo.cols:(p + 1) * geo.cols])
            for p in range(geo.passes)], dim=1))
    assert torch.equal(torch.cat(rows), cin_layer_plain(a, b0, w, bias))


def test_fwd_geometry_refuses_what_one_launch_cannot_take():
    with pytest.raises(ValueError, match="D=129"):
        cin_fused.fwd_geometry(8, 3, 3, 129, 10)
    with pytest.raises(ValueError, match="shared memory"):
        cin_fused.fwd_geometry(8, 1000, 39, 100, 100)
    # F = 39 (W 1950 × 100) keeps whole rows in shared memory
    assert cin_fused.fwd_geometry(512, 50, 39, 10, 100).tb >= 1


# Layers one launch does not take go through several, over spans of D
# (`fwd_plan`); only a pair axis whose offset table alone exceeds shared
# memory is refused.
FWD_SPLIT_CASES = [
    # B, H, F, D, L, n_hidden, ps, spans
    (5, 7, 7, 200, 100, 50, 50, ((0, 100), (100, 200))),
    (9, 16, 7, 200, 200, 200, 0, ((0, 100), (100, 200))),
    (4, 350, 7, 128, 100, 50, 50, ((0, 64), (64, 128))),
    (3, 5, 3, 300, 20, 20, 20, ((0, 100), (100, 200), (200, 300))),
    (6, 50, 7, 10, 100, 0, 0, ((0, 10),)),
]


@pytest.mark.parametrize("B,H,F,D,L,nh,ps,spans", FWD_SPLIT_CASES)
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_forward_split_over_d_spans_equals_the_whole_layer(B, H, F, D, L, nh, ps, spans, mxu):
    """`forward_split` with the plain version as its launch: the hidden
    spans joined and the pooled parts added equal the whole plain layer,
    bit for bit on integer inputs and to 1e-5 on random ones."""
    assert cin_fused.fwd_plan(B, H, F, D, L) == spans

    def plain(a, b0, w, bias, mxu_dtype, n_hidden, pool_start):
        o = cin_layer_plain(a, b0, w, bias, mxu_dtype)
        return o[:, :n_hidden].contiguous(), o[:, pool_start:].sum(dim=2)

    for exact in (True, False):
        inputs = _exact(B, H, F, D, L, seed=D) if exact else _torch(*_inputs(H, F, D, B, L, seed=D))
        got = cin_fused.forward_split(*inputs, mxu, nh, ps, plain)
        want = plain(*inputs, mxu, nh, ps)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            if exact:
                assert torch.equal(g, w)
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_fwd_plan_refuses_only_what_no_span_fits():
    assert cin_fused.fwd_plan(8192, 100, 7, 200, 200) == ((0, 100), (100, 200))
    with pytest.raises(ValueError, match="no span of D fits"):
        cin_fused.fwd_plan(8, 1000, 39, 100, 100)   # a 39,000-pair offset table


def test_kernel_route_refuses_what_it_cannot_take():
    """The kernel route raises on tensors that are not on the card instead
    of falling back, and importing the op builds nothing."""
    from oovrec_tpu_torch.utils import cuda_build

    a, b0, w, bias = _torch(*_inputs(3, 3, 4, 5, 6, seed=4))
    with pytest.raises(ValueError, match="must lie on"):
        cin_fused._launch(a, b0, w, bias, "float32", 3, 3)
    assert "cin_fused" not in cuda_build.LIBRARIES._libs

"""The port's fused top-k (plain version, as the CPU runs it) against the
JAX Pallas kernel in interpret mode.

Values agree to rtol/atol 1e-5: the f32 dot products are summed in another
order. Indices match exactly on tie-free inputs. Dead slots (a user with
fewer than k live items) carry no meaning in either package: both give
them a value ≤ NEG_INF, and the JAX kernel repeats one index there.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.ops import topk_score as jax_topk  # noqa: E402
from oovrec_tpu_torch.ops import topk_score  # noqa: E402
from oovrec_tpu_torch.ops.topk_score import (  # noqa: E402
    NEG_INF,
    build_hist_bitmap,
    fused_topk_scores,
    fused_topk_scores_plain,
    pack_bitplane,
    unpack_bitmap,
)

TN = 256  # the JAX kernel's item tile in these tests (its own layout knob)


def _inputs(B, N, D, seed, tied=False):
    rng = np.random.default_rng(seed)
    if tied:  # small integers: exact dot products, ties everywhere
        u = rng.integers(-1, 2, size=(B, D)).astype(np.float32)
        it = rng.integers(0, 2, size=(N, D)).astype(np.float32)
    else:
        u = rng.standard_normal((B, D)).astype(np.float32)
        it = rng.standard_normal((N, D)).astype(np.float32)
    H = min(5, N - 1)
    hist = np.zeros((B, H), np.int64)
    hist_len = rng.integers(0, H + 1, B)
    for b in range(B):
        hist[b, : hist_len[b]] = rng.choice(np.arange(1, N), hist_len[b], replace=False)
    return u, it, hist, hist_len


def _jax(u, it, hist, hist_len, k, exclude_col0):
    N = it.shape[0]
    bm = jax_topk.build_hist_bitmap(
        jnp.asarray(hist), jnp.asarray(hist_len), N, tn=TN, exclude_col0=exclude_col0
    )
    v, i = jax_topk.fused_topk_scores(
        jnp.asarray(u), jnp.asarray(it), bm, k=k, tn=TN, interpret=True
    )
    return np.asarray(v), np.asarray(i)


def _port(u, it, hist, hist_len, k, exclude_col0):
    bm = build_hist_bitmap(
        torch.from_numpy(hist), torch.from_numpy(hist_len), it.shape[0],
        exclude_col0=exclude_col0,
    )
    v, i = fused_topk_scores(torch.from_numpy(u), torch.from_numpy(it), bm, k=k)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("exclude_col0", [True, False])
@pytest.mark.parametrize(
    "B,N,D,k", [(8, 300, 32, 10), (13, 1000, 64, 20), (5, 12, 16, 20)]
)
def test_plain_matches_jax_kernel(B, N, D, k, exclude_col0):
    u, it, hist, hist_len = _inputs(B, N, D, seed=B * N)
    jv, ji = _jax(u, it, hist, hist_len, k, exclude_col0)
    pv, pi = _port(u, it, hist, hist_len, k, exclude_col0)
    assert pv.shape == jv.shape == (B, k) and pi.dtype == np.int32
    live = jv > NEG_INF / 2
    np.testing.assert_array_equal(live, pv > NEG_INF / 2)
    np.testing.assert_allclose(pv[live], jv[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pi[live], ji[live])
    if N < k:  # dead slots: the lowest excluded items, then indices past N
        assert (~live).any()
        assert (pv[~live] <= NEG_INF).all()
        for b in range(B):
            dead = pi[b][~live[b]]
            assert len(set(dead.tolist())) == len(dead)


def test_ties_go_to_lowest_index():
    B, N, D, k = 6, 500, 8, 20
    u, it, hist, hist_len = _inputs(B, N, D, seed=3, tied=True)
    jv, ji = _jax(u, it, hist, hist_len, k, True)
    pv, pi = _port(u, it, hist, hist_len, k, True)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pi, ji)
    scores = u @ it.T
    scores[:, 0] = NEG_INF
    for b in range(B):
        scores[b, hist[b, : hist_len[b]]] = NEG_INF
    ref = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(pi, ref)
    assert len(np.unique(scores[0])) < N // 10  # the case is really tied


@pytest.mark.parametrize("exclude_col0", [True, False])
def test_bitmap_exclusion_matches_jax(exclude_col0):
    """Same excluded items as the JAX bit-plane bitmaps, item by item."""
    N = 1000
    _, _, hist, hist_len = _inputs(7, N, 4, seed=5)
    jbm = np.asarray(jax_topk.build_hist_bitmap(
        jnp.asarray(hist), jnp.asarray(hist_len), N, tn=TN,
        exclude_col0=exclude_col0,
    ))
    word, bit = jax_topk._plane_coords(jnp.arange(N), jax_topk._resolve_tn(TN, N))
    jax_mask = (jbm[:, np.asarray(word)] >> np.asarray(bit)) & 1
    port = unpack_bitmap(build_hist_bitmap(
        torch.from_numpy(hist), torch.from_numpy(hist_len), N,
        exclude_col0=exclude_col0,
    ), N)
    np.testing.assert_array_equal(port.numpy(), jax_mask.astype(bool))

    mask = np.random.default_rng(6).random(N) < 0.3
    jp = np.asarray(jax_topk.pack_bitplane(jnp.asarray(mask), TN))
    jax_packed = ((jp[np.asarray(word)] >> np.asarray(bit)) & 1).astype(bool)
    port_packed = unpack_bitmap(pack_bitplane(torch.from_numpy(mask))[None, :], N)[0]
    np.testing.assert_array_equal(port_packed.numpy(), jax_packed)
    np.testing.assert_array_equal(jax_packed, mask)


def test_cpu_tensors_take_the_plain_version():
    u, it, hist, hist_len = _inputs(4, 100, 8, seed=9)
    bm = build_hist_bitmap(torch.from_numpy(hist), torch.from_numpy(hist_len), 100)
    before = fused_topk_scores.launches
    got = fused_topk_scores(torch.from_numpy(u), torch.from_numpy(it), bm, k=7)
    want = fused_topk_scores_plain(torch.from_numpy(u), torch.from_numpy(it), bm, k=7)
    assert fused_topk_scores.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="bitmap shape"):
        fused_topk_scores(torch.from_numpy(u), torch.from_numpy(it), bm[:, :1], k=7)


def test_module_imports_no_kernel_toolchain():
    """Importing the op builds nothing: the library loads on first launch."""
    from oovrec_tpu_torch.utils import cuda_build

    assert "topk_score" not in cuda_build.LIBRARIES._libs
    assert topk_score.NEG_INF == jax_topk.NEG_INF
    assert jax.devices()[0].platform == "cpu"

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


# The kernel's own output has a plain version: per-range candidates over the
# wrapper's split of the item axis, then the wrapper's merge.
RANGE_CASES = [
    # name, B, N, D, k, n_sm, tied, n_hist
    ("ties-across-ranges", 6, 700, 8, 20, 40, True, 5),
    ("dead-slots", 5, 90, 8, 20, 132, False, 80),
    ("n-below-k", 6, 13, 16, 20, 132, False, 5),
    ("k1", 9, 900, 8, 1, 64, False, 5),
    ("k100", 4, 1500, 8, 100, 64, False, 5),
    ("k512", 3, 1300, 8, 512, 132, False, 5),
    ("k512-n-below-k", 3, 300, 8, 512, 132, False, 5),
    ("B1", 1, 1000, 8, 20, 132, False, 5),
    ("B257", 257, 700, 8, 20, 132, True, 5),
]


def _hist_inputs(B, N, D, seed, tied, n_hist):
    u, it, _, _ = _inputs(B, N, D, seed, tied)
    rng = np.random.default_rng(seed + 1)
    H = min(n_hist, N - 1)
    hist = np.zeros((B, H), np.int64)
    hist_len = rng.integers(H // 2, H + 1, B)
    for b in range(B):
        hist[b, : hist_len[b]] = rng.choice(np.arange(1, N), hist_len[b], replace=False)
    return u, it, hist, hist_len


@pytest.mark.parametrize("name,B,N,D,k,n_sm,tied,n_hist", RANGE_CASES,
                         ids=[c[0] for c in RANGE_CASES])
def test_range_candidates_merge_to_plain_and_jax(name, B, N, D, k, n_sm, tied, n_hist):
    u, it, hist, hist_len = _hist_inputs(B, N, D, B * N + k, tied, n_hist)
    bm = build_hist_bitmap(torch.from_numpy(hist), torch.from_numpy(hist_len), N)
    users = topk_score.K_CLASSES[topk_score.k_class(k, D)][0]
    n_tiles, n_ranges = topk_score.range_split(N, k, users, B, n_sm)
    ut, itt = torch.from_numpy(u), torch.from_numpy(it)
    cand_v, cand_i = topk_score.range_candidates_plain(ut, itt, bm, k, n_tiles, n_ranges)
    assert cand_v.shape == cand_i.shape == (n_ranges, B, k) and cand_i.dtype == torch.int32

    bounds = topk_score.range_bounds(n_tiles, n_ranges)
    assert bounds[0][0] == 0 and bounds[-1][1] == n_tiles * topk_score.TILE_ITEMS >= max(N, k)
    for r, (lo, hi) in enumerate(bounds):  # contiguous, ascending, k indices each
        assert hi - lo >= k and (r == 0 or lo == bounds[r - 1][1])
        assert ((cand_i[r] >= lo) & (cand_i[r] < hi)).all()
        v, i = cand_v[r], cand_i[r]  # score desc, then index asc
        assert ((v[:, :-1] > v[:, 1:]) | ((v[:, :-1] == v[:, 1:]) & (i[:, :-1] < i[:, 1:]))).all()

    got_v, got_i = topk_score.merge_candidates(cand_v, cand_i, k)
    want_v, want_i = fused_topk_scores_plain(ut, itt, bm, k)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)

    if name == "ties-across-ranges":  # a tied value's picks come from two ranges
        assert n_ranges > 1
        starts = torch.tensor([lo for lo, _ in bounds])
        rng_of = torch.searchsorted(starts, got_i.long(), right=True)
        assert any(len(set(rng_of[b][got_v[b] == val].tolist())) > 1
                   for b in range(B) for val in got_v[b].unique())
    if name == "dead-slots":
        assert (got_v <= NEG_INF).any()
    if N < k:
        assert (got_i[:, N:] == torch.arange(N, k, dtype=torch.int32)).all()

    tn = 1024 if k > TN else TN
    jbm = jax_topk.build_hist_bitmap(jnp.asarray(hist), jnp.asarray(hist_len), N, tn=tn)
    jv, ji = jax_topk.fused_topk_scores(jnp.asarray(u), jnp.asarray(it), jbm, k=k, tn=tn,
                                        interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    live = jv > NEG_INF / 2
    np.testing.assert_array_equal(live, got_v.numpy() > NEG_INF / 2)
    np.testing.assert_allclose(got_v.numpy()[live], jv[live], rtol=1e-5, atol=1e-5)
    if tied:  # integer scores: exact, and the JAX kernel also takes ties lowest-first
        np.testing.assert_array_equal(got_v.numpy()[live], jv[live])
    np.testing.assert_array_equal(got_i.numpy()[live], ji[live])


def test_k_class_and_range_split_limits():
    """The k classes hold k up to 1024 and shrink the user tile for large k
    or a deep D, then stream it; ranges are at most one per SM and user
    tile."""
    assert topk_score.k_class(20, 64) == 0 and topk_score.k_class(100, 64) == 1
    assert topk_score.k_class(512, 64) == 2 and topk_score.k_class(20, 160) == 1
    assert topk_score.k_class(513, 64) == 3 and not topk_score.stream_users(3, 64)
    with pytest.raises(ValueError, match="k=1025"):
        topk_score.k_class(1025, 64)
    assert all(topk_score.kernel_smem_bytes(c, 64) <= topk_score.MAX_SMEM for c in range(4))
    n_tiles, n_ranges = topk_score.range_split(1_000_000, 20, 128, 256, n_sm=132)
    assert (n_tiles, n_ranges) == (7813, 66)
    assert topk_score.range_split(13, 20, 128, 6) == (1, 1)
    assert topk_score.range_split(1300, 512, 16, 3) == (11, 2)

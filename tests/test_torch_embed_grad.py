"""`oovrec_tpu_torch/ops/embed_grad.py` against `oovrec_tpu/ops/embed_grad.py`.

The same tables, ids and cotangents (numpy, from a seed) go through the
JAX gathers (their CPU backward, the scatter-add) and the port's (the
CUDA kernel's wrapper takes its plain version on the CPU): the forward
exactly, the table gradient to 1e-6 on random cotangents and bit for bit
on integer-valued ones, for 1-D ids, 2-D ids, ids all 0 (the bucket-0 rows
of branchless routing) and offset-packed field ids, with int64 and int32
ids, without `live` and with dead rows whose cotangent is zero (what
`route`'s select leaves them). Then `live`: the rows it marks dead add
nothing, and `route` with that discard gives the gradient it gives
without it, bit for bit on integer-valued inputs; and the CUDA kernel's
sort, chunk and run logic on both routes (a plan, a call's own sort),
followed step by step in numpy, equals the plain version bit for bit on
integers and to 1e-6 on random cotangents.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.ops.embed_grad import gather_rows as jax_gather_rows  # noqa: E402
from oovrec_tpu.ops.embed_grad import packed_gather as jax_packed_gather  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.inductive.routing import route  # noqa: E402
from oovrec_tpu_torch.ops import embed_grad  # noqa: E402

# (n_rows, D, ids shape, ids drawn from [0, high)); high 1: every id is 0
CASES = {
    "1d": (50, 8, (300,), 50),
    "2d": (40, 5, (64, 3), 40),
    "all-zero": (16, 7, (513,), 1),
    "few-rows": (3, 4, (1000,), 3),
}


def _inputs(case, integer):
    n, d, shape, high = CASES[case]
    rng = np.random.default_rng(7)
    ids = rng.integers(0, high, shape).astype(np.int64)
    if integer:
        table = rng.integers(-8, 9, (n, d)).astype(np.float32)
        g = rng.integers(-8, 9, shape + (d,)).astype(np.float32)
    else:
        table = rng.standard_normal((n, d)).astype(np.float32)
        g = rng.standard_normal(shape + (d,)).astype(np.float32)
    return table, ids, g


def _port_grad(fn, table, g):
    t = torch.from_numpy(table).requires_grad_()
    out = fn(t)
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    return out.detach().numpy(), grad.numpy()


def _port_ids_live(ids, g, dtype, with_live):
    """The port's ids in `dtype` and, under `with_live`, a `live` mask
    whose dead rows get a zero cotangent in `g` (so JAX's gradient, which
    sums every row, is the one to match)."""
    ids_t = torch.from_numpy(ids).to(dtype)
    if not with_live:
        return ids_t, None, g
    live = np.random.default_rng(13).random(ids.shape) < 0.6
    return ids_t, torch.from_numpy(live), np.where(live[..., None], g, 0).astype(np.float32)


LIVE = pytest.mark.parametrize("with_live", [False, True], ids=["all", "live"])
ID_DTYPES = pytest.mark.parametrize("dtype", [torch.int64, torch.int32],
                                    ids=["int64", "int32"])


@LIVE
@ID_DTYPES
@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("case", list(CASES))
def test_gather_rows_matches_jax(case, integer, dtype, with_live):
    table, ids, g = _inputs(case, integer)
    ids_t, live, g = _port_ids_live(ids, g, dtype, with_live)
    want_out = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(ids)))
    want_grad = np.asarray(jax.grad(
        lambda t: jnp.sum(jax_gather_rows(t, jnp.asarray(ids)) * g))(jnp.asarray(table)))
    out, grad = _port_grad(lambda t: embed_grad.gather_rows(t, ids_t, live), table, g)
    np.testing.assert_array_equal(out, want_out)
    if integer:
        np.testing.assert_array_equal(grad, want_grad)
    else:
        np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6)


@LIVE
@ID_DTYPES
@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
def test_packed_gather_matches_jax(integer, dtype, with_live):
    """Three fields packed into one table (a 2-row field repeats its rows
    a whole batch long), with their offsets."""
    dims, D, B = (30, 2, 9), 6, 400
    offsets = np.array((0, 30, 32), np.int64)
    rng = np.random.default_rng(11)
    raw = np.stack([rng.integers(0, d, B) for d in dims], axis=1)
    ids = (raw + offsets[None, :]).astype(np.int64)
    if integer:
        table = rng.integers(-8, 9, (sum(dims), D)).astype(np.float32)
        g = rng.integers(-8, 9, (B, 3, D)).astype(np.float32)
    else:
        table = rng.standard_normal((sum(dims), D)).astype(np.float32)
        g = rng.standard_normal((B, 3, D)).astype(np.float32)
    ids_t, live, g = _port_ids_live(ids, g, dtype, with_live)

    def jfn(t):
        return jax_packed_gather(t, jnp.asarray(ids.astype(np.int32)), dims, tuple(offsets))

    want_out = np.asarray(jfn(jnp.asarray(table)))
    want_grad = np.asarray(jax.grad(lambda t: jnp.sum(jfn(t) * g))(jnp.asarray(table)))
    out, grad = _port_grad(
        lambda t: embed_grad.packed_gather(t, ids_t, dims, offsets, live), table, g)
    np.testing.assert_array_equal(out, want_out)
    if integer:
        np.testing.assert_array_equal(grad, want_grad)
    else:
        np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6)


def test_packed_gather_refuses_mismatched_fields():
    t = torch.zeros((10, 2))
    with pytest.raises(ValueError, match="id columns"):
        embed_grad.packed_gather(t, torch.zeros((3, 2), dtype=torch.long), (10,), (0,))
    with pytest.raises(ValueError, match="rows"):
        embed_grad.packed_gather(t, torch.zeros((3, 2), dtype=torch.long), (4, 5), (0, 4))


@pytest.mark.parametrize("p_live", [0.0, 0.3, 1.0])
def test_live_rows_skipped(p_live):
    """With non-zero cotangents on the dead rows, the backward sums the
    live rows alone, and the same bits on a repeat."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 5, 200))
    live = torch.from_numpy(rng.random(200) < p_live)
    g = torch.from_numpy(rng.integers(-4, 5, (200, 3)).astype(np.float32))
    got = embed_grad.scatter_rows(g, ids, 5, live)
    again = embed_grad.scatter_rows(g, ids, 5, live)
    want = torch.zeros((5, 3)).index_add_(0, ids[live], g[live])
    assert torch.equal(got, want) and torch.equal(got, again)


def _radix_order(keys, end_bit, radix_bits=4):
    """The one-block sort's order (`csrc/embed_grad.cu:sort_block`, cub's
    BlockRadixSort, 4 bits a pass over the low `end_bit` bits): least
    significant digit first, each pass a stable counting sort, so equal
    keys keep their positions."""
    order = np.arange(len(keys))
    for bit in range(0, end_bit, radix_bits):
        digit = (keys[order] >> bit) & ((1 << radix_bits) - 1)
        order = order[np.argsort(digit, kind="stable")]
    return order


def _spans(sk, chunk, dead):
    """Each chunk's crossing runs, walked position by position: the first
    chunk of the run it begins inside, the last chunk of the run its last
    position goes on into (-1 for none)."""
    n = len(sk)
    out = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = y = -1
        if sk[s] != dead and s > 0 and sk[s - 1] == sk[s]:
            p = s
            while p > 0 and sk[p - 1] == sk[s]:
                p -= 1
            x = p // chunk
        if sk[e - 1] != dead and e < n and sk[e] == sk[e - 1]:
            p = e
            while p + 1 < n and sk[p + 1] == sk[e - 1]:
                p += 1
            y = p // chunk
        out.append((x, y))
    return np.array(out, np.int64).reshape(-1, 2)


def _kernel_steps(g, ids, live, n_rows, route):
    """`csrc/embed_grad.cu` step by step in numpy, by route: "plan" (the
    plan's stable order, PLAN_CHUNK) or "batch" (the keys live ? id :
    n_rows; at n <= SMALL_MAX the one-block radix sort over the bits in
    which the smallest and largest key differ and SMALL_CHUNK, the pass
    owning the table where n_rows <= n; above it the device-wide sort,
    LARGE_CHUNK, a zeroed table).
    `segment_pass`, for each slice of SLICE_FLOATS columns with its own
    counters: each chunk's run pieces summed in sorted order, a piece
    inside the chunk to out, the crossing ones to head[c] (the chunk's
    first piece, of a run begun before it) or tail[c] (its last, going
    on); a crossing run's last chunk to finish adds tail[c0] and head[c0 +
    1 .. c1] in chunk order. Where the pass owns the table the empty rows
    get their zeros; else out starts at 0."""
    n, d = g.shape
    keys = np.where(live, ids, n_rows).astype(np.int64)
    small = n <= embed_grad.SMALL_MAX
    if route == "plan":
        chunk, own = embed_grad.PLAN_CHUNK, True
        perm = np.argsort(keys, kind="stable")
    elif small:
        chunk, own = embed_grad.SMALL_CHUNK, n_rows <= n
        perm = _radix_order(keys, int(keys.min() ^ keys.max()).bit_length())
    else:
        chunk, own = embed_grad.LARGE_CHUNK, False
        perm = np.argsort(keys, kind="stable")
    sk = keys[perm]
    spans = _spans(sk, chunk, n_rows)
    out = np.full((n_rows, d), np.nan if own else 0, np.float32)
    n_chunks = len(spans)
    head = np.full((n_chunks, d), np.nan, np.float32)
    tail = np.full((n_chunks, d), np.nan, np.float32)
    width = embed_grad.SLICE_FLOATS
    count = np.zeros((-(-d // width), n_chunks), np.int64)

    def finish(c0, c1, key, cols, count):
        count[c0] += 1
        if count[c0] == c1 - c0 + 1:  # the run's last chunk to finish
            acc = tail[c0, cols].copy()
            for k in range(c0 + 1, c1 + 1):
                acc = acc + head[k, cols]
            out[key, cols] = acc
            count[c0] = 0

    # the slices, and in each the chunks in reverse: the last to finish is
    # not the run's last chunk
    for c, sl in ((c, sl) for sl in range(len(count)) for c in reversed(range(n_chunks))):
        cols = slice(sl * width, min(d, sl * width + width))
        s, e = c * chunk, min(c * chunk + chunk, n)
        if sk[s] == n_rows:
            continue
        (x, y), kf, kl = spans[c], sk[s], sk[e - 1]
        whole = x >= 0 and y >= 0 and kf == kl
        acc, key, first = np.zeros(d, np.float32)[cols], kf, True
        for p in range(s, e):
            if sk[p] != key:
                if first and x >= 0:
                    head[c, cols] = acc
                else:
                    out[key, cols] = acc
                first, acc, key = False, np.zeros(d, np.float32)[cols], sk[p]
            acc = acc + (g[perm[p], cols] if sk[p] != n_rows else np.float32(0))
        if key != n_rows:
            if first and x >= 0:
                head[c, cols] = acc
            elif y >= 0:
                tail[c, cols] = acc
            else:
                out[key, cols] = acc
        if x >= 0:
            finish(x, y if whole else c, kf, cols, count[sl])
        if y >= 0 and not whole:
            finish(c, y, kl, cols, count[sl])
    if own:
        offsets = np.searchsorted(sk, np.arange(n_rows + 1))
        out[offsets[:-1] == offsets[1:]] = 0
    assert not count.any()
    return out


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "random"])
@pytest.mark.parametrize("route", ["batch", "plan"])
@pytest.mark.parametrize("n,n_rows,d,high,p_live", [
    (8192, 64, 4, 1, 1.0),      # one run of 8,192 across the chunks
    (8192, 64, 4, 1, 0.0),      # all discarded: the IV rows' bucket 0
    (1000, 50, 3, 3, 0.7),      # a few long runs, ragged last chunk
    (777, 900, 5, 900, 0.9),    # spread ids, most runs inside a chunk; a memset table
    (31, 8, 2, 8, 1.0),         # fewer rows than a chunk
    (4096, 300, 1, 2, 0.5),     # D = 1 (the first-order twin)
    (20000, 70, 4, 70, 0.8),    # past the one-block sort: the device-wide sort
    (1500, 30, 1100, 30, 0.9),  # a row wider than a slice: three slices, their own counters
])
def test_kernel_steps_equal_the_plain_version(n, n_rows, d, high, p_live, route, integer):
    """The kernel's sort, chunk and run logic, followed in numpy on either
    route (with a plan every row is live), sums what the plain version
    sums: bit for bit on integer-valued cotangents; on random ones each
    element to 1e-6 of the sum of its terms' magnitudes (two float32
    summation orders differ by rounding that grows with that sum: a run of
    8,192 normals gives 2.4e-4 against 6,500); every position in exactly
    one piece, every crossing run completed once, every row written."""
    rng = np.random.default_rng(n + d)
    ids = rng.integers(0, high, n)
    live = np.ones(n, bool) if route == "plan" else rng.random(n) < p_live
    g = (rng.integers(-8, 9, (n, d)) if integer else rng.standard_normal((n, d))
         ).astype(np.float32)
    got = _kernel_steps(g, ids, live, n_rows, route)
    want = embed_grad.scatter_rows_plain(torch.from_numpy(g), torch.from_numpy(ids), n_rows,
                                         torch.from_numpy(live)).numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        size = embed_grad.scatter_rows_plain(torch.from_numpy(np.abs(g)), torch.from_numpy(ids),
                                             n_rows, torch.from_numpy(live)).numpy()
        assert (np.abs(got - want) <= 1e-6 * np.maximum(size, 1.0)).all()


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    g = torch.ones((4, 2))
    ids = torch.tensor([1, 1, 0, 3])
    got = embed_grad.scatter_rows_kernel(g, ids, 5, torch.tensor([True, True, False, True]))
    assert got.tolist() == [[0, 0], [2, 2], [0, 0], [1, 1], [0, 0]]
    assert embed_grad.scatter_rows_kernel.launches == 0


@pytest.mark.parametrize("embedder", [None, "slsh"], ids=["bucket", "slsh"])
def test_route_discard_keeps_the_gradient(embedder, monkeypatch):
    """`route`'s gradients through the IV and bucket tables with the
    discarded rows skipped equal those with every row summed, bit for bit
    on integer-valued tables and cotangents: IV rows (the bucket-0
    placeholder among them), flagged rows and ids past the vocabulary."""
    rng = np.random.default_rng(5)
    B, V, NB, D, F = 256, 20, 8, 4, 3
    ids = torch.from_numpy(rng.integers(0, V + 5, B))
    flags = torch.from_numpy((rng.random(B) < 0.3).astype(np.int64))
    buckets = torch.from_numpy(rng.integers(0, NB, B))
    buckets[flags == 0] = 0
    iv = torch.from_numpy(rng.integers(-8, 9, (V, D)).astype(np.float32))
    bt = torch.from_numpy(rng.integers(-8, 9, (NB, D)).astype(np.float32))
    g = torch.from_numpy(rng.integers(-8, 9, (B, D)).astype(np.float32))
    spec = InductiveSpec(mapper="random" if embedder is None else None, embedder=embedder,
                         add_oov_buckets=True, n_user_buckets=NB, n_item_buckets=NB)
    estate = {"user_feat_mat": torch.from_numpy(rng.standard_normal((V + 5, F)).astype(
                  np.float32)),
              "user_planes": torch.from_numpy(rng.standard_normal((3, F)).astype(np.float32))}

    def grads():
        a, b = iv.clone().requires_grad_(), bt.clone().requires_grad_()
        out = route(spec, "user", ids, flags, buckets, a, b, estate)
        return torch.autograd.grad(out, (a, b), g)

    skipped = grads()
    # the same backward with every row summed, the discarded ones included
    monkeypatch.setattr(embed_grad, "scatter_rows",
                        lambda g, ids, n_rows, live=None: embed_grad.scatter_rows_plain(
                            g, ids, n_rows))
    for got, want in zip(skipped, grads()):
        assert torch.equal(got, want)
    assert skipped[1].abs().sum() > 0  # the flagged rows reached the buckets

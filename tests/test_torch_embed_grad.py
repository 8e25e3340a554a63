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
chunk and run logic, followed step by step in numpy, equals the plain
version bit for bit.
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


def _kernel_steps(g, ids, live, n_rows, chunk):
    """`csrc/embed_grad.cu` step by step in numpy: keys (dead rows under
    n_rows), a stable sort, `segment_chunks` (run pieces of each chunk to
    out, head or tail) and `segment_runs` (a crossing run's owner chunk
    adds its tail and the heads of the chunks it covers, LANES-strided,
    then the lanes in order)."""
    n, d = g.shape
    keys = np.where(live, ids, n_rows)
    perm = np.argsort(keys, kind="stable")
    sk = keys[perm]
    out = np.zeros((n_rows, d), np.float32)
    n_chunks = -(-n // chunk)
    head = np.full((n_chunks, d), np.nan, np.float32)
    tail = np.full((n_chunks, d), np.nan, np.float32)
    for c in range(n_chunks):
        start, end = c * chunk, min(c * chunk + chunk, n)
        from_prev = start > 0 and sk[start - 1] == sk[start]
        into_next = end < n and sk[end] == sk[end - 1]
        first, acc = start, np.zeros(d, np.float32)
        for p in range(start, end + 1):
            if p == end or sk[p] != sk[first]:
                if sk[first] != n_rows:
                    if first == start and from_prev:
                        head[c] = acc
                    elif p == end and into_next:
                        tail[c] = acc
                    else:
                        out[sk[first]] = acc
                if p == end:
                    break
                first, acc = p, np.zeros(d, np.float32)
            acc = acc + g[perm[p]]
    for c in range(n_chunks):
        start, end = c * chunk, min(c * chunk + chunk, n)
        if end >= n:
            continue
        key = sk[end - 1]
        if key == n_rows or sk[end] != key or (start > 0 and sk[start - 1] == key
                                               and sk[start] == key):
            continue
        last_chunk = (np.searchsorted(sk, key, side="right") - 1) // chunk
        parts = [np.sum([head[k] for k in range(c + 1 + lane, last_chunk + 1, 8)]
                        or [np.zeros(d, np.float32)], axis=0, dtype=np.float32)
                 for lane in range(8)]
        total = tail[c].copy()
        for part in parts:
            total = total + part
        out[key] = total
    return out


@pytest.mark.parametrize("n,n_rows,d,high,p_live", [
    (8192, 64, 4, 1, 1.0),      # one run of 8,192 across 256 chunks
    (8192, 64, 4, 1, 0.0),      # all discarded: the IV rows' bucket 0
    (1000, 50, 3, 3, 0.7),      # a few long runs, ragged last chunk
    (777, 900, 5, 900, 0.9),    # spread ids, most runs inside a chunk
    (31, 8, 2, 8, 1.0),         # fewer rows than a chunk
    (4096, 300, 1, 2, 0.5),     # D = 1 (the first-order twin)
])
def test_kernel_steps_equal_the_plain_version(n, n_rows, d, high, p_live):
    """The kernel's chunk and run logic, followed in numpy, sums what the
    plain version sums, bit for bit on integer-valued cotangents: every
    position in exactly one piece, every crossing run completed once."""
    rng = np.random.default_rng(n + d)
    ids = rng.integers(0, high, n)
    live = rng.random(n) < p_live
    g = rng.integers(-8, 9, (n, d)).astype(np.float32)
    got = _kernel_steps(g, ids, live, n_rows, chunk=32)
    want = embed_grad.scatter_rows_plain(torch.from_numpy(g), torch.from_numpy(ids), n_rows,
                                         torch.from_numpy(live))
    np.testing.assert_array_equal(got, want.numpy())


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

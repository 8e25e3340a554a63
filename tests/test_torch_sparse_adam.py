"""The port's row-sparse Adam against the JAX package.

Kernel 6's plain version (`ops/sparse_rows.py`, what a CPU tensor runs)
against the JAX kernel in interpret mode and against
`sparse_adam_update_table(impl="xla")`, over 1 and 4 steps with duplicate
ids, an all-zero gradient row, the first and last table row and n = 1;
`coalesce_rows` against JAX's; the port's `sparse_adam_update_table`
(kernel route and plain route) against its own dense lazy-Adam rule; that
rule (`learner: sparse_adam`) against `optax.chain(scale_by_lazy_adam(),
scale(-lr))` with 1-D leaves, zero rows and a frozen stretch; the BPR
`_sparse_rows_<side>` override against the full model and the JAX
package's. Inputs come from numpy with a seed.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.inductive.spec import InductiveSpec as JaxSpec  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu.ops.sparse_rows import sparse_adam_rows_kernel as jax_rows_kernel  # noqa: E402
from oovrec_tpu.train import sparse_update as jsu  # noqa: E402
from oovrec_tpu.train.optimizers import scale_by_lazy_adam  # noqa: E402
from oovrec_tpu.train.trainer import _is_oov_param_path as jax_is_oov  # noqa: E402
from oovrec_tpu.train.trainer import _select_opt_state  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.models import BPR  # noqa: E402
from oovrec_tpu_torch.ops.sparse_rows import sparse_adam_rows_kernel  # noqa: E402
from oovrec_tpu_torch.train.optimizers import Optimizer  # noqa: E402
from oovrec_tpu_torch.train.sparse_update import (  # noqa: E402
    SparseTableState,
    coalesce_rows,
    gather_rows_for_batch,
    init_sparse_state,
    sparse_adam_update_table,
)
from oovrec_tpu_torch.train.trainer import _is_oov_param_path  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import state_dict_from_flax  # noqa: E402

from tests.test_torch_xdeepfm import _jax_batch, _torch_batch  # noqa: E402

V, D, LR = 40, 8, 1e-2
TOL = dict(rtol=1e-6, atol=1e-7)


def _ids(rng, case, n=12):
    """Row ids of one step: duplicates, an all-zero gradient row (position
    5), the first and last rows, or a single id."""
    if case == "n1":
        return np.array([int(rng.integers(0, V))], np.int64)
    ids = rng.integers(0, V, n)
    ids[3] = ids[0]
    ids[7] = ids[0]  # a run of three
    if case == "edges":
        ids[1], ids[2] = 0, V - 1
    return ids


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("case", ["dups-zero-row", "edges", "n1"])
def test_plain_kernel6_matches_jax_interpret_kernel_and_xla(case, steps):
    rng = np.random.default_rng(0)
    table0 = rng.standard_normal((V, D)).astype(np.float32)
    # a non-zero start: moments as a trained table holds them
    mu0 = (rng.standard_normal((V, D)) * 0.01).astype(np.float32)
    nu0 = (rng.random((V, D)) * 1e-3).astype(np.float32)
    port = [_t(x) for x in (table0, mu0, nu0)]
    port_tab = [_t(x) for x in (table0, mu0, nu0)]
    jk = [jnp.asarray(x) for x in (table0, mu0, nu0)]
    jx_p, jx_s = jnp.asarray(table0), jsu.SparseTableState(jnp.asarray(mu0), jnp.asarray(nu0))
    for step in range(steps):
        count = 3 + step
        ids = _ids(rng, case)
        rows = rng.standard_normal((len(ids), D)).astype(np.float32)
        if len(ids) > 5:
            rows[5] = 0.0
        zero_alone = len(ids) > 5 and (ids == ids[5]).sum() == 1
        before = port[0][int(ids[5])].clone() if zero_alone else None

        # JAX: interpret-mode kernel on coalesced, 8-padded rows, and xla
        sid, g = jsu.coalesce_rows(jnp.asarray(ids, jnp.int32), jnp.asarray(rows))
        pad = (-sid.shape[0]) % 8
        sid_p = jnp.concatenate([sid, jnp.repeat(sid[-1:], pad)])
        g_p = jnp.concatenate([g, jnp.zeros((pad, D), g.dtype)])
        jk = list(jax_rows_kernel(*jk, sid_p, g_p, count, LR, interpret=True))
        jx_p, jx_s = jsu.sparse_adam_update_table(
            jx_p, jx_s, jnp.asarray(ids, jnp.int32), jnp.asarray(rows), jnp.int32(count), LR,
            impl="xla")

        # the port: kernel 6's plain version on its own coalesced rows, and
        # the table update's kernel route (the plain version on the CPU)
        psid, pg = coalesce_rows(_t(ids), _t(rows))
        out = sparse_adam_rows_kernel(*port, psid, pg, count, LR)
        assert all(o is t for o, t in zip(out, port))  # in place
        sparse_adam_update_table(port_tab[0], SparseTableState(*port_tab[1:]), _t(ids),
                                 _t(rows), count, LR, impl="pallas")
        if before is not None:
            assert torch.equal(port[0][int(ids[5])], before)  # bit-unchanged
    for got, want_k, want_x in zip(port, jk, (jx_p, jx_s.mu, jx_s.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
    for a, b in zip(port, port_tab):
        assert torch.equal(a, b)


def test_kernel6_wrapper_refuses_unsorted_ids_on_the_cpu():
    p = torch.zeros(V, D)
    with pytest.raises(ValueError, match="sorted"):
        sparse_adam_rows_kernel(p, p.clone(), p.clone(), _t([3, 1]), torch.ones(2, D), 1, LR)


@pytest.mark.parametrize("n,vocab", [(6, 10), (64, 5), (200, 150)])
def test_coalesce_rows_matches_jax(n, vocab):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, vocab, n)
    rows = rng.standard_normal((n, 5)).astype(np.float32)
    jsid, jg = jsu.coalesce_rows(jnp.asarray(ids, jnp.int32), jnp.asarray(rows))
    sid, g = coalesce_rows(_t(ids), _t(rows))
    np.testing.assert_array_equal(sid.numpy(), np.asarray(jsid))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    # every duplicate position carries its id's full sum
    for i in np.unique(ids):
        np.testing.assert_allclose(g.numpy()[sid.numpy() == i],
                                   np.broadcast_to(rows[ids == i].sum(0), ((ids == i).sum(), 5)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("steps", [1, 4])
def test_sparse_update_matches_the_dense_lazy_rule(impl, steps):
    """`sparse_adam_update_table` over (ids, row grads) == the port's dense
    `sparse_adam` rule over the equivalent dense gradient."""
    rng = np.random.default_rng(1)
    table0 = rng.standard_normal((V, D)).astype(np.float32)
    opt = Optimizer("sparse_adam", LR)
    dense = {"t": _t(table0)}
    state = opt.init(dense)
    sp = _t(table0)
    sps = init_sparse_state(sp)
    for _ in range(steps):
        ids = _ids(rng, "edges")
        rows = rng.standard_normal((len(ids), D)).astype(np.float32)
        rows[5] = 0.0
        g = torch.zeros(V, D).index_add_(0, _t(ids), _t(rows))
        opt.step(dense, {"t": g}, state)
        sp, sps = sparse_adam_update_table(sp, sps, _t(ids), _t(rows), state["count"], LR,
                                           impl=impl)
    np.testing.assert_allclose(sp.numpy(), dense["t"].numpy(), **TOL)
    np.testing.assert_allclose(sps.mu.numpy(), state["mu"]["t"].numpy(), **TOL)
    np.testing.assert_allclose(sps.nu.numpy(), state["nu"]["t"].numpy(), **TOL)


def test_lazy_adam_rule_matches_optax():
    """`learner: sparse_adam` == chain(scale_by_lazy_adam(), scale(-lr)):
    10 steps with zero rows in the 2-D leaves, an all-zero 1-D gradient
    (dense Adam still moves it) and a frozen stretch (only OOV leaves train,
    the shared count advances): parameters, moments and count."""
    shapes = {"a.weight": (6, 4), "b.oov_buckets.weight": (5, 3), "c.bias": (7,)}
    rng = np.random.default_rng(2)
    params0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    tx = optax.chain(scale_by_lazy_adam(), optax.scale(-LR))
    jp = {n: jnp.asarray(v) for n, v in params0.items()}
    js = tx.init(jp)
    opt = Optimizer("sparse_adam", LR)
    tp = {n: _t(v) for n, v in params0.items()}
    ts = opt.init(tp)
    for step in range(10):
        g = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        g["a.weight"][rng.random(6) < 0.4] = 0.0
        g["b.oov_buckets.weight"][step % 5] = 0.0
        if step % 3 == 2:
            g["c.bias"][:] = 0.0
        frozen = 4 <= step < 7
        mask = {n: (jax_is_oov([n]) if frozen else True) for n in shapes}
        updates, new = tx.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        updates = {n: u if mask[n] else jnp.zeros_like(u) for n, u in updates.items()}
        js = _select_opt_state(mask, js, new) if frozen else new
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, {n: _t(v) for n, v in g.items()}, ts,
                 trainable={n for n in shapes if _is_oov_param_path(n)} if frozen else None)
    assert ts["count"] == int(js[0].count) == 10
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts["mu"][n].numpy(), np.asarray(js[0].mu[n]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ts["nu"][n].numpy(), np.asarray(js[0].nu[n]), rtol=1e-6,
                                   atol=1e-9)


def _bpr_fixture():
    """The JAX test's BPR (50 users, 40 items, D = 8, 8 buckets a side) and
    batch: a duplicate user, OOV flags and buckets on all three columns."""
    spec = dict(mapper="random", add_oov_buckets=True, n_user_buckets=8, n_item_buckets=8)
    jm = jax_model_class("BPR")(n_users=50, n_items=40, embedding_size=8,
                                spec=JaxSpec(**spec, embedding_size=8))
    rng = np.random.default_rng(0)
    B = 16
    b = {
        "user_id": rng.integers(0, 50, B), "item_id": rng.integers(1, 40, B),
        "neg_item_id": rng.integers(1, 40, B), "weight": np.ones(B, np.float32),
    }
    b["user_id"][3] = b["user_id"][0]
    for f in ("user_id", "item_id", "neg_item_id"):
        b[f + "_oov"] = (rng.random(B) < 0.2).astype(np.int32)
        b[f + "_bucket"] = rng.integers(0, 8, B)
    params = jm.init(jax.random.key(0), _jax_batch(b), {}, method=jm.calculate_loss)["params"]
    model = BPR(50, 40, 8, InductiveSpec(**spec), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return jm, params, model, b


def test_sparse_rows_override_matches_full_model_and_jax():
    """Through the port's BPR with OOV routing and the JAX BPR's weights:
    the override gives the full model's loss, its row gradients scattered
    by the gathered ids are the dense table gradients, the bucket tables'
    gradients are unchanged, and all of it equals the JAX quantities of
    `test_sparse_rows_override_matches_full_model`."""
    jm, params, model, batch = _bpr_fixture()
    tmap = model.sparse_table_fields()
    jmap = jm.sparse_table_fields()
    assert {s: (n, list(f)) for s, (n, f) in tmap.items()} == \
        {s: (n, list(f)) for s, (n, f) in jmap.items()}

    tb = _torch_batch(batch)
    full = model.calculate_loss(tb)
    full_grads = dict(zip(
        [n for n, _ in model.named_parameters()],
        torch.autograd.grad(full, list(model.parameters()))))
    tparams = dict(model.named_parameters())
    rows, nb, gathered = gather_rows_for_batch(tparams, tb, tmap)
    for side, r in rows.items():
        nb["_sparse_rows_" + side] = r
    sparse = model.calculate_loss(nb)
    g_rows = dict(zip(rows, torch.autograd.grad(sparse, list(rows.values()), retain_graph=True)))
    g_buckets = torch.autograd.grad(sparse, [model.user_oov_buckets.weight])[0]
    np.testing.assert_allclose(float(sparse.detach()), float(full.detach()), rtol=1e-6)

    jrows, jnb, jgathered = jsu.gather_rows_for_batch(params, _jax_batch(batch), jmap)

    def jloss(rows, p):
        b2 = dict(jnb)
        for side in rows:
            b2["_sparse_rows_" + side] = rows[side]
        return jm.apply({"params": p}, b2, {}, method=jm.calculate_loss)

    jl, (jg_rows, jg_rest) = jax.value_and_grad(jloss, argnums=(0, 1))(jrows, params)
    np.testing.assert_allclose(float(sparse.detach()), float(jl), rtol=1e-6)
    for side, (name, fields) in tmap.items():
        np.testing.assert_array_equal(gathered[side].numpy(), np.asarray(jgathered[side]))
        for f in fields:
            np.testing.assert_array_equal(nb[f].numpy(), np.asarray(jnb[f]))
        np.testing.assert_allclose(g_rows[side].numpy(), np.asarray(jg_rows[side]),
                                   rtol=1e-5, atol=1e-6)
        scat = torch.zeros_like(tparams[name + ".weight"]).index_add_(
            0, gathered[side], g_rows[side])
        np.testing.assert_allclose(scat.numpy(), full_grads[name + ".weight"].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_buckets.numpy(), full_grads["user_oov_buckets.weight"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_buckets.numpy(),
                               np.asarray(jg_rest["user_oov_buckets"]["embedding"]),
                               rtol=1e-5, atol=1e-6)

"""LightGCN and the graph models against the JAX package, on the CPU:
LightGCN, NGCF, SGL, SpectralCF, GCMC, DGCF and NCL.

`segment_sum` (the edge propagation, `ops/embed_grad.py`) equals
`jax.ops.segment_sum` with repeated and absent destinations, int32 and
int64 ids, in value and in its gradient (exact on integers, 1e-6 on
floats). On the edges of a seeded split (30 users × 20 items, 150 draws,
LightGCN's `build_estate`, bit for bit with JAX's) each model at
embedding 8, with its flax params bridged into the port, gives JAX's
`predict`, `full_sort_scores`, loss and the gradient of every parameter to
1e-5 (dropout 0; SGL's loss on JAX's own edge masks, `loss_with_masks`);
SGL's masks in the port come from the trainer's dropout generator; NCL's
k-means equals JAX's `_kmeans`, its empty clusters at 0. DGCF refuses an
embedding size that `n_factors` does not divide. End to end on toy (RS
8:1:1, full sort), each model trains two epochs through `quick_start.run`
from the JAX run's initial weights: the epoch losses agree to 1e-5
relative, the valid and test metrics to 1e-5. `objective_function` runs
each of the fourteen general models of the slice.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu.models.general.more5 import NCL as JaxNCL  # noqa: E402
from oovrec_tpu_torch.models import get_model_class  # noqa: E402
from oovrec_tpu_torch.models.general.more5 import kmeans  # noqa: E402
from oovrec_tpu_torch.ops.embed_grad import segment_sum  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402

from tests.test_torch_cli import ASSETS  # noqa: E402
from tests.test_torch_seq_slice import _bridge  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N_USERS, N_ITEMS, D = 30, 20, 8


def _split(seed=4, n=150):
    rng = np.random.default_rng(seed)
    inter = {"user_id": rng.integers(1, N_USERS, n), "item_id": rng.integers(1, N_ITEMS - 1, n)}
    return types.SimpleNamespace(inter=inter, uid_field="user_id", iid_field="item_id",
                                 user_num=N_USERS, item_num=N_ITEMS)


ESTATE = jax_model_class("LightGCN").build_estate(_split())
MODELS = {
    "LightGCN": {},
    "NGCF": {"hidden_size_list": (8, 6), "message_dropout": 0.0},
    "SGL": {"drop_ratio": 0.3},
    "SpectralCF": {"n_layers": 3},
    "GCMC": {"gcn_output_dim": 6, "dropout_prob": 0.0},
    "DGCF": {"n_factors": 2, "n_layers": 2},
    "NCL": {"num_clusters": 4},
}


@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("values", ["integers", "floats"])
def test_segment_sum_matches_jax(ids, values):
    rng = np.random.default_rng(0)
    n, rows, width = 50, 12, 5
    dst = rng.integers(0, rows - 3, n).astype(ids)  # the last rows absent
    dst[:10] = 2  # a long run
    msg = (rng.integers(-4, 5, (n, width)) if values == "integers"
           else rng.standard_normal((n, width))).astype(np.float32)
    g = rng.standard_normal((rows, width)).astype(np.float32)
    want, vjp = jax.vjp(lambda m: jax.ops.segment_sum(m, jnp.asarray(dst), num_segments=rows),
                        jnp.asarray(msg))
    t = torch.from_numpy(msg).requires_grad_()
    got = segment_sum(t, torch.from_numpy(dst), rows)
    (grad,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    tol = dict(rtol=0, atol=0) if values == "integers" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    assert not got[rows - 3:].any()
    np.testing.assert_array_equal(grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_edges_match_jax():
    port = get_model_class("LightGCN").build_estate(_split())
    for k, v in ESTATE.items():
        assert port[k].dtype == v.dtype
        np.testing.assert_array_equal(port[k], v, err_msg=k)


def _batch(seed=1, B=9):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, N_USERS, B), "item_id": rng.integers(0, N_ITEMS, B),
            "neg_item_id": rng.integers(0, N_ITEMS, B),
            "label": (rng.random(B) < 0.5).astype(np.float32),
            "weight": np.r_[np.ones(B - 1), 0.0].astype(np.float32)}


def _both(name, batch, seed=0):
    """(JAX model, its params with the biases moved off 0, the port's
    model holding them and the edges)."""
    kw = MODELS[name]
    jm = jax_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, embedding_size=D, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    je = {k: jnp.asarray(v) for k, v in ESTATE.items()}
    params = jm.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)}, jb, je,
                     method=jm.calculate_loss)["params"]
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                         if getattr(path[-1], "key", "") == "bias" else 0),
        params)
    port = get_model_class(name)(N_USERS, N_ITEMS, embedding_size=D, device="cpu", **kw,
                                 **ESTATE)
    load_flax_params(port, params)
    return jm, params, je, port


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_outputs_match_jax(name):
    batch = _batch()
    jm, params, je, port = _both(name, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    port.eval()
    with torch.no_grad():
        for method in ("predict", "full_sort_scores"):
            want = np.asarray(jm.apply({"params": params}, jb, je, method=getattr(jm, method)))
            got = getattr(port, method)(_tb(batch)).numpy()
            np.testing.assert_allclose(got, want, err_msg=method, **TOL)
    assert _flat(flax_from_state_dict(port.state_dict(), port)).keys() == _flat(params).keys()


def _jax_masks(jm, params, jb, je, drop_ratio):
    """The two edge masks JAX's SGL loss draws under the dropout key 5."""
    k1 = jm.apply({"params": params}, jb, je, method=lambda m, *a: m.make_rng("dropout"),
                  rngs={"dropout": jax.random.key(5)})
    shape = ESTATE["edge_src"].shape
    return [np.asarray(jax.random.uniform(k, shape) > drop_ratio, np.float32)
            for k in (k1, jax.random.fold_in(k1, 1))]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_match_jax(name):
    batch = _batch(seed=2)
    jm, params, je, port = _both(name, batch, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jm.apply({"params": p}, jb, je, method=jm.calculate_loss,
                        rngs={"dropout": jax.random.key(5)})

    want, jgrads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
    port.train()
    named = list(port.named_parameters())
    tb = _tb(batch)
    if name == "SGL":
        m1, m2 = _jax_masks(jm, params, jb, je, MODELS[name]["drop_ratio"])
        assert 0 < m1.mean() < 1 and not np.array_equal(m1, m2)
        loss = port.loss_with_masks(tb, torch.from_numpy(m1), torch.from_numpy(m2))
    else:
        loss = port.calculate_loss(tb)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    pg = _flat(flax_from_state_dict({n: torch.zeros_like(p) if g is None else g
                                     for (n, p), g in zip(named, grads)}, port))
    jg = _flat(jgrads)
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k, **TOL)


def test_sgl_masks_come_from_the_dropout_generator():
    from oovrec_tpu_torch.models.layers import set_dropout_generator

    port = get_model_class("SGL")(N_USERS, N_ITEMS, embedding_size=D, device="cpu",
                                  drop_ratio=0.3, **ESTATE)
    tb = _tb(_batch())
    with pytest.raises(RuntimeError, match="explicit generator"):
        port.calculate_loss(tb)
    set_dropout_generator(port, torch.Generator().manual_seed(3))
    m = port.edge_masks()
    assert m.shape == (2, len(ESTATE["edge_src"])) and not torch.equal(m[0], m[1])
    set_dropout_generator(port, torch.Generator().manual_seed(3))
    assert torch.equal(m, port.edge_masks())
    assert torch.isfinite(port.calculate_loss(tb))


def test_kmeans_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    x[5:8] = x[0]  # ties: rows equal to the first centre
    x[1] = x[0]    # two equal centres: the ties go to 0, 1 is empty
    for iters in (1, 4):
        c, a = kmeans(torch.from_numpy(x), 6, iters)
        wc, wa = JaxNCL._kmeans(jnp.asarray(x), 6, iters)
        np.testing.assert_array_equal(a.numpy(), np.asarray(wa))
        np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=1e-6, atol=1e-6)
        if iters == 1:
            assert not c[1].any()


def test_dgcf_refuses_an_undivided_width():
    with pytest.raises(ValueError, match="not a multiple of n_factors"):
        get_model_class("DGCF")(N_USERS, N_ITEMS, embedding_size=6, n_factors=4,
                                device="cpu", **ESTATE)


def _cfg(model, **over):
    d = dict(model=model, dataset="toy", data_path=ASSETS, epochs=2, train_batch_size=8,
             eval_batch_size=64, embedding_size=8, log_tensorboard=False, seed=11,
             load_col={"inter": ["user_id", "item_id", "rating", "timestamp"]},
             eval_args={"split": {"RS": [8, 1, 1]}, "order": "RO", "group_by": "user",
                        "mode": "full"})
    d.update(over)
    return d


FITS = {
    "LightGCN": {},
    "NGCF": {"message_dropout": 0.0, "hidden_size_list": [8, 8]},
    "SGL": {"drop_ratio": 0.0},
    "SpectralCF": {},
    "GCMC": {"dropout_prob": 0.0, "gcn_output_dim": 8,
             "train_neg_sample_args": {"distribution": "uniform", "sample_num": 1}},
    "DGCF": {},
    "NCL": {"num_clusters": 3},
}


def _agree(a, b, tol, what):
    assert list(a) == list(b), what
    for k in a:
        assert abs(float(a[k]) - float(b[k])) <= tol, (what, k, a[k], b[k])


@pytest.mark.parametrize("name", sorted(FITS))
def test_run_matches_jax(name, tmp_path, monkeypatch):
    _bridge(monkeypatch)
    cfg = _cfg(name, **FITS[name])
    jres = jax_quick_start.run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / "jax")),
                               saved=False)
    pres = port_quick_start.run(config_dict=dict(cfg, device="cpu",
                                                 checkpoint_dir=str(tmp_path / "port")),
                                saved=False)
    jt, pt = jres["trainer"], pres["trainer"]
    assert list(pt.train_loss_dict) == list(jt.train_loss_dict) == [0, 1]
    for e, want in jt.train_loss_dict.items():
        np.testing.assert_allclose(pt.train_loss_dict[e], want, rtol=1e-5, err_msg=f"epoch {e}")
    _agree(jres["best_valid_result"], pres["best_valid_result"], 1e-5, "valid")
    _agree(jres["test_result"], pres["test_result"], 1e-5, "test")


SLICE = ["Pop", "Random", "ItemKNN", "EASE", "ADMMSLIM", "NCEPLRec", "SLIMElastic",
         "LightGCN", "NGCF", "SGL", "SpectralCF", "GCMC", "DGCF", "NCL"]


@pytest.mark.parametrize("name", SLICE)
def test_objective_function_runs(name, tmp_path):
    over = {"train_neg_sample_args": {"distribution": "uniform", "sample_num": 1}} \
        if name == "GCMC" else {}
    res = port_quick_start.objective_function(config_dict=_cfg(
        name, device="cpu", epochs=1, checkpoint_dir=str(tmp_path), **over))
    assert set(res) == {"best_valid_score", "valid_score_bigger", "best_valid_result",
                        "test_result"}
    for v in res["test_result"].values():
        assert 0.0 <= float(v) <= 1.0

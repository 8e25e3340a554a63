"""The pair and pointwise general models against the JAX package, on the
CPU: NeuMF, DMF, SimpleX, FISM, NAIS, LINE, ConvNCF and NNCF.

On a seeded training split (30 users × 20 items, 150 draws) the states
equal the JAX package's `build_estate` bit for bit: the padded history of
FISM, NAIS and ENMF at the default cap of 200 and at a cap of 3 that cuts
(the first items kept, in `used_ids_per_user` order), and NNCF's
neighbour sets (the port's reading `neigh_num` from the config, the JAX
`quick_start`'s always 8). Each model at embedding 8 and dropout 0, its flax
params bridged into the port, gives JAX's `predict`, `full_sort_scores`,
loss and the gradient of every parameter to 1e-5; the bridge's tree is
flax's, so LINE has no `user_ctx`, NeuMF with either tower off has no
tables of that tower, and ConvNCF's `out` kernel reads the flattened conv
map in flax's (H, W, C) order ((128, 1) at embedding 8; an odd embedding
of 7 takes flax's SAME padding). NAIS's, ConvNCF's and NNCF's full sorts,
over blocks of 3 items, equal JAX's vmap and the per-item definition. End
to end on toy (RS 8:1:1, full sort), each model trains two epochs through
`quick_start.run` from the JAX run's initial weights: the epoch losses
agree to 1e-5 relative, the valid and test metrics to 1e-5.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.data.dataset import DatasetSplit as JaxSplit  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu_torch.models import get_model_class  # noqa: E402
from oovrec_tpu_torch.models.general.base import padded_history  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402

from tests.test_torch_cli import ASSETS  # noqa: E402
from tests.test_torch_seq_slice import _bridge  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N_USERS, N_ITEMS, D = 30, 20, 8


class _Split(types.SimpleNamespace):
    used_ids_per_user = JaxSplit.used_ids_per_user


def make_split(seed=4, n=150):
    """Ids from 1 (0 pads), the last item never drawn, repeated pairs."""
    rng = np.random.default_rng(seed)
    inter = {"user_id": rng.integers(1, N_USERS, n), "item_id": rng.integers(1, N_ITEMS - 1, n)}
    return _Split(inter=inter, uid_field="user_id", iid_field="item_id", user_num=N_USERS,
                  item_num=N_ITEMS)


SPLIT = make_split()
# (model, constructor keywords, embedding size)
CASES = {
    "NeuMF": ("NeuMF", {"mlp_hidden_size": (8, 6), "dropout_prob": 0.0}, D),
    "NeuMF-gmf": ("NeuMF", {"mlp_train": False}, D),
    "NeuMF-mlp": ("NeuMF", {"mf_train": False, "mlp_hidden_size": (8, 6),
                            "dropout_prob": 0.0}, D),
    "DMF": ("DMF", {"user_hidden": (8, 6), "item_hidden": (8, 6)}, D),
    "SimpleX": ("SimpleX", {}, D),
    "FISM": ("FISM", {"alpha": 0.5}, D),
    "NAIS": ("NAIS", {"weight_size": 6, "alpha": 0.5}, D),
    "LINE": ("LINE", {}, D),
    "LINE-order1": ("LINE", {"order": 1}, D),
    "ConvNCF": ("ConvNCF", {"cnn_channels": (4, 3)}, D),
    "ConvNCF-odd": ("ConvNCF", {"cnn_channels": (4, 3)}, 7),
    "NNCF": ("NNCF", {"dropout_prob": 0.0, "mlp_hidden_size": (8, 6)}, D),
}
BLOCKED = ("NAIS", "ConvNCF", "ConvNCF-odd", "NNCF")


def _estate(name):
    cls = jax_model_class(name)
    return cls.build_estate(SPLIT) if hasattr(cls, "build_estate") else {}


ESTATES = {name: _estate(name) for name in {c[0] for c in CASES.values()}}


def _batch(seed=1, B=9):
    """Rows whose items lie in their users' histories (FISM's and NAIS's
    target left out), a padded last row."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1, N_USERS, B)
    hist = SPLIT.used_ids_per_user()
    items = np.array([hist[u][0] if len(hist[u]) and k % 2 else rng.integers(0, N_ITEMS)
                      for k, u in enumerate(users)])
    users[-1] = items[-1] = 0
    return {"user_id": users, "item_id": items, "neg_item_id": rng.integers(0, N_ITEMS, B),
            "label": (rng.random(B) < 0.5).astype(np.float32),
            "weight": np.r_[np.ones(B - 1), 0.0].astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _both(case, batch, seed=0):
    """(JAX model, its params with the biases moved off 0, its estate, the
    port's model holding them)."""
    name, kw, d = CASES[case]
    jm = jax_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, embedding_size=d, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    je = {k: jnp.asarray(v) for k, v in ESTATES[name].items()}
    params = jm.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)}, jb, je,
                     method=jm.calculate_loss)["params"]
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                         if "bias" in getattr(path[-1], "key", "") else 0),
        params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    port = get_model_class(name)(N_USERS, N_ITEMS, embedding_size=d, device="cpu", **kw,
                                 **ESTATES[name])
    load_flax_params(port, params)
    return jm, params, je, port


@pytest.mark.parametrize("max_len", [200, 3])
def test_padded_history_matches_jax(max_len):
    want = jax_model_class("FISM").build_estate(SPLIT, max_len=max_len)
    got = padded_history(SPLIT, max_len)
    assert want["hist_items"].shape[1] == (max_len if max_len == 3 else
                                          max(len(h) for h in SPLIT.used_ids_per_user()))
    for k in ("hist_items", "hist_len"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("FISM", "NAIS", "ENMF"):
        port = get_model_class(name).build_estate(SPLIT, None)
        for k in ("hist_items", "hist_len"):
            np.testing.assert_array_equal(port[k], ESTATES["FISM"][k])


@pytest.mark.parametrize("neigh_num", [8, 3])
def test_nncf_neighbors_match_jax(neigh_num):
    """Bit for bit at `neigh_num` (JAX by keyword, the port from the
    config); the JAX `quick_start` passes no config and always draws 8."""
    want = jax_model_class("NNCF").build_estate(SPLIT, neigh_num=neigh_num)
    got = get_model_class("NNCF").build_estate(SPLIT, {"neigh_num": neigh_num})
    for k in ("user_neighbors", "item_neighbors"):
        assert got[k].dtype == want[k].dtype and got[k].shape[1] == neigh_num
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got["item_neighbors"][N_ITEMS - 1].any()  # an item without rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_match_jax(case):
    batch = _batch()
    jm, params, je, port = _both(case, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    port.eval()
    with torch.no_grad():
        for method in ("predict", "full_sort_scores"):
            want = np.asarray(jm.apply({"params": params}, jb, je, method=getattr(jm, method)))
            got = getattr(port, method)(_tb(batch)).numpy()
            np.testing.assert_allclose(got, want, err_msg=method, **TOL)
    assert _flat(flax_from_state_dict(port.state_dict(), port)).keys() == _flat(params).keys()


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    batch = _batch(seed=2)
    jm, params, je, port = _both(case, batch, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jm.apply({"params": p}, jb, je, method=jm.calculate_loss,
                        rngs={"dropout": jax.random.key(5)})

    want, jgrads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
    port.train()
    named = list(port.named_parameters())
    loss = port.calculate_loss(_tb(batch))
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    pg = _flat(flax_from_state_dict({n: torch.zeros_like(p) if g is None else g
                                     for (n, p), g in zip(named, grads)}, port))
    jg = _flat(jgrads)
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k, **TOL)


def test_the_trees_are_flax_trees():
    trees = {case: set(_flat(flax_from_state_dict(port.state_dict(), port)))
             for case in ("LINE", "NeuMF-gmf", "NeuMF-mlp")
             for port in [_both(case, _batch())[3]]}
    assert not any("user_ctx" in k for k in trees["LINE"])
    assert any("item_ctx" in k for k in trees["LINE"])
    assert not any("mlp" in k for k in trees["NeuMF-gmf"])
    assert not any("_mf_" in k for k in trees["NeuMF-mlp"])
    # ConvNCF at its YAML channels: `out` reads 2 x 2 x 32 at embedding 8
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    jm = jax_model_class("ConvNCF")(n_users=N_USERS, n_items=N_ITEMS, embedding_size=D)
    params = jm.init({"params": jax.random.key(0)}, batch, {}, method=jm.calculate_loss)
    port = get_model_class("ConvNCF")(N_USERS, N_ITEMS, embedding_size=D, device="cpu")
    shapes = {k: v.shape for k, v in _flat(flax_from_state_dict(port.state_dict(), port)).items()}
    assert shapes == {k: v.shape for k, v in _flat(params["params"]).items()}
    assert shapes["['out']['kernel']"] == (128, 1)


def test_convncf_nested_layout_is_the_image():
    """Where 2^L divides D the outer product is laid out patch by patch
    (`nested_outer`): the same scores as the image through the padded
    patch convs, bit for bit."""
    port = get_model_class("ConvNCF")(N_USERS, N_ITEMS, embedding_size=16, device="cpu")
    rng = np.random.default_rng(8)
    u, i = (torch.from_numpy(rng.standard_normal((12, 16)).astype(np.float32)) for _ in "ui")
    assert port.nested
    with torch.no_grad():
        nested = port._pairs(u, i)
        port.nested = False
        image = port._pairs(u, i)
    assert torch.equal(nested, image)


def _per_item(port, batch):
    """(B, n_items) from the per-pair definition, one item at a time."""
    users = _tb(batch)["user_id"]
    cols = [port._score(users, torch.full_like(users, i)) for i in range(N_ITEMS)]
    return torch.stack(cols, dim=1)


@pytest.mark.parametrize("case", BLOCKED)
def test_blocked_full_sort_matches_the_vmap(case, monkeypatch):
    """One block at the default budget, then one item a block, then three
    (the last block short): each equals JAX's vmap, and so does the
    per-item definition."""
    batch = _batch(seed=3)
    jm, params, je, port = _both(case, batch, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jm.apply({"params": params}, jb, je, method=jm.full_sort_scores))
    port.eval()
    import oovrec_tpu_torch.models.base as base

    blocks, sizes, budgets = base.score_item_blocks, [], [base.FULL_SORT_ELEMS]

    def counted(n, per_item, device, score, budget=base.FULL_SORT_ELEMS):
        assert budget == base.FULL_SORT_ELEMS
        sizes.append((per_item, max(1, budgets[-1] // per_item)))
        return blocks(n, per_item, device, score, budget=budgets[-1])

    for module in ("more3", "more5"):
        monkeypatch.setattr(f"oovrec_tpu_torch.models.general.{module}.score_item_blocks",
                            counted)
    with torch.no_grad():
        got = [port.full_sort_scores(_tb(batch))]
        budgets.append(1)
        got.append(port.full_sort_scores(_tb(batch)))
        budgets.append(3 * sizes[0][0])
        got.append(port.full_sort_scores(_tb(batch)))
        per_item = _per_item(port, batch)
    assert [t for _, t in sizes][1:] == [1, 3] and sizes[0][1] >= N_ITEMS, sizes
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, **TOL)
    np.testing.assert_allclose(per_item.numpy(), want, **TOL)


def _cfg(model, **over):
    d = dict(model=model, dataset="toy", data_path=ASSETS, epochs=2, train_batch_size=8,
             eval_batch_size=64, embedding_size=8, log_tensorboard=False, seed=11,
             load_col={"inter": ["user_id", "item_id", "rating", "timestamp"]},
             eval_args={"split": {"RS": [8, 1, 1]}, "order": "RO", "group_by": "user",
                        "mode": "full"})
    d.update(over)
    return d


POINTWISE = {"train_neg_sample_args": {"distribution": "uniform", "sample_num": 1}}
FITS = {
    "NeuMF": {"dropout_prob": 0.0, "mlp_hidden_size": [8, 8], **POINTWISE},
    "DMF": {"user_hidden": [8], "item_hidden": [8], **POINTWISE},
    "SimpleX": {},
    "FISM": POINTWISE,
    "NAIS": {"weight_size": 8, **POINTWISE},
    "LINE": {},
    "ConvNCF": {"cnn_channels": [4, 4]},
    "NNCF": {"dropout_prob": 0.0, "mlp_hidden_size": [8, 8], **POINTWISE},
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
    assert type(pt.model).__name__ == name
    assert list(pt.train_loss_dict) == list(jt.train_loss_dict) == [0, 1]
    for e, want in jt.train_loss_dict.items():
        np.testing.assert_allclose(pt.train_loss_dict[e], want, rtol=1e-5, err_msg=f"epoch {e}")
    _agree(jres["best_valid_result"], pres["best_valid_result"], 1e-5, "valid")
    _agree(jres["test_result"], pres["test_result"], 1e-5, "test")

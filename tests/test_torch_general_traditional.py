"""The traditional general models against the JAX package, on the CPU:
Pop, Random, ItemKNN, EASE, ADMMSLIM, NCEPLRec and SLIMElastic.

On a seeded training split (60 users × 40 items, 500 draws, no row for
the padding ids 0 and none for item 39), each state equals the JAX
package's `build_estate` bit for bit, at its keyword defaults and at other
values passed by keyword, the port's `build_estate` reading those values
from the config. SLIMElastic's W (JAX: sklearn's ElasticNet, item by
item) holds to 2e-3 absolute, and each column's objective lies within its
duality tolerance (`tol`·‖y‖²) of sklearn's; the port's solve stops every
column by the rule. Each model's `predict` and `full_sort_scores` equal
JAX's on the same state (1e-6). Random gives uniform scores in [0, 1)
that repeat. The JAX driver ignores the config in the state (its fault 1,
ROADMAP §3): ItemKNN at `k: 1` builds the default similarity there. The
trainer's traditional branch: `quick_start.run` on toy gives the JAX
run's valid and test metrics (1e-9) and writes checkpoint 0, which
`--eval_only` restores. `perform_inductive_eval` refuses the model before
any work with the port's TypeError (JAX: an AttributeError from inside
its evaluator; for MultiVAE a TypeError where it rebuilds the model's
state over the inductive corpus). The refusal covers Pop, LightGCN,
MultiVAE and NeuMF.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.inductive_eval as port_inductive  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli.inductive_eval import perform_inductive_eval as jax_inductive  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.utils import create_dataset as jax_create_dataset  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu_torch.models import get_model_class  # noqa: E402
from oovrec_tpu_torch.models.general.more3 import (  # noqa: E402
    elastic_net_gaps,
    slim_elastic_solve,
)

from tests.test_torch_cli import ASSETS  # noqa: E402

N_USERS, N_ITEMS = 60, 40


def make_split(seed=3, n=500):
    """A training split as both packages read it: ids from 1 (0 pads),
    item 39 never drawn, repeated pairs."""
    rng = np.random.default_rng(seed)
    inter = {"user_id": rng.integers(1, N_USERS, n),
             "item_id": np.minimum(rng.geometric(0.08, n), N_ITEMS - 2)}
    return types.SimpleNamespace(inter=inter, uid_field="user_id", iid_field="item_id",
                                 user_num=N_USERS, item_num=N_ITEMS)


SPLIT = make_split()
# model → (the values passed by keyword, besides the defaults)
OTHER = {
    "Pop": None,
    "ItemKNN": {"k": 5, "shrink": 2.0},
    "EASE": {"reg_weight": 10.0},
    "ADMMSLIM": {"lambda1": 1.0, "lambda2": 20.0, "admm_iter": 5, "rho": 50.0,
                 "positive_only": False},
    "NCEPLRec": {"rank": 8, "beta": 0.5, "reg_weight": 10.0},
}


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


STATE_CASES = [(name, "defaults") for name in sorted(OTHER)] + [
    (name, "other") for name in sorted(OTHER) if OTHER[name]]


@pytest.mark.parametrize("name,values", STATE_CASES)
def test_state_matches_jax_bit_for_bit(name, values):
    kw = {} if values == "defaults" else OTHER[name]
    want = jax_model_class(name).build_estate(SPLIT, **kw)
    _same(get_model_class(name).build_estate(SPLIT, dict(kw)), want)


def test_itemknn_rows_keep_k_and_a_zero_diagonal():
    sim = get_model_class("ItemKNN").build_estate(SPLIT, {"k": 3})["item_sim"]
    assert (np.count_nonzero(sim, axis=1) <= 3).all()
    assert not np.diagonal(sim).any()


def elastic_net_objectives(X, W, l1, l2):
    """(n,) primal objective of each column's problem at W:
    ½‖y_j − X_{-j}w‖² + l1‖w‖₁ + ½·l2‖w‖² (W[j, j] = 0)."""
    R = X - X @ W
    return (0.5 * ((R * R).sum(dim=0) + l2 * (W * W).sum(dim=0))
            + l1 * W.abs().sum(dim=0))


def _jax_slim():
    return jax_model_class("SLIMElastic").build_estate(SPLIT, alpha=0.2, l1_ratio=0.02)


def test_slim_elastic_matches_sklearn():
    """W to 2e-3; each column's objective within its duality tolerance of
    sklearn's; the port's columns all stopped by the rule."""
    want = _jax_slim()
    X = torch.from_numpy(want["user_hist_matrix"])
    W, info = slim_elastic_solve(X, 0.2, 0.02)
    assert info["stopped"] == N_ITEMS - 1 and info["max_iter"] == 0
    np.testing.assert_allclose(W.numpy(), want["slim_W"], atol=2e-3)
    assert not np.diagonal(W.numpy()).any() and not W[:, 0].any() and (W >= 0).all()
    l1, l2 = 0.2 * 0.02 * N_USERS, 0.2 * 0.98 * N_USERS
    tol_y = 1e-4 * (X * X).sum(dim=0)
    gap = elastic_net_gaps(X, W, l1, l2)[1:]
    assert (gap <= tol_y[1:]).all()
    mine = elastic_net_objectives(X, W, l1, l2)[1:]
    theirs = elastic_net_objectives(X, torch.from_numpy(want["slim_W"]), l1, l2)[1:]
    assert ((mine - theirs).abs() <= tol_y[1:] + 1e-6).all()
    state = get_model_class("SLIMElastic").build_estate(SPLIT, {"device": "cpu"})
    np.testing.assert_array_equal(state["slim_W"], W.numpy())
    np.testing.assert_array_equal(state["user_hist_matrix"], want["user_hist_matrix"])


def _batch(seed=0, B=7):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, N_USERS, B), "item_id": rng.integers(0, N_ITEMS, B)}


@pytest.mark.parametrize("name", ["Pop", "ItemKNN", "EASE", "ADMMSLIM", "NCEPLRec",
                                  "SLIMElastic"])
def test_scores_match_jax(name):
    estate = (_jax_slim() if name == "SLIMElastic"
              else jax_model_class(name).build_estate(SPLIT))
    jm = jax_model_class(name)(n_users=N_USERS, n_items=N_ITEMS)
    port = get_model_class(name)(N_USERS, N_ITEMS, device="cpu", **estate)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    je = {k: jnp.asarray(v) for k, v in estate.items()}
    params = {"params": {"dummy": jnp.zeros(1)}}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for method in ("predict", "full_sort_scores"):
        want = np.asarray(jm.apply(params, jb, je, method=getattr(jm, method)))
        got = getattr(port, method)(tb).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=method)
    assert [n for n, _ in port.named_parameters()] == ["dummy"]
    loss = port.calculate_loss(tb)
    assert loss.item() == 0.0


def test_random_scores_repeat_in_the_unit_interval():
    port = get_model_class("Random")(N_USERS, N_ITEMS, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    s = port.full_sort_scores(tb)
    assert s.shape == (7, N_ITEMS) and (s >= 0).all() and (s < 1).all()
    assert torch.equal(s, port.full_sort_scores(tb))
    p = port.predict(tb)
    assert p.shape == (7,) and torch.equal(p, port.predict(tb)) and (p < 1).all()
    assert s.std() > 0.2  # not a constant


def _cfg(model, **over):
    d = dict(model=model, dataset="toy", data_path=ASSETS, epochs=2, train_batch_size=8,
             eval_batch_size=64, embedding_size=8, log_tensorboard=False, seed=11,
             load_col={"inter": ["user_id", "item_id", "rating", "timestamp"]},
             eval_args={"split": {"RS": [8, 1, 1]}, "order": "RO", "group_by": "user",
                        "mode": "full"})
    d.update(over)
    return d


def test_jax_driver_ignores_the_config_in_the_state():
    """JAX fault 1: its driver calls `build_estate(split)` without the
    config, so `k: 1` leaves the default similarity; the port's state at
    `k: 1` is JAX's `build_estate(split, k=1)`."""
    cfg = _cfg("ItemKNN", k=1, shrink=5.0)
    jcfg = JaxConfig(config_dict=cfg)
    ds = jax_create_dataset(jcfg)
    _, _, estate = jax_quick_start.build_model_and_state(jcfg, ds)
    train = ds.build()[0]
    default = jax_model_class("ItemKNN").build_estate(train)
    np.testing.assert_array_equal(estate["item_sim"], default["item_sim"])
    asked = jax_model_class("ItemKNN").build_estate(train, k=1, shrink=5.0)
    assert not np.array_equal(asked["item_sim"], default["item_sim"])
    port = port_quick_start.build_model_and_state(
        port_quick_start.Config(dict(cfg, device="cpu")),
        port_quick_start.create_dataset(port_quick_start.Config(dict(cfg, device="cpu"))))
    assert port.k == 1
    np.testing.assert_array_equal(port.item_sim.numpy(), asked["item_sim"])


def _agree(a, b, what):
    assert list(a) == list(b), what
    for k in a:
        assert abs(float(a[k]) - float(b[k])) <= 1e-9, (what, k, a[k], b[k])


@pytest.mark.parametrize("name", ["Pop", "ItemKNN", "EASE", "ADMMSLIM", "NCEPLRec"])
def test_fit_is_one_valid_pass_as_jax(name, tmp_path):
    cfg = _cfg(name)
    jres = jax_quick_start.run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / "jax")),
                               saved=True)
    pres = port_quick_start.run(config_dict=dict(cfg, device="cpu",
                                                 checkpoint_dir=str(tmp_path / "port")),
                                saved=True)
    pt = pres["trainer"]
    assert pt.train_loss_dict == {} == jres["trainer"].train_loss_dict
    _agree(jres["best_valid_result"], pres["best_valid_result"], "valid")
    _agree(jres["test_result"], pres["test_result"], "test")
    assert pres["best_valid_score"] == pytest.approx(jres["best_valid_score"], abs=1e-9)
    ckpt = torch.load(pt.saved_model_file, map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 0 and "dummy" in ckpt["params"]
    loaded = port_quick_start.load_data_and_model(pt.saved_model_file)
    _agree(loaded.trainer.evaluate(loaded.test_loader, load_best_model=False),
           pres["test_result"], "restored")


# the JAX eval's own failure: inside its evaluator, or for MultiVAE
# earlier, where it rebuilds the model's state over the inductive corpus
# (its history matrix at the new item count, ROADMAP §3)
JAX_FAILURES = {"Pop": (AttributeError, "all_item_embeddings"),
                "LightGCN": (AttributeError, "all_item_embeddings"),
                "MultiVAE": (TypeError, "incompatible shapes"),
                "NeuMF": (AttributeError, "all_item_embeddings")}


@pytest.mark.parametrize("name", ["Pop", "LightGCN", "MultiVAE", "NeuMF"])
def test_inductive_eval_refuses_a_model_without_an_id_tower(name, tmp_path, monkeypatch):
    cfg = dict(model=name, dataset="toy-ind", data_path=ASSETS, epochs=1,
               train_batch_size=16, embedding_size=8, log_tensorboard=False,
               inductive_mapper="random", add_oov_buckets=True, n_user_oov_buckets=8,
               n_item_oov_buckets=8, train_oov=True,
               load_col={"inter": ["user_id", "item_id", "rating", "timestamp", "is_new"]})
    jres = jax_quick_start.run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / "jax")))
    error, match = JAX_FAILURES[name]
    with pytest.raises(error, match=match):
        jax_inductive(jres["dataset"], jres["trainer"].saved_model_file, config=jres["config"])
    pres = port_quick_start.run(config_dict=dict(cfg, device="cpu",
                                                 checkpoint_dir=str(tmp_path / "port")))

    def no_work(*a, **k):
        raise AssertionError("the refusal comes before any work")

    monkeypatch.setattr(port_inductive, "create_ind_dataset", no_work)
    monkeypatch.setattr(port_quick_start, "load_data_and_model", no_work)
    with pytest.raises(TypeError, match=f"model \\[{name}\\] has no ID tower"):
        port_inductive.perform_inductive_eval(None, pres["trainer"].saved_model_file)


@pytest.mark.parametrize("model,mode,refused", [
    ("Pop", "full", True), ("LightGCN", "full", True), ("Pop", "uni100", False),
    ("BPR", "full", False), ("xDeepFM", "labeled", False)])
def test_only_the_full_sort_slices_need_an_id_tower(model, mode, refused):
    """The uni-N slices score through `predict`, and so do a ranking
    model's value slices: only the full sort embeds the item range."""
    over = {"model_eval_type": "ranking"} if model == "xDeepFM" else {}
    cfg = port_quick_start.Config(dict(model=model, dataset="toy-ind", data_path=ASSETS,
                                       eval_args={"mode": mode}, **over))
    if refused:
        with pytest.raises(TypeError, match="no ID tower"):
            port_inductive.refuse_without_id_tower(cfg)
    else:
        port_inductive.refuse_without_id_tower(cfg)

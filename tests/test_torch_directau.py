"""The port's DirectAU against the JAX package's.

A JAX DirectAU with random-mapper OOV buckets is trained once on the
toy-ind fixture (`cli/quick_start.run`, the OOV regime); its weights cross
to the port (numpy only). Checked against the JAX model and evaluators:
  * the alignment and uniformity terms and the whole loss with its
    gradient to 1e-5, on a batch of IV and OOV rows whose last rows are
    padding (weight 0), and without weights;
  * `predict` (the cosine) and `full_sort_scores` (unnormalised) to 1e-6;
  * the full-sort eval and the 7-slice inductive eval to 1e-9 (both
    round the same integer hit matrices), on the dense path and on the
    fused top-k path (the kernel's plain version on the CPU), which must
    equal each other.
"""

import pickle

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

from oovrec_tpu.cli.inductive_eval import perform_inductive_eval  # noqa: E402
from oovrec_tpu.cli.quick_start import run  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.utils import data_preparation  # noqa: E402
from oovrec_tpu.eval.runner import EvalRunner as JaxEvalRunner  # noqa: E402
from oovrec_tpu.models.directau import DirectAU as JaxDirectAU  # noqa: E402
from oovrec_tpu_torch.data import FullSortEvalBatcher  # noqa: E402
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper  # noqa: E402
from oovrec_tpu_torch.models import DirectAU, get_model_class  # noqa: E402
from oovrec_tpu_torch.models.directau import alignment, uniformity  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, state_dict_from_flax  # noqa: E402

from tests.test_inductive import _ind_cfg  # noqa: E402
from tests.test_torch_inductive_eval import (  # noqa: E402
    _port_config,
    _port_ind_loader,
    _port_sampler,
    _port_split,
)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = _ind_cfg(model="DirectAU", checkpoint_dir=str(tmp_path_factory.mktemp("dau")),
                   log_tensorboard=False)
    res = run(config_dict=cfg, saved=True)
    with open(res["trainer"].saved_model_file, "rb") as f:
        params = serialization.msgpack_restore(pickle.load(f)["params"])
    from oovrec_tpu.cli.inductive_eval import check_feature_consistency, create_ind_dataset

    ind_cfg, ind_ds = create_ind_dataset(res["config"], res["dataset"])
    check_feature_consistency(res["dataset"], ind_ds)
    return {"res": res, "params": params, "ind_cfg": ind_cfg, "ind_ds": ind_ds}


def _port_model(params, n_users, n_items, cfg):
    spec = InductiveSpec(
        mapper=cfg["inductive_mapper"], add_oov_buckets=bool(cfg["add_oov_buckets"]),
        n_user_buckets=int(cfg["n_user_oov_buckets"]),
        n_item_buckets=int(cfg["n_item_oov_buckets"]),
        hash_function=cfg["oov_hash_function"],
    )
    model = DirectAU(n_users, n_items, int(cfg["embedding_size"]), spec, device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return model


def _batch(trained, n=24, n_pad=5):
    """Pointwise rows over IV and OOV users and items (annotated by the
    random mapper), the last `n_pad` of them padding."""
    res = trained["res"]
    nu, ni = res["dataset"].user_num, res["dataset"].item_num
    rng = np.random.default_rng(3)
    users, items = rng.integers(1, nu + 6, n), rng.integers(1, ni + 6, n)
    users[::5] = users[1]  # repeated users: pairs at distance 0
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=8,
                         n_item_buckets=8)
    mapper = RandomOOVMapper(spec, nu, ni, nu + 6, ni + 6)
    mapper.set_eval()
    batch = mapper.annotate({"user_id": users, "item_id": items}, "user_id", "item_id")
    batch["weight"] = np.ones(n, np.float32)
    batch["label"] = (rng.random(n) < 0.5).astype(np.float32)
    for v in batch.values():
        v[n - n_pad:] = 0
    assert batch["user_id_oov"].sum() > 0 and batch["item_id_oov"].sum() > 0
    return batch


def _jax_model(trained):
    cfg = trained["res"]["config"]
    return trained["res"]["trainer"].model, JaxConfig(config_dict=cfg.as_dict())


@pytest.mark.parametrize("weighted", [True, False], ids=["pads", "no-weights"])
def test_loss_terms_and_gradient_match_jax(trained, weighted):
    jm, jcfg = _jax_model(trained)
    params = trained["params"]
    batch = _batch(trained)
    if not weighted:
        del batch["weight"]
    jb = {k: jnp.asarray(np.asarray(v, np.int32) if v.dtype.kind in "iu" else v)
          for k, v in batch.items()}
    jloss, jgrad = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jb, {}, method=jm.calculate_loss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = _port_model(params, jm.n_users, jm.n_items, jcfg)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss = model.calculate_loss(tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    got = flax_from_state_dict(dict(zip(names, grads)))
    assert set(got) == set(jgrad) == {"user_embedding", "item_embedding",
                                      "user_oov_buckets", "item_oov_buckets"}
    for k in jgrad:
        np.testing.assert_allclose(got[k]["embedding"], np.asarray(jgrad[k]["embedding"]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)

    # the terms alone, on normalised random rows
    rng = np.random.default_rng(5)
    u, i = (rng.standard_normal((12, 8)).astype(np.float32) for _ in range(2))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = np.r_[np.ones(9), np.zeros(3)].astype(np.float32) if weighted else None
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    np.testing.assert_allclose(
        float(alignment(torch.from_numpy(u), torch.from_numpy(i), tw)),
        float(JaxDirectAU._alignment(jnp.asarray(u), jnp.asarray(i), jw)), rtol=1e-6)
    np.testing.assert_allclose(
        float(uniformity(torch.from_numpy(u), tw)),
        float(JaxDirectAU._uniformity(jnp.asarray(u), jw)), rtol=1e-5)


def test_predict_and_full_sort_scores_match_jax(trained):
    jm, jcfg = _jax_model(trained)
    params = trained["params"]
    batch = _batch(trained, n_pad=0)
    jb = {k: jnp.asarray(np.asarray(v, np.int32) if v.dtype.kind in "iu" else v)
          for k, v in batch.items()}
    model = _port_model(params, jm.n_users, jm.n_items, jcfg)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        for method in ("predict", "full_sort_scores"):
            want = np.asarray(jm.apply({"params": params}, jb, {},
                                       method=getattr(jm, method)))
            got = getattr(model, method)(tb).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=method)
        # the fused kernel's towers: unnormalised
        np.testing.assert_allclose(model.user_tower(tb).numpy() @ model.item_tower().numpy().T,
                                   model.full_sort_scores(tb).numpy(), rtol=1e-6, atol=1e-6)
    assert get_model_class("DirectAU") is DirectAU
    assert model.sparse_table_fields() == {"user": ("user_embedding", ["user_id"]),
                                           "item": ("item_embedding", ["item_id"])}


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_eval_runner_full_sort_matches_jax(trained, fused):
    res = trained["res"]
    jcfg, tr = res["config"], res["trainer"]
    jax_train, _, jax_test = data_preparation(jcfg, res["dataset"])
    jax_runner = JaxEvalRunner(tr.model, jcfg, estate=tr.estate)
    jax_runner.train_split = jax_train.split
    ref = jax_runner.evaluate({"params": trained["params"]}, jax_test)

    cfg = _port_config(jcfg, use_fused_topk=fused)
    model = _port_model(trained["params"], res["dataset"].user_num,
                        res["dataset"].item_num, cfg)
    splits = res["dataset"].build()
    runner = EvalRunner(model, cfg)
    got = runner.evaluate(FullSortEvalBatcher(_port_split(splits[2]), _port_sampler(splits),
                                              cfg, phase="test"))
    assert runner._use_fused(res["dataset"].item_num) is fused
    assert list(got) == list(ref) and len(got) > 0
    for m, v in ref.items():
        assert abs(v - got[m]) < 1e-9, (m, v, got[m])


@pytest.mark.parametrize("perturbed", [True, False], ids=["perturbed", "plain"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_seven_slices_match_jax(trained, fused, perturbed):
    res = trained["res"]
    jcfg = JaxConfig(config_dict=res["config"].as_dict())
    jcfg["use_perturbed_hits"] = perturbed
    jcfg["use_fused_topk"] = fused
    ref = perform_inductive_eval(res["dataset"], res["trainer"].saved_model_file, config=jcfg)

    cfg = _port_config(trained["ind_cfg"], use_perturbed_hits=perturbed, use_fused_topk=fused)
    n_old_users, n_old_items = res["dataset"].user_num, res["dataset"].item_num
    model = _port_model(trained["params"], n_old_users, n_old_items, cfg)
    ind_ds = trained["ind_ds"]
    mapper = RandomOOVMapper(model.spec, n_old_users, n_old_items, ind_ds.user_num,
                             ind_ds.item_num)
    mapper.set_eval()
    evaluator = InductiveEvaluator(model, cfg, n_old_users, n_old_items, mapper=mapper)
    got = evaluator.evaluate_model(_port_ind_loader(trained, cfg))
    assert evaluator._fused is fused
    assert list(got) == list(ref) and len(got["overall"]) > 0
    for s in ref:
        assert set(got[s]) == set(ref[s]), s
        for m, v in ref[s].items():
            assert abs(v - got[s][m]) < 1e-9, (s, m, v, got[s][m])

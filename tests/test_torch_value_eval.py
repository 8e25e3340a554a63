"""The port's ranking-track serving path (xDeepFM + OOV buckets, VALUE
metrics) against the JAX package, end to end on the toy-ind fixture.

The JAX package loads `tests/assets/toy-ind` (the verify recipe's
`load_col`, `threshold` rating ≥ 4 as the label, 'labeled' eval) and its
`_ind` corpus; the port's `DatasetSplit`s are built from the same numpy
arrays and feature tables. A JAX xDeepFM with random-mapper OOV buckets is
built by the JAX pipeline and its params cross to the port. Then:

  * the port's `PlainEvalBatcher` emits the JAX batcher's batches, key for
    key;
  * `EvalRunner` AUC / LogLoss and the 7 value slices of
    `InductiveEvaluator` equal the JAX package's to 1e-6, both rounded at
    12 decimals, on the slab path and on the CIN kernel route (its plain
    version on the CPU).

The toy `_ind` corpus has no old_new / new_new rows: `{}` is expected
there, on both sides.
"""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from oovrec_tpu.cli.inductive_eval import (  # noqa: E402
    check_feature_consistency,
    create_ind_dataset,
)
from oovrec_tpu.cli.quick_start import build_model_and_state  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.dataloader import PlainEvalBatcher as JaxPlainEvalBatcher  # noqa: E402
from oovrec_tpu.data.utils import create_dataset, data_preparation  # noqa: E402
from oovrec_tpu.eval.inductive import InductiveEvaluator as JaxInductiveEvaluator  # noqa: E402
from oovrec_tpu.eval.runner import EvalRunner as JaxEvalRunner  # noqa: E402
from oovrec_tpu.inductive.mapper import RandomOOVMapper as JaxMapper  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data import DatasetSplit, PlainEvalBatcher  # noqa: E402
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper  # noqa: E402
from oovrec_tpu_torch.models import FieldSpec, xDeepFM  # noqa: E402
from oovrec_tpu_torch.utils.enums import EvaluatorType  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import load_flax_params  # noqa: E402

from tests.test_context_models import _ranking_cfg  # noqa: E402

BATCH = 16  # several batches per split, the last one padded
PORT_KEYS = ("metrics", "metric_decimal_place", "seed", "eval_batch_size")


@pytest.fixture(scope="module")
def setup():
    cfg = JaxConfig(config_dict=_ranking_cfg(
        "xDeepFM", metrics=["AUC", "LogLoss"], valid_metric="AUC",
        metric_decimal_place=12, eval_batch_size=BATCH,
        eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO",
                   "group_by": None, "mode": "labeled"},
        cin_layer_size=[8, 8], inductive_mapper="random", add_oov_buckets=True,
        n_user_oov_buckets=8, n_item_oov_buckets=8,
    ))
    ds = create_dataset(cfg)
    train, _, test = data_preparation(cfg, ds)
    jmodel, variables, estate = build_model_and_state(
        cfg, ds, template_batch=next(iter(test)))
    # random biases, so the bridge's bias leaves are exercised; the float
    # fields' tables scaled down, because ages and prices of ~20 otherwise
    # saturate the sigmoid, and AUC over tied 1.0 scores would rest on
    # last-bit rounding
    rng = np.random.default_rng(5)

    def perturb(path, v):
        v = np.asarray(v)
        if path[-1].key == "bias":
            return v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        if path[-2].key == "float_embedding_table":
            return v * np.float32(0.01)
        return v

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    ind_cfg, ind_ds = create_ind_dataset(cfg, ds)
    check_feature_consistency(ds, ind_ds)
    ind_train, _, ind_test = data_preparation(ind_cfg, ind_ds)
    return {
        "cfg": cfg, "ds": ds, "jmodel": jmodel, "params": params,
        "estate": estate, "splits": {"train": train.split, "test": test.split},
        "ind_cfg": ind_cfg, "ind_ds": ind_ds,
        "ind_splits": {"train": ind_train.split, "test": ind_test.split},
    }


def _port_split(split):
    parent = split.parent
    return DatasetSplit(
        dict(split.inter), split.user_num, split.item_num,
        split.uid_field, split.iid_field, split.label_field,
        user_feat=parent.get_user_feature() if parent.user_feat is not None else None,
        item_feat=parent.get_item_feature() if parent.item_feat is not None else None,
    )


def _port_cfg(jax_cfg):
    return Config({k: jax_cfg[k] for k in PORT_KEYS})


def _port_model(setup, fused):
    jm, cfg = setup["jmodel"], setup["cfg"]
    spec = InductiveSpec(
        mapper=cfg["inductive_mapper"], add_oov_buckets=True,
        n_user_buckets=int(cfg["n_user_oov_buckets"]),
        n_item_buckets=int(cfg["n_item_oov_buckets"]),
        hash_function=cfg["oov_hash_function"],
    )
    model = xDeepFM(
        FieldSpec(**dataclasses.asdict(jm.fields)), embedding_size=jm.embedding_size,
        spec=spec, mlp_hidden_size=jm.mlp_hidden_size, dropout_prob=jm.dropout_prob,
        direct=jm.direct, cin_layer_size=jm.cin_layer_size, fused_cin=fused,
        label_field=jm.label_field, device="cpu",
    )
    return load_flax_params(model, setup["params"])


def _same(got, want, what):
    assert list(got) == list(want), what
    for m, v in want.items():
        if math.isnan(v):
            assert math.isnan(got[m]), (what, m)
        else:
            assert abs(v - got[m]) < 1e-6, (what, m, v, got[m])


@pytest.mark.parametrize("which", ["train", "test", "ind_train", "ind_test"])
def test_plain_batches_match_jax(setup, which):
    group, name = ("ind_splits", which[4:]) if which.startswith("ind") else ("splits", which)
    jsplit = setup[group][name]
    cfg = setup["ind_cfg" if group == "ind_splits" else "cfg"]
    ref = list(JaxPlainEvalBatcher(jsplit, cfg))
    port = list(PlainEvalBatcher(_port_split(jsplit), _port_cfg(cfg)))
    assert len(port) == len(ref) > 0
    assert ref[-1]["weight"].min() == 0  # the last batch is padded
    for pb, jb in zip(port, ref):
        assert list(pb) == list(jb)
        for key in jb:
            assert pb[key].dtype == np.asarray(jb[key]).dtype, key
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]), err_msg=key)


@pytest.mark.parametrize("fused", [False, True], ids=["slab", "kernel"])
@pytest.mark.parametrize("which", ["train", "test"])
def test_eval_runner_value_metrics_match_jax(setup, which, fused):
    jsplit = setup["splits"][which]
    cfg = setup["cfg"]
    runner = JaxEvalRunner(setup["jmodel"], cfg, estate=setup["estate"])
    ref = runner.evaluate({"params": setup["params"]}, JaxPlainEvalBatcher(jsplit, cfg))

    port_cfg = _port_cfg(cfg)
    assert port_cfg["eval_type"] == EvaluatorType.VALUE
    got = EvalRunner(_port_model(setup, fused), port_cfg).evaluate(
        PlainEvalBatcher(_port_split(jsplit), port_cfg))
    assert list(got) == ["auc", "logloss"]
    _same(got, ref, which)
    if which == "train":
        assert 0.0 < got["auc"] < 1.0


@pytest.mark.parametrize("fused", [False, True], ids=["slab", "kernel"])
@pytest.mark.parametrize("which", ["train", "test"])
def test_seven_value_slices_match_jax(setup, which, fused):
    ds, ind_ds, ind_cfg = setup["ds"], setup["ind_ds"], setup["ind_cfg"]
    jsplit = setup["ind_splits"][which]
    n_old_users, n_old_items = ds.user_num, ds.item_num
    jmodel = setup["jmodel"]
    jmapper = JaxMapper(jmodel.spec, n_old_users, n_old_items,
                        ind_ds.user_num, ind_ds.item_num)
    jmapper.set_eval()
    ref = JaxInductiveEvaluator(
        jmodel, ind_cfg, n_old_users, n_old_items, estate=setup["estate"],
        mapper=jmapper,
    ).evaluate_model({"params": setup["params"]}, JaxPlainEvalBatcher(jsplit, ind_cfg))

    model = _port_model(setup, fused)
    mapper = RandomOOVMapper(model.spec, n_old_users, n_old_items,
                             ind_ds.user_num, ind_ds.item_num)
    mapper.set_eval()
    cfg = _port_cfg(ind_cfg)
    got = InductiveEvaluator(model, cfg, n_old_users, n_old_items, mapper=mapper) \
        .evaluate_model(PlainEvalBatcher(_port_split(jsplit), cfg))

    assert list(got) == list(ref) == [
        "overall", "old_users", "new_users", "old_old", "old_new", "new_old", "new_new"]
    assert got["old_new"] == ref["old_new"] == {}
    assert got["new_new"] == ref["new_new"] == {}
    assert len(got["overall"]) == 2
    if which == "test":  # the new user's rows route through the OOV buckets
        assert got["new_users"] and got["new_old"]
    for s in ref:
        _same(got[s], ref[s], s)

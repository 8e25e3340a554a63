"""The decision-tree models against the JAX package's numpy originals.

`data/decisiontree.py`, `models/exlib/decision_tree.py` and
`train/decision_tree_trainer.py` of the port are copies of the JAX
package's numpy modules:

  * `tabularize` and `tabularize_split` bit for bit with JAX's on toy,
    toy-ind and a seeded corpus written into the test's directory with
    token, float, token_seq and float_seq columns and empty sequences;
  * `DecisionTreeTrainer.fit` / `evaluate` and the models' loader `fit`
    with the same stub `xgboost` and `lightgbm` modules put into
    `sys.modules` for both packages: the (X, y, params, rounds) each
    booster receives are identical, and the VALUE metrics of its
    predictions equal;
  * the ImportError texts when the wheels are absent;
  * a real booster where the wheel is installed (skipped otherwise, as in
    JAX's `tests/test_dataset.py:256`).
"""

import os
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from oovrec_tpu.config.configurator import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data import decisiontree as jdt  # noqa: E402
from oovrec_tpu.models.exlib import decision_tree as jmodels  # noqa: E402
from oovrec_tpu.train.decision_tree_trainer import (  # noqa: E402
    DecisionTreeTrainer as JaxTreeTrainer,
)
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data import decisiontree as pdt  # noqa: E402
from oovrec_tpu_torch.models.exlib import LightGBMModel, XGBoostModel  # noqa: E402
from oovrec_tpu_torch.train.decision_tree_trainer import DecisionTreeTrainer  # noqa: E402

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
SPLIT = {"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO", "group_by": None, "mode": "labeled"}


def _seq_corpus(root) -> dict:
    """A seeded inter file with token, float, token_seq and float_seq
    columns (some sequences empty) and a 0/1 label."""
    rng = np.random.default_rng(11)
    (root / "seqc").mkdir()
    lines = ["user_id:token\titem_id:token\trating:float\ttimestamp:float\ttags:token_seq\t"
             "scores:float_seq\tlabel:float"]
    for i in range(60):
        tags = " ".join(f"t{x}" for x in rng.integers(0, 5, rng.integers(0, 4)))
        scores = " ".join(f"{x:.3f}" for x in rng.random(rng.integers(0, 3)))
        lines.append(f"u{rng.integers(1, 9)}\ti{rng.integers(1, 12)}\t{rng.integers(1, 6)}\t{i}"
                     f"\t{tags}\t{scores}\t{rng.integers(0, 2)}")
    (root / "seqc" / "seqc.inter").write_text("\n".join(lines) + "\n")
    return {"model": "BPR", "dataset": "seqc", "data_path": str(root), "eval_args": SPLIT,
            "load_col": {"inter": ["user_id", "item_id", "rating", "timestamp", "tags",
                                   "scores", "label"]},
            "metrics": ["AUC", "LogLoss", "RMSE", "MAE"], "valid_metric": "AUC"}


def _corpus(name, tmp_path) -> dict:
    if name == "seqc":
        return _seq_corpus(tmp_path)
    cols = ["user_id", "item_id", "rating", "timestamp"] + (["is_new"] if name == "toy-ind"
                                                             else [])
    load = {"inter": cols}
    if name == "toy-ind":
        load.update(user=["user_id", "age", "gender"], item=["item_id", "price", "category"])
    return {"model": "BPR", "dataset": name, "data_path": ASSETS, "load_col": load,
            "eval_args": SPLIT, "threshold": {"rating": 4},
            "metrics": ["AUC", "LogLoss", "RMSE", "MAE"], "valid_metric": "AUC"}


def _pair(cfg):
    return (jdt.DecisionTreeDataset(JaxConfig(config_dict=cfg)),
            pdt.DecisionTreeDataset(Config(cfg)))


def _same(a, b):
    (Xa, ya, na), (Xb, yb, nb) = a, b
    assert na == nb
    assert Xa.dtype == Xb.dtype and ya.dtype == yb.dtype
    np.testing.assert_array_equal(Xa, Xb)
    np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("name", ["toy", "toy-ind", "seqc"])
def test_tabularize_matches_jax(name, tmp_path):
    jds, pds = _pair(_corpus(name, tmp_path))
    _same(jds.tabularize(), pds.tabularize())
    for js, ps in zip(jds.build()[:3], pds.build()[:3]):
        _same(jdt.tabularize_split(js), pdt.tabularize_split(ps))
    if name == "seqc":
        X, _, names = pds.tabularize()
        assert "tags" in names and "scores" in names
        assert (X[:, names.index("tags")] == 0).any()  # an empty sequence


class _Recorder:
    """A stub booster library: records what each `train` call receives and
    predicts a fixed function of the features."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def score(X):
        X = np.asarray(X, np.float64)
        w = np.cos(np.arange(X.shape[1]) + 1.0)
        return 1.0 / (1.0 + np.exp(-(X @ w) / (1.0 + np.abs(X).sum(axis=1))))


def _stub_modules(rec: _Recorder):
    xgb = types.ModuleType("xgboost")
    lgb = types.ModuleType("lightgbm")

    class DMatrix:
        def __init__(self, X, label=None):
            self.X, self.label = np.array(X), None if label is None else np.array(label)

    class XBooster:
        def predict(self, d):
            return rec.score(d.X)

    def xtrain(params, dtrain, num_boost_round=10, evals=(), verbose_eval=True):
        rec.calls.append(("xgboost", dtrain.X, dtrain.label, dict(params), num_boost_round,
                          [(e[0].X, e[0].label, e[1]) for e in evals]))
        return XBooster()

    class Dataset:
        def __init__(self, X, label=None):
            self.X, self.label = np.array(X), None if label is None else np.array(label)

    class LBooster:
        def predict(self, X):
            return rec.score(X)

    def ltrain(params, train_set, num_boost_round=10, valid_sets=()):
        rec.calls.append(("lightgbm", train_set.X, train_set.label, dict(params),
                          num_boost_round, [(v.X, v.label) for v in valid_sets]))
        return LBooster()

    xgb.DMatrix, xgb.train = DMatrix, xtrain
    lgb.Dataset, lgb.train = Dataset, ltrain
    return {"xgboost": xgb, "lightgbm": lgb}


def _same_calls(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert ca[0] == cb[0] and ca[3] == cb[3] and ca[4] == cb[4]
        np.testing.assert_array_equal(ca[1], cb[1])
        np.testing.assert_array_equal(ca[2], cb[2])
        assert len(ca[5]) == len(cb[5])
        for ea, eb in zip(ca[5], cb[5]):
            for x, y in zip(ea, eb):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("lib", ["xgboost", "lightgbm"])
@pytest.mark.parametrize("name", ["toy-ind", "seqc"])
def test_trainer_hands_the_booster_jax_inputs(lib, name, tmp_path, monkeypatch):
    cfg = dict(_corpus(name, tmp_path), xgb_num_boost_round=7, lgb_num_boost_round=5,
               tree_params={"max_depth": 3} if lib == "xgboost" else {})
    jds, pds = _pair(cfg)
    jrec, prec = _Recorder(), _Recorder()
    jcls = jmodels.XGBoostModel if lib == "xgboost" else jmodels.LightGBMModel
    pcls = XGBoostModel if lib == "xgboost" else LightGBMModel
    jsplits, psplits = jds.build(), pds.build()

    for mod, v in _stub_modules(jrec).items():
        monkeypatch.setitem(sys.modules, mod, v)
    jcfg = JaxConfig(config_dict=cfg)
    jt = JaxTreeTrainer(jcfg, jcls(jcfg, fields=["user_id", "item_id"]))
    jvalid = jt.fit(jsplits[0], jsplits[1])
    jtest = jt.evaluate(jsplits[2])

    for mod, v in _stub_modules(prec).items():
        monkeypatch.setitem(sys.modules, mod, v)
    pcfg = Config(cfg)
    pt = DecisionTreeTrainer(pcfg, pcls(pcfg, fields=["user_id", "item_id"]))
    pvalid = pt.fit(psplits[0], psplits[1])
    ptest = pt.evaluate(psplits[2])

    _same_calls(jrec.calls, prec.calls)
    assert prec.calls[0][4] == (7 if lib == "xgboost" else 5)
    assert pvalid == jvalid and ptest == jtest
    assert set(ptest) == {"auc", "logloss", "rmse", "mae"}


@pytest.mark.parametrize("lib", ["xgboost", "lightgbm"])
def test_model_fit_on_batches_matches_jax(lib, monkeypatch):
    rng = np.random.default_rng(2)
    batches = [{"user_id": rng.integers(1, 9, 16), "item_id": rng.integers(1, 12, 16),
                "tags": rng.integers(0, 5, (16, 3)), "label": rng.integers(0, 2, 16),
                "weight": (np.arange(16) < 16 - 5 * b).astype(np.float32)} for b in range(3)]
    calls = []
    for cls in ((jmodels.XGBoostModel, XGBoostModel) if lib == "xgboost"
                else (jmodels.LightGBMModel, LightGBMModel)):
        rec = _Recorder()
        for mod, v in _stub_modules(rec).items():
            monkeypatch.setitem(sys.modules, mod, v)
        model = cls({"xgb_num_boost_round": 3}, ["user_id", "item_id", "tags"]).fit(batches)
        calls.append((rec.calls, model.predict(batches[0])))
    _same_calls(calls[0][0], calls[1][0])
    np.testing.assert_array_equal(calls[0][1], calls[1][1])


@pytest.mark.parametrize("lib", ["xgboost", "lightgbm"])
def test_import_error_texts(lib, monkeypatch):
    monkeypatch.setitem(sys.modules, lib, None)
    jcls = jmodels.XGBoostModel if lib == "xgboost" else jmodels.LightGBMModel
    pcls = XGBoostModel if lib == "xgboost" else LightGBMModel
    with pytest.raises(ImportError) as want:
        jcls({}, ["user_id"]).fit([])
    with pytest.raises(ImportError) as got:
        pcls({}, ["user_id"]).fit([])
    assert str(got.value) == str(want.value)
    assert f"{lib} is not installed" in str(got.value)


def test_real_xgboost_booster():
    pytest.importorskip("xgboost")
    c = Config({"model": "BPR", "dataset": "toy", "data_path": ASSETS,
                "load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"]},
                "metrics": ["AUC", "LogLoss"], "metric_decimal_place": 4})
    ds = pdt.DecisionTreeDataset(c)
    tr, va, te = ds.build()
    t = DecisionTreeTrainer(c, XGBoostModel(c, fields=["user_id", "item_id"]))
    t.fit(tr, va)
    assert set(t.evaluate(te)) == {"auc", "logloss"}

"""Decision-tree recommenders: a numpy copy of
`oovrec_tpu/models/exlib/decision_tree.py` (reference
`exlib_recommender/xgboost.py`,
`lightgbm.py` + DecisionTreeTrainer `trainer.py:1020-1180`).

Host-side gradient-boosting over the flattened interaction features; the
libraries are optional — constructing the model without them raises a
clear error (this environment does not guarantee the wheels).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class _TreeBase:
    """VALUE-metric model trained host-side (not a flax module)."""

    model_type = "decisiontree"
    lib_name = ""

    def __init__(self, config, fields, label_field: str = "label"):
        self.config = config
        self.fields = fields  # list of feature column names
        self.label_field = label_field
        self.booster = None

    def _matrix(self, batch: dict) -> np.ndarray:
        cols = []
        for f in self.fields:
            v = np.asarray(batch[f], dtype=np.float32)
            cols.append(v.reshape(len(v), -1))
        return np.concatenate(cols, axis=1)

    def fit(self, train_loader, valid_loader=None, params: Optional[dict] = None):
        raise NotImplementedError

    def predict(self, batch: dict) -> np.ndarray:
        raise NotImplementedError


class XGBoostModel(_TreeBase):
    lib_name = "xgboost"

    def fit_arrays(self, X, y, Xv=None, yv=None, params=None):
        import xgboost as xgb

        dtrain = xgb.DMatrix(X, label=y)
        evals = [(xgb.DMatrix(Xv, label=yv), "valid")] if Xv is not None else []
        self.booster = xgb.train(
            params or {"objective": "binary:logistic", "eta": 0.1,
                       "max_depth": 6},
            dtrain, evals=evals,
            num_boost_round=int(self.config.get("xgb_num_boost_round", 100)),
            verbose_eval=False,
        )
        return self

    def predict_array(self, X):
        import xgboost as xgb

        return self.booster.predict(xgb.DMatrix(X))

    def fit(self, train_loader, valid_loader=None, params: Optional[dict] = None):
        try:
            import xgboost as xgb
        except ImportError as e:
            raise ImportError(
                "xgboost is not installed in this environment; the XGBoost "
                "recommender requires the optional wheel"
            ) from e
        X, y = [], []
        for batch in train_loader:
            w = batch["weight"] > 0
            X.append(self._matrix(batch)[w])
            y.append(np.asarray(batch[self.label_field])[w])
        dtrain = xgb.DMatrix(np.concatenate(X), label=np.concatenate(y))
        params = params or {
            "objective": "binary:logistic", "eta": 0.1, "max_depth": 6,
        }
        self.booster = xgb.train(
            params, dtrain,
            num_boost_round=int(self.config.get("xgb_num_boost_round", 100)),
        )
        return self

    def predict(self, batch: dict) -> np.ndarray:
        import xgboost as xgb

        return self.booster.predict(xgb.DMatrix(self._matrix(batch)))


class LightGBMModel(_TreeBase):
    lib_name = "lightgbm"

    def fit_arrays(self, X, y, Xv=None, yv=None, params=None):
        import lightgbm as lgb

        train_set = lgb.Dataset(X, label=y)
        valid = [lgb.Dataset(Xv, label=yv)] if Xv is not None else []
        self.booster = lgb.train(
            params or {"objective": "binary", "learning_rate": 0.1},
            train_set, valid_sets=valid,
            num_boost_round=int(self.config.get("lgb_num_boost_round", 100)),
        )
        return self

    def predict_array(self, X):
        return self.booster.predict(X)

    def fit(self, train_loader, valid_loader=None, params: Optional[dict] = None):
        try:
            import lightgbm as lgb
        except ImportError as e:
            raise ImportError(
                "lightgbm is not installed in this environment; the LightGBM "
                "recommender requires the optional wheel"
            ) from e
        X, y = [], []
        for batch in train_loader:
            w = batch["weight"] > 0
            X.append(self._matrix(batch)[w])
            y.append(np.asarray(batch[self.label_field])[w])
        train_set = lgb.Dataset(np.concatenate(X), label=np.concatenate(y))
        params = params or {"objective": "binary", "learning_rate": 0.1}
        self.booster = lgb.train(
            params, train_set,
            num_boost_round=int(self.config.get("lgb_num_boost_round", 100)),
        )
        return self

    def predict(self, batch: dict) -> np.ndarray:
        return self.booster.predict(self._matrix(batch))

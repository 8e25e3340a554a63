"""DecisionTreeTrainer: a numpy copy of
`oovrec_tpu/train/decision_tree_trainer.py` (reference `trainer.py:1020-1180`
DecisionTreeTrainer / xgboostTrainer / lightgbmTrainer).

Fits a host-side booster over the tabularized splits and reports VALUE
metrics (AUC / LogLoss / MAE / RMSE) through the same Collector/Evaluator
stack the neural models use. The boosters are optional wheels; call sites
get a clear ImportError when absent."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from oovrec_tpu_torch.data.decisiontree import DecisionTreeDataset
from oovrec_tpu_torch.eval.collector import Collector, Evaluator


class DecisionTreeTrainer:
    def __init__(self, config, model):
        self.config = config
        self.model = model  # XGBoostModel | LightGBMModel
        self.label_field = config["LABEL_FIELD"]

    def _xy(self, split):
        X, y, names = DecisionTreeDataset.tabularize(
            split.parent, df=split.inter
        )
        return X, y

    def fit(self, train_split, valid_split=None,
            params: Optional[dict] = None) -> Dict[str, float]:
        Xt, yt = self._xy(train_split)
        Xv, yv = self._xy(valid_split) if valid_split is not None else (None, None)
        self.model.fit_arrays(Xt, yt, Xv, yv, params=params or
                              self.config.get("tree_params", {}))
        if Xv is None:
            return {}
        return self.evaluate(valid_split)

    def evaluate(self, split) -> Dict[str, float]:
        X, y = self._xy(split)
        scores = self.model.predict_array(X)
        collector = Collector(self.config)
        collector.collect_scores(
            np.asarray(scores, np.float64), np.asarray(y, np.float64)
        )
        return dict(Evaluator(self.config).evaluate(collector.get_data_struct()))

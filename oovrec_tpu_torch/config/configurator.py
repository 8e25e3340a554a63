"""Dict-based configuration with defaults written in Python.

Holds the keys of `oovrec_tpu/config/defaults.yaml` that the ported
modules read (environment, training, evaluation and the OOV regime), with
the same defaults and the same derived `eval_type`.
The YAML layers (model, dataset and user files, command line) come with
the slice that ports the atomic-file dataset; the card's machine has no
PyYAML.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from oovrec_tpu_torch.utils.enums import EvaluatorType

DEFAULTS: Dict[str, Any] = {
    "seed": 2020,
    "checkpoint_dir": "saved",
    # optimizer semantics (defaults.yaml:23-27)
    "optimizer_mu_dtype": None,
    "optimizer_skip_zero_grads": False,
    # training (defaults.yaml:31-47)
    "epochs": 300,
    "train_batch_size": 2048,
    "learner": "adam",
    "learning_rate": 0.001,
    "train_neg_sample_args": {
        "distribution": "uniform", "sample_num": 1, "alpha": 1.0,
        "dynamic": False, "candidate_num": 0,
    },
    "eval_step": 1,
    "stopping_step": 10,
    "clip_grad_norm": None,
    "weight_decay": 0.0,
    "loss_decimal_place": 4,
    "require_pow": False,
    "transform": None,
    "valid_metric": "MRR@10",
    "valid_metric_bigger": True,
    "eval_valid_sample_ratio": -1,
    "NEG_PREFIX": "neg_",
    # inductive / OOV regime (defaults.yaml:102-123)
    "train_oov": False,
    "inductive_mapper": None,
    "inductive_embedder": None,
    "add_oov_buckets": False,
    "n_user_oov_buckets": 100,
    "n_item_oov_buckets": 100,
    "oov_train_ratio": 0.2,
    "oov_feature_mask_rate": 0.2,
    "oov_prime_pad": 112062759511,
    "oov_hash_function": "3round",
    "oov_only_epoch": True,
    "oov_eval_batch_size": -1,
    "oov_freeze_embedding": False,
    "oov_debug_skip_eval": False,
    "oov_debug_skip_train": False,
    "oov_shuffle_epoch": True,
    "oov_freeze_skip_optim": False,
    # TPU dispatch paths the trainer takes only on request
    # (defaults.yaml:134, 146, 155): auto means the host pipeline here
    "use_mesh": False,
    "device_epoch": "auto",
    "host_scan_steps": "auto",
    # evaluation (defaults.yaml:49-61, :123, :143)
    "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision"],
    "topk": [10],
    "eval_batch_size": 4096,
    "metric_decimal_place": 4,
    "use_perturbed_hits": True,
    "use_fused_topk": "auto",
    # precision policy (utils/precision.py) and xDeepFM's CIN kernel switch
    "compute_dtype": "float32",
    "fused_cin": "auto",
}

RANKING_METRICS = {
    "recall", "mrr", "ndcg", "hit", "precision", "map", "gauc",
    "itemcoverage", "averagepopularity", "shannonentropy", "giniindex",
    "tailpercentage",
}
VALUE_METRICS = {"auc", "rmse", "mae", "logloss"}


class Config:
    """Dict-like resolved configuration: defaults updated by `config_dict`."""

    def __init__(self, config_dict: Optional[Dict[str, Any]] = None):
        self.final_config_dict = copy.deepcopy(DEFAULTS)
        self.final_config_dict.update(config_dict or {})
        self._derive()

    def _derive(self) -> None:
        d = self.final_config_dict
        if isinstance(d.get("metrics"), str):
            d["metrics"] = [d["metrics"]]
        if isinstance(d.get("topk"), int):
            d["topk"] = [d["topk"]]
        kinds = set()
        for m in d.get("metrics") or []:
            ml = m.lower()
            if ml in RANKING_METRICS:
                kinds.add(EvaluatorType.RANKING)
            elif ml in VALUE_METRICS:
                kinds.add(EvaluatorType.VALUE)
            else:
                raise NotImplementedError(f"There is no metric named '{m}'")
        if len(kinds) > 1:
            raise RuntimeError(
                "Ranking metrics and value metrics can not be used at the same time."
            )
        d["eval_type"] = kinds.pop() if kinds else EvaluatorType.RANKING

    def __getitem__(self, key: str) -> Any:
        return self.final_config_dict.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self.final_config_dict[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.final_config_dict

    def get(self, key: str, default: Any = None) -> Any:
        v = self.final_config_dict.get(key, default)
        return default if v is None else v

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.final_config_dict)



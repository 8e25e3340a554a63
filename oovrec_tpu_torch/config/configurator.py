"""Layered configuration.

Port of `oovrec_tpu/config/configurator.py:48-248`. Merge precedence,
lowest to highest:

  1. framework defaults   (`DEFAULTS`: `config/defaults.yaml`, a copy of
                           the JAX package's file, then the port's own
                           keys, `PORT_DEFAULTS`);
  2. model defaults       (`config/model/<Model>.yaml`, for the models the
                           port has);
  3. dataset defaults     (`config/dataset/<dataset>.yaml` or `.json`);
  4. user config files    (`config_file_list`);
  5. the config dict      (`config_dict`, where the command line lands).

`_derive` then sets `MODEL_INPUT_TYPE` from the port's model registry, the
metric kind (`eval_type`), `valid_metric_bigger` and the per-phase
`eval_args.mode`, as the JAX package does. The YAML files are read with
`yaml_subset.load`, which gives what `yaml.safe_load` gives on them: the
card's machine has no PyYAML.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, List, Optional

from oovrec_tpu_torch.config.yaml_subset import YamlSubsetError, load_file
from oovrec_tpu_torch.config.yaml_subset import load as yaml_load
from oovrec_tpu_torch.utils.enums import EvaluatorType, InputType

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))

# keys the port reads that the JAX defaults do not hold: the device the
# entry points run on (the counterpart of the JAX `--jax_platforms` switch;
# "cuda" never falls back to the CPU) and xDeepFM's CIN kernel switch
PORT_DEFAULTS: Dict[str, Any] = {"device": "cuda", "fused_cin": "auto"}
# the first layer: the defaults file, then the port's own keys
DEFAULTS: Dict[str, Any] = {
    **(load_file(os.path.join(_PKG_DIR, "defaults.yaml")) or {}), **PORT_DEFAULTS,
}

# what `_derive` sets from the other keys: a config restored from a
# checkpoint (where enums are stored as their strings) derives them anew
DERIVED_KEYS = frozenset({"MODEL_INPUT_TYPE", "eval_type", "valid_metric_bigger"})

# Metrics whose inputs are ranked top-k lists vs pooled scores.
RANKING_METRICS = {
    "recall", "mrr", "ndcg", "hit", "precision", "map", "gauc",
    "itemcoverage", "averagepopularity", "shannonentropy", "giniindex",
    "tailpercentage",
}
VALUE_METRICS = {"auc", "rmse", "mae", "logloss"}

SMALLER_METRICS = {"rmse", "mae", "logloss", "averagepopularity"}


class Config:
    """Dict-like resolved configuration. `config_dict` comes first, as the
    port's callers have always passed it; the JAX order is
    `Config(model, dataset, config_file_list, config_dict)`."""

    def __init__(
        self,
        config_dict: Optional[Dict[str, Any]] = None,
        model: Optional[str] = None,
        dataset: Optional[str] = None,
        config_file_list: Optional[List[str]] = None,
    ):
        self.final_config_dict: Dict[str, Any] = copy.deepcopy(DEFAULTS)

        pre = dict(config_dict or {})
        model = model or pre.get("model")
        dataset = dataset or pre.get("dataset")

        if model is not None:
            model_yaml = os.path.join(_PKG_DIR, "model", f"{model}.yaml")
            if os.path.isfile(model_yaml):
                self._load_yaml(model_yaml)
        if dataset is not None:
            for cand in (
                os.path.join(_PKG_DIR, "dataset", f"{dataset}.yaml"),
                os.path.join(_PKG_DIR, "dataset", f"{dataset}.json"),
            ):
                if os.path.isfile(cand):
                    self._load_any(cand)

        for f in config_file_list or []:
            self._load_any(f)

        self._deep_update(self.final_config_dict, pre)

        if model is not None:
            self.final_config_dict["model"] = model
        if dataset is not None:
            self.final_config_dict["dataset"] = dataset

        self._derive()

    # -- loading ----------------------------------------------------------

    def _load_yaml(self, path: str) -> None:
        self._deep_update(self.final_config_dict, load_file(path) or {})

    def _load_any(self, path: str) -> None:
        if path.endswith(".json"):
            with open(path) as f:
                d = json.load(f) or {}
            self._deep_update(self.final_config_dict, d)
        else:
            self._load_yaml(path)

    # keys whose dict value REPLACES the default instead of deep-merging:
    # a user-provided eval split {'LS': ...} must not inherit the default
    # {'RS': [...]} sibling (the strategy key is exclusive)
    _REPLACE_KEYS = frozenset({"split"})

    @staticmethod
    def _deep_update(base: Dict[str, Any], upd: Dict[str, Any]) -> None:
        for k, v in upd.items():
            if (
                isinstance(v, dict)
                and isinstance(base.get(k), dict)
                and k not in Config._REPLACE_KEYS
            ):
                Config._deep_update(base[k], v)
            else:
                base[k] = v

    # -- derivations ------------------------------------------------------

    def _derive(self) -> None:
        d = self.final_config_dict

        model = d.get("model")
        if model and "MODEL_INPUT_TYPE" not in d:
            from oovrec_tpu_torch.models import get_model_class

            try:
                d["MODEL_INPUT_TYPE"] = get_model_class(model).input_type
            except (ValueError, NotImplementedError):
                d["MODEL_INPUT_TYPE"] = InputType.POINTWISE

        metrics = d.get("metrics") or []
        if isinstance(metrics, str):
            metrics = [metrics]
            d["metrics"] = metrics
        kinds = set()
        for m in metrics:
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

        vm = str(d.get("valid_metric", "MRR@10")).split("@")[0].lower()
        d["valid_metric_bigger"] = vm not in SMALLER_METRICS

        if isinstance(d.get("topk"), int):
            d["topk"] = [d["topk"]]

        ea = d.get("eval_args") or {}
        mode = ea.get("mode", "full")
        if isinstance(mode, str):
            ea["mode"] = {"valid": mode, "test": mode}
        ea.setdefault("split", {"RS": [0.8, 0.1, 0.1]})
        ea.setdefault("order", "RO")
        ea.setdefault("group_by", "user")
        d["eval_args"] = ea

        d.setdefault("single_spec", True)

    # -- mapping interface -------------------------------------------------

    def __getitem__(self, key: str) -> Any:
        return self.final_config_dict.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self.final_config_dict[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.final_config_dict

    def get(self, key: str, default: Any = None) -> Any:
        v = self.final_config_dict.get(key, default)
        return default if v is None else v

    def keys(self):
        return self.final_config_dict.keys()

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.final_config_dict)

    def __repr__(self) -> str:
        return (f"Config({self.final_config_dict.get('model')}, "
                f"{self.final_config_dict.get('dataset')})")


def parse_cli_args(argv: List[str]) -> Dict[str, Any]:
    """`--key=value` args with type inference (ints, floats, booleans,
    None and bracketed YAML flow values); a bare `--key` is True."""
    out: Dict[str, Any] = {}
    for arg in argv:
        if not arg.startswith("--"):
            continue
        body = arg[2:]
        if "=" in body:
            k, v = body.split("=", 1)
            out[k] = _infer(v)
        else:
            out[body] = True
    return out


def _infer(v: str) -> Any:
    s = v.strip()
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null", "~"):
        return None
    if re.fullmatch(r"[+-]?\d+", s):
        return int(s)
    try:
        return float(s)
    except ValueError:
        pass
    if (s.startswith("[") and s.endswith("]")) or (
        s.startswith("{") and s.endswith("}")
    ):
        try:
            return yaml_load(s)
        except YamlSubsetError:
            return s
    return s

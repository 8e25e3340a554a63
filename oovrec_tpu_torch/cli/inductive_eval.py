"""perform_inductive_eval: checkpoint → `_ind` corpus → 7-slice metrics.

Port of `oovrec_tpu/cli/inductive_eval.py:34-173`:
  * build the inductive corpus `<dataset>_ind` from its benchmark files
    ['train', 'empty', 'test_filt'] with topk [3, 5, 10, 20];
  * reconcile its vocabularies to the training dataset and check that the
    shared-entity feature rows are identical;
  * rebuild the model with the ORIGINAL user / item counts and its
    embedder state in 'inductive' mode over the `_ind` corpus (feature
    matrices and knn neighbors of every entity), load the checkpoint's
    parameters (the port's `torch.save` file), its BatchNorm running
    statistics (DCNv2; the JAX module's `extra_vars`, `:136-145`) and of
    its embedder state only the LSH planes and DHE keys (`:116-150`),
    build the random mapper over the extended id space and run the
    `InductiveEvaluator`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from oovrec_tpu_torch.config import Config
from oovrec_tpu_torch.config.configurator import DERIVED_KEYS
from oovrec_tpu_torch.data.utils import create_dataset, data_preparation
from oovrec_tpu_torch.eval.inductive import InductiveEvaluator
from oovrec_tpu_torch.inductive.mapper import RandomOOVMapper
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models.base import load_params
from oovrec_tpu_torch.utils.logging import init_logger


def create_ind_dataset(config: Config, orig_dataset):
    """→ (config of `<dataset>_ind`, its `InductiveDataset`)."""
    ind_cfg = Config(config.as_dict())
    ind_cfg["dataset"] = config["dataset"] + "_ind"
    ind_cfg["benchmark_filename"] = ["train", "empty", "test_filt"]
    ind_cfg["topk"] = [3, 5, 10, 20]
    # the _ind corpus has no is_new column in its benchmark files
    lc = dict(ind_cfg["load_col"] or {})
    if "inter" in lc and "is_new" in (lc["inter"] or []):
        lc["inter"] = [c for c in lc["inter"] if c != "is_new"]
        ind_cfg["load_col"] = lc
    if config["oov_eval_batch_size"] and int(config["oov_eval_batch_size"]) > 0:
        ind_cfg["eval_batch_size"] = int(config["oov_eval_batch_size"])
    ind_dataset = create_dataset(ind_cfg, inductive=True)
    ind_dataset.set_orig_dataset(orig_dataset)
    return ind_cfg, ind_dataset


def check_feature_consistency(orig_dataset, ind_dataset) -> None:
    """Shared-entity feature rows must be identical after the
    reconciliation."""
    ind_dataset.remap_features()
    for getter in ("get_user_feature", "get_item_feature"):
        orig_f = getattr(orig_dataset, getter)()
        ind_f = getattr(ind_dataset, getter)()
        for field, ov in orig_f.items():
            if field.endswith("_len") or field not in ind_f:
                continue
            n = len(ov)
            iv = ind_f[field]
            if iv.ndim > 1 and ov.ndim > 1 and iv.shape[1] != ov.shape[1]:
                iv = iv[:, : ov.shape[1]]
            if not np.array_equal(np.asarray(iv)[1:n], np.asarray(ov)[1:]):
                raise AssertionError(
                    f"feature rows differ between train and inductive "
                    f"datasets for field [{field}]"
                )


def perform_inductive_eval(
    orig_dataset,
    checkpoint_path: str,
    oov_eval_batch_size: Optional[int] = None,
    config: Optional[Config] = None,
) -> Dict[str, Dict[str, float]]:
    """The 7-slice inductive evaluation of a saved checkpoint."""
    from oovrec_tpu_torch.cli.quick_start import build_model_and_state, load_data_and_model

    logger = init_logger()
    if orig_dataset is None:
        loaded = load_data_and_model(checkpoint_path)
        orig_dataset = loaded.dataset
        if config is None:
            config = loaded.config

    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if config is None:
        config = Config({k: v for k, v in ckpt["config"].items() if k not in DERIVED_KEYS})
    if oov_eval_batch_size:
        config["oov_eval_batch_size"] = oov_eval_batch_size

    ind_cfg, ind_dataset = create_ind_dataset(config, orig_dataset)
    check_feature_consistency(orig_dataset, ind_dataset)
    _, _, test_loader = data_preparation(ind_cfg, ind_dataset)

    n_old_users = orig_dataset.user_num
    n_old_items = orig_dataset.item_num
    spec = InductiveSpec.from_config(config)

    model = build_model_and_state(
        ind_cfg, ind_dataset, mode="inductive",
        n_entities=(n_old_users, n_old_items), fields_from=orig_dataset,
    )
    load_params(model, ckpt["params"])

    mapper = None
    if spec.active and spec.mapper is not None:
        mapper = RandomOOVMapper(spec, n_old_users, n_old_items,
                                 ind_dataset.user_num, ind_dataset.item_num)
        mapper.set_eval()

    evaluator = InductiveEvaluator(model, ind_cfg, n_old_users, n_old_items, mapper=mapper)
    results = evaluator.evaluate_model(test_loader)
    for s, r in results.items():
        logger.info(f"[{s}] {dict(r)}")
    if any(results.get(s) for s in ("old_new", "new_old")):
        logger.info(
            "note: old_new/new_old use the intended complementary-mask "
            "semantics (see eval/inductive.py docstring) and are NOT "
            "numerically comparable with reference-produced numbers for "
            "those two slices"
        )
    return results

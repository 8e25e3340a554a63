"""run / objective_function / load_data_and_model: the end-to-end driver.

Port of `oovrec_tpu/cli/quick_start.py:28-342`: config → dataset →
loaders → model → `Trainer.fit` → test evaluation, and the one-call
restore of a saved run. Everything runs on `config["device"]` ("cuda"
unless the caller asks for "cpu"; CUDA asked for and absent raises).

What the JAX driver does and the port refuses: the migration from a
reference `.pth` (`import_torch_checkpoint`, ROADMAP.md queue 1 "Trainer
leftovers") and the multi-host bootstrap (`coordinator_address` /
`num_processes`, ROADMAP.md queue 1 "Parallelism").
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from oovrec_tpu_torch.config import Config
from oovrec_tpu_torch.config.configurator import DERIVED_KEYS
from oovrec_tpu_torch.data.utils import create_dataset, data_preparation
from oovrec_tpu_torch.inductive.factory import build_embedder_state, needs_state
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.models import get_model_class
from oovrec_tpu_torch.models.context import ContextRecommender, field_spec_from_dataset
from oovrec_tpu_torch.train.trainer import Trainer
from oovrec_tpu_torch.utils.device import resolve_device
from oovrec_tpu_torch.utils.logging import init_logger
from oovrec_tpu_torch.utils.precision import set_policy
from oovrec_tpu_torch.utils.seeding import init_seed, torch_generator

# constructor arguments the driver sets itself; the others come from the
# config where it holds them (`mlp_hidden_size`, `fused_cin`, ...)
_CLAIMED = frozenset({
    "spec", "uid_field", "iid_field", "label_field", "neg_prefix", "fields",
    "embedding_size", "n_users", "n_items", "device", "generator", "embedder_state",
})


def _ctor_params(cls) -> Dict[str, inspect.Parameter]:
    """Named constructor parameters of `cls` and its bases (below
    `nn.Module`)."""
    params: Dict[str, inspect.Parameter] = {}
    for klass in cls.__mro__:
        if klass is nn.Module or "__init__" not in klass.__dict__:
            continue
        for p in inspect.signature(klass.__init__).parameters.values():
            if p.name != "self" and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                params.setdefault(p.name, p)
    return params


def _coerce(value, default):
    """A config value in the type of the constructor's default (a YAML
    quirk: '1e-05' reads as a string)."""
    if isinstance(value, list):
        return tuple(value)
    if isinstance(default, bool):
        return value.lower() in ("true", "1", "yes") if isinstance(value, str) else value
    if isinstance(default, float) and isinstance(value, (str, int)):
        return float(value)
    if isinstance(default, int) and isinstance(value, str):
        return int(value)
    return value


def model_kwargs(config, cls) -> Dict[str, Any]:
    """The constructor arguments of `cls` that come from `config`: each
    named parameter that `build_model_and_state` does not set itself,
    where the config holds a value, in the type of the parameter's default
    (`mlp_hidden_size` a tuple, `mixed` a bool)."""
    return {name: _coerce(config[name], p.default) for name, p in _ctor_params(cls).items()
            if name not in _CLAIMED and name in config.keys() and config[name] is not None}


def build_model_and_state(config, dataset, mode: str = "transductive",
                          n_entities=None, fields_from=None):
    """The model for `config["model"]` on `config["device"]`, its weights
    drawn from `torch_generator(seed)`.

    `n_entities=(n_users, n_items)` overrides the table sizes when the
    model is rebuilt against the inductive corpus with the ORIGINAL
    counts; `fields_from` is the dataset a context model's field spec
    comes from (the training dataset in that rebuild, so the packed
    tables match the checkpoint). The embedder state
    (`inductive/factory.py:build_embedder_state`) is built over `dataset`
    in `mode` ('transductive', or 'inductive' over the `_ind` corpus, as
    `oovrec_tpu/cli/quick_start.py:122-131` builds it) and handed to the
    model, which keeps it as buffers."""
    cls = get_model_class(config["model"])
    spec = InductiveSpec.from_config(config)
    if not spec.active:
        spec = None
    device = resolve_device(config["device"])
    seed = int(config["seed"] or 2020)
    n_users, n_items = n_entities or (dataset.user_num, dataset.item_num)

    state = None
    if needs_state(spec):
        state = build_embedder_state(
            spec, dataset, n_users, n_items, mode=mode, seed=seed,
            hash_key_dir=config.get("hash_key_dir") or "./hash_keys",
        )
    kwargs: Dict[str, Any] = dict(
        spec=spec,
        uid_field=config["USER_ID_FIELD"],
        iid_field=config["ITEM_ID_FIELD"],
        device=device,
        generator=torch_generator(seed, device),
        embedder_state=state,
    )
    if issubclass(cls, ContextRecommender):
        fields = field_spec_from_dataset(fields_from or dataset, config)
        if n_entities is not None:
            dims = list(fields.token_dims)
            dims[0], dims[1] = n_users, n_items
            fields = dataclasses.replace(fields, token_dims=tuple(dims))
        kwargs.update(fields=fields, label_field=config["LABEL_FIELD"],
                      embedding_size=int(config.get("embedding_size", 10)))
    else:
        kwargs.update(n_users=n_users, n_items=n_items, neg_prefix=config["NEG_PREFIX"],
                      embedding_size=int(config.get("embedding_size", 64)))
    kwargs.update(model_kwargs(config, cls))
    return cls(**kwargs)


def _refuse_unported(config) -> None:
    if config["import_torch_checkpoint"]:
        raise NotImplementedError(
            "import_torch_checkpoint (seeding from a reference .pth) is not ported "
            "(ROADMAP.md, queue 1: trainer leftovers)")
    if config["coordinator_address"] or (config["num_processes"] or 0) > 1:
        raise NotImplementedError(
            "the multi-host bootstrap (coordinator_address / num_processes) is not "
            "ported (ROADMAP.md, queue 1: parallelism)")


def _draw_template(train_loader) -> None:
    """Make the template batch the JAX driver builds before its model init
    (`quick_start.py:200-202`). Its negatives come from the sampler's shared
    stream, so drawing it here keeps the training negatives on the JAX
    run's stream; the port's model needs no template."""
    train_loader._make_batch(np.arange(min(2, max(len(train_loader.split), 1))))


def run(
    model: Optional[str] = None,
    dataset: Optional[str] = None,
    config_file_list: Optional[List[str]] = None,
    config_dict: Optional[Dict[str, Any]] = None,
    saved: bool = True,
):
    """Full train + test run. → the result dict of the JAX driver."""
    config = Config(config_dict, model=model, dataset=dataset,
                    config_file_list=config_file_list)
    _refuse_unported(config)
    resolve_device(config["device"])
    init_seed(int(config["seed"] or 2020), config["reproducibility"])
    logger = init_logger(config)
    set_policy(config.get("compute_dtype", "float32"))

    ds = create_dataset(config)
    train_loader, valid_loader, test_loader = data_preparation(config, ds)
    _draw_template(train_loader)
    model_obj = build_model_and_state(config, ds)
    n_params = sum(p.numel() for p in model_obj.parameters())
    logger.info(f"model: {config['model']}  trainable params: {n_params:,}")
    trainer = Trainer(config, model_obj)

    best_valid_score, best_valid_result = trainer.fit(train_loader, valid_loader, saved=saved)
    test_result = trainer.evaluate(test_loader, load_best_model=saved)

    logger.info(f"best valid: {best_valid_result}")
    logger.info(f"test result: {test_result}")
    return {
        "best_valid_score": best_valid_score,
        "valid_score_bigger": config["valid_metric_bigger"],
        "best_valid_result": best_valid_result,
        "test_result": test_result,
        "trainer": trainer,
        "config": config,
        "dataset": ds,
    }


def objective_function(config_dict=None, config_file_list=None, saved: bool = False):
    """Hyper-tuning / test objective."""
    res = run(config_dict=config_dict, config_file_list=config_file_list, saved=saved)
    return {k: res[k] for k in (
        "best_valid_score", "valid_score_bigger", "best_valid_result", "test_result")}


@dataclasses.dataclass
class LoadedRun:
    """What `load_data_and_model` restores. Iterating yields the
    reference's 6-tuple (config, model, dataset, train, valid, test)."""

    config: Any
    model: Any
    dataset: Any
    train_loader: Any
    valid_loader: Any
    test_loader: Any
    trainer: Any

    def __iter__(self):
        return iter((self.config, self.model, self.dataset,
                     self.train_loader, self.valid_loader, self.test_loader))


def load_data_and_model(model_file: str,
                        config_overrides: Optional[Dict[str, Any]] = None) -> LoadedRun:
    """Restore a saved run in one call: the config stored in the
    checkpoint (with `config_overrides` on top) rebuilds the dataset,
    loaders and model, and the checkpoint's parameters and trainer state
    are loaded. The same seed re-derives the loaders' streams, so
    `trainer.evaluate(test_loader)` reproduces the run's test metrics
    (the uni-N candidates included)."""
    state = torch.load(model_file, map_location="cpu", weights_only=True)
    cfg_dict = {k: v for k, v in state["config"].items() if k not in DERIVED_KEYS}
    if config_overrides:
        cfg_dict.update(config_overrides)
    config = Config(cfg_dict)
    _refuse_unported(config)
    init_seed(int(config["seed"] or 2020), config["reproducibility"])
    set_policy(config.get("compute_dtype", "float32"))
    ds = create_dataset(config)
    train_loader, valid_loader, test_loader = data_preparation(config, ds)
    _draw_template(train_loader)
    model = build_model_and_state(config, ds)
    trainer = Trainer(config, model)
    trainer.resume_checkpoint(model_file)
    return LoadedRun(config=config, model=model, dataset=ds, train_loader=train_loader,
                     valid_loader=valid_loader, test_loader=test_loader, trainer=trainer)

"""Dataset and loader factory.

Port of `oovrec_tpu/data/utils.py:28-189`: `create_dataset` (with the
`save_dataset` pickle cache keyed on the dataset arguments),
`eval_mode_to_neg_args` and `data_preparation`, which splits the dataset,
builds the cross-phase sampler and the train / valid / test batchers
(full sort for 'full', plain labelled rows for 'labeled', sampled
negatives for 'uniN' / 'popN'). A sequential model gets the
`SequentialDataset` (`data/sequential.py`) and, under full sort, its
`SeqFullSortEvalBatcher`. The loaders take the process pair from the
caller (one process when it gives none). A knowledge model gets the
`KnowledgeBasedDataset` (`data/kg_dataset.py`) and the `KGTrainBatcher`,
whose batches carry a block of triples and their negative tails
(`KGSampler`); a corpus without its `.kg` and `.link` files is refused
before any work, naming them (the JAX package falls back to the plain
`Dataset` and builds the model with no entities, ROADMAP.md §3).
GRU4RecKG and KSR get the `KGSeqDataset` on a corpus with both files, as
in the JAX package (the model build refuses them there), and the plain
`SequentialDataset` without. A model that trains on users
(`train_on_users`: the autoencoders and ENMF) gets the `UserTrainBatcher`.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
from typing import Optional, Tuple

from oovrec_tpu_torch.data.dataloader import (
    FullSortEvalBatcher,
    KGTrainBatcher,
    NegSampleEvalBatcher,
    PlainEvalBatcher,
    TrainBatcher,
    UserTrainBatcher,
)
from oovrec_tpu_torch.data.dataset import Dataset
from oovrec_tpu_torch.data.inductive_dataset import InductiveDataset
from oovrec_tpu_torch.data.kg_dataset import KnowledgeBasedDataset
from oovrec_tpu_torch.data.kg_seq_dataset import KGSeqDataset
from oovrec_tpu_torch.data.sampler import KGSampler, Sampler
from oovrec_tpu_torch.data.sequential import (
    SeqDatasetSplit,
    SeqFullSortEvalBatcher,
    SequentialDataset,
)
from oovrec_tpu_torch.utils.enums import InputType, ModelType

DATASET_CACHE_ARGS = (
    "dataset", "data_path", "load_col", "unload_col", "rm_dup_inter",
    "val_interval", "user_inter_num_interval", "item_inter_num_interval",
    "filter_inter_by_user_or_item", "threshold", "normalize_field",
    "normalize_all", "discretization", "numerical_features", "seed",
    "benchmark_filename", "MAX_ITEM_LIST_LENGTH",
)
# sequential models whose JAX dataset is `KGSeqDataset` when the corpus
# ships `.kg` and `.link` files (`data/utils.py:70-80` of the JAX package)
KG_SEQUENTIAL = ("GRU4RecKG", "KSR")


def _missing_kg_files(config):
    """The corpus' `.kg` and `.link` paths that do not exist."""
    path = os.path.join(config["data_path"], config["dataset"])
    files = (os.path.join(path, f"{config['dataset']}.{ext}") for ext in ("kg", "link"))
    return [f for f in files if not os.path.isfile(f)]


def _dataset_cache_path(config) -> str:
    key = {k: config[k] for k in DATASET_CACHE_ARGS}
    digest = hashlib.sha1(
        json.dumps(key, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]
    d = config.get("checkpoint_dir", "saved")
    return f"{d}/{config['dataset']}-dataset-{digest}.pkl"


def _model_class(config):
    from oovrec_tpu_torch.models import get_model_class

    try:
        return get_model_class(config["model"]) if config["model"] else None
    except (ValueError, NotImplementedError):
        return None


def create_dataset(config, inductive: bool = False):
    """The dataset for the config's model. Under `save_dataset` the
    processed `Dataset` round-trips through a pickle keyed on the dataset
    arguments; a sequential or knowledge model's dataset is never read
    from or written to it (the key names no model, so a general model
    would load it, and the JAX package's knowledge branch, behind its
    pickle read, would load a general model's)."""
    if inductive:
        return InductiveDataset(config)
    cls = _model_class(config)
    mt = getattr(cls, "model_type", None)
    if mt == ModelType.SEQUENTIAL:
        if config["model"] in KG_SEQUENTIAL and not _missing_kg_files(config):
            return KGSeqDataset(config)
        return SequentialDataset(config)
    if mt == ModelType.KNOWLEDGE:
        missing = _missing_kg_files(config)
        if missing:
            raise ValueError(f"[{config['model']}] needs the corpus' knowledge graph: "
                             f"{', '.join(missing)} not found")
        return KnowledgeBasedDataset(config)
    cache_path = None
    if config.get("save_dataset"):
        cache_path = config.get("dataset_save_path") or _dataset_cache_path(config)
        if os.path.isfile(cache_path):
            with open(cache_path, "rb") as f:
                ds = pickle.load(f)
            ds.config = config
            return ds
    ds = Dataset(config)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(ds, f)
    return ds


def eval_mode_to_neg_args(mode: str) -> Optional[dict]:
    """'uni250' → {'distribution': 'uniform', 'sample_num': 250};
    'full' / 'labeled' → None."""
    if mode in ("full", "labeled"):
        return None
    m = re.fullmatch(r"(uni|pop)(\d+)", mode)
    if not m:
        raise NotImplementedError(f"eval mode [{mode}] is not supported")
    dist = "uniform" if m.group(1) == "uni" else "popularity"
    return {"distribution": dist, "sample_num": int(m.group(2))}


def data_preparation(config, dataset, process_index: Optional[int] = None,
                     process_count: Optional[int] = None
                     ) -> Tuple[object, object, object]:
    """Split, sampler and the (train, valid, test) batchers. An empty
    valid or test split gives None for its loader."""
    train_split, valid_split, test_split = dataset.build()[:3]

    nsa = config["train_neg_sample_args"] or {"distribution": "none"}
    sampler = Sampler(
        ["train", "valid", "test"],
        [train_split, valid_split, test_split],
        distribution=nsa.get("distribution", "uniform")
        if nsa.get("distribution", "none") != "none"
        else "uniform",
        alpha=nsa.get("alpha", 1.0),
        seed=int(config["seed"] or 2020),
        repeatable=bool(config["repeatable"]),
    )
    procs = dict(process_index=process_index, process_count=process_count)

    input_type = config["MODEL_INPUT_TYPE"] or InputType.POINTWISE
    # the JAX branch's order (`data/utils.py:132-163` there): the knowledge
    # dataset (a `KGSeqDataset` too), then the user batches, then the rows
    cls = _model_class(config)
    # the global batch on every rank (one sampler stream, as one process
    # draws it): the mesh trainer takes each rank's rows
    # (`parallel/mesh.py:place_batch`, padded as `pad_batch` pads them), so
    # a run on n ranks trains on the batches of a run on one; the user
    # batches are global too
    train_procs = procs if process_count is not None else dict(
        process_index=0, process_count=1)
    if isinstance(dataset, KnowledgeBasedDataset):
        heads, _, tails = dataset.kg_triples
        kg_sampler = KGSampler(heads, tails, dataset.entity_num,
                               seed=int(config["seed"] or 2020))
        train_loader = KGTrainBatcher(train_split, sampler, config, input_type, phase="train",
                                      kg_dataset=dataset, kg_sampler=kg_sampler, **train_procs)
    elif getattr(cls, "train_on_users", False):
        train_loader = UserTrainBatcher(train_split, config)
    else:
        train_loader = TrainBatcher(train_split, sampler, config, input_type, phase="train",
                                    **train_procs)

    def eval_loader(split, phase):
        mode = config["eval_args"]["mode"]["valid" if phase == "valid" else "test"]
        neg_args = eval_mode_to_neg_args(mode)
        if isinstance(split, SeqDatasetSplit) and neg_args is None:
            return SeqFullSortEvalBatcher(split, config)
        if mode == "labeled":
            return PlainEvalBatcher(split, config)
        if neg_args is None:
            return FullSortEvalBatcher(split, sampler, config, phase=phase, **procs)
        return NegSampleEvalBatcher(split, sampler, config, phase=phase,
                                    neg_sample_args=neg_args, **procs)

    valid_loader = eval_loader(valid_split, "valid") if len(valid_split) else None
    test_loader = eval_loader(test_split, "test") if len(test_split) else None
    return train_loader, valid_loader, test_loader

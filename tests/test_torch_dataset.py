"""The port's numpy data layer against the JAX package's pandas one.

Exact on every integer and float:
  * `load_atomic_file` on every atomic file of the toy-ind and synth-ind
    corpora (token cells as strings, floats bit for bit, sequence cells
    element for element);
  * `Dataset`: vocabularies (`field2id_token`), field types and sources,
    the feature tables and the splits for RS and LS, TO and RO, group_by
    user and None, with the k-core, threshold, normalization and
    discretization options;
  * `InductiveDataset` over `<dataset>_ind` with the JAX driver's
    benchmark files, `check_feature_consistency` and its splits;
  * `data_preparation`'s batches: two epochs of pairwise (BPR) and
    pointwise (xDeepFM) training batches, and the `NegSampleEvalBatcher`
    at uni 5 and uni 250 (one process, and each of two), full-sort and
    labelled eval batches, key for key;
  * `history_item_matrix`, `eval_mode_to_neg_args` and the `save_dataset`
    pickle cache.
"""

import copy
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from oovrec_tpu.cli.inductive_eval import check_feature_consistency as jax_check  # noqa: E402
from oovrec_tpu.cli.inductive_eval import create_ind_dataset as jax_create_ind  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.atomic import load_atomic_file as jax_load  # noqa: E402
from oovrec_tpu.data.dataset import Dataset as JaxDataset  # noqa: E402
from oovrec_tpu.data.utils import data_preparation as jax_prep  # noqa: E402
from oovrec_tpu.data.utils import eval_mode_to_neg_args as jax_neg_args  # noqa: E402
from oovrec_tpu_torch.cli.inductive_eval import (  # noqa: E402
    check_feature_consistency,
    create_ind_dataset,
)
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.atomic import load_atomic_file  # noqa: E402
from oovrec_tpu_torch.data.dataset import Dataset  # noqa: E402
from oovrec_tpu_torch.data.utils import (  # noqa: E402
    create_dataset,
    data_preparation,
    eval_mode_to_neg_args,
)
from oovrec_tpu_torch.utils.enums import FeatureType  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "tests", "assets")
DATASET = os.path.join(ROOT, "dataset")

ATOMIC_FILES = sorted(
    os.path.join(d, f)
    for base, names in ((ASSETS, ("toy-ind", "toy-ind_ind")),
                        (DATASET, ("synth-ind", "synth-ind_ind")))
    for d in (os.path.join(base, n) for n in names)
    for f in os.listdir(d) if f.rsplit(".", 1)[-1] in ("inter", "user", "item")
)
TOY_LOAD_COL = {"inter": ["user_id", "item_id", "rating", "timestamp", "is_new"],
                "user": ["user_id", "age", "gender"], "item": ["item_id", "price", "category"]}
SYNTH_LOAD_COL = {"inter": ["user_id", "item_id", "timestamp", "is_new"],
                  "user": ["user_id", "age", "group"], "item": ["item_id", "price", "category"]}
TOY = dict(data_path=ASSETS, dataset="toy-ind", load_col=TOY_LOAD_COL)
SYNTH = dict(data_path=DATASET, dataset="synth-ind", load_col=None)
PAPER_SPLIT = {"split": {"RS": [0.88, 0.02, 0.1]}, "order": "TO", "group_by": None}
DATASET_CASES = {
    "toy_rs_ro_user": TOY,
    "toy_numerical_threshold": dict(TOY, numerical_features=["age", "price"],
                                    threshold={"rating": 4}),
    "toy_ls_to_user": dict(TOY, eval_args={"split": {"LS": "valid_and_test"}, "order": "TO",
                                           "group_by": "user"}),
    "toy_ls_valid_only": dict(TOY, eval_args={"split": {"LS": "valid_only"}}),
    "toy_rs_to_none_normalized": dict(TOY, eval_args=PAPER_SPLIT, normalize_all=True),
    "toy_kcore_all_columns": dict(TOY, load_col=None, user_inter_num_interval="[3,inf)",
                                  item_inter_num_interval="[2,inf)"),
    "toy_discretized_dedup": dict(TOY, numerical_features=["age", "price"],
                                  discretization={"age": {"method": "ED", "bucket": 3},
                                                  "price": {"method": "LD"}},
                                  rm_dup_inter="first", val_interval={"rating": "[2,inf)"}),
    "toy_token_seq": dict(data_path=ASSETS, dataset="toy", load_col=None),
    "synth_all_columns": SYNTH,
    "synth_paper_split": dict(SYNTH, load_col=SYNTH_LOAD_COL, eval_args=PAPER_SPLIT,
                              numerical_features=["age", "price"]),
}


def _same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.int32 if a.itemsize == 4 else np.int64),
                              b.view(np.int32 if b.itemsize == 4 else np.int64)), what
    else:
        assert np.array_equal(a, b), what


def _same_arrays(a, b, what):
    assert list(a) == list(b), (what, list(a), list(b))
    for k in a:
        _same_array(a[k], b[k], f"{what}[{k}]")


def _same_vocab(port, jax_ds):
    assert [(k, v.value) for k, v in port.field2type.items()] == \
        [(k, v.value) for k, v in jax_ds.field2type.items()]
    assert [(k, v.value) for k, v in port.field2source.items()] == \
        [(k, v.value) for k, v in jax_ds.field2source.items()]
    assert list(port.field2id_token) == list(jax_ds.field2id_token)
    for f, tokens in jax_ds.field2id_token.items():
        assert list(port.field2id_token[f]) == list(tokens), f
        assert dict(port.field2token_id[f]) == dict(jax_ds.field2token_id[f]), f
    assert port.field2bucketnum == jax_ds.field2bucketnum
    assert (port.user_num, port.item_num, len(port)) == (jax_ds.user_num, jax_ds.item_num,
                                                          len(jax_ds))


def _same_splits(port_splits, jax_splits):
    assert len(port_splits) == len(jax_splits)
    for ps, js in zip(port_splits, jax_splits):
        _same_array(ps.index, js.index, "split index")
        _same_arrays(ps.inter, js.inter, "split")


@pytest.mark.parametrize("path", ATOMIC_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_load_atomic_file_matches_pandas(path):
    cols, f2t = load_atomic_file(path)
    df, jf2t = jax_load(path)
    assert [(k, v.value) for k, v in f2t.items()] == [(k, v.value) for k, v in jf2t.items()]
    assert list(cols) == list(df.columns)
    for field, ftype in f2t.items():
        got, want = cols[field], list(df[field])
        assert len(got) == len(want)
        if ftype == FeatureType.TOKEN:
            assert list(got) == [str(v) for v in want], field
        elif ftype == FeatureType.FLOAT:
            _same_array(got, np.asarray(want, np.float64), field)
        else:
            for g, w in zip(got, want):
                _same_array(g, w, field)


@pytest.mark.parametrize("name", sorted(DATASET_CASES))
def test_dataset_matches_jax(name):
    cfg = DATASET_CASES[name]
    port = Dataset(Config(copy.deepcopy(cfg)))
    jax_ds = JaxDataset(JaxConfig(config_dict=copy.deepcopy(cfg)))
    _same_vocab(port, jax_ds)
    _same_arrays(port.get_user_feature(), jax_ds.get_user_feature(), "user features")
    _same_arrays(port.get_item_feature(), jax_ds.get_item_feature(), "item features")
    _same_splits(port.build(), jax_ds.build())
    for h in (None, 2):
        for a, b in zip(port.history_item_matrix(h), jax_ds.history_item_matrix(h)):
            _same_array(a, b, "history_item_matrix")


@pytest.mark.parametrize("base", [TOY, dict(SYNTH, load_col=SYNTH_LOAD_COL)],
                         ids=["toy-ind", "synth-ind"])
def test_inductive_dataset_matches_jax(base):
    cfg = dict(base, numerical_features=["age", "price"])
    port_orig = Dataset(Config(copy.deepcopy(cfg)))
    jax_orig = JaxDataset(JaxConfig(config_dict=copy.deepcopy(cfg)))
    port_cfg, port = create_ind_dataset(Config(copy.deepcopy(cfg)), port_orig)
    jax_cfg, jax_ds = jax_create_ind(JaxConfig(config_dict=copy.deepcopy(cfg)), jax_orig)
    assert port_cfg["benchmark_filename"] == ["train", "empty", "test_filt"]
    assert port_cfg["topk"] == [3, 5, 10, 20]
    check_feature_consistency(port_orig, port)
    jax_check(jax_orig, jax_ds)
    _same_vocab(port, jax_ds)
    assert port.user_num > port_orig.user_num and port.item_num >= port_orig.item_num
    _same_arrays(port.get_user_feature(), jax_ds.get_user_feature(), "ind user features")
    _same_arrays(port.get_item_feature(), jax_ds.get_item_feature(), "ind item features")
    _same_splits(port.build(), jax_ds.build())


def _batches(loader, epochs=1):
    return [b for _ in range(epochs) for b in loader]


def _same_batches(port_loader, jax_loader, what, epochs=1):
    pb, jb = _batches(port_loader, epochs), _batches(jax_loader, epochs)
    assert len(pb) == len(jb) > 0, what
    for i, (p, j) in enumerate(zip(pb, jb)):
        _same_arrays(p, j, f"{what} batch {i}")


PREP_CASES = {
    "bpr_full": dict(TOY, model="BPR", train_batch_size=6),
    "bpr_uni5": dict(TOY, model="BPR", train_batch_size=6,
                     eval_args={"mode": "uni5", **PAPER_SPLIT}, eval_batch_size=40),
    "bpr_uni250": dict(TOY, model="BPR", train_batch_size=6,
                       eval_args={"mode": "uni250", **PAPER_SPLIT}, eval_batch_size=1000),
    "xdeepfm_uni250": dict(TOY, model="xDeepFM", train_batch_size=8,
                           numerical_features=["age", "price"], threshold={"rating": 4},
                           metrics=["AUC", "RMSE"], valid_metric="RMSE",
                           eval_args={"mode": "uni250", **PAPER_SPLIT}, eval_batch_size=600),
    "xdeepfm_labeled": dict(TOY, model="xDeepFM", train_batch_size=8,
                            numerical_features=["age", "price"], threshold={"rating": 4},
                            metrics=["AUC"], valid_metric="AUC",
                            eval_args={"mode": "labeled"}),
    "bpr_synth_uni250": dict(SYNTH, model="BPR", load_col=SYNTH_LOAD_COL,
                             train_batch_size=2048, eval_args={"mode": "uni250", **PAPER_SPLIT},
                             eval_batch_size=100_000),
}


@pytest.mark.parametrize("name", sorted(PREP_CASES))
def test_data_preparation_batches_match_jax(name):
    cfg = PREP_CASES[name]
    pcfg, jcfg = Config(copy.deepcopy(cfg)), JaxConfig(config_dict=copy.deepcopy(cfg))
    port = data_preparation(pcfg, Dataset(pcfg), process_index=0, process_count=1)
    jax_loaders = jax_prep(jcfg, JaxDataset(jcfg))
    epochs = 1 if name.startswith("bpr_synth") else 2
    _same_batches(port[0], jax_loaders[0], f"{name} train", epochs=epochs)
    for phase, p, j in zip(("valid", "test"), port[1:], jax_loaders[1:]):
        assert type(p).__name__ == type(j).__name__, phase
        if hasattr(j, "join_features"):
            assert (p.step, p.max_rows, p.max_users, p.max_pos, len(p)) == \
                (j.step, j.max_rows, j.max_users, j.max_pos, len(j))
        _same_batches(p, j, f"{name} {phase}", epochs=2)


def test_eval_mode_to_neg_args_matches_jax():
    for mode in ("full", "labeled", "uni5", "uni250", "pop100"):
        assert eval_mode_to_neg_args(mode) == jax_neg_args(mode)
    with pytest.raises(NotImplementedError):
        eval_mode_to_neg_args("sampled")


def test_save_dataset_cache_round_trip(tmp_path):
    cfg = Config(dict(TOY, save_dataset=True, checkpoint_dir=str(tmp_path)))
    first = create_dataset(cfg)
    cached = list(tmp_path.glob("toy-ind-dataset-*.pkl"))
    assert len(cached) == 1
    second = create_dataset(cfg)
    assert second is not first and second.config is cfg
    _same_arrays(second.get_item_feature(), first.get_item_feature(), "cached items")
    _same_splits(second.build(), first.build())


@pytest.mark.parametrize("order", [("GRU4Rec", "BPR"), ("BPR", "GRU4Rec")])
def test_save_dataset_cache_keeps_sequential_apart(order, tmp_path):
    """The cache key names only the dataset arguments: a sequential
    model's dataset is neither written to the cache nor read from it, so
    a general model in the same `checkpoint_dir` gets a plain `Dataset`
    and a sequential one its `SequentialDataset`, in either order."""
    from oovrec_tpu_torch.data.sequential import SequentialDataset
    from tests.test_torch_seq_data import _cfg as seq_cfg

    for model in order:
        cfg = Config(seq_cfg(model=model, save_dataset=True, checkpoint_dir=str(tmp_path)))
        ds = create_dataset(cfg)
        want = SequentialDataset if model == "GRU4Rec" else Dataset
        assert type(ds) is want, (model, type(ds))
        cached = list(tmp_path.glob("toy-dataset-*.pkl"))
        assert len(cached) == (order.index("BPR") <= order.index(model)), (model, cached)
    assert type(create_dataset(cfg)) is want


@pytest.mark.parametrize("process_index", [0, 1])
def test_neg_sample_batches_per_process_match_jax(process_index):
    """Two processes: each takes its interleaved user slice, pads to the
    global sizes and places its users in its own slot range."""
    from oovrec_tpu.data.dataloader import NegSampleEvalBatcher as JaxBatcher
    from oovrec_tpu_torch.data.dataloader import NegSampleEvalBatcher

    cfg = dict(SYNTH, model="BPR", load_col=SYNTH_LOAD_COL,
               eval_args={"mode": "uni250", **PAPER_SPLIT}, eval_batch_size=100_000)
    pcfg, jcfg = Config(copy.deepcopy(cfg)), JaxConfig(config_dict=copy.deepcopy(cfg))
    port_loaders = data_preparation(pcfg, Dataset(pcfg))
    jax_loaders = jax_prep(jcfg, JaxDataset(jcfg))
    procs = dict(process_index=process_index, process_count=2)
    p, j = port_loaders[1], jax_loaders[1]
    port = NegSampleEvalBatcher(p.split, p.sampler, pcfg, "valid", {"sample_num": 250}, **procs)
    jax_b = JaxBatcher(j.split, j.sampler, jcfg, "valid", {"sample_num": 250}, **procs)
    assert port.slot_offset == jax_b.slot_offset == process_index * port.step
    _same_batches(port, jax_b, f"process {process_index} of 2")

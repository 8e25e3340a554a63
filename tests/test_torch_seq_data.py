"""The port's sequential data path against the JAX package's, bit for bit.

`oovrec_tpu_torch/data/sequential.py` (numpy, the windows built without a
loop over rows) against `oovrec_tpu/data/sequential.py` (a pandas sort and
a Python loop) on the toy fixture and on a seeded corpus whose users have
tied timestamps and whose rows come in no order: the augmented examples
(`item_id_list`, `item_length`, the target, the user), the leave-one-out
splits and their `SeqFullSortEvalBatcher` batches (repeatable on and off,
eval batches of several rows and a padded tail), at MAX_ITEM_LIST_LENGTH
2, 4 and 50; DIEN's presampled negative lists; `data_preparation`'s
loaders (plain CE batches over two epochs, pairwise BPR batches, the
uni-N eval over sequential examples); and the five batch transforms
(mask, inverse, crop, reorder, user-defined) over several batches from
one seed. On a corpus with `.kg` and `.link` files the knowledge-graph
sequential models get the `KGSeqDataset` and the model build refuses
them; without, they get the plain `SequentialDataset`.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data import transform as jax_transform  # noqa: E402
from oovrec_tpu.data.sequential import SeqFullSortEvalBatcher as JaxSeqBatcher  # noqa: E402
from oovrec_tpu.data.sequential import SequentialDataset as JaxSeqDataset  # noqa: E402
from oovrec_tpu.data.utils import data_preparation as jax_prep  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data import transform as port_transform  # noqa: E402
from oovrec_tpu_torch.data.sequential import SeqFullSortEvalBatcher, SequentialDataset  # noqa: E402
from oovrec_tpu_torch.data.utils import create_dataset, data_preparation  # noqa: E402

from tests.test_torch_dataset import (  # noqa: E402
    ASSETS,
    _batches,
    _same_arrays,
    _same_batches,
    _same_splits,
)

TRANSFORMS = ["mask_itemseq", "inverse_itemseq", "crop_itemseq", "reorder_itemseq",
              "user_defined"]


def _cfg(data_path=ASSETS, dataset="toy", **over):
    d = {
        "model": "GRU4Rec", "dataset": dataset, "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "train_batch_size": 8, "eval_batch_size": 64, "MAX_ITEM_LIST_LENGTH": 4,
        "train_neg_sample_args": {"distribution": "none"},
        "eval_args": {"split": {"LS": "valid_and_test"}, "order": "TO",
                      "group_by": "user", "mode": "full"},
        "log_tensorboard": False, "seed": 11,
    }
    d.update(over)
    return d


@pytest.fixture(scope="module")
def tied(tmp_path_factory):
    """A seeded corpus: 40 users, 30 items, 600 rows in shuffled order,
    timestamps from 10 values (many ties within a user), one user with a
    single row and one with two."""
    rng = np.random.default_rng(5)
    n = 600
    users = np.r_[rng.integers(0, 38, n - 3), [38, 39, 39]]
    items = rng.integers(0, 30, n)
    times = rng.integers(0, 10, n).astype(float)
    order = rng.permutation(n)
    root = tmp_path_factory.mktemp("seq")
    os.makedirs(root / "tied")
    with open(root / "tied" / "tied.inter", "w") as f:
        f.write("user_id:token\titem_id:token\ttimestamp:float\n")
        for i in order:
            f.write(f"u{users[i]}\ti{items[i]}\t{times[i]:g}\n")
    return str(root)


def _datasets(cfg):
    return SequentialDataset(Config(dict(cfg))), JaxSeqDataset(JaxConfig(config_dict=dict(cfg)))


def _corpus(name, tied):
    return dict(dataset="toy") if name == "toy" else dict(dataset="tied", data_path=tied)


@pytest.mark.parametrize("max_len", [2, 4, 50])
@pytest.mark.parametrize("corpus", ["toy", "tied"])
def test_augmentation_and_splits_match_jax(corpus, max_len, tied):
    port, jax_ds = _datasets(_cfg(**_corpus(corpus, tied), MAX_ITEM_LIST_LENGTH=max_len))
    _same_arrays(port.data_augmentation(), jax_ds.data_augmentation(), "augmentation")
    assert port.data_augmentation()["item_id_list"].shape[1] == max_len
    _same_splits(port.build(), jax_ds.build())


@pytest.mark.parametrize("repeatable", [False, True])
@pytest.mark.parametrize("eval_batch", [64, 200])
@pytest.mark.parametrize("corpus", ["toy", "tied"])
def test_full_sort_batches_match_jax(corpus, eval_batch, repeatable, tied):
    cfg = _cfg(**_corpus(corpus, tied), eval_batch_size=eval_batch, repeatable=repeatable)
    port, jax_ds = _datasets(cfg)
    pc, jc = Config(dict(cfg)), JaxConfig(config_dict=dict(cfg))
    for ps, js in zip(port.build()[1:], jax_ds.build()[1:]):
        pb, jb = SeqFullSortEvalBatcher(ps, pc), JaxSeqBatcher(js, jc)
        assert pb.rows_per_batch == jb.rows_per_batch == max(1, eval_batch // port.item_num)
        assert len(pb) == len(jb) > 0
        _same_batches(pb, jb, "seq full sort")


def test_dien_presampled_lists_match_jax():
    port, jax_ds = _datasets(_cfg(dien_neg_sampling="presampled", seed=5))
    _same_arrays(port.data_augmentation(), jax_ds.data_augmentation(), "augmentation")
    assert "neg_item_id_list" in port.data_augmentation()


@pytest.mark.parametrize("case", ["plain", "pairwise", "uni5"])
def test_data_preparation_matches_jax(case, tied):
    """The loaders `data_preparation` builds over the examples, batch for
    batch: CE rows (plain), BPR rows with a sampled negative (pairwise),
    and the uni-N eval over the examples."""
    over = _corpus("tied", tied)
    if case == "pairwise":
        over.update(model="FPMC", train_neg_sample_args={"distribution": "uniform",
                                                          "sample_num": 1})
    if case == "uni5":
        over.update(eval_args={"split": {"LS": "valid_and_test"}, "order": "TO",
                               "group_by": "user", "mode": "uni5"})
    cfg = _cfg(**over)
    pc, jc = Config(dict(cfg)), JaxConfig(config_dict=dict(cfg))
    port, jax_ds = create_dataset(pc), JaxSeqDataset(jc)
    assert type(port) is SequentialDataset
    pl, jl = data_preparation(pc, port), jax_prep(jc, jax_ds)
    assert [type(x).__name__ for x in pl] == [type(x).__name__ for x in jl]
    _same_batches(pl[0], jl[0], "train", epochs=2)
    for p, j in zip(pl[1:], jl[1:]):
        _same_batches(p, j, type(p).__name__)


@pytest.mark.parametrize("model", ["GRU4RecKG", "KSR"])
def test_knowledge_graph_sequential_models_are_refused(model):
    """On a corpus with `.kg` and `.link` files (toy-kg) both packages
    build a `KGSeqDataset`, and neither builds the model on it: flax
    refuses the `n_entities` that JAX's `quick_start` passes (TypeError), the
    port's build refuses with its own error. Without them (toy) both take
    the plain `SequentialDataset`."""
    import oovrec_tpu.cli.quick_start as jax_quick_start
    from oovrec_tpu.data.utils import create_dataset as jax_create_dataset
    from oovrec_tpu_torch.cli.quick_start import build_model_and_state
    from oovrec_tpu_torch.data.kg_seq_dataset import KGSeqDataset

    cfg = _cfg(model=model, dataset="toy-kg", device="cpu")
    port = create_dataset(Config(dict(cfg)))
    jc = JaxConfig(config_dict=dict(cfg))
    jax_ds = jax_create_dataset(jc)
    assert type(port) is KGSeqDataset and type(jax_ds).__name__ == "KGSeqDataset"
    with pytest.raises(NotImplementedError, match="KGSeqDataset"):
        build_model_and_state(Config(dict(cfg)), port)
    with pytest.raises(TypeError, match="n_entities"):
        jax_quick_start.build_model_and_state(jc, jax_ds)
    assert type(create_dataset(Config(_cfg(model=model)))) is SequentialDataset


def double_items(batch):
    """The user-defined transform of the test: the item lists doubled."""
    out = dict(batch)
    out["item_id_list"] = batch["item_id_list"] * 2
    return out


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transforms_match_jax(name, tied):
    """Five batches through each transform of one seed: the same outputs,
    key for key, bit for bit (the random ones draw in JAX's order)."""
    cfg = _cfg(**_corpus("tied", tied), transform=name, mask_ratio=0.3, MAX_ITEM_LIST_LENGTH=6,
               user_defined_transform="tests.test_torch_seq_data:double_items")
    pc, jc = Config(dict(cfg)), JaxConfig(config_dict=dict(cfg))
    port = SequentialDataset(pc)
    n_items = port.item_num
    pt = port_transform.construct_transform(pc, n_items=n_items)
    jt = jax_transform.construct_transform(jc, n_items=n_items)
    assert type(pt).__name__ == type(jt).__name__
    inter = port.build()[0].inter
    for b in range(5):
        rows = slice(b * 32, (b + 1) * 32)
        batch = {k: v[rows] for k, v in inter.items()}
        got, want = pt(dict(batch)), jt(dict(batch))
        _same_arrays(got, want, f"{name} batch {b}")
        assert any(not np.array_equal(got[k], batch[k]) for k in batch) or set(got) > set(batch)


def test_mask_transform_through_the_train_loader(tied):
    """BERT4Rec's masked training batches from `data_preparation`, two
    epochs, against the JAX loader's."""
    cfg = _cfg(**_corpus("tied", tied), model="BERT4Rec", transform="mask_itemseq",
               mask_ratio=0.2)
    pc, jc = Config(dict(cfg)), JaxConfig(config_dict=dict(cfg))
    pl, jl = data_preparation(pc, create_dataset(pc)), jax_prep(jc, JaxSeqDataset(jc))
    _same_batches(pl[0], jl[0], "masked train", epochs=2)
    assert all("mask_index" in b for b in _batches(pl[0], 1))

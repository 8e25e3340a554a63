"""The port's knowledge-graph data path against the JAX package's, bit for
bit.

`oovrec_tpu_torch/data/kg_dataset.py` (numpy) against
`oovrec_tpu/data/kg_dataset.py` (pandas) on `tests/assets/toy-kg` and on a
seeded corpus (40 users, 30 items, 250 triples over 6 relations) with an
entity linked to two items (the last link wins), an item linked to two
entities, items without a link (their interactions go) or linked to an
entity in no triple, repeated triples and a self-loop: the entity and
relation ids, `kg_triples`, the filtered interactions and the
vocabularies, with `kg_reverse_r` on and off and under the entity and
relation k-cores. Then `KGTrainBatcher`'s batches over two epochs
(pairwise and pointwise, the graph tiled to a batch on toy-kg and cycled
through fresh permutations on the seeded corpus), `KGSampler`'s
negatives, the KGCN neighbours and the RippleNet ripple sets (at the
defaults and at other sizes) and `KGSeqDataset`. `create_dataset` keeps
the knowledge datasets out of the `save_dataset` pickle in either order
and refuses a corpus without its `.kg` / `.link` files, where the JAX
package falls back to the plain `Dataset`. The 7-slice inductive eval
refuses a knowledge model in every mode before any work (the JAX one
fails at the rebuild over the `_ind` corpus), and the device-epoch gate
keeps the knowledge models on the host path, as JAX's does.
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.inductive_eval as port_inductive  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli.inductive_eval import perform_inductive_eval as jax_inductive  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.kg_dataset import KnowledgeBasedDataset as JaxKG  # noqa: E402
from oovrec_tpu.data.kg_seq_dataset import KGSeqDataset as JaxKGSeq  # noqa: E402
from oovrec_tpu.data.sampler import KGSampler as JaxKGSampler  # noqa: E402
from oovrec_tpu.data.utils import create_dataset as jax_create_dataset  # noqa: E402
from oovrec_tpu.data.utils import data_preparation as jax_prep  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.dataloader import KGTrainBatcher  # noqa: E402
from oovrec_tpu_torch.data.dataset import Dataset  # noqa: E402
from oovrec_tpu_torch.data.kg_dataset import KnowledgeBasedDataset  # noqa: E402
from oovrec_tpu_torch.data.kg_seq_dataset import KGSeqDataset  # noqa: E402
from oovrec_tpu_torch.data.sampler import KGSampler  # noqa: E402
from oovrec_tpu_torch.data.utils import create_dataset, data_preparation  # noqa: E402
from oovrec_tpu_torch.models.knowledge.more import kg_neighbors  # noqa: E402
from oovrec_tpu_torch.models.knowledge.more2 import ripple_sets  # noqa: E402

from tests.test_torch_dataset import (  # noqa: E402
    ASSETS,
    _same_array,
    _same_arrays,
    _same_batches,
    _same_vocab,
)

LOAD_COL = {"inter": ["user_id", "item_id", "rating", "timestamp"]}


def write_kg_corpus(root, name="kgseed", seed=3, n_users=40, n_items=30, n_inter=500,
                    n_triples=250):
    """A seeded knowledge corpus under `root/name`. Items i0..i26 link to
    e0..e26; e7 links to i7 and then to i8, i5 also to e40, i28 to e99
    (in no triple); i27 and i29 have no link. Heads are mostly item
    entities, tails Zipf-skewed over e27..e59; relation r5 is rare; the
    first triple repeats and one is a self-loop."""
    rng = np.random.default_rng(seed)
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    users = rng.integers(0, n_users, n_inter)
    items = rng.integers(0, n_items, n_inter)
    with open(os.path.join(path, f"{name}.inter"), "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\ttimestamp:float\n")
        for k, (u, i) in enumerate(zip(users, items)):
            f.write(f"u{u}\ti{i}\t{1 + k % 5}\t{k}\n")
    links = [(f"i{i}", f"e{i}") for i in range(27)]
    links += [("i8", "e7"), ("i5", "e40"), ("i28", "e99")]
    with open(os.path.join(path, f"{name}.link"), "w") as f:
        f.write("item_id:token\tentity_id:token\n")
        f.writelines(f"{i}\t{e}\n" for i, e in links)
    heads = np.where(rng.random(n_triples) < 0.8, rng.integers(0, 27, n_triples),
                     27 + rng.integers(0, 33, n_triples))
    tails = 27 + np.minimum(rng.zipf(1.6, n_triples) - 1, 32)
    rels = np.minimum(rng.integers(0, 6, n_triples), rng.integers(0, 6, n_triples))
    rels[rels == 5] = rng.integers(0, 5, (rels == 5).sum())
    rels[:2] = 5                       # the rare relation: two triples
    heads[-1], tails[-1] = 3, 3        # a self-loop
    heads[1], tails[1], rels[1] = heads[0], tails[0], rels[0]  # a repeated triple
    heads[2] = 40                      # the second entity of i5
    with open(os.path.join(path, f"{name}.kg"), "w") as f:
        f.write("head_id:token\trelation_id:token\ttail_id:token\n")
        f.writelines(f"e{h}\tr{r}\te{t}\n" for h, r, t in zip(heads, rels, tails))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_kg_corpus(str(tmp_path_factory.mktemp("kg")))


def kg_cfg(model="CKE", data_path=ASSETS, dataset="toy-kg", **over):
    d = {"model": model, "dataset": dataset, "data_path": data_path, "load_col": LOAD_COL,
         "train_batch_size": 16, "eval_batch_size": 64, "log_tensorboard": False, "seed": 7,
         "eval_args": {"split": {"RS": [0.8, 0.1, 0.1]}, "order": "RO", "group_by": "user",
                       "mode": "full"}}
    d.update(over)
    return d


def _both(cfg, port_cls=KnowledgeBasedDataset, jax_cls=JaxKG):
    return port_cls(Config(dict(cfg))), jax_cls(JaxConfig(config_dict=dict(cfg)))


def same_kg(port, jds):
    assert port._entity2id == jds._entity2id
    assert (port.entity_num, port.relation_num) == (jds.entity_num, jds.relation_num)
    for a, b, what in zip(port.kg_triples, jds.kg_triples, ("heads", "relations", "tails")):
        _same_array(a, b, what)
    _same_vocab(port, jds)
    for f in (port.uid_field, port.iid_field):
        _same_array(np.asarray(port.inter_feat[f]), jds.inter_feat[f].values, f)
    assert port.num("entity_id") == port.num("head_id") == jds.num("tail_id")
    assert port.num("relation_id") == jds.num("relation_id")


KG_CASES = {
    "plain": {},
    "reverse": {"kg_reverse_r": True},
    "entity-core": {"entity_kg_num_interval": "[3,inf)"},
    "relation-core": {"relation_kg_num_interval": "[3,inf)"},
    "both-cores-reverse": {"entity_kg_num_interval": "[2,40]",
                           "relation_kg_num_interval": "(2,inf)", "kg_reverse_r": True,
                           "user_inter_num_interval": "[5,inf)"},
}


@pytest.mark.parametrize("case", sorted(KG_CASES))
def test_seeded_kg_dataset_matches_jax(case, corpus):
    port, jds = _both(kg_cfg(data_path=corpus, dataset="kgseed", **KG_CASES[case]))
    same_kg(port, jds)
    if case == "plain":
        # the last link wins for e7; i27, i29 and i28 (whose entity is in no
        # triple) lose their interactions; e40 shares i5's id
        item = port.field2token_id["item_id"]
        assert port._entity2id["e7"] == item["i8"] and port._entity2id["e40"] == item["i5"]
        assert not {"i27", "i28", "i29"} & set(item)
        assert port.relation_num == 6 + 2


@pytest.mark.parametrize("reverse", [False, True])
def test_toy_kg_dataset_matches_jax(reverse):
    port, jds = _both(kg_cfg(kg_reverse_r=reverse))
    same_kg(port, jds)
    assert list(port.field2id_token["relation_id"])[-1] == "[UI-Relation]"


def _loaders(cfg):
    pc, jc = Config(dict(cfg)), JaxConfig(config_dict=dict(cfg))
    return (data_preparation(pc, create_dataset(pc)),
            jax_prep(jc, jax_create_dataset(jc)))


@pytest.mark.parametrize("model,where", [("CKE", "toy"), ("KGCN", "toy"), ("CKE", "seeded"),
                                         ("KGCN", "seeded")])
def test_kg_train_batches_match_jax(model, where, corpus):
    """Two epochs of `KGTrainBatcher` batches, key for key (the rows, the
    negatives, the triples and their negative tails)."""
    over = {"train_neg_sample_args": {"distribution": "uniform", "sample_num": 1}}
    if where == "seeded":
        over.update(data_path=corpus, dataset="kgseed", train_batch_size=64)
    (pt, pv, _), (jt, jv, _) = _loaders(kg_cfg(model, **over))
    assert type(pt) is KGTrainBatcher and type(jt).__name__ == "KGTrainBatcher"
    _same_batches(pt, jt, f"{model} {where} train", epochs=2)
    assert {"kg_head", "kg_relation", "kg_pos_tail", "kg_neg_tail", "kg_weight"} <= set(
        next(iter(pt)))
    _same_batches(pv, jv, f"{model} {where} valid")


def test_kg_sampler_matches_jax(corpus):
    port, _ = _both(kg_cfg(data_path=corpus, dataset="kgseed"))
    heads, _, tails = port.kg_triples
    ps, js = KGSampler(heads, tails, port.entity_num, 9), JaxKGSampler(heads, tails,
                                                                       port.entity_num, 9)
    for num in (1, 3):
        rows = np.r_[heads[:40], [0, port.entity_num - 1]]
        got, want = ps.sample_negatives(rows, num), js.sample_negatives(rows, num)
        _same_array(got, want, f"negatives {num}")


@pytest.mark.parametrize("where", ["toy", "seeded"])
def test_kgcn_and_ripple_states_match_jax(where, corpus):
    """`build_estate` of KGCN (neighbours) and RippleNet (ripple sets) on
    the training split, at the defaults and at other sizes."""
    over = {} if where == "toy" else {"data_path": corpus, "dataset": "kgseed"}
    port, jds = _both(kg_cfg(**over))
    ps, js = port.build()[0], jds.build()[0]
    kgcn, ripple = jax_model_class("KGCN"), jax_model_class("RippleNet")
    for got, want in ((kg_neighbors(ps), kgcn.build_estate(js)),
                      (kg_neighbors(ps, 7), kgcn.build_estate(js, neighbor_sample_size=7)),
                      (ripple_sets(ps), ripple.build_estate(js)),
                      (ripple_sets(ps, 3, 5), ripple.build_estate(js, n_hop=3, n_memory=5))):
        _same_arrays(got, want, where)


def test_kg_seq_dataset_matches_jax():
    cfg = kg_cfg("KSR", MAX_ITEM_LIST_LENGTH=4, eval_args={
        "split": {"LS": "valid_and_test"}, "order": "TO", "group_by": "user", "mode": "full"})
    port = create_dataset(Config(dict(cfg)))
    jds = JaxKGSeq(JaxConfig(config_dict=dict(cfg)))
    assert type(port) is KGSeqDataset
    same_kg(port, jds)
    _same_arrays(port.data_augmentation(), jds.data_augmentation(), "examples")


@pytest.mark.parametrize("order", [("BPR", "CKE"), ("CKE", "BPR")])
def test_save_dataset_cache_keeps_knowledge_apart(order, tmp_path):
    """A knowledge model's dataset is neither written to the pickle nor
    read from it, so in one `checkpoint_dir` a general model gets its
    `Dataset` and a knowledge one its `KnowledgeBasedDataset`, in either
    order (the JAX package reads the pickle first)."""
    for model in order:
        ds = create_dataset(Config(kg_cfg(model, save_dataset=True, checkpoint_dir=str(tmp_path))))
        want = KnowledgeBasedDataset if model == "CKE" else Dataset
        assert type(ds) is want, (model, type(ds))
        cached = list(tmp_path.glob("toy-kg-dataset-*.pkl"))
        assert len(cached) == (order.index("BPR") <= order.index(model)), (model, cached)
    assert type(create_dataset(Config(kg_cfg("CKE", save_dataset=True,
                                             checkpoint_dir=str(tmp_path))))) is \
        KnowledgeBasedDataset


def test_corpus_without_kg_files_is_refused():
    """toy has no `.kg` / `.link`: the port refuses before any work, naming
    both; the JAX package falls back to the plain `Dataset` and then fails
    in the model (CKE's empty entity table, KGCN's missing `kg_triples`)."""
    cfg = kg_cfg(dataset="toy")
    with pytest.raises(ValueError, match=r"toy\.kg, .*toy\.link not found"):
        create_dataset(Config(dict(cfg)))
    assert type(jax_create_dataset(JaxConfig(config_dict=dict(cfg)))).__name__ == "Dataset"


# what the JAX inductive eval raises: the `_ind` corpus is an
# InductiveDataset, so CKE is rebuilt with no entities and KGAT finds no
# triples for its state
JAX_FAILURES = {"CKE": (IndexError, "empty axis"), "KGAT": (AttributeError, "kg_triples")}


@pytest.mark.parametrize("name,mode", [("CKE", "full"), ("KGAT", "uni5")])
def test_inductive_eval_refuses_a_knowledge_model(name, mode, tmp_path, monkeypatch):
    """toy-ind and its `_ind` corpus, with toy-kg's graph beside the
    training corpus: both packages train the model; the JAX inductive eval
    fails at the rebuild, the port's refuses before any work."""
    for d in ("toy-ind", "toy-ind_ind"):
        shutil.copytree(f"{ASSETS}/{d}", tmp_path / d)
    for ext in ("kg", "link"):
        shutil.copy(f"{ASSETS}/toy-kg/toy-kg.{ext}", tmp_path / "toy-ind" / f"toy-ind.{ext}")
    cfg = dict(model=name, dataset="toy-ind", data_path=str(tmp_path), epochs=1,
               train_batch_size=16, embedding_size=8, kg_embedding_size=8, layers=[8],
               log_tensorboard=False, eval_args={"mode": mode},
               load_col={"inter": ["user_id", "item_id", "rating", "timestamp", "is_new"]})
    jres = jax_quick_start.run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / "jax")))
    error, match = JAX_FAILURES[name]
    with pytest.raises(error, match=match):
        jax_inductive(jres["dataset"], jres["trainer"].saved_model_file, config=jres["config"])
    pres = port_quick_start.run(config_dict=dict(cfg, device="cpu",
                                                 checkpoint_dir=str(tmp_path / "port")))

    def no_work(*a, **k):
        raise AssertionError("the refusal comes before any work")

    monkeypatch.setattr(port_inductive, "create_ind_dataset", no_work)
    monkeypatch.setattr(port_quick_start, "load_data_and_model", no_work)
    with pytest.raises(TypeError, match=f"model \\[{name}\\] is a knowledge model"):
        port_inductive.perform_inductive_eval(None, pres["trainer"].saved_model_file)


@pytest.mark.parametrize("name", ["CKE", "KGCN"])
def test_device_epoch_gate_refuses_the_knowledge_models(name, tmp_path):
    """`device_epoch: true` keeps a knowledge model on the host path (its
    loss reads the batch's triples, which no device epoch assembles), as
    JAX's gate does."""
    from oovrec_tpu.train.device_epoch import device_epoch_eligible as jax_eligible
    from oovrec_tpu_torch.train import Trainer
    from oovrec_tpu_torch.train.device_epoch import device_epoch_eligible

    over = dict(device_epoch=True, checkpoint_dir=str(tmp_path))
    cfg = Config(kg_cfg(name, device="cpu", **over))
    ds = create_dataset(cfg)
    train = data_preparation(cfg, ds)[0]
    trainer = Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds))
    jcfg = JaxConfig(config_dict=kg_cfg(name, **over))
    jtrain = jax_prep(jcfg, jax_create_dataset(jcfg))[0]
    stub = type("T", (), {"mesh": None, "dhe_hasher": None,
                          "model": jax_quick_start.get_model_class(name)})()
    assert device_epoch_eligible(trainer, train, cfg) is False
    assert jax_eligible(stub, jtrain, jcfg) is False

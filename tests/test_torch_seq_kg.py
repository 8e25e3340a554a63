"""RepeatNet, GRU4RecKG and KSR (`more5.py`) against flax, and the
preloaded entity vectors.

At embedding 8, L 5, dropout 0 (`tests/seq_parity.py`): the outputs
(`seq_output`, `predict`, the full sort; RepeatNet's probabilities), the
loss (CE, KSR's BPR, RepeatNet's `joint_train` term) and every gradient
to 1e-5, the bridge both ways (the raw `entity_embedding` and
`relation_embedding`, the scanned `gru` and `entity_gru`), and an
all-padding batch finite and equal to JAX's; the entity table frozen
(its gradient 0) and trainable. RepeatNet on rows that repeat an item
equals JAX's, and its scatter gives the same bits with each item's
positions permuted. Under `freeze_kg` one Adam step with weight decay
0.01 moves the entity table as the JAX trainer's optax chain does, and
without decay leaves it as it was. On toy, against the JAX package bit
for bit: `get_preload_weight` aligned to the items, its file-order
fallback and its refusals, and `derive_kwargs` with and without a
preload. Then the `-m` entry of each of the three on toy for one epoch
from JAX's initial weights, against the JAX CLI to 1e-5.
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.utils import create_dataset  # noqa: E402

from tests import seq_parity as sp  # noqa: E402
from tests.test_torch_dataset import ASSETS  # noqa: E402
from tests.test_torch_seq_feat import cli_matches_jax  # noqa: E402

K = 6
ENT = (np.random.default_rng(9).standard_normal((sp.N_ITEMS, K)) * 0.3).astype(np.float32)
KG = dict(kg_embedding_size=K, pretrained_ent=ENT)
MODELS = {
    "RepeatNet": ("RepeatNet", dict(hidden_size=8, dropout_prob=0.0)),
    "RepeatNet-joint": ("RepeatNet", dict(hidden_size=6, dropout_prob=0.0, joint_train=True)),
    "GRU4RecKG": ("GRU4RecKG", dict(hidden_size=8, dropout_prob=0.0, **KG)),
    "GRU4RecKG-trainable": ("GRU4RecKG", dict(hidden_size=8, dropout_prob=0.0, freeze_kg=False,
                                              **KG)),
    "GRU4RecKG-2layers": ("GRU4RecKG", dict(hidden_size=6, num_layers=2, dropout_prob=0.0,
                                            **KG)),
    "KSR": ("KSR", dict(hidden_size=8, n_relations=3, dropout_prob=0.0, **KG)),
    "KSR-BPR": ("KSR", dict(hidden_size=8, n_relations=3, dropout_prob=0.0, loss_type="BPR",
                            **KG)),
    "KSR-trainable": ("KSR", dict(hidden_size=8, n_relations=2, dropout_prob=0.0,
                                  freeze_kg=False, gamma=3.0, **KG)),
}
CASES = sp.cases(MODELS)


@pytest.mark.parametrize("name,kw", CASES)
def test_outputs_match_flax(name, kw):
    methods = ("predict", "full_sort_scores") + (() if name == "RepeatNet" else ("seq_output",))
    sp.outputs_match(name, kw, sp.make_batch(), methods)


@pytest.mark.parametrize("name,kw", CASES)
def test_loss_and_gradients_match_flax(name, kw):
    port = sp.loss_and_gradients_match(name, kw, sp.make_batch(seed=1))
    if kw.get("freeze_kg", True) and name != "RepeatNet":
        port.zero_grad()
        port.calculate_loss(sp.to_torch(sp.make_batch(seed=1))).backward()
        assert port.entity_embedding.grad is None  # read detached: no gradient at all


@pytest.mark.parametrize("name,kw", CASES)
def test_bridge_round_trips(name, kw):
    sp.bridge_round_trips(name, kw, sp.make_batch())


@pytest.mark.parametrize("name,kw", CASES)
def test_all_padding_rows_match_flax(name, kw):
    methods = ("predict", "full_sort_scores") + (() if name == "RepeatNet" else ("seq_output",))
    sp.outputs_match(name, kw, sp.all_padding(sp.make_batch(seed=2)), methods)


def _repeating_batch():
    """`make_batch` with items repeated inside rows: twice, three times,
    a whole row of one item."""
    batch = sp.make_batch(seed=4)
    seq = batch["item_id_list"]
    seq[3, :3] = [7, 7, 7]
    seq[5, :5] = [2, 9, 2, 9, 2]
    seq[6, :5] = 4
    seq[7, :3] = [5, 1, 5]
    return batch


@pytest.mark.parametrize("joint", [False, True])
def test_repeatnet_repeated_items_match_flax(joint):
    kw = dict(hidden_size=8, dropout_prob=0.0, joint_train=joint)
    batch = _repeating_batch()
    batch["item_id"][5] = 9  # a target inside its history (the gate term)
    sp.outputs_match("RepeatNet", kw, batch, ("predict", "full_sort_scores"))
    sp.loss_and_gradients_match("RepeatNet", kw, batch)


def test_repeatnet_scatter_ignores_the_order_of_duplicates():
    """The repeat decoder's probabilities of an item do not depend on the
    positions its duplicates take (the fold runs in ascending values) nor
    on the order of the scatter's adds, though a plain scatter-add of the
    raw values does: 0.5 + 2⁻²⁵ + 2⁻²⁵ rounds to 0.5 one way and to
    0.5 + 2⁻²⁴ the other. Each duplicate's gradient is the item's, once."""
    from oovrec_tpu_torch.models.sequential.more5 import scatter_probs

    tiny = 2.0 ** -25
    seq = torch.tensor([[3, 1, 3, 3, 2], [6, 6, 6, 6, 6]])
    probs = torch.tensor([[0.5, 0.25, tiny, tiny, 0.125], [tiny, tiny, 0.5, 0.0, tiny]])
    want = scatter_probs(probs, seq, 7)
    for perm in ([3, 1, 0, 2, 4], [2, 1, 3, 0, 4]):  # the 3s' positions permuted
        p = probs.clone()
        p[0] = probs[0, perm]
        assert torch.equal(scatter_probs(p, seq, 7), want)
    p = probs.clone()
    p[1] = probs[1].flip(0)
    assert torch.equal(scatter_probs(p, seq, 7), want)
    plain = [torch.zeros(7).scatter_add(0, seq[0, order], probs[0, order])
             for order in ([0, 1, 2, 3, 4], [2, 3, 0, 1, 4])]
    assert not torch.equal(plain[0], plain[1])  # why the fold is needed
    leaf = probs.clone().requires_grad_(True)
    (scatter_probs(leaf, seq, 7) * torch.arange(7.0)).sum().backward()
    assert torch.equal(leaf.grad, seq.float())


@pytest.mark.parametrize("name", ["GRU4RecKG", "KSR"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_frozen_table_under_weight_decay_follows_jax(name, wd):
    """One Adam step (lr 0.01) under `freeze_kg`: the JAX trainer's optax
    chain (`add_decayed_weights` before Adam) moves the stop-gradient
    table by its decay term; the port's optimizer over the detached table
    moves it the same, to 1e-6; without decay neither moves it."""
    from oovrec_tpu.train.optimizers import build_optimizer
    from oovrec_tpu_torch.train.optimizers import Optimizer
    from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict

    kw = dict(MODELS[name][1], freeze_kg=True)
    batch = sp.make_batch(seed=3)
    jm, params, port = sp.both(name, kw, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    grads = jax.grad(lambda p: jm.apply({"params": p}, jb, method=jm.calculate_loss))(jparams)
    tx = build_optimizer("adam", 0.01, weight_decay=wd)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    want = np.asarray(jparams["entity_embedding"] + updates["entity_embedding"])

    opt = Optimizer("adam", 0.01, weight_decay=wd)
    named = dict(port.named_parameters())
    state = opt.init(named)
    loss = port.calculate_loss(sp.to_torch(batch))
    g = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    opt.step(named, {n: torch.zeros_like(p) if x is None else x
                     for (n, p), x in zip(named.items(), g)}, state)
    got = flax_from_state_dict(port.state_dict(), port)["entity_embedding"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    moved = not np.array_equal(got, np.asarray(params["entity_embedding"]))
    assert moved == (wd > 0)


def _cfg(dataset="toy", data_path=ASSETS, **over):
    d = {"model": "GRU4RecKG", "dataset": dataset, "data_path": data_path,
         "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
         "additional_feat_suffix": ["ent"], "preload_weight": {"ent_id": "ent_vec"},
         "MAX_ITEM_LIST_LENGTH": 4, "log_tensorboard": False, "seed": 21}
    d.update(over)
    return d


def _both_datasets(**over):
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.utils import create_dataset as jax_create

    cfg = _cfg(**over)
    pc, jc = Config(dict(cfg, device="cpu")), JaxConfig(config_dict=dict(cfg))
    return pc, create_dataset(pc), jc, jax_create(jc)


def test_preload_weight_matches_jax():
    """toy.ent (8 wide, one row an item) aligned to the item vocabulary,
    row 0 zero, bit for bit."""
    _, pds, _, jds = _both_datasets()
    got, want = pds.get_preload_weight("ent_id"), jds.get_preload_weight("ent_id")
    assert got.dtype == want.dtype == np.float32 and got.shape == (pds.item_num, 8)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()
    assert abs(got[pds.field2token_id["item_id"]["i3"], 0] - 0.3) < 1e-6


def test_preload_weight_fallbacks_match_jax(tmp_path):
    """Tokens that cover no vocabulary: the file's order after a zero pad
    row; an unconfigured key and a missing column raise ValueError in
    both."""
    d = tmp_path / "toy"
    shutil.copytree(os.path.join(ASSETS, "toy"), d)
    with open(d / "toy.ent") as f:
        lines = f.read().splitlines()
    with open(d / "toy.ent", "w") as f:
        f.write("\n".join([lines[0]] + ["x" + ln for ln in lines[1:4]]) + "\n")
    _, pds, _, jds = _both_datasets(data_path=str(tmp_path))
    got, want = pds.get_preload_weight("ent_id"), jds.get_preload_weight("ent_id")
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got, want)
    for ds in (pds, jds):
        with pytest.raises(ValueError, match="preload_weight"):
            ds.get_preload_weight("other_id")
    _, pds, _, jds = _both_datasets(preload_weight={"ent_id": "ent_other"})
    for ds in (pds, jds):
        with pytest.raises(ValueError, match="ent_other"):
            ds.get_preload_weight("ent_id")


@pytest.mark.parametrize("preload", [True, False])
@pytest.mark.parametrize("name", ["GRU4RecKG", "KSR"])
def test_derive_kwargs_matches_jax(name, preload):
    """The preload cut to item_num rows and its width, or the seeded
    0.02 · N(0, 1) draws at `kg_embedding_size`: bit for bit."""
    from oovrec_tpu.models import get_model_class as jax_model_class
    from oovrec_tpu_torch.models import get_model_class

    over = {} if preload else dict(additional_feat_suffix=None, preload_weight=None,
                                   kg_embedding_size=5)
    pc, pds, jc, jds = _both_datasets(model=name, **over)
    got = get_model_class(name).derive_kwargs(pds, pc)
    want = jax_model_class(name).derive_kwargs(jds, jc)
    assert got.keys() == want.keys() == {"pretrained_ent", "kg_embedding_size"}
    assert got["kg_embedding_size"] == want["kg_embedding_size"] == (8 if preload else 5)
    assert got["pretrained_ent"].dtype == np.float32
    np.testing.assert_array_equal(got["pretrained_ent"], want["pretrained_ent"])


CLI = ["--dataset=toy", f"--data_path={ASSETS}", "--epochs=1", "--train_batch_size=8",
       "--embedding_size=8", "--MAX_ITEM_LIST_LENGTH=4", "--log_tensorboard=False",
       "--metric_decimal_place=12", "--load_col={'inter': ['user_id','item_id','timestamp']}"]
PRELOAD = ["--additional_feat_suffix=['ent']", "--preload_weight={'ent_id': 'ent_vec'}"]
CLI_MODELS = {
    "RepeatNet": ["--hidden_size=8", "--dropout_prob=0.0"],
    "GRU4RecKG": ["--hidden_size=8", "--dropout_prob=0.0", *PRELOAD],
    "KSR": ["--hidden_size=8", "--dropout_prob=0.0", "--n_relations=3", *PRELOAD],
}


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_matches_jax(name, tmp_path, monkeypatch):
    pres = cli_matches_jax(name, [f"--model={name}", *CLI, *CLI_MODELS[name]], tmp_path,
                           monkeypatch)
    if name != "RepeatNet":  # the preload is the entity table's width
        assert pres["trainer"].model.entity_embedding.shape == (pres["dataset"].item_num, 8)

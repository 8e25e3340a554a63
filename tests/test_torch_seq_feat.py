"""GRU4RecF, SASRecF and FDSA (`featseq.py`) against flax, and the packed
item features.

At embedding 8, L 5, dropout 0 (`tests/seq_parity.py`), each model with a
packed table of a token field (one column) and a token_seq field (five
slots, rows with 0 to 5 tokens, item 0 with none), given to JAX as
`estate` and to the port as the `seq_feat_tokens` buffer: the outputs
(`seq_output`, `predict`, the full sort), the loss (CE, GRU4RecF's BPR)
and every gradient to 1e-5, the bridge both ways (`feature_gru`,
`feat_block_<i>`, `feat_ln`; the buffer never crosses as a param) and
an all-padding batch finite and equal to JAX's. Then, on the toy
fixtures against the JAX package bit for bit: `derive_kwargs` and
`build_estate` (toy's `category` and `tags`, toy-ind's `category` and
the float `price`, packed truncated); the buffer through the driver, a
JAX `estate` into it, and its place in `load_params`;
`selected_features: []` refused at build time (JAX fails later, at its
first stack), and so is a float field packed past the table's end (JAX
trains on NaN); and the `-m` entry of each of the three on toy for one
epoch from JAX's initial weights, against the JAX CLI to 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli.run import main as jax_main  # noqa: E402
from oovrec_tpu_torch.cli.run import main as port_main  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.utils import create_dataset  # noqa: E402

from tests import seq_parity as sp  # noqa: E402
from tests.test_torch_dataset import ASSETS  # noqa: E402
from tests.test_torch_seq_slice import _agree, _bridge  # noqa: E402

SLICES = ((0, 1), (1, 6))
VOCAB = 9
FEAT = dict(selected_features=("category", "tags"), feat_vocab_size=VOCAB, feat_slices=SLICES)
ONE_FIELD = dict(selected_features=("tags",), feat_vocab_size=6, feat_slices=((0, 5),))
ATTN = dict(n_layers=2, n_heads=2, inner_size=16, hidden_dropout_prob=0.0, attn_dropout_prob=0.0)
MODELS = {
    "GRU4RecF": ("GRU4RecF", dict(hidden_size=8, dropout_prob=0.0, **FEAT)),
    "GRU4RecF-BPR": ("GRU4RecF", dict(hidden_size=8, dropout_prob=0.0, loss_type="BPR",
                                      **FEAT)),
    "GRU4RecF-2layers": ("GRU4RecF", dict(hidden_size=6, num_layers=2, dropout_prob=0.0,
                                          **FEAT)),
    "SASRecF": ("SASRecF", dict(ATTN, **FEAT)),
    "SASRecF-one-field": ("SASRecF", dict(ATTN, **ONE_FIELD)),
    "FDSA": ("FDSA", dict(ATTN, **FEAT)),
    "FDSA-1layer": ("FDSA", dict(ATTN, n_layers=1, **ONE_FIELD)),
}


def packed_tokens(kw, seed=3):
    """A seeded (N_ITEMS, C) table in `build_estate`'s layout for the
    case's slices: a token column in [0, 4), slots of a token_seq field
    filled from the left with 0 to 5 tokens in [4, vocab), row 0 empty."""
    rng = np.random.default_rng(seed)
    vocab = kw["feat_vocab_size"]
    cols = []
    for s, e in kw["feat_slices"]:
        width = e - s
        if width == 1:
            cols.append(rng.integers(0, 4, (sp.N_ITEMS, 1)))
            continue
        block = rng.integers(4 if vocab > 6 else 1, vocab, (sp.N_ITEMS, width))
        count = rng.integers(0, width + 1, sp.N_ITEMS)
        block[np.arange(width)[None, :] >= count[:, None]] = 0
        cols.append(block)
    mat = np.concatenate(cols, axis=1).astype(np.int32)
    mat[0] = 0
    return {"seq_feat_tokens": mat}


def _case(case):
    name, kw = MODELS[case]
    return name, kw, packed_tokens(kw)


CASES = [pytest.param(case, id=case) for case in sorted(MODELS)]


@pytest.mark.parametrize("case", CASES)
def test_outputs_match_flax(case):
    name, kw, est = _case(case)
    sp.outputs_match(name, kw, sp.make_batch(), estate=est)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_flax(case):
    name, kw, est = _case(case)
    sp.loss_and_gradients_match(name, kw, sp.make_batch(seed=1), estate=est)


@pytest.mark.parametrize("case", CASES)
def test_bridge_round_trips(case):
    name, kw, est = _case(case)
    sp.bridge_round_trips(name, kw, sp.make_batch(), estate=est)


@pytest.mark.parametrize("case", CASES)
def test_all_padding_rows_match_flax(case):
    name, kw, est = _case(case)
    sp.outputs_match(name, kw, sp.all_padding(sp.make_batch(seed=2)), estate=est)


def _datasets(dataset, features):
    """The port's and the JAX package's sequential datasets over `dataset`
    with the item columns of `features` loaded."""
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.utils import create_dataset as jax_create

    inter = ["user_id", "item_id", "timestamp"] + (["is_new"] if dataset == "toy-ind" else [])
    cfg = {"model": "GRU4RecF", "dataset": dataset, "data_path": ASSETS,
           "load_col": {"inter": inter, "item": ["item_id", *features]},
           "selected_features": list(features), "MAX_ITEM_LIST_LENGTH": 4,
           "log_tensorboard": False}
    pc, jc = Config(dict(cfg, device="cpu")), JaxConfig(config_dict=dict(cfg))
    return pc, create_dataset(pc), jc, jax_create(jc)


PACKINGS = [pytest.param("toy", ("category", "tags"), id="toy-token-and-seq"),
            pytest.param("toy-ind", ("category", "price"), id="toy-ind-token-and-float")]


@pytest.mark.parametrize("dataset,features", PACKINGS)
def test_packing_matches_jax(dataset, features):
    """`derive_kwargs` and `build_estate` on the port's dataset == the JAX
    hooks on JAX's, bit for bit (JAX's `build_estate` reads the parent of
    the training split; the port's takes the dataset)."""
    from oovrec_tpu.models.sequential.featseq import GRU4RecF as JaxGRU4RecF
    from oovrec_tpu_torch.models.sequential.featseq import TOKEN_SEQ_CAP, GRU4RecF

    pc, pds, jc, jds = _datasets(dataset, features)
    assert GRU4RecF.derive_kwargs(pds, pc) == JaxGRU4RecF.derive_kwargs(jds, jc)
    got = GRU4RecF.build_estate(pds, pc)["seq_feat_tokens"]
    want = JaxGRU4RecF.build_estate(jds.build()[0], config=jc)["seq_feat_tokens"]
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if "tags" in features:  # a token_seq of several tokens, capped at the slots; the
        # pad item has no feature (a float field's pad takes the column mean)
        assert got.shape[1] == 1 + TOKEN_SEQ_CAP and (got[:, 1:] > 0).sum(axis=1).max() > 1
        assert not got[0].any()


def test_driver_hands_the_buffer_and_keeps_it(tmp_path):
    """`build_model_and_state` derives the sizes and packs the table into
    the model's buffer; a JAX `estate` loads into it; `load_params` (a
    model rebuilt over another corpus) keeps the model's own; the bridge
    never sees it."""
    from oovrec_tpu_torch.models.base import load_params
    from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, set_embedder_state

    pc, pds, _, _ = _datasets("toy", ("category", "tags"))
    model = port_quick_start.build_model_and_state(pc, pds)
    table = model.seq_feat_tokens.clone()
    assert table.dtype == torch.int32 and table.shape == (pds.item_num, 6)
    assert model.feat_slices == SLICES and model.feature_embedding.weight.shape[0] == 1 + 3 + 3
    assert "seq_feat_tokens" not in flax_from_state_dict(model.state_dict(), model)
    other = torch.arange(table.numel(), dtype=torch.int32).reshape(table.shape) % 7
    set_embedder_state(model, {"seq_feat_tokens": other.numpy()})
    assert torch.equal(model.seq_feat_tokens, other)
    with pytest.raises(ValueError, match="seq_feat_tokens"):
        set_embedder_state(model, {"seq_feat_tokens": np.zeros((2, 6), np.int32)})
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = port_quick_start.build_model_and_state(pc, pds)
    load_params(fresh, saved)
    assert torch.equal(fresh.seq_feat_tokens, table)
    assert torch.equal(fresh.feature_embedding.weight, saved["feature_embedding.weight"])


@pytest.mark.parametrize("name", ["GRU4RecF", "SASRecF", "FDSA"])
def test_no_selected_features_is_refused(name):
    """Under the YAML default `selected_features: []` the port refuses at
    build time, naming the key; the JAX package fails at init, stacking no
    field (`featseq.py:97`)."""
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.utils import create_dataset as jax_create
    from oovrec_tpu.data.utils import data_preparation as jax_prep

    cfg = {"model": name, "dataset": "toy", "data_path": ASSETS,
           "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
           "MAX_ITEM_LIST_LENGTH": 4, "embedding_size": 8, "log_tensorboard": False}
    pc = Config(dict(cfg, device="cpu"))
    assert list(pc["selected_features"]) == []
    with pytest.raises(ValueError, match="selected_features"):
        port_quick_start.build_model_and_state(pc, create_dataset(pc))
    jc = JaxConfig(config_dict=dict(cfg))
    jds = jax_create(jc)
    template = jax_prep(jc, jds)[0]._make_batch(np.arange(2))
    with pytest.raises(ValueError, match="at least one array"):
        jax_quick_start.build_model_and_state(jc, jds, template_batch=template)


def test_float_feature_past_the_table_is_refused(tmp_path, monkeypatch):
    """toy-ind's `price` packs its truncated values (up to 9) into a table
    of 1 + (num(category) − 1) rows: the port refuses at build time,
    naming the field; the JAX package reads the tokens past the end as NaN
    and its first epoch's loss is NaN."""
    pc, pds, _, _ = _datasets("toy-ind", ("category", "price"))
    with pytest.raises(ValueError, match=r"feature \[price\]"):
        port_quick_start.build_model_and_state(pc, pds)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="nan"):
        jax_main(["--model=SASRecF", "--dataset=toy-ind", f"--data_path={ASSETS}",
                  "--epochs=1", "--embedding_size=8", "--MAX_ITEM_LIST_LENGTH=4",
                  "--selected_features=['category','price']", "--log_tensorboard=False",
                  "--load_col={'inter': ['user_id','item_id','timestamp','is_new'], "
                  "'item': ['item_id','price','category']}",
                  f"--checkpoint_dir={tmp_path / 'saved'}"])


CLI = ["--dataset=toy", f"--data_path={ASSETS}", "--epochs=1", "--train_batch_size=8",
       "--embedding_size=8", "--MAX_ITEM_LIST_LENGTH=4", "--log_tensorboard=False",
       "--metric_decimal_place=12", "--selected_features=['category','tags']",
       "--load_col={'inter': ['user_id','item_id','timestamp'], "
       "'item': ['item_id','category','tags']}"]
CLI_MODELS = {
    "GRU4RecF": ["--hidden_size=8", "--dropout_prob=0.0"],
    "SASRecF": ["--inner_size=16", "--hidden_dropout_prob=0.0", "--attn_dropout_prob=0.0"],
    "FDSA": ["--inner_size=16", "--hidden_dropout_prob=0.0", "--attn_dropout_prob=0.0"],
}


def cli_matches_jax(name, argv, tmp_path, monkeypatch):
    """`argv` through the JAX CLI and the port's `-m` entry from JAX's
    initial weights: the epoch losses to 1e-5 relative and the test
    metrics to 1e-5. → the port's result."""
    _bridge(monkeypatch)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jres = jax_main(argv + [f"--checkpoint_dir={tmp_path / 'jax' / 'saved'}"])
    monkeypatch.chdir(tmp_path / "port")
    pres = port_main(argv + ["--device=cpu", f"--checkpoint_dir={tmp_path / 'port' / 'saved'}"])
    pt, jt = pres["trainer"], jres["trainer"]
    assert type(pt.model).__name__ == name
    assert list(pt.train_loss_dict) == list(jt.train_loss_dict) == [0]
    np.testing.assert_allclose(pt.train_loss_dict[0], jt.train_loss_dict[0], rtol=1e-5)
    _agree(jres["test_result"], pres["test_result"], 1e-5, f"{name} CLI test")
    return pres


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_matches_jax(name, tmp_path, monkeypatch):
    cli_matches_jax(name, [f"--model={name}", *CLI, *CLI_MODELS[name]], tmp_path, monkeypatch)

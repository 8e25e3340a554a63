"""S3Rec (`s3rec.py`) against flax.

At embedding 8, L 5, dropout 0 (`tests/seq_parity.py`), with a packed
attribute table given to JAX as `estate` and to the port as its buffer:
the outputs (`seq_output`, `predict`, the full sort over the first
n_items rows) in both stages, the loss and every gradient to 1e-5 (the
pretraining loss on JAX's own draws: the key its `_pretrain_loss` splits
is the first `dropout` draw at the top scope, recomputed here, and the
Bernoulli mask, the negatives and the segment starts drawn from it as
JAX draws them), the bridge both ways (the `*_norm` heads, the n_items +
1 item table; no heads and no attribute table when finetuning, as in
flax's tree), and an all-padding batch finite and equal to JAX's. Then
the port's own draws (their ranges, from the dropout generator alone),
and the `-m` entry on toy: finetuning for one epoch from JAX's initial
weights against the JAX CLI to 1e-5; pretraining (whose draws cannot be
JAX's) runs with and without `selected_features`, as JAX's does.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu_torch.cli.run import main as port_main  # noqa: E402
from oovrec_tpu_torch.models.layers import set_dropout_generator  # noqa: E402

from tests import seq_parity as sp  # noqa: E402
from tests.test_torch_dataset import ASSETS  # noqa: E402
from tests.test_torch_seq_feat import FEAT, cli_matches_jax, packed_tokens  # noqa: E402

BASE = dict(n_layers=2, n_heads=2, inner_size=16, hidden_dropout_prob=0.0)
NO_FEATURES = dict(selected_features=(), feat_vocab_size=2, feat_slices=())
MODELS = {
    "pretrain": dict(BASE, **FEAT),
    "pretrain-weights": dict(BASE, n_layers=1, mask_ratio=0.5, aap_weight=0.7, mip_weight=0.3,
                             map_weight=2.0, sp_weight=1.5, **FEAT),
    "pretrain-no-features": dict(BASE, **NO_FEATURES),
    "finetune": dict(BASE, train_stage="finetune", **FEAT),
}
CASES = [pytest.param(case, id=case) for case in sorted(MODELS)]


def _estate(kw):
    if not kw["feat_slices"]:
        return {"seq_feat_tokens": np.zeros((sp.N_ITEMS, 1), np.int32)}
    return packed_tokens(kw)


def jax_draws(jm, params, batch, ratio):
    """JAX's draws of `_pretrain_loss` under the dropout key of
    `seq_parity.loss_and_gradients_match`, as torch tensors."""
    key = jm.apply({"params": params}, method=lambda m: m.make_rng("dropout"),
                   rngs={"dropout": jax.random.key(sp.DROPOUT_SEED)})
    r_mask, r_neg, r_seg = jax.random.split(key, 3)
    seq = jnp.asarray(batch["item_id_list"])
    lengths = jnp.asarray(batch["item_length"])
    seg_len = max(seq.shape[1] // 4, 1)
    out = {"mask": jax.random.bernoulli(r_mask, ratio, seq.shape),
           "neg": jax.random.randint(r_neg, seq.shape, 1, sp.N_ITEMS),
           "start": jax.random.randint(r_seg, (seq.shape[0],), 0,
                                       jnp.maximum(lengths - seg_len, 1))}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("case", CASES)
def test_outputs_match_flax(case):
    sp.outputs_match("S3Rec", MODELS[case], sp.make_batch(), estate=_estate(MODELS[case]))


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_flax(case):
    kw = MODELS[case]
    batch = sp.make_batch(seed=1)
    seen = []

    def on_jax_draws(port, jm, params, tb):
        draws = jax_draws(jm, params, batch, kw.get("mask_ratio", 0.2))
        seen.append(int(draws["mask"].sum()))
        return port.pretrain_loss(tb, draws)

    pretrain = kw.get("train_stage", "pretrain") == "pretrain"
    sp.loss_and_gradients_match("S3Rec", kw, batch, estate=_estate(kw),
                                port_loss=on_jax_draws if pretrain else None)
    assert bool(seen) == pretrain and (not seen or seen[0] > 0)  # some positions masked


@pytest.mark.parametrize("case", CASES)
def test_bridge_round_trips(case):
    sp.bridge_round_trips("S3Rec", MODELS[case], sp.make_batch(), estate=_estate(MODELS[case]))


@pytest.mark.parametrize("case", CASES)
def test_all_padding_rows_match_flax(case):
    sp.outputs_match("S3Rec", MODELS[case], sp.all_padding(sp.make_batch(seed=2)),
                     estate=_estate(MODELS[case]))


def test_finetune_has_no_pretraining_heads():
    from oovrec_tpu_torch.models import get_model_class

    model = get_model_class("S3Rec")(n_users=sp.N_USERS, n_items=sp.N_ITEMS, device="cpu",
                                     **sp.SMALL, **MODELS["finetune"])
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert not names & {"aap_norm", "mip_norm", "map_norm", "sp_norm", "feature_embedding"}
    assert model.item_embedding.weight.shape[0] == sp.N_ITEMS + 1


def test_pretrain_draws_come_from_the_dropout_generator():
    """The mask at about `mask_ratio`, the negatives in [1, n_items), the
    starts in [0, max(length − ⌊L/4⌋, 1)); the same generator state gives
    the same draws, and without a generator the draw raises."""
    from oovrec_tpu_torch.models import get_model_class

    model = get_model_class("S3Rec")(n_users=sp.N_USERS, n_items=sp.N_ITEMS, device="cpu",
                                     **sp.SMALL, **MODELS["pretrain"])
    batch = sp.to_torch(sp.make_batch(seed=5))
    with pytest.raises(RuntimeError, match="generator"):
        model.pretrain_draws(batch)
    set_dropout_generator(model, torch.Generator().manual_seed(3))
    many = [model.pretrain_draws(batch) for _ in range(200)]
    masks = torch.stack([d["mask"] for d in many]).float()
    assert abs(float(masks.mean()) - 0.2) < 0.02
    neg = torch.stack([d["neg"] for d in many])
    assert int(neg.min()) == 1 and int(neg.max()) == sp.N_ITEMS - 1
    start = torch.stack([d["start"] for d in many])
    high = torch.clamp(batch["item_length"] - max(sp.L // 4, 1), min=1)
    assert bool((start >= 0).all()) and bool((start < high).all())
    assert bool((start.max(dim=0).values == high - 1).all())  # every start reached
    set_dropout_generator(model, torch.Generator().manual_seed(3))
    again = model.pretrain_draws(batch)
    assert all(torch.equal(again[k], many[0][k]) for k in again)
    assert torch.isfinite(model.calculate_loss(batch))


CLI = ["--model=S3Rec", "--dataset=toy", f"--data_path={ASSETS}", "--epochs=1",
       "--train_batch_size=8", "--embedding_size=8", "--MAX_ITEM_LIST_LENGTH=4",
       "--log_tensorboard=False", "--metric_decimal_place=12", "--inner_size=16",
       "--hidden_dropout_prob=0.0"]
WITH_FEATURES = ["--selected_features=['category','tags']",
                 "--load_col={'inter': ['user_id','item_id','timestamp'], "
                 "'item': ['item_id','category','tags']}"]


def test_cli_finetune_matches_jax(tmp_path, monkeypatch):
    cli_matches_jax("S3Rec", CLI + WITH_FEATURES + ["--train_stage=finetune"], tmp_path,
                    monkeypatch)


@pytest.mark.parametrize("features", [True, False], ids=["features", "no-features"])
def test_cli_pretrain_runs(features, tmp_path, monkeypatch):
    """Pretraining through the `-m` entry: a finite epoch loss and test
    metrics (the JAX package runs it too, also without features)."""
    from oovrec_tpu.cli.run import main as jax_main

    argv = CLI + (WITH_FEATURES if features else
                  ["--load_col={'inter': ['user_id','item_id','timestamp']}"])
    monkeypatch.chdir(tmp_path)
    jres = jax_main(argv + [f"--checkpoint_dir={tmp_path / 'jax'}"])
    pres = port_main(argv + ["--device=cpu", f"--checkpoint_dir={tmp_path / 'port'}"])
    for res in (jres, pres):
        assert np.isfinite(res["trainer"].train_loss_dict[0])
        assert all(np.isfinite(float(v)) for v in res["test_result"].values())
    assert pres["trainer"].model.train_stage == "pretrain"

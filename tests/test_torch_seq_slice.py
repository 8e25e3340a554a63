"""The sequential slice end to end: the port's `quick_start.run` and CLI
against the JAX package's, from the same initial weights, on the CPU.

Each JAX run's initial params are recorded (its `build_model_and_state`
wrapped) and loaded into the port's model through `utils/jax_params.py`;
dropout is 0 (the two packages' random streams differ). On the toy
fixture with timestamps, under full sort, leave-one-out and the host path
(`device_epoch: false`), the six models train two epochs: GRU4Rec, SASRec,
NARM and STAMP under CE, FPMC (pairwise BPR) and BERT4Rec (the
`MaskItemSequence` batches). Their epoch losses agree to 1e-5 relative
and their valid and test metrics to 1e-5. (GRU4Rec's BPR loss is held in
`test_torch_seq_models.py`: its pointwise loader gives no negative column
to train it on, in either package.) GRU4Rec through `python -m
oovrec_tpu_torch.cli.run` (the paper protocol: uni250 eval, one sampled
negative a row) agrees with the JAX CLI to 1e-5, and `--eval_only`
reproduces the port's run to 1e-9. Then on the card's paths that the CPU
can run: the scanned full-sort eval over sequential examples equals the
per-batch one exactly; the plain device epoch's batch from given rows
equals the JAX host batcher's `_make_batch` bit for bit (a padded tail
too), and one plain device epoch of GRU4Rec, SASRec, NARM and STAMP
covers every real row once and gives the JAX trainer's losses and
parameters over the same batches (1e-5); those four train on it through
`Trainer.fit` (a corpus without feature tables, the (n, L) lists, lengths
and weights reaching the step; on toy-ind the user and item feature
columns joined as the host batcher joins them), and the gate keeps BERT4Rec (a
transform), FPMC (no `supports_device_epoch`) and a small corpus under
`auto` on the host path, as the JAX gate does.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli.run import main as jax_main  # noqa: E402
from oovrec_tpu.train.device_epoch import device_epoch_eligible as jax_eligible  # noqa: E402
from oovrec_tpu_torch.cli.run import main as port_main  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.utils import create_dataset, data_preparation  # noqa: E402
from oovrec_tpu_torch.data.sequential import SeqFullSortEvalBatcher  # noqa: E402
from oovrec_tpu_torch.eval.collector import Collector  # noqa: E402
from oovrec_tpu_torch.eval.runner import EvalRunner  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.train.device_epoch import device_epoch_eligible  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import load_flax_params  # noqa: E402

from tests.test_torch_seq_data import _cfg  # noqa: E402

TOL = 1e-5
SMALL = dict(embedding_size=8, hidden_size=8, inner_size=16, n_layers=2, n_heads=2,
             dropout_prob=0.0, hidden_dropout_prob=0.0, attn_dropout_prob=0.0,
             dropout_probs=[0.0, 0.0], epochs=2, topk=[2, 5], valid_metric="MRR@5",
             metrics=["Recall", "MRR", "NDCG"], metric_decimal_place=12, device_epoch=False)
FITS = {
    "GRU4Rec": dict(model="GRU4Rec"),
    "SASRec": dict(model="SASRec"),
    "NARM": dict(model="NARM"),
    "STAMP": dict(model="STAMP"),
    "FPMC": dict(model="FPMC", train_neg_sample_args={"distribution": "uniform",
                                                      "sample_num": 1}),
    "BERT4Rec": dict(model="BERT4Rec"),
}


def _bridge(monkeypatch):
    """Record each JAX run's initial params; start the port's model from
    them."""
    recorded = {}
    jax_build = jax_quick_start.build_model_and_state

    def recording(config, dataset, mode="transductive", **kw):
        model, variables, estate = jax_build(config, dataset, mode=mode, **kw)
        params = jax.tree_util.tree_map(np.array, variables["params"])
        recorded["params"] = params
        return model, dict(variables, params=jax.tree_util.tree_map(np.array, params)), estate

    port_build = port_quick_start.build_model_and_state

    def bridged(config, dataset, mode="transductive", **kw):
        model = port_build(config, dataset, mode=mode, **kw)
        load_flax_params(model, recorded["params"])
        return model

    monkeypatch.setattr(jax_quick_start, "build_model_and_state", recording)
    monkeypatch.setattr(port_quick_start, "build_model_and_state", bridged)


def _agree(a, b, tol, what):
    assert list(a) == list(b), what
    for k in a:
        assert abs(float(a[k]) - float(b[k])) <= tol, (what, k, a[k], b[k])


@pytest.mark.parametrize("case", sorted(FITS))
def test_run_matches_jax(case, tmp_path, monkeypatch):
    _bridge(monkeypatch)
    cfg = _cfg(**SMALL, **FITS[case])
    jres = jax_quick_start.run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / "jax")),
                               saved=False)
    pres = port_quick_start.run(config_dict=dict(cfg, device="cpu",
                                                 checkpoint_dir=str(tmp_path / "port")),
                                saved=False)
    jt, pt = jres["trainer"], pres["trainer"]
    assert type(pt.model).__name__ == cfg["model"]
    assert not pt._device_epochs
    assert list(pt.train_loss_dict) == list(jt.train_loss_dict) == [0, 1]
    for e, want in jt.train_loss_dict.items():
        np.testing.assert_allclose(pt.train_loss_dict[e], want, rtol=TOL, err_msg=f"epoch {e}")
    _agree(jres["best_valid_result"], pres["best_valid_result"], TOL, f"{case} valid")
    _agree(jres["test_result"], pres["test_result"], TOL, f"{case} test")
    assert pres["test_result"]["recall@5"] > 0


def test_cli_gru4rec_matches_jax(tmp_path, monkeypatch):
    from tests.test_torch_dataset import ASSETS

    _bridge(monkeypatch)
    argv = ["--model=GRU4Rec", "--dataset=toy", f"--data_path={ASSETS}", "--epochs=2",
            "--train_batch_size=8", "--embedding_size=8", "--hidden_size=8",
            "--dropout_prob=0.0", "--MAX_ITEM_LIST_LENGTH=4", "--log_tensorboard=False",
            "--metric_decimal_place=12",
            "--load_col={'inter': ['user_id','item_id','timestamp']}"]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jres = jax_main(argv + [f"--checkpoint_dir={tmp_path / 'jax' / 'saved'}"])
    monkeypatch.chdir(tmp_path / "port")
    pres = port_main(argv + ["--device=cpu", f"--checkpoint_dir={tmp_path / 'port' / 'saved'}"])
    assert pres["config"]["eval_args"]["mode"] == {"valid": "uni250", "test": "uni250"}
    assert pres["trainer"].train_loss_dict
    _agree(jres["test_result"], pres["test_result"], TOL, "CLI test")
    again = port_main([f"--eval_only={pres['trainer'].saved_model_file}"])
    assert type(again["trainer"].model).__name__ == "GRU4Rec"
    _agree(pres["test_result"], again["test_result"], 1e-9, "eval_only")


def _prepared(model, **over):
    cfg = Config(_cfg(**dict(SMALL, model=model, device="cpu", **over)))
    ds = create_dataset(cfg)
    return cfg, ds, data_preparation(cfg, ds)


@pytest.mark.parametrize("model", ["GRU4Rec", "SASRec"])
def test_scanned_eval_equals_per_batch(model, tmp_path):
    """After a short fit, `device_eval` true and false give the same
    metrics over the valid and test examples, 3 rows a batch with a padded
    tail."""
    cfg, ds, (train, *evals) = _prepared(model, checkpoint_dir=str(tmp_path))
    trainer = Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds))
    trainer.fit(train, None, saved=False)
    for loader in evals:
        loader = SeqFullSortEvalBatcher(loader.split, cfg, batch_size=3 * ds.item_num)
        assert loader.rows_per_batch == 3 and len(loader.split) % 3
        results = []
        for flag in (True, False):
            runner = EvalRunner(trainer.model, Config(dict(cfg.as_dict(), device_eval=flag)))
            assert runner._use_scanned_eval(loader, Collector(runner.config)) is flag
            results.append(runner.evaluate(loader))
        assert results[0] == results[1]


@pytest.mark.parametrize("model", ["GRU4Rec", "SASRec", "NARM", "STAMP"])
def test_plain_device_epoch_trains(model, tmp_path, monkeypatch):
    """`device_epoch: true` takes the plain device epoch: every step's
    batch carries the split's columns, the (n, L) lists among them, on the
    step; the losses are finite and the parameters move."""
    cfg, ds, (train, _, _) = _prepared(model, device_epoch=True, checkpoint_dir=str(tmp_path))
    assert ds.user_feat is None and ds.item_feat is None
    trainer = Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds))
    seen = []
    step = trainer.step_graphs.step

    def recorded(batch, trainable=None):
        seen.append({k: (tuple(v.shape), v.dtype) for k, v in batch.items()})
        return step(batch, trainable)

    monkeypatch.setattr(trainer.step_graphs, "step", recorded)
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    trainer.fit(train, None, saved=False)
    (de,) = trainer._device_epochs.values()
    assert de.mode == "plain" and len(seen) == 2 * de.n_steps
    B, L = train.step, cfg["MAX_ITEM_LIST_LENGTH"]
    assert seen[0] == {"user_id": ((B,), torch.int64), "item_id": ((B,), torch.int64),
                       "item_id_list": ((B, L), torch.int64),
                       "item_length": ((B,), torch.int64), "weight": ((B,), torch.float32)}
    assert np.isfinite(trainer.last_losses).all()
    assert all(not torch.equal(before[n], p) for n, p in trainer.params.items())


def _jax_trainer(cfg_dict):
    """The JAX trainer and its host loader for `cfg_dict`, from the JAX
    package's own initial weights."""
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.sequential import SequentialDataset as JaxSeqDataset
    from oovrec_tpu.data.utils import data_preparation as jax_prep
    from oovrec_tpu.train.trainer import Trainer as JaxTrainer

    jcfg = JaxConfig(config_dict=cfg_dict)
    jds = JaxSeqDataset(jcfg)
    jtrain = jax_prep(jcfg, jds)[0]
    model, variables, estate = jax_quick_start.build_model_and_state(
        jcfg, jds, template_batch=jtrain._make_batch(np.arange(2)))
    return JaxTrainer(jcfg, model, variables, estate), jtrain


@pytest.mark.parametrize("model", ["GRU4Rec", "SASRec"])
def test_plain_sequential_batch_matches_host_batcher(model, tmp_path):
    """The plain device epoch's batch from given rows of its padded columns
    equals the JAX host batcher's `_make_batch` at the same indices, key
    for key and bit for bit: full batches, and a tail batch whose padding
    is the device epoch's zero rows at weight 0 (the JAX batcher pads with
    zero rows at weight 0)."""
    from tests.test_torch_device_epoch_modes import _same_values
    from oovrec_tpu_torch.train.device_epoch import DeviceEpoch

    over = dict(device_epoch=True, train_batch_size=5, checkpoint_dir=str(tmp_path))
    cfg, ds, (train, _, _) = _prepared(model, **over)
    jt, jtrain = _jax_trainer(_cfg(**dict(SMALL, model=model, **over)))
    de = DeviceEpoch(Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds)), train)
    assert de.mode == jtrain.mode == "plain" and de.B == jtrain.local_step == 5
    pad = de.weights.shape[0] - de.n_real
    assert 0 < pad < de.B, pad
    rng = np.random.default_rng(3)
    for k in (de.B, de.B, de.B - pad):
        idx = rng.choice(de.n_real, k, replace=False)
        rows = torch.from_numpy(np.r_[idx, np.arange(de.n_real, de.n_real + de.B - k)])
        got = de.make_batch({c: v[rows] for c, v in de.columns.items()}, de.weights[rows], None)
        assert got["item_id_list"].shape == (de.B, cfg["MAX_ITEM_LIST_LENGTH"])
        _same_values(got, jtrain._make_batch(idx))


@pytest.mark.parametrize("model", ["GRU4Rec", "SASRec", "NARM", "STAMP"])
def test_plain_device_epoch_follows_the_jax_steps(model, tmp_path):
    """One plain device epoch from JAX's initial weights: its batches hold
    every real row of the split once at weight 1 and zero rows at weight
    0; the JAX trainer's step over the same batches gives its losses
    (1e-5 relative) and, after the epoch, its parameters (1e-5). SASRec's
    attention key biases are left out of that last check: the softmax is
    invariant to them, so their gradient is rounding noise, which Adam
    scales up to whole steps in either package."""
    from jax.tree_util import tree_map
    from oovrec_tpu.train.trainer import _device_estate
    from oovrec_tpu_torch.train.device_epoch import DeviceEpoch
    from oovrec_tpu_torch.utils.jax_params import state_dict_from_flax

    over = dict(device_epoch=True, train_batch_size=7, checkpoint_dir=str(tmp_path))
    cfg, ds, (train, _, _) = _prepared(model, **over)
    jt, _ = _jax_trainer(_cfg(**dict(SMALL, model=model, **over)))
    port_model = port_quick_start.build_model_and_state(cfg, ds)
    load_flax_params(port_model, tree_map(np.array, jt.variables["params"]))
    trainer = Trainer(cfg, port_model)
    de = DeviceEpoch(trainer, train)
    assert de.n_steps * de.B > de.n_real
    batches = [{k: v.clone() for k, v in b.items()} for _, b in de.batches(0)]
    cols = ("user_id", "item_id", "item_length")
    real = sorted((*(int(b[c][r]) for c in cols), tuple(b["item_id_list"][r].tolist()))
                  for b in batches for r in range(de.B) if b["weight"][r] > 0)
    split = train.split.inter
    assert real == sorted((*(int(split[c][r]) for c in cols),
                           tuple(split["item_id_list"][r].tolist()))
                          for r in range(len(train.split)))
    for b in batches:
        w = b["weight"].numpy()
        assert set(np.unique(w)) <= {0.0, 1.0}
        assert all(not b[c][w == 0].any() for c in (*cols, "item_id_list"))
    assert sum(int((b["weight"] == 0).sum()) for b in batches) == de.n_steps * de.B - de.n_real
    losses = de.run(0).numpy()

    step = jt._get_step(False)
    params = jt.variables["params"]
    extra = {k: v for k, v in jt.variables.items() if k != "params"}
    opt_state, estate, want = jt.opt_state, _device_estate(jt.estate), []
    for i, b in enumerate(batches):
        db = jt._place_batch({k: v.numpy() for k, v in b.items()})
        loss, params, _, opt_state = step(params, extra, opt_state, db, estate,
                                          jax.random.fold_in(jt._dropout_key, i))
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=TOL)
    got = port_model.state_dict()
    for k, v in state_dict_from_flax(tree_map(np.array, params), port_model).items():
        if k.endswith(".key.bias"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=TOL, err_msg=k)


def test_plain_device_epoch_joins_feature_tables(tmp_path):
    """On a corpus with `.user` and `.item` tables (toy-ind) the plain
    device epoch joins their columns onto each sequential batch, as the
    host batcher does, and GRU4Rec trains over them."""
    cfg, ds, (train, _, _) = _prepared(
        "GRU4Rec", dataset="toy-ind", device_epoch=True, checkpoint_dir=str(tmp_path),
        load_col={"inter": ["user_id", "item_id", "timestamp", "is_new"],
                  "user": ["user_id", "age", "gender"], "item": ["item_id", "price", "category"]})
    assert ds.user_feat is not None and ds.item_feat is not None
    trainer = Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds))
    (de,) = [trainer._maybe_device_epoch(train)]
    batch = next(b for _, b in de.batches(0))
    host = train._make_batch(np.arange(len(train.split)))
    assert set(batch) == set(host) >= {"item_id_list", "age", "gender", "price", "category"}
    trainer.fit(train, None, saved=False)
    assert de.mode == "plain" and np.isfinite(trainer.last_losses).all()


@pytest.mark.parametrize("model,flag,want", [
    ("GRU4Rec", True, True), ("STAMP", True, True), ("GRU4Rec", "auto", False),
    ("BERT4Rec", True, False), ("FPMC", True, False), ("GRU4Rec", False, False)])
def test_device_epoch_gate_matches_jax(model, flag, want, tmp_path):
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.sequential import SequentialDataset as JaxSeqDataset
    from oovrec_tpu.data.utils import data_preparation as jax_prep

    over = dict(device_epoch=flag, checkpoint_dir=str(tmp_path))
    if model == "FPMC":
        over["train_neg_sample_args"] = {"distribution": "uniform", "sample_num": 1}
    cfg, ds, (train, _, _) = _prepared(model, **over)
    trainer = Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds))
    got = device_epoch_eligible(trainer, train, cfg)
    jcfg = JaxConfig(config_dict=_cfg(**dict(SMALL, model=model, **over)))
    jtrain = jax_prep(jcfg, JaxSeqDataset(jcfg))[0]
    stub = type("T", (), {"mesh": None, "dhe_hasher": None,
                          "model": jax_quick_start.get_model_class(model)})()
    assert got == jax_eligible(stub, jtrain, jcfg) == want

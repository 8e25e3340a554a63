"""The second sequential slice end to end against the JAX package, on the
CPU: Caser, NextItNet, DIN, DIEN, HGN, FOSSIL, TransRec, SHAN, NPE, HRM,
CORE, SRGNN, GCSAN, LightSANs and SINE.

As `test_torch_seq_slice.py` does for the first six: each JAX run's
initial params are loaded into the port's model (`_bridge`), dropout is
0, and on the toy fixture (full sort, leave-one-out, the host path) each
model trains two epochs through `quick_start.run`. The epoch losses agree
to 1e-5 relative and the valid and test metrics to 1e-5. DIN, DIEN and
TransRec train with one sampled negative a row (DIEN on the presampled
negative lists, `dien_neg_sampling: presampled`), SHAN also through the
`inverse_itemseq` transform. Caser through `python -m
oovrec_tpu_torch.cli.run` (uni250, one sampled negative) agrees with the
JAX CLI to 1e-5 and `--eval_only` reproduces the run to 1e-9. One plain
device epoch of Caser and NextItNet gives the JAX trainer's losses and
parameters over the same batches (1e-5); they train on it through
`Trainer.fit`; and the gate sends them there under `true`, keeps the
other thirteen on the host path and a small corpus under `auto`, as the
JAX gate does.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli.run import main as jax_main  # noqa: E402
from oovrec_tpu_torch.cli.run import main as port_main  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402

from tests.test_torch_seq_data import _cfg  # noqa: E402
from tests.test_torch_seq_slice import (  # noqa: E402
    SMALL,
    TOL,
    _agree,
    _bridge,
    _prepared,
)

ONE_NEG = {"train_neg_sample_args": {"distribution": "uniform", "sample_num": 1}}
CLICK = dict(ONE_NEG, mlp_hidden_size=[8, 4], att_hidden=[6, 5])
FITS = {
    "Caser": dict(model="Caser", n_h=4, n_v=2),
    "NextItNet": dict(model="NextItNet"),
    "DIN": dict(CLICK, model="DIN"),
    "DIEN": dict(CLICK, model="DIEN", dien_neg_sampling="presampled"),
    "HGN": dict(model="HGN"),
    "FOSSIL": dict(model="FOSSIL"),
    "TransRec": dict(ONE_NEG, model="TransRec"),
    "SHAN": dict(model="SHAN"),
    "SHAN-inverse": dict(model="SHAN", transform="inverse_itemseq"),
    "NPE": dict(model="NPE"),
    "HRM": dict(model="HRM"),
    "CORE": dict(model="CORE", dnn_type="trm"),
    "SRGNN": dict(model="SRGNN"),
    "GCSAN": dict(model="GCSAN"),
    "LightSANs": dict(model="LightSANs", k_interests=3),
    "SINE": dict(model="SINE", prototype_size=4),
}
DEVICE_EPOCH = ("Caser", "NextItNet")


@pytest.mark.parametrize("case", sorted(FITS))
def test_run_matches_jax(case, tmp_path, monkeypatch):
    _bridge(monkeypatch)
    cfg = _cfg(**dict(SMALL, **FITS[case]))
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


def test_cli_caser_matches_jax(tmp_path, monkeypatch):
    from tests.test_torch_dataset import ASSETS

    _bridge(monkeypatch)
    argv = ["--model=Caser", "--dataset=toy", f"--data_path={ASSETS}", "--epochs=2",
            "--train_batch_size=8", "--embedding_size=8", "--n_h=4", "--n_v=2",
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
    assert type(again["trainer"].model).__name__ == "Caser"
    _agree(pres["test_result"], again["test_result"], 1e-9, "eval_only")


@pytest.mark.parametrize("model", DEVICE_EPOCH)
def test_plain_device_epoch_follows_the_jax_steps(model, tmp_path):
    """One plain device epoch from JAX's initial weights: the JAX
    trainer's step over the same batches gives its losses (1e-5 relative)
    and, after the epoch, its parameters (1e-5)."""
    from jax.tree_util import tree_map

    import jax
    from oovrec_tpu.train.trainer import _device_estate
    from oovrec_tpu_torch.train.device_epoch import DeviceEpoch
    from oovrec_tpu_torch.utils.jax_params import load_flax_params, state_dict_from_flax
    from tests.test_torch_seq_slice import _jax_trainer

    over = dict(FITS[model], device_epoch=True, train_batch_size=7,
                checkpoint_dir=str(tmp_path))
    cfg, ds, (train, _, _) = _prepared(**over)
    jt, _ = _jax_trainer(_cfg(**dict(SMALL, **over)))
    port_model = port_quick_start.build_model_and_state(cfg, ds)
    load_flax_params(port_model, tree_map(np.array, jt.variables["params"]))
    trainer = Trainer(cfg, port_model)
    de = DeviceEpoch(trainer, train)
    assert de.mode == "plain" and de.n_steps * de.B > de.n_real
    batches = [{k: v.clone() for k, v in b.items()} for _, b in de.batches(0)]
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
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("model", DEVICE_EPOCH)
def test_plain_device_epoch_trains(model, tmp_path):
    cfg, ds, (train, _, _) = _prepared(**dict(FITS[model], device_epoch=True,
                                              checkpoint_dir=str(tmp_path)))
    trainer = Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds))
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    trainer.fit(train, None, saved=False)
    (de,) = trainer._device_epochs.values()
    assert de.mode == "plain"
    assert np.isfinite(trainer.last_losses).all()
    moved = [n for n, p in trainer.params.items() if not np.array_equal(before[n], p.detach())]
    assert set(moved) == set(trainer.params)


@pytest.mark.parametrize("flag", [True, "auto"])
@pytest.mark.parametrize("case", sorted(FITS))
def test_device_epoch_gate_matches_jax(case, flag, tmp_path):
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.sequential import SequentialDataset as JaxSeqDataset
    from oovrec_tpu.data.utils import data_preparation as jax_prep
    from oovrec_tpu.train.device_epoch import device_epoch_eligible as jax_eligible
    from oovrec_tpu_torch.train.device_epoch import device_epoch_eligible

    over = dict(FITS[case], device_epoch=flag, checkpoint_dir=str(tmp_path))
    cfg, ds, (train, _, _) = _prepared(**over)
    trainer = Trainer(cfg, port_quick_start.build_model_and_state(cfg, ds))
    got = device_epoch_eligible(trainer, train, cfg)
    jcfg = JaxConfig(config_dict=_cfg(**dict(SMALL, **over)))
    jtrain = jax_prep(jcfg, JaxSeqDataset(jcfg))[0]
    stub = type("T", (), {"mesh": None, "dhe_hasher": None,
                          "model": jax_quick_start.get_model_class(over["model"])})()
    assert got == jax_eligible(stub, jtrain, jcfg) == (flag is True and case in DEVICE_EPOCH)

"""The knowledge slice end to end against the JAX package, on the CPU.

Each of the ten knowledge models trains two epochs on `toy-kg` through
`quick_start.run` (the `KnowledgeBasedDataset`, `KGTrainBatcher` with its
triples and negative tails, the state from the training split, the full
sort) from the JAX run's initial weights, at dropout 0: the epoch losses
agree to 1e-5 relative, the valid and test metrics to 1e-5. KGIN's JAX
run takes `finite_l2norm` (its own `_l2norm` makes the first step's
parameters NaN, ROADMAP.md §3). CKE runs through `python -m
oovrec_tpu_torch.cli.run` against the JAX CLI, and its `--eval_only`
reproduces the run to 1e-9 (`test_torch_kg_data.py` holds the
refusals of the inductive eval and the device epoch).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli.run import main as jax_main  # noqa: E402
from oovrec_tpu_torch.cli.run import main as port_main  # noqa: E402

from tests.test_torch_dataset import ASSETS  # noqa: E402
from tests.test_torch_kg_grads import finite_l2norm  # noqa: E402
from tests.test_torch_seq_slice import _bridge  # noqa: E402

TOL = 1e-5
FITS = {
    "CKE": {"kg_embedding_size": 8},
    "CFKG": {},
    "CFKG-transe": {"loss_function": "transe"},
    "KGAT": {"kg_embedding_size": 8, "layers": [8], "mess_dropout": 0.0},
    "KGCN": {},
    "KGNNLS": {},
    "MKR": {},
    "KTUP": {},
    "RippleNet": {},
    "KGIN": {"n_factors": 2, "mess_dropout_rate": 0.0},
    "MCCLK": {"knn_k": 3},
}


def _cfg(model, **over):
    d = dict(model=model, dataset="toy-kg", data_path=ASSETS, epochs=2, train_batch_size=8,
             eval_batch_size=64, embedding_size=8, log_tensorboard=False, seed=11,
             topk=[2, 5], valid_metric="MRR@5", metric_decimal_place=12,
             load_col={"inter": ["user_id", "item_id", "rating", "timestamp"]},
             eval_args={"split": {"RS": [8, 1, 1]}, "order": "RO", "group_by": "user",
                        "mode": "full"})
    d.update(over)
    return d


def _agree(a, b, tol, what):
    assert list(a) == list(b), what
    for k in a:
        assert abs(float(a[k]) - float(b[k])) <= tol, (what, k, a[k], b[k])


@pytest.mark.parametrize("case", sorted(FITS))
def test_run_matches_jax(case, tmp_path, monkeypatch):
    _bridge(monkeypatch)
    if case == "KGIN":
        monkeypatch.setattr("oovrec_tpu.models.knowledge.more3._l2norm", finite_l2norm)
    cfg = _cfg(case.split("-")[0], **FITS[case])
    jres = jax_quick_start.run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / "jax")),
                               saved=False)
    pres = port_quick_start.run(config_dict=dict(cfg, device="cpu",
                                                 checkpoint_dir=str(tmp_path / "port")),
                                saved=False)
    jt, pt = jres["trainer"], pres["trainer"]
    assert type(pt.model).__name__ == cfg["model"] and not pt._device_epochs
    assert list(pt.train_loss_dict) == list(jt.train_loss_dict) == [0, 1]
    for e, want in jt.train_loss_dict.items():
        np.testing.assert_allclose(pt.train_loss_dict[e], want, rtol=TOL, err_msg=f"epoch {e}")
    _agree(jres["best_valid_result"], pres["best_valid_result"], TOL, "valid")
    _agree(jres["test_result"], pres["test_result"], TOL, "test")


def test_cli_cke_matches_jax(tmp_path, monkeypatch):
    _bridge(monkeypatch)
    argv = ["--model=CKE", "--dataset=toy-kg", f"--data_path={ASSETS}", "--epochs=2",
            "--train_batch_size=8", "--embedding_size=8", "--kg_embedding_size=8",
            "--log_tensorboard=False", "--metric_decimal_place=12", "--topk=[2,5]",
            "--valid_metric=MRR@5",
            "--load_col={'inter': ['user_id','item_id','rating','timestamp']}"]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jres = jax_main(argv + [f"--checkpoint_dir={tmp_path / 'jax' / 'saved'}"])
    monkeypatch.chdir(tmp_path / "port")
    pres = port_main(argv + ["--device=cpu", f"--checkpoint_dir={tmp_path / 'port' / 'saved'}"])
    assert pres["trainer"].train_loss_dict
    _agree(jres["test_result"], pres["test_result"], TOL, "CLI test")
    again = port_main([f"--eval_only={pres['trainer'].saved_model_file}"])
    assert type(again["trainer"].model).__name__ == "CKE"
    _agree(pres["test_result"], again["test_result"], 1e-9, "eval_only")

"""The port's `Trainer.fit` against the JAX package's, whole trajectories.

Both packages train the same model from the same weights (the JAX init,
crossed through the weight bridge) for two epochs on the toy-ind fixture
with random-mapper OOV buckets and the OOV regime: BPR (pairwise) and
xDeepFM (pointwise, dropout 0, on the CIN kernel route and on the slab
path), with the frozen OOV-only sub-epoch, in mixed mode
(`oov_only_epoch: false`), with sampled validation and with the
torch-faithful Adam plus decay and clipping. The JAX side runs its host per-batch path (`device_epoch:
false`, `host_scan_steps: 1`), as `tests/test_host_scan.py:_train` builds
it. Epoch losses must agree to 1e-5 relative, the final parameters to
1e-5 absolute, and the validation scores exactly. Then the optimizer
rollback of `oov_freeze_skip_optim`, which the JAX trainer cannot run (its
`fit` raises NameError at `trainer.py:675`: `jnp` is bound only inside the
dynamic-negatives branch above), a checkpoint save → resume round trip,
and the configurations the port refuses.
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.cli.quick_start import build_model_and_state  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.utils import create_dataset, data_preparation  # noqa: E402
from oovrec_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data import (  # noqa: E402
    FullSortEvalBatcher,
    PlainEvalBatcher,
    Sampler,
    TrainBatcher,
)
from oovrec_tpu_torch.inductive import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.models import BPR, FieldSpec, xDeepFM  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.utils.enums import InputType  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402

from tests.test_context_models import _ranking_cfg  # noqa: E402
from tests.test_inductive import _ind_cfg  # noqa: E402
from tests.test_torch_train_parts import _port_split  # noqa: E402

HOST_PATH = dict(host_scan_steps=1, device_epoch=False, log_tensorboard=False)
OOV = dict(inductive_mapper="random", add_oov_buckets=True, n_user_oov_buckets=8,
           n_item_oov_buckets=8, train_oov=True, oov_only_epoch=True,
           oov_train_ratio=0.8, oov_feature_mask_rate=0.2)


def _bpr_cfg(tmp, **over):
    d = dict(epochs=2, train_batch_size=4, checkpoint_dir=str(tmp), **HOST_PATH)
    d.update(over)
    return _ind_cfg(**d)


def _xdfm_cfg(tmp, **over):
    d = dict(OOV, epochs=2, train_batch_size=8, metrics=["AUC", "LogLoss"],
             valid_metric="AUC", cin_layer_size=[8, 8], dropout_prob=0.0,
             eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO",
                        "group_by": None, "mode": "labeled"},
             checkpoint_dir=str(tmp), **HOST_PATH)
    d.update(over)
    return _ranking_cfg("xDeepFM", **d)


def _setup(cfg_dict, fused="auto"):
    """The JAX pipeline (dataset, loaders, model, initial params) and the
    port's counterparts built from the same arrays and weights."""
    jcfg = JaxConfig(config_dict=cfg_dict)
    ds = create_dataset(jcfg)
    # the template batch draws negatives: take it from a second loader so
    # the training loader's sampler stream is the port's
    template = data_preparation(jcfg, ds)[0]._make_batch(np.arange(2))
    jtrain, jvalid, jtest = data_preparation(jcfg, ds)
    jm, variables, estate = build_model_and_state(jcfg, ds, template_batch=template)
    # float-field tables scaled down: ages and prices of ~20 saturate xDeepFM
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) * (np.float32(0.01) if p[-2].key == "float_embedding_table"
                                      else np.float32(1)), variables["params"])

    cfg = Config(jcfg.as_dict())
    splits = [_port_split(s) for s in ds.build()[:3]]
    nsa = jcfg["train_neg_sample_args"]
    sampler = Sampler(["train", "valid", "test"], splits,
                      distribution=nsa.get("distribution", "uniform"),
                      alpha=nsa.get("alpha", 1.0), seed=int(jcfg["seed"]),
                      repeatable=bool(jcfg["repeatable"]))
    spec = InductiveSpec.from_config(cfg)
    if jcfg["model"] == "BPR":
        model = BPR(ds.user_num, ds.item_num, int(jcfg["embedding_size"]), spec, device="cpu")
        input_type = InputType.PAIRWISE
        valid = FullSortEvalBatcher(splits[1], sampler, cfg, phase="valid")
        test = FullSortEvalBatcher(splits[2], sampler, cfg, phase="test")
    else:
        model = xDeepFM(
            FieldSpec(**dataclasses.asdict(jm.fields)), embedding_size=jm.embedding_size,
            spec=spec, mlp_hidden_size=jm.mlp_hidden_size, reg_weight=jm.reg_weight,
            dropout_prob=jm.dropout_prob, direct=jm.direct, cin_layer_size=jm.cin_layer_size,
            fused_cin=fused, label_field=jm.label_field, device="cpu")
        input_type = InputType.POINTWISE
        valid, test = PlainEvalBatcher(splits[1], cfg), PlainEvalBatcher(splits[2], cfg)
    load_flax_params(model, params)
    return {
        "jax": (jcfg, jm, dict(variables, params=jax.tree_util.tree_map(jax.numpy.asarray, params)),
                estate, jtrain, jvalid, jtest),
        "port": (cfg, model, TrainBatcher(splits[0], sampler, cfg, input_type), valid, test),
    }


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


CASES = {
    "bpr-frozen": (_bpr_cfg, dict(oov_freeze_embedding=True), "auto"),
    "bpr-mixed": (_bpr_cfg, dict(oov_only_epoch=False), "auto"),
    # one valid user a batch, half the batches after the first sampled
    # from the `valid_sampling` stream
    "bpr-frozen-sampled-valid": (_bpr_cfg, dict(
        oov_freeze_embedding=True, eval_batch_size=11, eval_valid_sample_ratio=0.5), "auto"),
    "bpr-torch-adam-decay-clip": (_bpr_cfg, dict(
        oov_freeze_embedding=True, optimizer_skip_zero_grads=True, weight_decay=1e-3,
        clip_grad_norm={"max_norm": 0.5}), "auto"),
    "xdeepfm-frozen-kernel": (_xdfm_cfg, dict(oov_freeze_embedding=True), True),
    "xdeepfm-mixed-slab": (_xdfm_cfg, dict(oov_only_epoch=False), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_trajectory_matches_jax(case, tmp_path):
    make, over, fused = CASES[case]
    s = _setup(make(tmp_path, **over), fused)
    jcfg, jm, variables, estate, jtrain, jvalid, _ = s["jax"]
    jt = JaxTrainer(jcfg, jm, variables, estate)
    jbest = jt.fit(jtrain, jvalid, saved=False)

    cfg, model, train, valid, _ = s["port"]
    pt = Trainer(cfg, model)
    best = pt.fit(train, valid, saved=False)

    assert list(pt.train_loss_dict) == list(jt.train_loss_dict) == [0, 1]
    assert list(pt.oov_loss_dict) == list(jt.oov_loss_dict)
    for got, want in ((pt.train_loss_dict, jt.train_loss_dict),
                      (pt.oov_loss_dict, jt.oov_loss_dict)):
        for e in want:
            np.testing.assert_allclose(got[e], want[e], rtol=1e-5, err_msg=f"epoch {e}")
    assert best[0] == jbest[0]
    got = _flat(flax_from_state_dict(model.state_dict(), model))
    want = _flat(jt.variables["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    if "mixed" not in case:
        assert pt.oov_loss_dict  # the OOV sub-epoch ran


def test_frozen_sub_epoch_rollback_restores_a_true_copy(tmp_path):
    """Under `oov_freeze_skip_optim` the optimizer state after `fit` is the
    state before the OOV sub-epoch, value for value, although the sub-epoch
    moved the bucket tables (and so their moments, before the rollback);
    the IV tables do not move in the frozen sub-epoch."""
    s = _setup(_bpr_cfg(tmp_path, epochs=1, oov_freeze_embedding=True,
                        oov_freeze_skip_optim=True))
    cfg, model, train, _, _ = s["port"]
    trainer = Trainer(cfg, model)
    inner, seen = trainer._train_epoch, {}

    def watched(loader, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        if frozen:
            seen["state"] = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                             else v for k, v in trainer.opt_state.items()}
            seen["params"] = {n: p.detach().clone() for n, p in trainer.params.items()}
        return inner(loader, epoch_idx, oov_transform, keep_ratio, frozen)

    trainer._train_epoch = watched
    trainer.fit(train, None, saved=False)
    assert trainer.oov_loss_dict
    before = seen["state"]
    assert trainer.opt_state["count"] == before["count"]
    for part in ("mu", "nu"):
        for n, t in before[part].items():
            assert torch.equal(trainer.opt_state[part][n], t), (part, n)
    moved = {n for n, p in trainer.params.items() if not torch.equal(p, seen["params"][n])}
    assert moved == {"user_oov_buckets.weight", "item_oov_buckets.weight"}


def test_checkpoint_round_trip(tmp_path):
    """fit saves the best epoch; a fresh trainer resumes parameters,
    optimizer state and early-stopping state from it; `evaluate` reloads
    the best weights; the metrics log is JSONL."""
    log_path = tmp_path / "metrics.jsonl"
    s = _setup(_bpr_cfg(tmp_path, oov_freeze_embedding=True, metrics_log_path=str(log_path)))
    cfg, model, train, valid, test = s["port"]
    trainer = Trainer(cfg, model)
    trainer.fit(train, valid, saved=True)
    saved = trainer.saved_model_file
    assert saved.startswith(str(tmp_path)) and saved.endswith(".pth")

    fresh = _setup(_bpr_cfg(tmp_path, oov_freeze_embedding=True))["port"][1]
    other = Trainer(cfg, fresh)
    state = other.resume_checkpoint(saved)
    best_epoch = state["epoch"]
    assert other.start_epoch == best_epoch + 1
    assert other.best_valid_score == trainer.best_valid_score
    assert state["config"]["model"] == "BPR"
    if best_epoch == cfg["epochs"] - 1:  # the last epoch was the best: same state
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
        assert other.opt_state["count"] == trainer.opt_state["count"]
        for part in ("mu", "nu"):
            for k, v in trainer.opt_state[part].items():
                assert torch.equal(other.opt_state[part][k], v), (part, k)
    want = Trainer(cfg, fresh).evaluate(test, load_best_model=False)
    assert trainer.evaluate(test, load_best_model=True) == want
    lines = [json.loads(x) for x in log_path.read_text().splitlines()]
    assert [x["head"] for x in lines] == ["train", "valid"] * 2
    assert lines[0]["epoch"] == 0 and "train_loss" in lines[0]


@pytest.mark.parametrize("over,match", [
    (dict(device_epoch=True), "device_epoch"),
    (dict(host_scan_steps=4), "host_scan_steps"),
    (dict(use_mesh=True), "mesh"),
    (dict(train_neg_sample_args={"distribution": "uniform", "sample_num": 1,
                                 "dynamic": True}), "dynamic"),
    (dict(learner="adagrad"), "adagrad"),
    (dict(optimizer_mu_dtype="bfloat16"), "mu_dtype"),
])
def test_trainer_refuses_what_is_not_ported(over, match):
    model = BPR(7, 11, 8, InductiveSpec(), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        Trainer(Config(over), model)

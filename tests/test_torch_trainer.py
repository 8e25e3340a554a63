"""The port's `Trainer.fit` against the JAX package's, whole trajectories.

Both packages train the same model from the same weights (the JAX init,
crossed through the weight bridge) for two epochs on the toy-ind fixture
with random-mapper OOV buckets and the OOV regime: BPR (pairwise) and
xDeepFM (pointwise, dropout 0, on the CIN kernel route and on the slab
path), with the frozen OOV-only sub-epoch, in mixed mode
(`oov_only_epoch: false`), with sampled validation and with the
torch-faithful Adam plus decay and clipping, and under `learner:
sparse_adam`; then with the embedders: BPR with lsh, dnn and fdhe (host
hashing, a key file under the test's directory) and xDeepFM with lsh, the
port's model holding the JAX run's embedder state as its buffers; then
the other paper models: WideDeep (also with lsh), DCNv2 stacked, parallel
(in mixed mode) and with mixed experts (under SGD: `_dcnv2_cfg`), whose BatchNorm running statistics
must end equal to the JAX run's `batch_stats` to 1e-5 and move in the
frozen sub-epoch too, and DirectAU (also under `learner: sparse_adam`,
where the port's host path takes the row-sparse step of kernel 6's plain
version and the JAX one sweeps the whole tables). The JAX
side runs its host per-batch path (`device_epoch:
false`, `host_scan_steps: 1`), as `tests/test_host_scan.py:_train` builds
it. Epoch losses must agree to 1e-5 relative, the final parameters to
1e-5 absolute, and the validation scores exactly. Then the frozen
OOV sub-epoch with an embedder tower moves only `oov_bucket` and `oov_mlp`
parameters, the optimizer
rollback of `oov_freeze_skip_optim`, which the JAX trainer cannot run (its
`fit` raises NameError at `trainer.py:675`: `jnp` is bound only inside the
dynamic-negatives branch above), a checkpoint save → resume round trip,
the configurations the port refuses, and the ranking models' routes to the
pointwise device epoch (`test_torch_device_epoch_modes.py` holds that
epoch against the JAX package).
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
    DatasetSplit,
    FullSortEvalBatcher,
    PlainEvalBatcher,
    Sampler,
    TrainBatcher,
)
from oovrec_tpu_torch.inductive import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.cli.quick_start import model_kwargs  # noqa: E402
from oovrec_tpu_torch.models import BPR, DirectAU, FieldSpec, get_model_class  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.utils.enums import InputType  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    batch_stats_from_module,
    flax_from_state_dict,
    load_flax_params,
)

from tests.test_context_models import _ranking_cfg  # noqa: E402
from tests.test_inductive import _ind_cfg  # noqa: E402
from tests.test_torch_train_parts import _port_split  # noqa: E402

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these tiny shapes run fastest on one thread:
    several test workers each spreading a 512-element GELU over every core
    spend milliseconds a call on the thread pool alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HOST_PATH = dict(host_scan_steps=1, device_epoch=False, log_tensorboard=False)
EMB = {
    "lsh": dict(inductive_mapper=None, inductive_embedder="lsh"),
    "dnn": dict(inductive_mapper=None, inductive_embedder="dnn", dhe_layer_size=16),
    "fdhe": dict(inductive_mapper=None, inductive_embedder="fdhe", dhe_num_hashes=8,
                 dhe_layer_size=16),
}
OOV = dict(inductive_mapper="random", add_oov_buckets=True, n_user_oov_buckets=8,
           n_item_oov_buckets=8, train_oov=True, oov_only_epoch=True,
           oov_train_ratio=0.8, oov_feature_mask_rate=0.2)


@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    """Both packages keep a module-global feature cache per mode: each test
    starts from an empty one and leaves one, so no other test's corpus is
    taken for this one's."""
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


def _bpr_cfg(tmp, **over):
    d = dict(epochs=2, train_batch_size=4, checkpoint_dir=str(tmp),
             hash_key_dir=str(tmp / "keys"), **HOST_PATH)
    d.update(over)
    return _ind_cfg(**d)


def _xdfm_cfg(tmp, model="xDeepFM", **over):
    d = dict(OOV, epochs=2, train_batch_size=8, metrics=["AUC", "LogLoss"],
             valid_metric="AUC", cin_layer_size=[8, 8], dropout_prob=0.0,
             eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO",
                        "group_by": None, "mode": "labeled"},
             checkpoint_dir=str(tmp), hash_key_dir=str(tmp / "keys"), **HOST_PATH)
    d.update(over)
    return _ranking_cfg(model, **d)


def _widedeep_cfg(tmp, **over):
    return _xdfm_cfg(tmp, model="WideDeep", **over)


def _dcnv2_cfg(tmp, **over):
    """DCNv2 under SGD, its cross weights starting at 1/10 of their N(0, 1)
    draw (`_setup`). Each Dense bias before a BatchNorm has a gradient that
    is zero in exact arithmetic (the norm removes any shift), so its
    gradient is rounding noise, which Adam scales up to whole steps that
    differ between the packages (losses 1e-4 apart after two epochs); and
    N(0, 1) cross weights over d = 56 make SGD at this rate diverge."""
    return _xdfm_cfg(tmp, model="DCNV2", cross_layer_num=2, reg_weight=0.01, expert_num=2,
                     low_rank=4, learner="sgd", learning_rate=0.01, **over)


def _directau_cfg(tmp, **over):
    return _bpr_cfg(tmp, model="DirectAU", **over)


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
    estate = {k: np.array(v) for k, v in estate.items()}
    # float-field tables scaled down: ages and prices of ~20 saturate
    # xDeepFM; DCNv2's and DCN's N(0, 1) cross weights by 1/10 (`_dcnv2_cfg`)
    def scaled(p, v):
        if p[-2:-1] and p[-2].key == "float_embedding_table":
            return np.asarray(v) * np.float32(0.01)
        cross = p[-1].key.startswith("cross_layer_") or p[-1].key == "cross_w"
        return np.asarray(v) * np.float32(0.1 if cross else 1)

    params = jax.tree_util.tree_map_with_path(scaled, variables["params"])

    cfg = Config(jcfg.as_dict())
    splits = [_port_split(s) for s in ds.build()[:3]]
    nsa = jcfg["train_neg_sample_args"]
    sampler = Sampler(["train", "valid", "test"], splits,
                      distribution=nsa.get("distribution", "uniform"),
                      alpha=nsa.get("alpha", 1.0), seed=int(jcfg["seed"]),
                      repeatable=bool(jcfg["repeatable"]))
    spec = InductiveSpec.from_config(cfg)
    cls = get_model_class(jcfg["model"])
    # the model's hyper-parameters from the config, as the port's CLI
    # takes them; each equal to the JAX model's
    kw = model_kwargs(cfg, cls)
    assert all(v == getattr(jm, n) for n, v in kw.items() if hasattr(jm, n)), kw
    if "fused_cin" in kw:
        kw["fused_cin"] = fused
    if jcfg["model"] in ("BPR", "DirectAU"):
        model = cls(ds.user_num, ds.item_num, int(jcfg["embedding_size"]), spec, device="cpu",
                    embedder_state=estate or None, **kw)
        input_type = cls.input_type
        valid = FullSortEvalBatcher(splits[1], sampler, cfg, phase="valid")
        test = FullSortEvalBatcher(splits[2], sampler, cfg, phase="test")
    else:
        model = cls(FieldSpec(**dataclasses.asdict(jm.fields)), embedding_size=jm.embedding_size,
                    spec=spec, label_field=jm.label_field, device="cpu",
                    embedder_state=estate or None, **kw)
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
    # `learner: sparse_adam` on the host path: the whole-tree lazy sweep
    "bpr-sparse-adam": (_bpr_cfg, dict(oov_freeze_embedding=True, learner="sparse_adam",
                                       learning_rate=1e-2), "auto"),
    "bpr-torch-adam-decay-clip": (_bpr_cfg, dict(
        oov_freeze_embedding=True, optimizer_skip_zero_grads=True, weight_decay=1e-3,
        clip_grad_norm={"max_norm": 0.5}), "auto"),
    "xdeepfm-frozen-kernel": (_xdfm_cfg, dict(oov_freeze_embedding=True), True),
    "xdeepfm-mixed-slab": (_xdfm_cfg, dict(oov_only_epoch=False), False),
    # the embedders (no mapper): features from toy-ind's user and item files
    "bpr-lsh-frozen": (_bpr_cfg, dict(oov_freeze_embedding=True, **EMB["lsh"]), "auto"),
    "bpr-dnn": (_bpr_cfg, EMB["dnn"], "auto"),
    "bpr-fdhe-frozen": (_bpr_cfg, dict(oov_freeze_embedding=True, **EMB["fdhe"]), "auto"),
    "xdeepfm-lsh-kernel": (_xdfm_cfg, dict(oov_freeze_embedding=True, **EMB["lsh"]), True),
    # the other paper models
    "widedeep-frozen": (_widedeep_cfg, dict(oov_freeze_embedding=True), "auto"),
    "widedeep-lsh": (_widedeep_cfg, EMB["lsh"], "auto"),
    "dcnv2-stacked-frozen": (_dcnv2_cfg, dict(oov_freeze_embedding=True), "auto"),
    "dcnv2-parallel-mixed": (_dcnv2_cfg, dict(structure="parallel", oov_only_epoch=False),
                             "auto"),
    "dcnv2-experts-frozen": (_dcnv2_cfg, dict(mixed=True, oov_freeze_embedding=True), "auto"),
    "directau-frozen": (_directau_cfg, dict(oov_freeze_embedding=True), "auto"),
    "directau-sparse-adam": (_directau_cfg, dict(oov_freeze_embedding=True,
                                                 learner="sparse_adam", learning_rate=1e-2),
                             "auto"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_trajectory_matches_jax(case, tmp_path):
    make, over, fused = CASES[case]
    s = _setup(make(tmp_path, **over), fused)
    jcfg, jm, variables, estate, jtrain, jvalid, _ = s["jax"]
    jt = JaxTrainer(jcfg, jm, variables, dict(estate))
    jbest = jt.fit(jtrain, jvalid, saved=False)

    cfg, model, train, valid, _ = s["port"]
    pt = Trainer(cfg, model)
    assert bool(pt.sparse_tables) == (cfg["learner"] == "sparse_adam"), pt.sparse_tables
    moved = []
    inner = pt._train_epoch

    def watched(loader, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        before = batch_stats_from_module(model)
        total = inner(loader, epoch_idx, oov_transform, keep_ratio, frozen)
        if frozen:
            after = batch_stats_from_module(model)
            moved.append(any(not np.array_equal(a, b) for a, b in zip(
                _flat(before).values(), _flat(after).values())))
        return total

    pt._train_epoch = watched
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
    stats, jstats = _flat(batch_stats_from_module(model)), _flat(jt.variables.get("batch_stats", {}))
    assert set(stats) == set(jstats) and bool(stats) == case.startswith("dcnv2")
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=0, atol=1e-5, err_msg=k)
    if stats and "frozen" in case:  # the running statistics move in the frozen sub-epoch
        assert moved and all(moved)


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


def test_frozen_sub_epoch_moves_only_oov_parameters(tmp_path):
    """With an embedder tower (dnn) the frozen OOV sub-epoch moves its
    `oov_mlp` parameters (and at most the `oov_bucket` tables), never an
    IV table; the tower counts among the trainer's OOV parameters."""
    s = _setup(_bpr_cfg(tmp_path, epochs=1, oov_freeze_embedding=True, **EMB["dnn"]))
    cfg, model, train, _, _ = s["port"]
    trainer = Trainer(cfg, model)
    towers = {n for n in trainer.params if "oov_mlp" in n}
    assert len(towers) == 16 and towers <= trainer.oov_params
    inner, seen = trainer._train_epoch, {}

    def watched(loader, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        if frozen:
            seen["before"] = {n: p.detach().clone() for n, p in trainer.params.items()}
        return inner(loader, epoch_idx, oov_transform, keep_ratio, frozen)

    trainer._train_epoch = watched
    trainer.fit(train, None, saved=False)
    assert trainer.oov_loss_dict
    moved = {n for n, p in trainer.params.items() if not torch.equal(p, seen["before"][n])}
    assert moved <= trainer.oov_params and towers <= moved
    assert {"user_embedding.weight", "item_embedding.weight"}.isdisjoint(moved)


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
    (dict(use_mesh=True), "mesh"),
])
def test_trainer_refuses_what_is_not_ported(over, match):
    """Nothing is refused on the mesh now: DirectAU, whose uniformity term
    spans pairs of the batch's rows, trains under `use_mesh` (a mesh of one
    process), its epoch equal to the plain trainer's bit for bit; every
    registered model trains on 2 ranks in `tests/test_torch_mesh_*.py`.
    Dynamic negatives, adagrad, rmsprop and `optimizer_mu_dtype` are ported
    (tests/test_torch_trainer_extras.py)."""
    split = DatasetSplit({"user_id": np.arange(1, 7), "item_id": np.arange(1, 7)}, 7, 11)
    runs = []
    for cfg in (Config(over), Config({})):
        torch.manual_seed(0)
        model = DirectAU(7, 11, 8, InductiveSpec(), device="cpu")
        trainer = Trainer(cfg, model)
        assert (getattr(trainer, match) is not None) == bool(cfg["use_mesh"])
        loader = TrainBatcher(split, Sampler(["train"], [split], seed=1), cfg,
                              InputType.POINTWISE)
        trainer._train_epoch(loader, 0)
        runs.append((trainer.last_losses, {n: p.detach().clone()
                                           for n, p in model.named_parameters()}))
    (l1, p1), (l0, p0) = runs
    assert np.array_equal(l1, l0) and len(l0) > 0
    assert all(torch.equal(p1[n], p0[n]) for n in p0)


@pytest.mark.parametrize("flag", ["auto", True])
def test_ranking_models_take_the_host_path(flag):
    """WideDeep and DCNv2 declare `supports_device_epoch` as the JAX models
    do: `auto` takes the host path below AUTO_MIN_ROWS rows and the
    pointwise device epoch at it, `true` the device epoch at any size."""
    from oovrec_tpu_torch.models import DCNV2, WideDeep
    from oovrec_tpu_torch.train import device_epoch

    fields = FieldSpec(token_names=("user_id", "item_id"), token_dims=(7, 11))
    split = DatasetSplit({"user_id": np.arange(1, 7), "item_id": np.arange(1, 7),
                          "label": np.ones(6, np.float32)}, 7, 11)
    cfg = Config({"device_epoch": flag})
    for cls in (WideDeep, DCNV2):
        trainer = Trainer(cfg, cls(fields, embedding_size=4, device="cpu"))
        loader = TrainBatcher(split, Sampler(["train"], [split], seed=1), cfg,
                              InputType.POINTWISE)
        assert cls.supports_device_epoch and loader.mode == "pointwise"
        if flag == "auto":
            assert trainer._maybe_device_epoch(loader) is None
            orig, device_epoch.AUTO_MIN_ROWS = device_epoch.AUTO_MIN_ROWS, 1
            try:
                trainer = Trainer(cfg, cls(fields, embedding_size=4, device="cpu"))
                assert trainer._maybe_device_epoch(loader).mode == "pointwise"
            finally:
                device_epoch.AUTO_MIN_ROWS = orig
        else:
            assert trainer._maybe_device_epoch(loader).mode == "pointwise"

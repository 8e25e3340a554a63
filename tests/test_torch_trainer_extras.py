"""The trainer's last learners and dynamic hard negatives, against the JAX
package.

Optimizers: `adagrad` (optax `scale_by_rss`), `rmsprop` (`scale_by_rms`),
`adam` with `optimizer_mu_dtype: bfloat16` and the torch-faithful Adam
(`optimizer_skip_zero_grads`) with it, each against the chain the JAX
trainer builds (`trainer.py:67-88`), its update jitted as the trainer's
step is: 8 steps with gradients of varying norm, an all-zero leaf at some
steps and a frozen stretch (only the OOV leaf trains, `_select_opt_state`),
plain and with weight decay plus clipping; parameters to 1e-6 relative
(and 1e-6 absolute near 0) after every step, the stored bf16 first moment
bit for bit. `mu_dtype` reaches neither `sparse_adam` nor the fallback of
an unknown learner, as in JAX.

Dynamic hard negatives: with JAX's sampler seed and the same weights, the
port's picks equal the JAX batcher's exactly (weights whose scores keep
every slot's top two more than 1e-4 apart, so no f32 rounding decides a
pick), a tie goes to the first candidate, and the picks are the argmax of
a plain numpy scorer; such a loader is not prefetched, takes the host path
and K = 1. Then two-epoch `Trainer.fit` trajectories on toy-ind, as
`test_torch_trainer.py` runs them (losses to 1e-5 relative, parameters to
1e-5 absolute, the validation scores exactly): BPR with `dynamic` (the
config of `tests/test_optim_extras.py:58`, on toy-ind's OOV regime), and
BPR and xDeepFM under adagrad, rmsprop and bf16 first moments.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.utils import create_dataset, data_preparation  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu.train import optimizers as jax_opt  # noqa: E402
from oovrec_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from oovrec_tpu.train.trainer import _is_oov_param_path as jax_is_oov  # noqa: E402
from oovrec_tpu.train.trainer import _select_opt_state  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data import Sampler, TrainBatcher  # noqa: E402
from oovrec_tpu_torch.data.prefetch import maybe_prefetch  # noqa: E402
from oovrec_tpu_torch.models import BPR  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.train.device_epoch import device_epoch_eligible  # noqa: E402
from oovrec_tpu_torch.train.optimizers import Optimizer  # noqa: E402
from oovrec_tpu_torch.train.trainer import _is_oov_param_path  # noqa: E402
from oovrec_tpu_torch.utils.enums import InputType  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict  # noqa: E402

from tests.test_context_models import _ranking_cfg  # noqa: E402
from tests.test_inductive import _ind_cfg  # noqa: E402
from tests.test_torch_train_parts import _port_split  # noqa: E402
from tests.test_torch_trainer import _bpr_cfg, _flat, _setup, _xdfm_cfg  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    """Both packages keep a module-global feature cache per mode."""
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


# --------------------------------------------------------------- optimizers

SHAPES = {"a.weight": (6, 4), "b.oov_buckets.weight": (5, 3), "c.bias": (7,)}
RULES = {
    "adagrad": dict(learner="adagrad"),
    "rmsprop": dict(learner="rmsprop"),
    "adam-bf16": dict(learner="adam", mu_dtype="bfloat16"),
    "torch-adam-bf16": dict(learner="adam", skip_zero_grads=True, mu_dtype="bfloat16"),
}


def jax_chain(learner, lr, wd=0.0, clip=None, skip_zero_grads=False, mu_dtype=None):
    """The JAX trainer's optimizer (`trainer.py:67-88`)."""
    if skip_zero_grads:
        txs = [optax.add_decayed_weights(wd)] if wd else []
        txs.append(jax_opt.scale_by_torch_adam(mu_dtype=mu_dtype and jnp.dtype(mu_dtype)))
        tx = optax.chain(*txs, optax.scale(-lr))
    else:
        tx = jax_opt.build_optimizer(learner, lr, wd, mu_dtype=mu_dtype)
    clip_tx = jax_opt.clip_by_norm(clip)
    return optax.chain(clip_tx, tx) if clip_tx is not None else tx


def _mu_leaves(state):
    """name → stored first moment of a JAX Adam state (any chain)."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(state):
        keys = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if "mu" in keys:
            out[keys[-1]] = np.asarray(v)
    return out


@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-2, {"max_norm": 6.0})],
                         ids=["plain", "decay-clip"])
@pytest.mark.parametrize("rule", list(RULES))
def test_rule_matches_optax_step_for_step(rule, wd, clip):
    kw = RULES[rule]
    lr = 1e-2
    rng = np.random.default_rng(16)
    params0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    tx = jax_chain(kw["learner"], lr, wd, clip, kw.get("skip_zero_grads", False),
                   kw.get("mu_dtype"))
    update = jax.jit(tx.update)
    jp = {n: jnp.asarray(v) for n, v in params0.items()}
    js = tx.init(jp)
    opt = Optimizer(kw["learner"], lr, wd, clip, kw.get("skip_zero_grads", False),
                    kw.get("mu_dtype"))
    tp = {n: torch.from_numpy(v.copy()) for n, v in params0.items()}
    ts = opt.init(tp)
    if "mu_dtype" in kw:
        assert all(t.dtype == torch.bfloat16 for t in ts["mu"].values())
    for step in range(8):
        scale = 0.2 + 2.5 * rng.random()
        g = {n: (rng.standard_normal(s) * scale).astype(np.float32) for n, s in SHAPES.items()}
        if step % 3 == 2:
            g["c.bias"][:] = 0.0  # an untouched leaf
        frozen = 3 <= step < 6
        mask = {n: (jax_is_oov([n]) if frozen else True) for n in SHAPES}
        updates, new = update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        updates = {n: u if mask[n] else jnp.zeros_like(u) for n, u in updates.items()}
        js = _select_opt_state(mask, js, new) if frozen else new
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, {n: torch.from_numpy(v) for n, v in g.items()}, ts,
                 trainable={n for n in SHAPES if _is_oov_param_path(n)} if frozen else None)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {n}")
        if "mu_dtype" in kw:
            want = _mu_leaves(js)
            assert set(want) == set(SHAPES)
            for n in SHAPES:
                assert want[n].dtype == jnp.bfloat16
                np.testing.assert_array_equal(
                    ts["mu"][n].view(torch.int16).numpy(), want[n].view(np.int16),
                    err_msg=f"step {step} {n}: bf16 first moment bits")


@pytest.mark.parametrize("learner", ["sparse_adam", "adamw", "sgd"])
def test_mu_dtype_reaches_only_adam(learner):
    """As in JAX: `sparse_adam`'s lazy Adam and an unknown learner's
    fallback Adam keep an f32 first moment under `mu_dtype`; a dtype that
    is not a float raises."""
    p = {"a.weight": torch.zeros(3, 2)}
    state = Optimizer(learner, mu_dtype="bfloat16").init(p)
    jstate = jax_opt.build_optimizer(learner, 1e-3, mu_dtype="bfloat16").init(
        {"a.weight": jnp.zeros((3, 2))})
    assert {str(v.dtype) for v in _mu_leaves(jstate).values()} <= {"float32"}
    assert all(t.dtype == torch.float32 for t in state.get("mu", {}).values())
    assert Optimizer("adam", mu_dtype="float32").init(p)["mu"]["a.weight"].dtype == torch.float32
    with pytest.raises(ValueError, match="int8"):
        Optimizer("adam", mu_dtype="int8")


# ------------------------------------------------------ dynamic negatives

CAND = 6
DYNAMIC = {"distribution": "uniform", "sample_num": 2, "dynamic": True, "candidate_num": CAND}
MODES = {"pairwise": (lambda: _ind_cfg(train_batch_size=8, train_neg_sample_args=DYNAMIC),
                      InputType.PAIRWISE),
         "pointwise": (lambda: _ranking_cfg("xDeepFM", train_batch_size=12,
                                            train_neg_sample_args=DYNAMIC),
                       InputType.POINTWISE)}


def _scored_batchers(item_weight=None, mode="pairwise"):
    """toy-ind's training split in both packages with one sampler seed, and
    BPR models of the same D = 1 weights (user u → 1 + u / 10, item i →
    `item_weight[i]`, by default distinct and 0.01 apart): the port's
    batcher scored by `Trainer._score_candidates`, the JAX one by the
    jitted `predict` the JAX trainer binds (`trainer.py:600-621`)."""
    make, input_type = MODES[mode]
    jcfg = JaxConfig(config_dict=dict(make(), log_tensorboard=False))
    ds = create_dataset(jcfg)
    jl = data_preparation(jcfg, ds)[0]
    split = _port_split(ds.build()[0])
    n_users, n_items = split.user_num, split.item_num
    if item_weight is None:
        item_weight = np.random.default_rng(4).permutation(n_items).astype(np.float32) * 0.01
    user_w = (1 + np.arange(n_users) / 10).astype(np.float32)
    pl = TrainBatcher(split, Sampler(["train"], [split], seed=int(jcfg["seed"])),
                      Config(jcfg.as_dict()), input_type)
    model = BPR(n_users, n_items, 1, device="cpu")
    with torch.no_grad():
        model.user_embedding.weight.copy_(torch.from_numpy(user_w[:, None]))
        model.item_embedding.weight.copy_(torch.from_numpy(item_weight[:, None]))
    pl.set_model_scorer(functools.partial(Trainer._score_candidates, SimpleNamespace(model=model)))
    jm = jax_model_class("BPR")(n_users=n_users, n_items=n_items, embedding_size=1)
    jparams = {"user_embedding": {"embedding": jnp.asarray(user_w[:, None])},
               "item_embedding": {"embedding": jnp.asarray(item_weight[:, None])}}
    score = jax.jit(lambda p, u, i: jm.apply({"params": p}, {"user_id": u, "item_id": i}, {},
                                            method=jm.predict))
    jl.set_model_scorer(lambda u, i: score(jparams, jnp.asarray(u.astype(np.int32)),
                                           jnp.asarray(i.astype(np.int32))))
    assert pl.mode == jl.mode == mode and pl.dynamic and pl.candidate_num == CAND
    return pl, jl, user_w, item_weight, int(jcfg["seed"])


@pytest.mark.parametrize("mode", list(MODES))
def test_dynamic_picks_equal_jax(mode):
    pl, jl, uw, iw, seed = _scored_batchers(mode=mode)
    users = np.random.default_rng(6).integers(1, len(uw), 16)
    got, want = pl._sample_negs(users), jl._sample_negs(users)
    np.testing.assert_array_equal(got, want)
    # the argmax of a plain scorer over the same candidates; in every slot
    # the top score is more than 1e-4 above any other item's (a candidate
    # drawn twice ties with itself)
    cand = Sampler(["train"], [pl.split], seed=seed).sample_negatives(
        "train", users, 2 * CAND).reshape(16, 2, CAND)
    scores = uw[users][:, None, None] * iw[cand]
    plain = np.take_along_axis(cand, scores.argmax(2)[..., None], 2)[..., 0]
    np.testing.assert_array_equal(got, plain)
    others = np.where(cand == plain[..., None], -np.inf, scores)
    assert (scores.max(2) - others.max(2)).min() > 1e-4
    # whole epochs of batches, key for key
    n = 0
    for pb, jb in zip(pl, jl):
        assert list(pb) == list(jb)
        for k in pb:
            np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]), err_msg=k)
        n += 1
    assert n == len(jl) > 1


def test_dynamic_ties_go_to_the_first_candidate():
    pl, jl, uw, iw, seed = _scored_batchers(np.zeros(toy_items(), np.float32))
    users = np.arange(1, len(uw))
    first = Sampler(["train"], [pl.split], seed=seed).sample_negatives(
        "train", users, 2 * CAND).reshape(len(users), 2, CAND)[:, :, 0]
    np.testing.assert_array_equal(pl._sample_negs(users), first)
    np.testing.assert_array_equal(jl._sample_negs(users), first)


def toy_items():
    return _scored_batchers()[0].split.item_num


def test_dynamic_loader_stays_on_the_host_one_batch_at_a_time():
    """Not prefetched at any `worker`, K = 1, no device epoch (even when
    asked for); without a scorer the draw is the plain one."""
    pl, _, _, _, seed = _scored_batchers()
    cfg = Config(dict(pl.config.as_dict(), worker=3, device_epoch=True, host_scan_steps=8))
    assert maybe_prefetch(pl, cfg) is pl
    model = BPR(pl.split.user_num, pl.split.item_num, 4, device="cpu")
    trainer = Trainer(cfg, model)
    assert trainer._host_scan_k(pl) == 1
    assert not device_epoch_eligible(trainer, pl, cfg)
    assert trainer._maybe_device_epoch(pl) is None
    plain = TrainBatcher(pl.split, Sampler(["train"], [pl.split], seed=seed), pl.config,
                         InputType.PAIRWISE)
    users = np.arange(1, 7)
    np.testing.assert_array_equal(
        plain._sample_negs(users),
        Sampler(["train"], [pl.split], seed=seed).sample_negatives("train", users, 2))


# ------------------------------------------------------------- Trainer.fit


def fit_both(s, **port_over):
    """Two epochs of the JAX `Trainer.fit` and the port's from the same
    weights; epoch losses to 1e-5 relative, the final parameters to 1e-5
    absolute, the best validation score exactly. → (port trainer, JAX
    trainer)."""
    jcfg, jm, variables, estate, jtrain, jvalid, _ = s["jax"]
    jt = JaxTrainer(jcfg, jm, variables, dict(estate))
    jbest = jt.fit(jtrain, jvalid, saved=False)
    cfg, model, train, valid, _ = s["port"]
    pt = Trainer(cfg, model)
    best = pt.fit(train, valid, saved=False)
    assert list(pt.train_loss_dict) == list(jt.train_loss_dict)
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
    return pt, jt


FITS = {
    "bpr-dynamic": (_bpr_cfg, dict(train_neg_sample_args={
        "distribution": "uniform", "sample_num": 1, "dynamic": True, "candidate_num": 4})),
    "bpr-adagrad-frozen": (_bpr_cfg, dict(learner="adagrad", learning_rate=0.05,
                                          oov_freeze_embedding=True)),
    "bpr-rmsprop-decay-clip": (_bpr_cfg, dict(learner="rmsprop", weight_decay=1e-3,
                                              clip_grad_norm={"max_norm": 0.5})),
    "bpr-adam-bf16-frozen": (_bpr_cfg, dict(optimizer_mu_dtype="bfloat16",
                                            oov_freeze_embedding=True)),
    "bpr-torch-adam-bf16": (_bpr_cfg, dict(optimizer_mu_dtype="bfloat16",
                                           optimizer_skip_zero_grads=True)),
    "xdeepfm-adagrad": (_xdfm_cfg, dict(learner="adagrad", learning_rate=0.02,
                                        oov_freeze_embedding=True)),
    "xdeepfm-rmsprop": (_xdfm_cfg, dict(learner="rmsprop", oov_only_epoch=False)),
    "xdeepfm-adam-bf16": (_xdfm_cfg, dict(optimizer_mu_dtype="bfloat16",
                                          oov_freeze_embedding=True)),
}


@pytest.mark.parametrize("case", list(FITS))
def test_fit_trajectory_matches_jax(case, tmp_path):
    make, over = FITS[case]
    pt, jt = fit_both(_setup(make(tmp_path, **over)))
    assert pt.oov_loss_dict or "mixed" in case or not pt.config["oov_only_epoch"]
    if "bf16" in case:
        assert all(t.dtype == torch.bfloat16 for t in pt.opt_state["mu"].values())
    if "dynamic" in case:
        assert pt.step_graphs.replays == 0  # the CPU steps eagerly

"""The parts of the port's training slice against the JAX package.

Losses with padding weights; xDeepFM and BPR `calculate_loss` and their
gradients against `jax.value_and_grad` of the flax models (dropout 0, OOV
rows mixed in); the OOV simulator and the train batcher in all three modes,
key for key and bit for bit on the toy-ind fixture; the port's Adam (both
modes, with decay and clipping, frozen steps), its `sparse_adam` lazy rule
and SGD against optax step for step; the frozen-parameter set; dropout's
generator; the training config defaults; early stopping. Inputs come from
numpy with a seed.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.utils import create_dataset, data_preparation  # noqa: E402
from oovrec_tpu.inductive.spec import InductiveSpec as JaxSpec  # noqa: E402
from oovrec_tpu.inductive.transform import OOVSimulator as JaxOOVSimulator  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu.models import losses as jax_losses  # noqa: E402
from oovrec_tpu.models.context import FieldSpec as JaxFieldSpec  # noqa: E402
from oovrec_tpu.train import optimizers as jax_opt  # noqa: E402
from oovrec_tpu.train.early_stopping import early_stopping as jax_early_stopping  # noqa: E402
from oovrec_tpu.train.trainer import _is_oov_param_path as jax_is_oov  # noqa: E402
from oovrec_tpu.train.trainer import _select_opt_state  # noqa: E402
from oovrec_tpu.utils.seeding import host_rng as jax_host_rng  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.config.configurator import DEFAULTS  # noqa: E402
from oovrec_tpu_torch.data import DatasetSplit, Sampler, TrainBatcher  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, OOVSimulator  # noqa: E402
from oovrec_tpu_torch.models import BPR, FieldSpec, xDeepFM  # noqa: E402
from oovrec_tpu_torch.models.layers import MLPLayers, set_dropout_generator  # noqa: E402
from oovrec_tpu_torch.models.losses import bce_with_logits, bpr_loss  # noqa: E402
from oovrec_tpu_torch.train.early_stopping import early_stopping  # noqa: E402
from oovrec_tpu_torch.train.optimizers import Optimizer  # noqa: E402
from oovrec_tpu_torch.train.trainer import _is_oov_param_path  # noqa: E402
from oovrec_tpu_torch.utils.enums import InputType  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    flax_from_state_dict,
    load_flax_params,
    state_dict_from_flax,
)
from oovrec_tpu_torch.utils.seeding import host_rng, torch_generator  # noqa: E402

from tests.test_context_models import _ranking_cfg  # noqa: E402
from tests.test_inductive import _ind_cfg  # noqa: E402
from tests.test_torch_xdeepfm import (  # noqa: E402
    FIELDS,
    SPEC,
    _batch,
    _jax_batch,
    _torch_batch,
)

MODEL = dict(embedding_size=8, cin_layer_size=(10, 10), mlp_hidden_size=(16, 8),
             dropout_prob=0.0, reg_weight=5e-4)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------------ losses


def test_losses_match_jax_and_ignore_padding():
    rng = np.random.default_rng(0)
    n, n_real = 24, 17
    pos, neg, logits = (rng.standard_normal(n).astype(np.float32) * 3 for _ in range(3))
    labels = (rng.random(n) < 0.5).astype(np.float32)
    weight = np.zeros(n, np.float32)
    weight[:n_real] = 1.0
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    for w in (None, weight):
        jw = None if w is None else jnp.asarray(w)
        tw = None if w is None else t(w)
        np.testing.assert_allclose(
            float(bpr_loss(t(pos), t(neg), tw)),
            float(jax_losses.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), jw)), rtol=1e-6)
        np.testing.assert_allclose(
            float(bce_with_logits(t(logits), t(labels), tw)),
            float(jax_losses.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels), jw)),
            rtol=1e-6)
    # padded rows do not count: the padded batch gives the real rows' mean
    r = slice(0, n_real)
    np.testing.assert_allclose(float(bpr_loss(t(pos), t(neg), t(weight))),
                               float(bpr_loss(t(pos[r]), t(neg[r]))), rtol=1e-6)
    np.testing.assert_allclose(float(bce_with_logits(t(logits), t(labels), t(weight))),
                               float(bce_with_logits(t(logits[r]), t(labels[r]))), rtol=1e-6)
    assert float(bpr_loss(t(pos), t(neg), t(np.zeros(n, np.float32)))) == 0.0


# ------------------------------------------------------- model losses / grads


def _weighted_batch():
    batch = _batch()
    w = np.ones(len(batch["label"]), np.float32)
    w[-3:] = 0.0  # padded rows
    batch["weight"] = w
    return batch


def _port_grads(model):
    return flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, model)


def _assert_grads(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["slab", "kernel"])
@pytest.mark.parametrize("direct", [False, True], ids=["split", "direct"])
def test_xdeepfm_loss_and_grads_match_flax(direct, fused):
    batch = _weighted_batch()
    jm = jax_model_class("xDeepFM")(fields=JaxFieldSpec(**FIELDS), spec=JaxSpec(**SPEC),
                                    direct=direct, fused_cin=False, **MODEL)
    variables = jm.init(jax.random.key(3), _jax_batch(batch), {}, method=jm.predict)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                      if p[-1].key == "bias" else 0), variables["params"])

    def loss_fn(p):
        return jm.apply({"params": p}, _jax_batch(batch), {}, method=jm.calculate_loss)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model = xDeepFM(FieldSpec(**FIELDS), spec=InductiveSpec(**SPEC), direct=direct,
                    fused_cin=fused, device="cpu", **MODEL)
    load_flax_params(model, params)
    loss = model.calculate_loss(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    _assert_grads(_port_grads(model), want_grads)
    # the reg term alone, leaf for leaf the JAX package's set
    want_reg = jm.apply({"params": params}, method=lambda m: m._reg_from_scope())
    np.testing.assert_allclose(float(model._reg_from_scope().detach()), float(want_reg),
                               rtol=1e-6)


def test_bpr_loss_and_grads_match_flax():
    n_users, n_items = 30, 25
    spec = dict(mapper="random", add_oov_buckets=True, n_user_buckets=7, n_item_buckets=5)
    rng = np.random.default_rng(5)
    B = 16
    users = rng.integers(1, n_users, B)
    users[::3] = rng.integers(n_users, n_users + 20, len(users[::3]))
    batch = {
        "user_id": users, "item_id": rng.integers(1, n_items, B),
        "neg_item_id": rng.integers(1, n_items + 10, B),
        "user_id_oov": (users >= n_users).astype(np.int64),
        "user_id_bucket": rng.integers(0, 7, B),
        "item_id_oov": (rng.random(B) < 0.3).astype(np.int64),
        "item_id_bucket": rng.integers(0, 5, B),
        "weight": (np.arange(B) < B - 2).astype(np.float32),
    }
    jm = jax_model_class("BPR")(n_users=n_users, n_items=n_items, embedding_size=8,
                                spec=JaxSpec(**spec))
    params = jm.init(jax.random.key(1), _jax_batch(batch), {}, method=jm.calculate_loss)["params"]
    want_loss, want_grads = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, _jax_batch(batch), {}, method=jm.calculate_loss))(params)
    model = BPR(n_users, n_items, 8, InductiveSpec(**spec), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    loss = model.calculate_loss(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    _assert_grads(_port_grads(model), want_grads)


# ------------------------------------------------ batches and the simulator


def _plain_cfg():
    return _ranking_cfg("xDeepFM", train_neg_sample_args={"distribution": "none"},
                        log_tensorboard=False)


CONFIGS = {
    "pairwise": (lambda: _ind_cfg(train_batch_size=4, log_tensorboard=False),
                 InputType.PAIRWISE),
    "pointwise": (lambda: _ranking_cfg("xDeepFM", train_batch_size=8, log_tensorboard=False),
                  InputType.POINTWISE),
    "plain": (_plain_cfg, InputType.POINTWISE),
}


def _port_split(split):
    parent = split.parent
    return DatasetSplit(
        dict(split.inter), split.user_num, split.item_num, split.uid_field,
        split.iid_field, split.label_field,
        user_feat=parent.get_user_feature() if parent.user_feat is not None else None,
        item_feat=parent.get_item_feature() if parent.item_feat is not None else None,
    )


def _loaders(mode):
    make, input_type = CONFIGS[mode]
    jcfg = JaxConfig(config_dict=make())
    ds = create_dataset(jcfg)
    jax_loader = data_preparation(jcfg, ds)[0]
    splits = [_port_split(s) for s in ds.build()[:3]]
    nsa = jcfg["train_neg_sample_args"] or {}
    sampler = Sampler(["train", "valid", "test"], splits,
                      distribution=nsa.get("distribution", "uniform")
                      if nsa.get("distribution", "none") != "none" else "uniform",
                      seed=int(jcfg["seed"]))
    port_loader = TrainBatcher(splits[0], sampler, Config(jcfg.as_dict()), input_type)
    return jcfg, jax_loader, port_loader


def _same_batch(got, want):
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("mode", list(CONFIGS))
def test_train_batches_and_simulator_match_jax(mode):
    """Two epochs of batches key for key, then the OOV simulator on each
    batch from the same `oov_regime` stream, bit for bit."""
    jcfg, jl, pl = _loaders(mode)
    assert pl.mode == jl.mode == mode
    assert len(pl) == len(jl) > 1
    seed = int(jcfg["seed"])
    spec_kw = dict(mapper="random", add_oov_buckets=True, n_user_buckets=8, n_item_buckets=8)
    jsim = JaxOOVSimulator(JaxSpec(**spec_kw), jl.split.user_num, jl.split.item_num, 0.2,
                           jax_host_rng(seed, "oov_regime"))
    psim = OOVSimulator(InductiveSpec(**spec_kw), pl.split.user_num, pl.split.item_num, 0.2,
                        host_rng(seed, "oov_regime"))
    n = 0
    for _ in range(2):
        for pb, jb in zip(pl, jl):
            _same_batch(pb, jb)
            _same_batch(psim(pb), jsim(jb))
            n += 1
    assert n == 2 * len(jl)
    assert pb["weight"].min() == 0 or mode == "pointwise"  # the last batch is padded


def test_train_batcher_refuses_what_is_not_ported():
    _, _, pl = _loaders("plain")
    cfg = Config(dict(pl.config.as_dict(), transform="mask_itemseq"))
    with pytest.raises(NotImplementedError, match="transform"):
        TrainBatcher(pl.split, None, cfg, InputType.POINTWISE)
    cfg = Config(dict(pl.config.as_dict(), train_neg_sample_args={
        "distribution": "uniform", "sample_num": 1, "dynamic": True, "candidate_num": 4}))
    with pytest.raises(NotImplementedError, match="dynamic"):
        TrainBatcher(pl.split, None, cfg, InputType.PAIRWISE)


# --------------------------------------------------------------- optimizer

SHAPES = {"a.weight": (6, 4), "b.oov_buckets.weight": (5, 3), "c.bias": (7,)}


def _optax_chain(rule, lr, wd, clip):
    if rule == "torch_adam":
        txs = [optax.add_decayed_weights(wd)] if wd else []
        tx = optax.chain(*txs, jax_opt.scale_by_torch_adam(), optax.scale(-lr))
    else:
        tx = jax_opt.build_optimizer(rule, lr, wd)
    clip_tx = jax_opt.clip_by_norm(clip)
    return optax.chain(clip_tx, tx) if clip_tx is not None else tx


@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-2, {"max_norm": 6.0})],
                         ids=["plain", "decay-clip"])
@pytest.mark.parametrize("rule", ["adam", "torch_adam", "sgd", "sparse_adam"])
def test_optimizer_matches_optax_step_for_step(rule, wd, clip):
    """12 steps with gradients of varying norm (some above the clip, some
    below), all-zero gradients on some leaves and a frozen stretch (only
    the OOV leaf trains, the JAX trainer's masked update and
    `_select_opt_state`): parameters to 1e-6 after every step."""
    lr = 1e-2
    rng = np.random.default_rng(6)
    params0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    tx = _optax_chain(rule, lr, wd, clip)
    jp = {n: jnp.asarray(v) for n, v in params0.items()}
    js = tx.init(jp)
    opt = Optimizer({"torch_adam": "adam"}.get(rule, rule), lr, wd, clip,
                    skip_zero_grads=rule == "torch_adam")
    tp = {n: torch.from_numpy(v.copy()) for n, v in params0.items()}
    ts = opt.init(tp)
    for step in range(12):
        scale = 0.2 + 2.5 * rng.random()
        g = {n: (rng.standard_normal(s) * scale).astype(np.float32) for n, s in SHAPES.items()}
        if step % 4 == 3:
            g["c.bias"][:] = 0.0  # an untouched leaf
        frozen = 5 <= step < 9
        mask = {n: (jax_is_oov([n]) if frozen else True) for n in SHAPES}
        updates, new = tx.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        updates = {n: u if mask[n] else jnp.zeros_like(u) for n, u in updates.items()}
        js = _select_opt_state(mask, js, new) if frozen else new
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, {n: torch.from_numpy(v) for n, v in g.items()}, ts,
                 trainable={n for n in SHAPES if _is_oov_param_path(n)} if frozen else None)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {n}")


def test_optimizer_refuses_what_is_not_ported():
    for learner in ("adagrad", "rmsprop"):
        with pytest.raises(NotImplementedError, match=learner):
            Optimizer(learner)
    with pytest.raises(NotImplementedError, match="mu_dtype"):
        Optimizer("adam", mu_dtype="bfloat16")


def test_frozen_parameter_set_matches_jax():
    """The port's freeze filter, through the weight bridge, selects exactly
    the JAX package's frozen-step trainable leaves."""
    batch = _batch()
    jm = jax_model_class("xDeepFM")(fields=JaxFieldSpec(**FIELDS), spec=JaxSpec(**SPEC),
                                    fused_cin=False, **MODEL)
    params = jm.init(jax.random.key(3), _jax_batch(batch), {}, method=jm.predict)["params"]
    want = {jax.tree_util.keystr(p) for p, v in jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map_with_path(lambda path, _: jax_is_oov(path), params)) if v}
    model = xDeepFM(FieldSpec(**FIELDS), spec=InductiveSpec(**SPEC), device="cpu", **MODEL)
    port = {n: p for n, p in model.named_parameters() if _is_oov_param_path(n)}
    got = set(_flat(flax_from_state_dict(port, model)))
    assert got == want == {
        "['fields']['user_oov_buckets']['embedding']",
        "['fields']['item_oov_buckets']['embedding']",
        "['first_order_linear']['fo']['user_oov_buckets']['embedding']",
        "['first_order_linear']['fo']['item_oov_buckets']['embedding']",
    }
    bpr = BPR(30, 25, 8, InductiveSpec(**SPEC), device="cpu")
    assert {n for n, _ in bpr.named_parameters() if _is_oov_param_path(n)} == {
        "user_oov_buckets.weight", "item_oov_buckets.weight"}


# ------------------------------------------------ dropout, config, stopping


def test_dropout_draws_from_the_given_generator():
    mlp = MLPLayers((12, 16, 4), dropout=0.5, device="cpu")
    x = torch.randn(64, 12, generator=torch_generator(0))
    mlp.train()
    with pytest.raises(RuntimeError, match="generator"):
        mlp(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(mlp, torch_generator(11))
        outs.append(mlp(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], mlp(x))  # the stream moves on
    mlp.eval()
    assert torch.equal(mlp(x), mlp(x, train=False))
    assert not torch.equal(mlp(x), outs[0])
    h = torch.ones(20000, 12)
    set_dropout_generator(mlp, torch_generator(12))
    kept = mlp._drop(h)
    assert abs(float((kept > 0).float().mean()) - 0.5) < 0.02
    assert set(torch.unique(kept).tolist()) == {0.0, 2.0}


def test_training_defaults_match_the_jax_package():
    import oovrec_tpu

    path = oovrec_tpu.__path__[0] + "/config/defaults.yaml"
    with open(path) as f:
        want = yaml.safe_load(f)
    keys = [k for k in DEFAULTS if k in want]
    assert len(keys) >= 40
    for k in keys:
        assert DEFAULTS[k] == want[k], k
    assert Config()["train_neg_sample_args"] == want["train_neg_sample_args"]


def test_early_stopping_is_the_jax_rule():
    values = [0.3, 0.5, 0.5, 0.4, 0.6, 0.2, 0.2, 0.2]
    for bigger in (True, False):
        a = b = (None, 0)
        for v in values:
            ra = early_stopping(v, a[0], a[1], 2, bigger)
            rb = jax_early_stopping(v, b[0], b[1], 2, bigger)
            assert ra == rb
            a, b = ra[:2], rb[:2]

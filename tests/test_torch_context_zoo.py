"""The port's context zoo against flax: LR, FM, DeepFM, FFM, DCN, AutoInt,
FNN, PNN (inner, and with `use_outer`), AFM, FwFM, DSSM, FiGNN, EulerNet,
NFM and KD_DAGFM (each phase, inner and outer interaction).

On the small FieldSpec of `test_torch_context_models.py` (three token
fields, one float field, a token_seq and a float_seq field, embedding_size
8, dropout 0, IV and OOV users and items routed by the random mapper's
buckets or by lsh), the JAX model's params (biases perturbed) and, for DCN
and NFM, its `batch_stats` (random running statistics) cross into the port
through `utils/jax_params.py`. The widths are the small overrides of
`tests/test_model_zoo.py:73-88` (cross_layer_num 2, attention_size 8,
reg_weight 0.01, MLPs of 16 and 8, KD_DAGFM at depth 2), with two layers
for AutoInt and FiGNN (so the per-layer residual and the GRU cell shared
across layers are held) and two orders for EulerNet. Checked, each against
the JAX package:
  * `predict` in eval mode to 1e-5;
  * `calculate_loss` in train mode and its gradient over every parameter
    to 1e-5, on a batch whose last rows are padding (weight 0), and DCN's
    and NFM's new `batch_stats` after that step to 1e-6;
  * DCN, AutoInt, FNN, PNN and DSSM under the bf16 policy to 3e-2;
  * the bridge both ways: LR's tree has no field embedding, FFM's
    `field_proj` (F, F, D, D) and the raw leaves of the zoo (DCN's
    `cross_w` / `cross_b`, PNN's `outer_kernel`, AFM's `attn_h` / `attn_p`,
    FwFM's `pair_weight`, EulerNet's `order_w` / `mu`, KD_DAGFM's
    `student` tree) stay as they are, the `batch_stats` of DCN and NFM
    (whose BatchNorms are `bn` / `mlp_bn_<i>`, found by module type) to
    1e-6; `fm_second_order` to 1e-6;
then on toy-ind two-epoch `Trainer.fit` trajectories of each model on the
host path against the JAX trainer (losses 1e-5 relative, parameters 1e-5
absolute, the validation scores exactly; DCN's and NFM's statistics to
1e-5; KD_DAGFM's teacher unchanged in distillation), and LR, FM and DeepFM
through `Trainer.fit` on the pointwise and plain device epochs (the others,
which do not declare `supports_device_epoch`, keep the host path and are
never eligible for it).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.inductive.spec import InductiveSpec as JaxSpec  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu.models.context import FieldSpec as JaxFieldSpec  # noqa: E402
from oovrec_tpu.models.context_aware.basic import fm_second_order as jax_fm  # noqa: E402
from oovrec_tpu.models.context_aware.more3 import _fm_no_reduce as jax_fm_no_reduce  # noqa: E402
from oovrec_tpu.utils import precision as jax_precision  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.models import FieldSpec, get_model_class  # noqa: E402
from oovrec_tpu_torch.models.context_aware.basic import fm_second_order  # noqa: E402
from oovrec_tpu_torch.models.context_aware.more3 import fm_no_reduce  # noqa: E402
from oovrec_tpu_torch.train.device_epoch import device_epoch_eligible  # noqa: E402
from oovrec_tpu_torch.utils import precision  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    batch_stats_from_module,
    flax_from_state_dict,
    load_batch_stats,
    load_flax_params,
)

from tests.test_torch_context_models import (  # noqa: E402
    B,
    FIELDS,
    N_PAD,
    SPECS,
    _batch,
    _estate,
    _flat,
    _jax_batch,
    _torch_batch,
)
from tests.test_torch_device_epoch_modes import _ranking  # noqa: E402
from tests.test_torch_trainer import _setup, _xdfm_cfg  # noqa: E402
from tests.test_torch_trainer_extras import fit_both  # noqa: E402

MLP = dict(mlp_hidden_size=(16, 8))
KD = dict(depth=2)
MODELS = {  # case → the model's keyword arguments; the model is the case up to its first "-"
    "LR": {}, "FM": {}, "DeepFM": dict(MLP, dropout_prob=0.0), "FFM": {},
    "DCN": dict(MLP, cross_layer_num=2, reg_weight=0.01, dropout_prob=0.0),
    "AutoInt": dict(MLP, attention_size=8, n_layers=2, dropout_probs=(0.0, 0.0, 0.0)),
    "FNN": dict(MLP, dropout_prob=0.0),
    "PNN": dict(MLP, dropout_prob=0.0, reg_weight=0.01),
    "PNN-outer": dict(MLP, dropout_prob=0.0, use_outer=True),
    "AFM": dict(attention_size=8, dropout_prob=0.0, reg_weight=0.01),
    "FwFM": dict(dropout_prob=0.0),
    "DSSM": dict(MLP, dropout_prob=0.0),
    "FiGNN": dict(attention_size=8, n_layers=2),
    "EulerNet": dict(order_list=(7, 3), drop_ex=0.0, drop_im=0.0),
    "NFM": dict(MLP, dropout_prob=0.0),
    "KD_DAGFM": dict(KD, phase="distillation"),
    "KD_DAGFM-teacher": dict(KD, phase="teacher_training"),
    "KD_DAGFM-finetuning": dict(KD, phase="finetuning"),
    "KD_DAGFM-outer": dict(KD, phase="distillation", interaction_type="outer"),
    "KD_DAGFM-outer-teacher": dict(KD, phase="teacher_training", interaction_type="outer"),
    "KD_DAGFM-outer-finetuning": dict(KD, phase="finetuning", interaction_type="outer"),
}
ZOO4 = ("LR", "FM", "DeepFM", "FFM")  # the first four ported; all but FFM declare the device epoch
NEW = ("DCN", "AutoInt", "FNN", "PNN", "AFM", "FwFM", "DSSM", "FiGNN", "EulerNet", "NFM",
       "KD_DAGFM")
WITH_STATS = ("DCN", "NFM")
BF16 = ("DCN", "AutoInt", "FNN", "PNN", "DSSM")
# the models whose JAX forward calls `first_order_linear` (a flax `setup`
# submodule's params exist only once it is called)
FIRST_ORDER = {"LR", "FM", "DeepFM", "FFM", "AutoInt", "AFM", "FwFM", "NFM"}


def _name(case):
    return case.split("-")[0]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


def _flax(case, embedder):
    return jax_model_class(_name(case))(fields=JaxFieldSpec(**FIELDS),
                                        spec=JaxSpec(**SPECS[embedder]), embedding_size=8,
                                        **MODELS[case])


def _variables(case, embedder):
    """The JAX init with biases perturbed, and random running statistics
    where the model has BatchNorms."""
    m = _flax(case, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    variables = m.init(jax.random.key(7), _jax_batch(_batch(embedder)), estate,
                       method=m.calculate_loss)
    rng = np.random.default_rng(8)
    out = {"params": jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                      if p[-1].key == "bias" else 0), variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, v: (rng.standard_normal(v.shape).astype(np.float32) * 0.2
                          if p[-1].key == "mean"
                          else rng.uniform(0.5, 1.5, v.shape).astype(np.float32)),
            variables["batch_stats"])
    return out


def _port(case, variables, embedder):
    model = get_model_class(_name(case))(
        FieldSpec(**FIELDS), spec=InductiveSpec(**SPECS[embedder]), device="cpu",
        embedder_state=_estate(embedder) or None, embedding_size=8, **MODELS[case])
    load_flax_params(model, variables["params"])
    if "batch_stats" in variables:
        load_batch_stats(model, variables["batch_stats"])
    return model


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("name", list(MODELS))
def test_predict_matches_flax(name, embedder):
    variables = _variables(name, embedder)
    batch = _batch(embedder)
    jm = _flax(name, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    want = np.asarray(jm.apply(variables, _jax_batch(batch), estate, method=jm.predict))
    model = _port(name, variables, embedder)
    model.train()  # predict runs in eval mode whatever the module's mode
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model.predict(_torch_batch(batch)).numpy()
    assert got.shape == want.shape == (B,)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_gradients_match_flax(name, embedder):
    variables = _variables(name, embedder)
    batch = _batch(embedder, seed=5, n_pad=N_PAD)
    jm = _flax(name, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        return jm.apply({"params": p, **extra}, _jax_batch(batch), estate,
                        method=jm.calculate_loss, mutable=["batch_stats"])

    (jloss, new_vars), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    model = _port(name, variables, embedder)
    model.eval()  # calculate_loss runs in train mode whatever the module's mode
    named = list(model.named_parameters())
    loss = model.calculate_loss(_torch_batch(batch))
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-6)
    got = _flat(flax_from_state_dict(
        {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)}, model))
    want = _flat(jgrads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    if _name(name) in WITH_STATS:
        got_stats, want_stats = _flat(batch_stats_from_module(model)), _flat(
            new_vars["batch_stats"])
        assert set(got_stats) == set(want_stats) and len(want_stats) >= 4
        for k in want_stats:
            np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=0, atol=1e-6,
                                       err_msg=k)
            assert not np.allclose(want_stats[k], _flat(variables["batch_stats"])[k])
    else:
        assert "batch_stats" not in new_vars and not batch_stats_from_module(model)
    if name.startswith("KD_DAGFM"):  # the net outside the phase's loss gets no gradient
        idle = {"teacher_training": "student"}.get(MODELS[name]["phase"], "teacher")
        assert all(not want[k].any() for k in want if f"['{idle}']" in k)


@pytest.mark.parametrize("name", BF16)
def test_bf16_policy_close_to_flax(name):
    """Under `compute_dtype: bfloat16` only `MLPLayers` changes dtype, in
    both packages."""
    variables = _variables(name, "random")
    batch = _batch()
    jm = _flax(name, "random")
    model = _port(name, variables, "random")
    with torch.no_grad():
        p32 = model.predict(_torch_batch(batch)).numpy()
    jax_precision.set_policy("bfloat16")
    precision.set_policy("bfloat16")
    try:
        want = np.asarray(jm.apply(variables, _jax_batch(batch), {}, method=jm.predict))
        with torch.no_grad():
            got = model.predict(_torch_batch(batch)).numpy()
    finally:
        jax_precision.set_policy("float32")
        precision.set_policy("float32")
    np.testing.assert_allclose(got, want, atol=3e-2)
    np.testing.assert_allclose(got, p32, atol=3e-2)
    assert not np.allclose(got, p32, atol=1e-9)


RAW_LEAVES = {"FFM": ("field_proj",), "DCN": ("cross_w", "cross_b"), "PNN-outer": ("outer_kernel",),
              "AFM": ("attn_h", "attn_p"), "FwFM": ("pair_weight",), "EulerNet": ("order_w", "mu")}


@pytest.mark.parametrize("name", list(MODELS))
def test_weight_bridge_round_trip(name):
    variables = _variables(name, "random")
    params = variables["params"]
    model = _port(name, variables, "random")
    sd = model.state_dict()
    back = _flat(flax_from_state_dict(sd, model))
    assert back.keys() == _flat(params).keys()
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert ("field_embedding.token_embedding_table.weight" in sd) == (name != "LR")
    assert ("first_order_linear.bias" in sd) == (_name(name) in FIRST_ORDER)
    for leaf in RAW_LEAVES.get(name, ()):
        np.testing.assert_array_equal(sd[leaf].numpy(), params[leaf], err_msg=leaf)
    if name == "FFM":
        f = FieldSpec(**FIELDS).num_feature_field
        assert sd["field_proj"].shape == (f, f, 8, 8) and "pair_i" not in sd
    if name.startswith("KD_DAGFM"):
        for leaf in ("connect_layer", "p_0", "p_1") + (("q_0", "q_1") if "outer" in name else ()):
            np.testing.assert_array_equal(sd[f"student.{leaf}"].numpy(),
                                          params["student"][leaf], err_msg=leaf)
        assert sd["teacher.cross_1.weight"].shape == (6 * 8, 6 * 8)
    if name in ("AutoInt", "FiGNN"):
        attn = "attn_0" if name == "AutoInt" else "self_attn"
        assert sd[f"{attn}.query.kernel"].shape == (8, 2, 4)
        assert sd[f"{attn}.out.kernel"].shape == (2, 4, 8)
    stats = batch_stats_from_module(model)
    if _name(name) in WITH_STATS:
        want = _flat(variables["batch_stats"])
        assert _flat(stats).keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(_flat(stats)[k], v, rtol=0, atol=1e-6, err_msg=k)
    else:
        assert not stats
    flag = getattr(get_model_class(_name(name)), "supports_device_epoch", False)
    assert flag == getattr(jax_model_class(_name(name)), "supports_device_epoch", False) == (
        name in ZOO4 and name != "FFM")


def test_nfm_batch_stats_cross_by_module_type():
    """NFM's BatchNorms are `bn` and `mlp_bn_<i>`, not `BatchNorm_<j>`: the
    bridge finds their statistics by the module's type. Params without the
    statistics load; the statistics cross both ways to 1e-6 and stay out
    of the param tree."""
    variables = _variables("NFM", "random")
    model = get_model_class("NFM")(FieldSpec(**FIELDS), spec=InductiveSpec(**SPECS["random"]),
                                   device="cpu", embedding_size=8, **MODELS["NFM"])
    load_flax_params(model, variables["params"])
    load_batch_stats(model, variables["batch_stats"])
    assert set(variables["batch_stats"]) == {"bn", "mlp_bn_0", "mlp_bn_1"}
    got = _flat(batch_stats_from_module(model))
    want = _flat(variables["batch_stats"])
    assert got.keys() == want.keys() and len(want) == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(model.bn.var.numpy(), variables["batch_stats"]["bn"]["var"])
    tree = _flat(flax_from_state_dict(model.state_dict(), model))
    assert not any(k.endswith(("['mean']", "['var']")) for k in tree)
    with pytest.raises(KeyError, match="batch_stats"):
        load_batch_stats(model, {"bn": variables["batch_stats"]["bn"]})


def test_bce_with_logits_matches_jax_at_a_zero_logit():
    """A dead ReLU head with a zero bias scores exactly 0: there the JAX
    loss's gradient is −label (`jnp.maximum` splits at the tie, `jnp.abs`
    takes the + side); the port's is the same, and equal elsewhere."""
    from oovrec_tpu.models.losses import bce_with_logits as jax_bce_with_logits
    from oovrec_tpu_torch.models.losses import bce_with_logits

    x = np.array([0.0, 0.0, 0.0, 1.5, -2.0, 40.0, -40.0], np.float32)
    y = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0], np.float32)
    w = np.array([1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0], np.float32)
    want, jgrad = jax.value_and_grad(lambda a: jax_bce_with_logits(a, y, w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = bce_with_logits(xt, torch.from_numpy(y), torch.from_numpy(w))
    (grad,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)
    assert grad[0] == -1 / 6 and grad[1] == 0


def test_fm_second_order_matches_jax():
    emb = np.random.default_rng(1).standard_normal((32, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(fm_second_order(torch.from_numpy(emb)).numpy(),
                               np.asarray(jax_fm(jnp.asarray(emb))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fm_no_reduce(torch.from_numpy(emb)).numpy(),
                               np.asarray(jax_fm_no_reduce(jnp.asarray(emb))),
                               rtol=1e-6, atol=1e-6)


# the toy-ind fits, at the config keys of MODELS' widths. Some under SGD:
#   * DCN and NFM: a Dense bias before a BatchNorm has a gradient that is
#     rounding noise, which Adam scales up to whole steps (`_dcnv2_cfg`);
#   * AutoInt and FiGNN: so has the attention's key bias (a shift of every
#     key leaves the softmax as it is);
#   * DSSM: under Adam it is chaotic on toy-ind (with dead towers the
#     cosine's norms are near 0): a 1e-7 relative nudge of the port's own
#     initial weights moves its second OOV epoch's loss by 1e-3 relative;
#     under SGD the packages agree to 3e-8;
#   * NFM at rate 1e-3: at 0.01 it is chaotic on toy-ind's 8-row batches
#     (its BatchNorms over the bi-interaction of the ages and prices take
#     E[x²] − E[x]² of large values): a 1e-7 nudge of the port's own
#     weights moves its second epoch's losses by 4e-6 and 8e-6 relative
#     (the packages' rounding: 3e-5); at 1e-3 the parameters agree to 2e-7.
# DCN's N(0, 1) cross weights start at 1/10 (`_setup`).
SGD = dict(learner="sgd", learning_rate=0.01)
FIT = {
    "LR": {}, "FM": {}, "DeepFM": {}, "FFM": {},
    "DCN": dict(SGD, cross_layer_num=2, reg_weight=0.01),
    "AutoInt": dict(SGD, attention_size=8, n_layers=2, dropout_probs=[0.0, 0.0, 0.0]),
    "FNN": {}, "PNN": dict(use_outer=True), "AFM": dict(attention_size=8, reg_weight=0.01),
    "FwFM": {}, "DSSM": dict(SGD), "FiGNN": dict(SGD, attention_size=8),
    "EulerNet": dict(drop_ex=0.0, drop_im=0.0), "NFM": dict(SGD, learning_rate=1e-3),
    "KD_DAGFM": dict(depth=2, phase="distillation"),
}


@pytest.mark.parametrize("name", list(FIT))
def test_fit_trajectory_matches_jax(name, tmp_path):
    """Two epochs with the frozen OOV sub-epoch on toy-ind, dropout 0."""
    s = _setup(_xdfm_cfg(tmp_path, model=name, oov_freeze_embedding=True, **FIT[name]))
    model = s["port"][1]
    teacher = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("teacher.")}
    pt, jt = fit_both(s)
    assert pt.oov_loss_dict
    if name in WITH_STATS:
        got, want = _flat(batch_stats_from_module(model)), _flat(jt.variables["batch_stats"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    if name == "KD_DAGFM":  # distillation: the teacher's logit is detached
        assert teacher and all(torch.equal(v, model.state_dict()[k]) for k, v in teacher.items())


@pytest.mark.parametrize("mode", ["pointwise", "plain"])
@pytest.mark.parametrize("name", ZOO4)
def test_fit_on_the_device_epoch(name, mode, tmp_path):
    """`device_epoch: true`: LR, FM and DeepFM train on the pointwise and
    plain device epochs (the OOV sub-epoch on the host path, as in JAX);
    FFM keeps the host path. Finite losses, moved weights."""
    _, trainer, train = _ranking(tmp_path, mode, make=lambda t, **o: _xdfm_cfg(t, model=name, **o),
                                 oov_freeze_embedding=True)
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    trainer.fit(train, None, saved=False)
    des = list(trainer._device_epochs.values())
    if name == "FFM":
        assert not des
    else:
        assert len(des) == 1 and des[0].mode == mode and not des[0].oov
    assert trainer.oov_loss_dict and all(np.isfinite(v) for v in trainer.train_loss_dict.values())
    moved = {n for n, p in trainer.params.items() if not torch.equal(p, before[n])}
    assert any("oov_bucket" not in n for n in moved)


@pytest.mark.parametrize("mode", ["pointwise", "plain"])
@pytest.mark.parametrize("name", NEW)
def test_new_models_are_not_device_epoch_eligible(name, mode, tmp_path):
    """`device_epoch: true` on a loader the device epoch could take: the
    gate refuses each of the 11 (JAX's gate, `device_epoch.py:658`, reads
    the same flag)."""
    _, trainer, train = _ranking(tmp_path, mode, make=lambda t, **o: _xdfm_cfg(
        t, model=name, **{k: v for k, v in FIT[name].items() if k not in SGD}, **o))
    assert not trainer._maybe_device_epoch(train)
    assert not device_epoch_eligible(trainer, train, trainer.config)

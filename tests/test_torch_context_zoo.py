"""The port's LR, FM, DeepFM and FFM against flax.

On the small FieldSpec of `test_torch_context_models.py` (three token
fields, one float field, a token_seq and a float_seq field, embedding_size
8, dropout 0, IV and OOV users and items routed by the random mapper's
buckets or by lsh), the JAX model's params (biases perturbed) cross into
the port through `utils/jax_params.py`. Checked, each against the JAX
package:
  * `predict` in eval mode to 1e-5;
  * `calculate_loss` in train mode and its gradient over every parameter
    to 1e-5, on a batch whose last rows are padding (weight 0);
  * the bridge both ways: LR's tree has no field embedding, FFM's
    `field_proj` (F, F, D, D) stays a raw leaf; `fm_second_order` to 1e-6;
then on toy-ind two-epoch `Trainer.fit` trajectories of each model on the
host path against the JAX trainer (losses 1e-5 relative, parameters 1e-5
absolute, the validation scores exactly), and LR, FM and DeepFM through
`Trainer.fit` on the pointwise and plain device epochs (FFM, which does
not declare `supports_device_epoch`, keeps the host path).
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
from oovrec_tpu_torch.inductive import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.models import FieldSpec, get_model_class  # noqa: E402
from oovrec_tpu_torch.models.context_aware.basic import fm_second_order  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402

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

MODELS = {"LR": {}, "FM": {}, "DeepFM": dict(mlp_hidden_size=(16, 8), dropout_prob=0.0),
          "FFM": {}}


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


def _flax(name, embedder):
    return jax_model_class(name)(fields=JaxFieldSpec(**FIELDS), spec=JaxSpec(**SPECS[embedder]),
                                 embedding_size=8, **MODELS[name])


def _variables(name, embedder):
    m = _flax(name, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    params = m.init(jax.random.key(7), _jax_batch(_batch(embedder)), estate,
                    method=m.calculate_loss)["params"]
    rng = np.random.default_rng(8)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                      if p[-1].key == "bias" else 0), params)


def _port(name, params, embedder):
    model = get_model_class(name)(FieldSpec(**FIELDS), spec=InductiveSpec(**SPECS[embedder]),
                                  device="cpu", embedder_state=_estate(embedder) or None,
                                  embedding_size=8, **MODELS[name])
    return load_flax_params(model, params)


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("name", list(MODELS))
def test_predict_matches_flax(name, embedder):
    params = _variables(name, embedder)
    batch = _batch(embedder)
    jm = _flax(name, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    want = np.asarray(jm.apply({"params": params}, _jax_batch(batch), estate,
                               method=jm.predict))
    model = _port(name, params, embedder)
    model.train()  # predict runs in eval mode whatever the module's mode
    with torch.no_grad():
        got = model.predict(_torch_batch(batch)).numpy()
    assert got.shape == want.shape == (B,)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_gradients_match_flax(name, embedder):
    params = _variables(name, embedder)
    batch = _batch(embedder, seed=5, n_pad=N_PAD)
    jm = _flax(name, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, _jax_batch(batch), estate, method=jm.calculate_loss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = _port(name, params, embedder)
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


@pytest.mark.parametrize("name", list(MODELS))
def test_weight_bridge_round_trip(name):
    params = _variables(name, "random")
    model = _port(name, params, "random")
    back = _flat(flax_from_state_dict(model.state_dict(), model))
    assert back.keys() == _flat(params).keys()
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    sd = model.state_dict()
    assert ("field_embedding.token_embedding_table.weight" in sd) == (name != "LR")
    if name == "FFM":
        f = FieldSpec(**FIELDS).num_feature_field
        assert sd["field_proj"].shape == (f, f, 8, 8) and "pair_i" not in sd
        np.testing.assert_array_equal(sd["field_proj"].numpy(), params["field_proj"])
    flag = getattr(get_model_class(name), "supports_device_epoch", False)
    assert flag == getattr(jax_model_class(name), "supports_device_epoch", False) == (
        name != "FFM")


def test_fm_second_order_matches_jax():
    emb = np.random.default_rng(1).standard_normal((32, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(fm_second_order(torch.from_numpy(emb)).numpy(),
                               np.asarray(jax_fm(jnp.asarray(emb))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(MODELS))
def test_fit_trajectory_matches_jax(name, tmp_path):
    """Two epochs with the frozen OOV sub-epoch on toy-ind, dropout 0."""
    pt, _ = fit_both(_setup(_xdfm_cfg(tmp_path, model=name, oov_freeze_embedding=True)))
    assert pt.oov_loss_dict


@pytest.mark.parametrize("mode", ["pointwise", "plain"])
@pytest.mark.parametrize("name", list(MODELS))
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

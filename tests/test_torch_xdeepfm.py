"""The port's xDeepFM serving methods against flax xDeepFM.

A JAX xDeepFM with random-mapper OOV buckets on both sides is initialised
on a small FieldSpec (three token fields, one float field, embedding_size
8, cin_layer_size (10, 10)), direct and non-direct. Its params cross into
the port through `utils/jax_params.py`; `predict` on a batch that mixes IV
and OOV users and items must equal flax's to 1e-5 with the plain slab path
and with the CIN kernel route (the JAX Pallas kernel in interpret mode,
the port's wrapper on its plain version), in f32. Under the bf16 policy
the two agree to the JAX package's own bf16 tolerance (3e-2).
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
from oovrec_tpu.utils import precision as jax_precision  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper  # noqa: E402
from oovrec_tpu_torch.models import FieldSpec, get_model_class, xDeepFM  # noqa: E402
from oovrec_tpu_torch.ops.cin_fused import cin_layer_pooled  # noqa: E402
from oovrec_tpu_torch.utils import precision  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    flax_from_state_dict,
    load_flax_params,
    state_dict_from_flax,
)

N_USERS, N_ITEMS, N_CAT = 30, 25, 6
FIELDS = dict(
    token_names=("user_id", "item_id", "cat"),
    token_dims=(N_USERS, N_ITEMS, N_CAT),
    float_names=("price",),
    float_dims=(3,),
)
SPEC = dict(mapper="random", add_oov_buckets=True, n_user_buckets=7,
            n_item_buckets=5, embedding_size=8)
MODEL = dict(embedding_size=8, cin_layer_size=(10, 10), mlp_hidden_size=(16, 8),
             dropout_prob=0.2)


def _batch():
    rng = np.random.default_rng(4)
    B = 16
    users = rng.integers(1, N_USERS, B)
    items = rng.integers(1, N_ITEMS, B)
    users[::3] = rng.integers(N_USERS, N_USERS + 40, len(users[::3]))
    items[1::4] = rng.integers(N_ITEMS, N_ITEMS + 40, len(items[1::4]))
    mapper = RandomOOVMapper(InductiveSpec(**SPEC), N_USERS, N_ITEMS,
                             N_USERS + 40, N_ITEMS + 40)
    mapper.set_eval()
    batch = mapper.annotate({"user_id": users, "item_id": items}, "user_id", "item_id")
    batch.update({
        "cat": rng.integers(0, N_CAT, B),
        "price": rng.random(B).astype(np.float32) * 3,
        "price__bucket": rng.integers(1, 3, B),
        "label": (rng.random(B) < 0.5).astype(np.float32),
    })
    assert 0 < batch["user_id_oov"].sum() < B and 0 < batch["item_id_oov"].sum() < B
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(np.asarray(v, np.int32) if np.asarray(v).dtype.kind in "iu"
                           else v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flax(direct, fused):
    m = jax_model_class("xDeepFM")(
        fields=JaxFieldSpec(**FIELDS), spec=JaxSpec(**SPEC), direct=direct,
        fused_cin=fused, **MODEL)
    return m


def _flax_params(direct):
    m = _flax(direct, False)
    variables = m.init(jax.random.key(7), _jax_batch(_batch()), {}, method=m.predict)
    # random biases, so the bridge's bias leaves are really exercised
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                      if p[-1].key == "bias" else 0),
        variables["params"])
    return params


def _port(params, direct, fused):
    model = xDeepFM(FieldSpec(**FIELDS), spec=InductiveSpec(**SPEC), direct=direct,
                    fused_cin=fused, device="cpu", **MODEL)
    return load_flax_params(model, params)


@pytest.mark.parametrize("direct", [False, True], ids=["split", "direct"])
@pytest.mark.parametrize("fused", [False, True], ids=["slab", "kernel"])
def test_predict_matches_flax(direct, fused):
    params = _flax_params(direct)
    batch = _batch()
    jm = _flax(direct, fused)
    want = np.asarray(jm.apply({"params": params}, _jax_batch(batch), {}, method=jm.predict))
    model = _port(params, direct, fused)
    with torch.no_grad():
        model.eval()
        got = model.predict(_torch_batch(batch)).numpy()
        emb = model.concat_embed_input_fields(_torch_batch(batch))
        assert model._use_fused_cin(emb) is fused
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert get_model_class("xDeepFM") is xDeepFM


@pytest.mark.parametrize("direct", [False, True], ids=["split", "direct"])
def test_weight_bridge_round_trip(direct):
    params = _flax_params(direct)
    model = _port(params, direct, "auto")
    sd = model.state_dict()
    assert set(state_dict_from_flax(params, model)) == set(sd)
    assert "conv1d_0.kernel" in sd and "mlp_layers.Dense_0.weight" in sd
    assert sd["mlp_layers.Dense_0.weight"].shape == (16, 4 * 8)  # (out, in)
    assert "first_order_linear.fo.user_oov_buckets.weight" in sd
    back = flax_from_state_dict(sd, model)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(params), flat(back)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    with pytest.raises(ValueError, match="target module"):
        state_dict_from_flax(params)


def test_cin_route_and_plain_path_agree_layer_by_layer():
    """The model's fused CIN (kernel wrapper) equals its slab path."""
    params = _flax_params(False)
    emb = torch.from_numpy(
        np.random.default_rng(9).standard_normal((11, 4, 8)).astype(np.float32))
    with torch.no_grad():
        slab = _port(params, False, False).compressed_interaction_network(emb)
        fused = _port(params, False, True).compressed_interaction_network(emb)
    assert slab.shape == fused.shape == (11, 5 + 10)
    np.testing.assert_allclose(fused.numpy(), slab.numpy(), rtol=1e-5, atol=1e-5)
    assert cin_layer_pooled.launches == 0  # the CPU never launches the kernel


@pytest.mark.parametrize("fused", [False, True], ids=["slab", "kernel"])
def test_bf16_policy_close_to_flax(fused):
    params = _flax_params(False)
    batch = _batch()
    jm = _flax(False, fused)
    model = _port(params, False, fused)
    model.eval()
    with torch.no_grad():
        p32 = model.predict(_torch_batch(batch)).numpy()
    jax_precision.set_policy("bfloat16")
    precision.set_policy("bfloat16")
    try:
        want = np.asarray(jm.apply({"params": params}, _jax_batch(batch), {},
                                   method=jm.predict))
        with torch.no_grad():
            got = model.predict(_torch_batch(batch)).numpy()
    finally:
        jax_precision.set_policy("float32")
        precision.set_policy("float32")
    assert precision.compute_dtype() == torch.float32
    np.testing.assert_allclose(got, want, atol=3e-2)
    np.testing.assert_allclose(got, p32, atol=3e-2)
    assert not np.allclose(got, p32, atol=1e-9)


def test_unported_parts_raise():
    model = _port(_flax_params(False), False, "auto")
    # dropout in train mode draws only from a generator the trainer gives
    with pytest.raises(RuntimeError, match="generator"):
        model.calculate_loss(_torch_batch(_batch()))
    with pytest.raises(ValueError, match="needs its state"):
        xDeepFM(FieldSpec(**FIELDS), spec=InductiveSpec(embedder="dnn"), device="cpu")
    with pytest.raises(KeyError, match="cat"):
        batch = _torch_batch(_batch())
        del batch["cat"]
        model.predict(batch)


def test_missing_optional_column_is_pad_filled():
    """`is_new` may be absent (the `_ind` corpus has no such column): it
    embeds as PAD, as in the JAX package."""
    fields = dict(FIELDS, token_names=FIELDS["token_names"] + ("is_new",),
                  token_dims=FIELDS["token_dims"] + (3,))
    jm = jax_model_class("xDeepFM")(fields=JaxFieldSpec(**fields), spec=JaxSpec(**SPEC),
                                    fused_cin=False, **MODEL)
    batch = _batch()
    variables = jm.init(jax.random.key(3), _jax_batch(batch), {}, method=jm.predict)
    want = np.asarray(jm.apply(variables, _jax_batch(batch), {}, method=jm.predict))
    model = xDeepFM(FieldSpec(**fields), spec=InductiveSpec(**SPEC), fused_cin=False,
                    device="cpu", **MODEL)
    load_flax_params(model, variables["params"]).eval()
    with torch.no_grad():
        got = model.predict(_torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

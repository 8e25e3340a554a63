"""The port's WideDeep and DCNv2 (stacked, parallel, mixed experts) against
flax, with token_seq / float_seq fields and the BatchNorm statistics.

A JAX model on a small FieldSpec (three token fields, one float field, a
token_seq field `tags` and a float_seq field `scores`, embedding_size 8,
dropout 0) is initialised; its params (biases and BatchNorm scales
perturbed) and its `batch_stats` (random running statistics) cross into
the port through `utils/jax_params.py`. The batch mixes IV and OOV users
and items, routed by the random mapper's buckets or by lsh over random
feature rows. Checked, each against the JAX package:
  * `predict` in eval mode (running statistics) to 1e-5, xDeepFM with the
    sequence fields too;
  * `calculate_loss` in train mode and its gradient over every parameter
    to 1e-5, on a batch whose last rows are padding (weight 0), and the
    new `batch_stats` after that step to 1e-6 (the padded rows count in
    the statistics, as in flax);
  * the bf16 policy to 3e-2;
  * the sequence pooling (mean / max / sum, an all-pad row, float_seq with
    and without its `__bucket` column) and its gradient to 1e-5;
  * the bridge both ways, with the statistics.
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
from oovrec_tpu.models.context import _FieldEmbedding as JaxFieldEmbedding  # noqa: E402
from oovrec_tpu.utils import precision as jax_precision  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper  # noqa: E402
from oovrec_tpu_torch.models import DCNV2, FieldSpec, WideDeep, get_model_class  # noqa: E402
from oovrec_tpu_torch.models.context import _FieldEmbedding  # noqa: E402
from oovrec_tpu_torch.utils import precision  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    batch_stats_from_module,
    flax_from_state_dict,
    load_batch_stats,
    load_flax_params,
    state_dict_from_flax,
)

N_USERS, N_ITEMS, N_CAT, N_TAGS, N_SCORES, SEQ = 30, 25, 6, 9, 4, 5
N_EXTRA, B, N_PAD, NB, N_FEAT = 40, 16, 4, 7, 5
FIELDS = dict(
    token_names=("user_id", "item_id", "cat"), token_dims=(N_USERS, N_ITEMS, N_CAT),
    float_names=("price",), float_dims=(3,),
    token_seq_names=("tags",), token_seq_dims=(N_TAGS,),
    float_seq_names=("scores",), float_seq_dims=(N_SCORES,),
)
SPECS = {
    "random": dict(mapper="random", add_oov_buckets=True, n_user_buckets=NB,
                   n_item_buckets=5, embedding_size=8),
    "lsh": dict(embedder="lsh", add_oov_buckets=True, n_user_buckets=NB,
                n_item_buckets=NB, embedding_size=8),
}
MODELS = {
    "WideDeep": ("WideDeep", dict(mlp_hidden_size=(16, 8))),
    "DCNV2-stacked": ("DCNV2", dict(cross_layer_num=2, mlp_hidden_size=(16, 8))),
    "DCNV2-parallel": ("DCNV2", dict(cross_layer_num=2, mlp_hidden_size=(16, 8),
                                     structure="parallel")),
    "DCNV2-mixed": ("DCNV2", dict(cross_layer_num=2, mlp_hidden_size=(16, 8), mixed=True,
                                  expert_num=3, low_rank=4)),
}
COMMON = dict(embedding_size=8, dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these tiny shapes run fastest on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lsh_state():
    rng = np.random.default_rng(11)
    state = {}
    for side, n in (("user", N_USERS + N_EXTRA), ("item", N_ITEMS + N_EXTRA)):
        m = rng.standard_normal((n, N_FEAT)).astype(np.float32)
        state[f"{side}_feat_mat"] = m / np.linalg.norm(m, axis=1, keepdims=True)
        state[f"{side}_planes"] = rng.standard_normal((NB, N_FEAT)).astype(np.float32)
    return state


def _batch(embedder="random", seed=4, n=B, n_pad=0):
    """IV and OOV users and items, the feature columns, sequences with an
    all-pad row, labels; the last `n_pad` rows are padding (ids 0,
    weight 0)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1, N_USERS, n)
    items = rng.integers(1, N_ITEMS, n)
    users[::3] = rng.integers(N_USERS, N_USERS + N_EXTRA, len(users[::3]))
    items[1::4] = rng.integers(N_ITEMS, N_ITEMS + N_EXTRA, len(items[1::4]))
    if embedder == "random":
        mapper = RandomOOVMapper(InductiveSpec(**SPECS["random"]), N_USERS, N_ITEMS,
                                 N_USERS + N_EXTRA, N_ITEMS + N_EXTRA)
        mapper.set_eval()
        batch = mapper.annotate({"user_id": users, "item_id": items}, "user_id", "item_id")
    else:
        batch = {"user_id": users, "item_id": items,
                 "user_id_oov": (users >= N_USERS).astype(np.int64),
                 "item_id_oov": (items >= N_ITEMS).astype(np.int64)}
    tags = rng.integers(0, N_TAGS, (n, SEQ))
    tags[0] = 0
    buckets = rng.integers(0, N_SCORES, (n, SEQ))
    buckets[1] = 0
    batch.update({
        "cat": rng.integers(0, N_CAT, n),
        "price": rng.random(n).astype(np.float32) * 3,
        "price__bucket": rng.integers(1, 3, n),
        "tags": tags,
        "scores": rng.random((n, SEQ)).astype(np.float32) * 2,
        "scores__bucket": buckets,
        "label": (rng.random(n) < 0.5).astype(np.float32),
        "weight": np.ones(n, np.float32),
    })
    if n_pad:
        for k, v in batch.items():
            v[n - n_pad:] = 0
    assert 0 < batch["user_id_oov"][:n - n_pad].sum() < n - n_pad
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(np.asarray(v, np.int32) if np.asarray(v).dtype.kind in "iu"
                           else v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flax(case, embedder="random"):
    name, kw = MODELS[case] if case in MODELS else ("xDeepFM", dict(
        mlp_hidden_size=(16, 8), cin_layer_size=(6, 6), fused_cin=False))
    return jax_model_class(name)(fields=JaxFieldSpec(**FIELDS), spec=JaxSpec(**SPECS[embedder]),
                                 **COMMON, **kw)


def _estate(embedder):
    return _lsh_state() if embedder == "lsh" else {}


def _flax_variables(case, embedder="random"):
    """Init, then biases and BatchNorm scales perturbed and random running
    statistics, so every leaf of the bridge matters."""
    m = _flax(case, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    variables = m.init(jax.random.key(7), _jax_batch(_batch(embedder)), estate,
                       method=m.calculate_loss)
    rng = np.random.default_rng(8)

    def perturb(path, v):
        leaf = path[-1].key
        noise = rng.standard_normal(v.shape).astype(np.float32) * 0.1
        return np.asarray(v) + (noise if leaf in ("bias", "scale") else 0)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    out = {"params": params}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, v: (rng.standard_normal(v.shape).astype(np.float32) * 0.2
                          if p[-1].key == "mean"
                          else rng.uniform(0.5, 1.5, v.shape).astype(np.float32)),
            variables["batch_stats"])
    return out


def _port(case, variables, embedder="random"):
    name, kw = MODELS[case] if case in MODELS else ("xDeepFM", dict(
        mlp_hidden_size=(16, 8), cin_layer_size=(6, 6), fused_cin=False))
    model = get_model_class(name)(FieldSpec(**FIELDS), spec=InductiveSpec(**SPECS[embedder]),
                                  device="cpu", embedder_state=_estate(embedder) or None,
                                  **COMMON, **kw)
    load_flax_params(model, variables["params"])
    if "batch_stats" in variables:
        load_batch_stats(model, variables["batch_stats"])
    return model


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("case", list(MODELS) + ["xDeepFM"])
def test_predict_matches_flax(case, embedder):
    variables = _flax_variables(case, embedder)
    batch = _batch(embedder)
    jm = _flax(case, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    want = np.asarray(jm.apply(variables, _jax_batch(batch), estate, method=jm.predict))
    model = _port(case, variables, embedder)
    model.train()  # predict runs in eval mode whatever the module's mode
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model.predict(_torch_batch(batch)).numpy()
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("case", list(MODELS))
def test_loss_gradients_and_batch_stats_match_flax(case, embedder):
    """One train-mode loss on a batch with N_PAD padded rows: the loss and
    its gradient over every parameter to 1e-5, the running statistics it
    leaves to 1e-6 (the padded rows count, as in flax)."""
    variables = _flax_variables(case, embedder)
    batch = _batch(embedder, seed=5, n_pad=N_PAD)
    jm = _flax(case, embedder)
    estate = {k: jnp.asarray(v) for k, v in _estate(embedder).items()}
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        return jm.apply({"params": p, **extra}, _jax_batch(batch), estate,
                        method=jm.calculate_loss, mutable=["batch_stats"])

    (jloss, new_vars), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    model = _port(case, variables, embedder)
    model.eval()  # calculate_loss runs in train mode whatever the module's mode
    names = [n for n, _ in model.named_parameters()]
    loss = model.calculate_loss(_torch_batch(batch))
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-6)
    got = _flat(flax_from_state_dict(
        {n: torch.zeros_like(p) if g is None else g
         for (n, p), g in zip(model.named_parameters(), grads)}, model))
    want = _flat(jgrads)
    assert set(got) == set(want) and len(names) == len(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    if case.startswith("DCNV2"):
        got_stats = _flat(batch_stats_from_module(model))
        want_stats = _flat(new_vars["batch_stats"])
        assert set(got_stats) == set(want_stats) and len(want_stats) == 4
        for k in want_stats:
            np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=0, atol=1e-6,
                                       err_msg=k)
            assert not np.allclose(want_stats[k], _flat(variables["batch_stats"])[k])
    else:
        assert "batch_stats" not in new_vars and not batch_stats_from_module(model)


@pytest.mark.parametrize("case", list(MODELS))
def test_bf16_policy_close_to_flax(case):
    variables = _flax_variables(case)
    batch = _batch()
    jm = _flax(case)
    model = _port(case, variables)
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


@pytest.mark.parametrize("mode", ["mean", "max", "sum"])
@pytest.mark.parametrize("kind", ["token_seq", "float_seq", "float_seq-values"])
def test_sequence_pooling_matches_flax(kind, mode):
    """Each sequence field's pooled rows and their table gradient, an
    all-pad row included; float_seq with its `__bucket` column and with
    the values cast to int32 as indices."""
    batch = _batch(seed=9)
    if kind == "float_seq-values":
        del batch["scores__bucket"]
        batch["scores"] = np.random.default_rng(10).integers(
            0, N_SCORES, (B, SEQ)).astype(np.float32) + 0.75
        batch["scores"][2] = 0.5  # casts to pad 0 throughout
    fields = JaxFieldSpec(**FIELDS)
    jm = JaxFieldEmbedding(fields, 3)
    params = jm.init(jax.random.key(2), _jax_batch(batch), {})["params"]
    method = (JaxFieldEmbedding.embed_token_seq_fields if kind == "token_seq"
              else JaxFieldEmbedding.embed_float_seq_fields)
    g = np.random.default_rng(3).standard_normal((B, 1, 3)).astype(np.float32)

    def jfn(p):
        return jm.apply({"params": p}, _jax_batch(batch), mode, method=method)

    want = np.asarray(jfn(params))
    table = "token_seq_table_tags" if kind == "token_seq" else "float_seq_table_scores"
    jgrad = jax.grad(lambda p: jnp.sum(jfn(p) * g))(params)[table]["embedding"]

    port = _FieldEmbedding(FieldSpec(**FIELDS), 3, device="cpu")
    port.load_state_dict(state_dict_from_flax(params, port))
    fn = (port.embed_token_seq_fields if kind == "token_seq" else port.embed_float_seq_fields)
    got = fn(_torch_batch(batch), mode)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    (grad,) = torch.autograd.grad(got, getattr(port, table).weight, torch.from_numpy(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)
    if mode == "max" and kind == "token_seq":  # the all-pad row picks a pad row
        np.testing.assert_array_equal(got[0, 0].detach().numpy(),
                                      np.asarray(params[table]["embedding"])[0] - np.float32(1e9))


@pytest.mark.parametrize("case", list(MODELS))
def test_weight_bridge_round_trip_with_stats(case):
    """flax params → port → flax leaf for leaf; the running statistics
    stay out of the params and cross as `batch_stats`; raw cross weights
    keep their layout and the gating Denses are Linears."""
    variables = _flax_variables(case)
    model = _port(case, variables)
    sd = model.state_dict()
    back = flax_from_state_dict(sd, model)
    assert _flat(back).keys() == _flat(variables["params"]).keys()
    for k, v in _flat(variables["params"]).items():
        np.testing.assert_array_equal(_flat(back)[k], v, err_msg=k)
    # without the module, a stat is still no param
    assert "mean" not in str(_flat(flax_from_state_dict(
        {k: v for k, v in sd.items() if "BatchNorm" in k or k == "cross_bias"})))
    if case.startswith("DCNV2"):
        stats = batch_stats_from_module(model)
        assert set(stats["mlp_layers"]) == {"BatchNorm_0", "BatchNorm_1"}
        for k, v in _flat(variables["batch_stats"]).items():
            np.testing.assert_array_equal(_flat(stats)[k], v, err_msg=k)
        assert "mlp_layers.BatchNorm_0.mean" in sd and "mlp_layers.BatchNorm_0.scale" in sd
        assert "first_order_linear.bias" not in sd
        if "mixed" in case:
            assert sd["gating_0.weight"].shape == (1, 6 * 8)
            np.testing.assert_array_equal(sd["cross_layer_u"].numpy(),
                                          variables["params"]["cross_layer_u"])
        else:
            np.testing.assert_array_equal(sd["cross_layer_w"].numpy(),
                                          variables["params"]["cross_layer_w"])
        with pytest.raises(KeyError, match="batch_stats"):
            load_batch_stats(model, {"mlp_layers": {"BatchNorm_0": stats["mlp_layers"][
                "BatchNorm_0"]}})
    else:
        assert sd["mlp_layers.Dense_0.weight"].shape == (16, 6 * 8)


def test_eval_mode_uses_the_running_statistics():
    """DCNv2 in eval mode scores a row the same alone and inside a batch
    (the running statistics, not the batch's); a train-mode loss moves the
    statistics as 0.99·ra + 0.01·batch, and an eval pass leaves them."""
    variables = _flax_variables("DCNV2-stacked")
    model = _port("DCNV2-stacked", variables)
    batch = _torch_batch(_batch())
    with torch.no_grad():
        whole = model.predict(batch)
        alone = model.predict({k: v[:3] for k, v in batch.items()})
        model.train()
        trained_mode = model(batch, train=False)
    np.testing.assert_allclose(alone.numpy(), whole[:3].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(trained_mode.numpy(), whole.numpy())
    bn = model.mlp_layers.BatchNorm_0
    ra = bn.mean.clone()
    emb = model.concat_embed_input_fields(batch)
    x = model.mlp_layers.Dense_0(model.cross_network(emb.reshape(B, -1)))
    model.calculate_loss(batch)
    np.testing.assert_allclose(bn.mean.detach().numpy(),
                               (0.99 * ra + 0.01 * x.mean(dim=0)).detach().numpy(),
                               rtol=0, atol=1e-6)
    assert get_model_class("WideDeep") is WideDeep and get_model_class("DCNV2") is DCNV2


def test_bce_matches_jax_where_jax_is_finite():
    """`bce` equals the JAX function (value and gradient) on probabilities
    inside (0, 1); at a probability that rounds to 1 (which the f32 clip to
    1 - 1e-8 lets through) the JAX function gives inf or NaN and the port
    gives the reference's `nn.BCELoss` value, its log held at -100, with a
    finite gradient."""
    from oovrec_tpu.models.losses import bce as jax_bce
    from oovrec_tpu_torch.models.losses import bce

    rng = np.random.default_rng(12)
    p = rng.uniform(1e-6, 1 - 1e-6, 32).astype(np.float32)
    p[:3] = [0.0, 1e-12, 1 - 2 ** -20]
    y = (rng.random(32) < 0.5).astype(np.float32)
    w = np.r_[np.ones(28), np.zeros(4)].astype(np.float32)
    jv, jg = jax.value_and_grad(lambda q: jax_bce(q, jnp.asarray(y), jnp.asarray(w)))(
        jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_()
    got = bce(tp, torch.from_numpy(y), torch.from_numpy(w))
    (g,) = torch.autograd.grad(got, tp)
    np.testing.assert_allclose(float(got.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)

    sat = np.array([1.0, 1.0, 0.25], np.float32)
    for label in (0.0, 1.0):
        lab = np.full(3, label, np.float32)
        assert not np.isfinite(float(jax_bce(jnp.asarray(sat), jnp.asarray(lab))))
        tp = torch.from_numpy(sat).requires_grad_()
        got = bce(tp, torch.from_numpy(lab))
        want = torch.nn.functional.binary_cross_entropy(
            torch.clamp(torch.from_numpy(sat), 1e-8, 1 - 1e-8), torch.from_numpy(lab))
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        (g,) = torch.autograd.grad(got, tp)
        assert bool(torch.isfinite(g).all())

"""The port's sequential models against flax: GRU4Rec (CE, BPR, two
layers), SASRec, NARM, STAMP, FPMC and BERT4Rec.

Each JAX model (`oovrec_tpu/models/sequential/`) is initialised from a
seed at a small width (embedding 8, hidden 8, inner 16, L 5, 2 layers and
2 heads for the transformers, dropout 0), its biases and the zero-init
raw leaves moved off 0, and its params cross into the port through
`utils/jax_params.py`. On a seeded batch whose rows have every length
from 0 (all padding) to L and whose last row has weight 0, checked to
1e-5 against the JAX package: `seq_output`, `calculate_loss`, `predict`
and `full_sort_scores`, and the loss's gradient over every parameter
(`jax.grad` against autograd). SASRec's and BERT4Rec's all-padding row
is finite and equal to JAX's (their masked logits sit at the dtype's
finite minimum). BERT4Rec's loss reads the batch as `MaskItemSequence`
masks it. The bridge carries every tree both ways unchanged, and the
port's layers have flax's names (`gru_<i>`, `block_<i>` with
`LayerNorm_0/1`, `MultiHeadDotProductAttention_0`, `Dense_0/1`,
STAMP's raw `b_a`, FPMC's four tables). Then the flax attention with a
mask, `LayerNorm` and `gelu` alone; every one of the JAX package's 28
sequential models resolves in the port; and the GRU4Rec `.pth` map
against the JAX package's.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu.utils.torch_import import import_state_dict as jax_import  # noqa: E402
from oovrec_tpu_torch.data.transform import MaskItemSequence  # noqa: E402
from oovrec_tpu.models.sequential import __all__ as JAX_SEQUENTIAL  # noqa: E402
from oovrec_tpu_torch.models import get_model_class  # noqa: E402
from oovrec_tpu_torch.models.layers import (  # noqa: E402
    LayerNorm,
    MultiHeadDotProductAttention,
    gelu,
    gru_scan,
)
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402
from oovrec_tpu_torch.utils.torch_import import import_state_dict  # noqa: E402
from tests.seq_parity import flat as _flat, jax_out as _jax_out, to_torch as _torch  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N_USERS, N_ITEMS, D, L = 9, 13, 8, 5
LENGTHS = [0, 1, 2, 3, 4, 5, 5, 3]  # every length, two full rows
SMALL = dict(embedding_size=D, max_seq_length=L)
MODELS = {
    "GRU4Rec": ("GRU4Rec", dict(hidden_size=8, dropout_prob=0.0)),
    "GRU4Rec-BPR": ("GRU4Rec", dict(hidden_size=8, dropout_prob=0.0, loss_type="BPR")),
    "GRU4Rec-2layers": ("GRU4Rec", dict(hidden_size=8, num_layers=2, dropout_prob=0.0)),
    "SASRec": ("SASRec", dict(n_layers=2, n_heads=2, inner_size=16, hidden_dropout_prob=0.0,
                              attn_dropout_prob=0.0)),
    "NARM": ("NARM", dict(hidden_size=8, dropout_probs=(0.0, 0.0))),
    "STAMP": ("STAMP", {}),
    "FPMC": ("FPMC", {}),
    "BERT4Rec": ("BERT4Rec", dict(n_layers=2, n_heads=2, inner_size=16,
                                  hidden_dropout_prob=0.0, attn_dropout_prob=0.0)),
}
CFG = {"mask_ratio": 0.4, "MAX_ITEM_LIST_LENGTH": L, "ITEM_ID_FIELD": "item_id",
       "LIST_SUFFIX": "_list", "ITEM_LIST_LENGTH_FIELD": "item_length", "seed": 3}


def _batch(case, seed=0):
    """A numpy batch: the sequences (0 after each length), the target and
    a negative, the user, weights (the last row 0); BERT4Rec's masked by
    `MaskItemSequence`."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    lengths = np.array(LENGTHS, np.int64)
    seq = rng.integers(1, N_ITEMS, (B, L))
    seq[np.arange(L)[None, :] >= lengths[:, None]] = 0
    batch = {"user_id": rng.integers(1, N_USERS, B), "item_id": rng.integers(1, N_ITEMS, B),
             "neg_item_id": rng.integers(1, N_ITEMS, B), "item_id_list": seq,
             "item_length": lengths, "weight": np.r_[np.ones(B - 1), 0.0].astype(np.float32)}
    if case == "BERT4Rec":
        batch = MaskItemSequence(CFG, N_ITEMS)(batch)
    return batch


def _both(case, seed=0):
    """(JAX model, its params with biases and raw leaves moved off 0, the
    port's model with those params)."""
    name, kw = MODELS[case]
    jm = jax_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, **SMALL, **kw)
    jb = {k: jnp.asarray(v) for k, v in _batch(case).items()}
    params = jm.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)}, jb,
                     method=jm.calculate_loss)["params"]
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                      if p[-1].key in ("bias", "b_a") else 0), params)
    port = get_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, device="cpu", **SMALL, **kw)
    load_flax_params(port, params)
    return jm, params, port


@pytest.mark.parametrize("case", sorted(MODELS))
def test_forward_matches_flax(case):
    jm, params, port = _both(case)
    batch = _batch(case)
    tb = _torch(batch)
    port.eval()
    with torch.no_grad():
        for method in ("predict", "full_sort_scores") + (
                () if case == "FPMC" else ("seq_output",)):
            got = getattr(port, method)(tb).numpy()
            want = _jax_out(jm, params, batch, method)
            assert np.isfinite(got).all(), method
            np.testing.assert_allclose(got, want, err_msg=method, **TOL)


@pytest.mark.parametrize("case", sorted(MODELS))
def test_loss_and_gradients_match_flax(case):
    jm, params, port = _both(case, seed=1)
    batch = _batch(case, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jm.apply({"params": p}, jb, method=jm.calculate_loss)

    want, jgrads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
    port.train()
    named = list(port.named_parameters())
    loss = port.calculate_loss(_torch(batch))
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    pg = _flat(flax_from_state_dict({n: torch.zeros_like(p) if g is None else g
                                     for (n, p), g in zip(named, grads)}, port))
    jg = _flat(jgrads)
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k, **TOL)


@pytest.mark.parametrize("case", ["SASRec", "BERT4Rec"])
def test_all_padding_rows_are_finite(case):
    """Every row of the batch all padding: every key masked for every
    query (SASRec), and BERT4Rec's mask token alone in each row."""
    jm, params, port = _both(case)
    batch = _batch(case)
    batch["item_id_list"] = np.zeros_like(batch["item_id_list"])
    batch["item_length"] = np.zeros_like(batch["item_length"])
    port.eval()
    with torch.no_grad():
        got = port.full_sort_scores(_torch(batch)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_out(jm, params, batch, "full_sort_scores"), **TOL)


@pytest.mark.parametrize("case", sorted(MODELS))
def test_bridge_keeps_flax_names(case):
    _, params, port = _both(case)
    back = _flat(flax_from_state_dict(port.state_dict(), port))
    want = _flat(params)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_masked_attention_layernorm_and_gelu_match_flax():
    rng = np.random.default_rng(0)
    b, lq, d, heads = 4, 6, 8, 2
    x = rng.standard_normal((b, lq, d)).astype(np.float32)
    mask = rng.random((b, 1, lq, lq)) < 0.6
    mask[0] = False  # a row whose keys are all masked
    m = fnn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=d, deterministic=True)
    params = m.init(jax.random.key(0), x, x, mask=mask)["params"]
    port = MultiHeadDotProductAttention(d, heads, d, device="cpu")
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(m.apply({"params": params}, x, x, mask=mask)),
                               **TOL)
    ln = fnn.LayerNorm()
    lp = ln.init(jax.random.key(1), x)["params"]
    lp = {"scale": np.asarray(lp["scale"]) + 0.3, "bias": np.asarray(lp["bias"]) - 0.2}
    pln = LayerNorm(d, device="cpu")
    load_flax_params(pln, lp)
    with torch.no_grad():
        np.testing.assert_allclose(pln(torch.from_numpy(x * 5)).numpy(),
                                   np.asarray(ln.apply({"params": lp}, x * 5)), **TOL)
        np.testing.assert_allclose(gelu(torch.from_numpy(x * 3)).numpy(),
                                   np.asarray(jax.nn.gelu(x * 3)), **TOL)


@pytest.mark.parametrize("name", sorted(JAX_SEQUENTIAL))
def test_every_jax_sequential_model_is_ported(name):
    """Each of the JAX package's 28 sequential models resolves in the
    port's registry, as a sequential model of the same name."""
    assert jax_model_class(name).model_type.name == "SEQUENTIAL"
    cls = get_model_class(name)
    assert cls.__name__ == name and cls.model_type.name == "SEQUENTIAL"


def _reference_gru4rec(num_layers, bias, seed=0):
    """A RecBole GRU4Rec state_dict: item table, `gru_layers` (torch.nn.GRU)
    and `dense`."""
    g = torch.Generator().manual_seed(seed)
    gru = torch.nn.GRU(D, 8, num_layers=num_layers, bias=bias, batch_first=True)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    sd = {f"gru_layers.{k}": v.detach().numpy() for k, v in gru.state_dict().items()}
    sd["item_embedding.weight"] = torch.randn(N_ITEMS, D, generator=g).numpy()
    sd["dense.weight"] = torch.randn(D, 8, generator=g).numpy()
    sd["dense.bias"] = torch.randn(D, generator=g).numpy()
    return sd, gru


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_gru4rec_torch_import(num_layers, bias):
    """The map equals the JAX map on every leaf the JAX map names; the
    JAX map names layer 0 alone, the port's every layer; the imported
    cells reproduce torch's GRU on the same inputs."""
    sd, gru = _reference_gru4rec(num_layers, bias)
    got, want = _flat(import_state_dict("GRU4Rec", sd)), _flat(jax_import("GRU4Rec", sd))
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    extra = {k.split("'")[1] for k in set(got) - set(want)}
    assert extra == ({"gru_1"} if num_layers == 2 else set())
    port = get_model_class("GRU4Rec")(n_users=N_USERS, n_items=N_ITEMS, device="cpu",
                                      hidden_size=8, num_layers=num_layers, dropout_prob=0.0,
                                      **SMALL)
    load_flax_params(port, import_state_dict("GRU4Rec", sd))
    x = torch.randn(3, L, D, generator=torch.Generator().manual_seed(1))
    h = x
    for i in range(num_layers):
        _, h = gru_scan(getattr(port, f"gru_{i}"), h, torch.zeros(3, 8))
    with torch.no_grad():
        np.testing.assert_allclose(h.detach().numpy(), gru(x)[0].numpy(), **TOL)

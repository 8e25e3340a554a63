"""The port's `MultiHeadDotProductAttention` and `GRUCell` against flax.

Each flax layer (flax 0.12) is initialised from a seed, its params cross
into the port's layer through `utils/jax_params.py` (the attention's 3-D
kernels as raw leaves, the GRU cell's six Denses as `nn.Linear`s), and
both run on the same numpy inputs. Checked to 1e-5: the output, and the
gradient of a random projection of it over every parameter and over the
inputs; the attention with one input (self-attention) and with two (query
and key/value from different tensors), at 1, 2 and 4 heads; the GRU cell
called `(carry, inputs)`, with an input width other than its features.
The layers' leaves have flax's names and shapes, and the bridge carries
them both ways unchanged.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu_torch.models.layers import GRUCell, MultiHeadDotProductAttention  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _perturbed(params, seed):
    """Biases moved off zero, so each leaf matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                      if p[-1].key == "bias" else 0), params)


def _grads_match(port, named_inputs, jfn, params, jinputs, out_shape, seed):
    """The output and the gradient of Σ out·g over the parameters and the
    inputs, port against flax."""
    g = np.random.default_rng(seed).standard_normal(out_shape).astype(np.float32)
    want, vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, params), *jinputs)
    jgrads = vjp(jnp.asarray(g))
    tensors = [torch.from_numpy(np.asarray(x)).requires_grad_() for x in jinputs]
    got = port(*tensors)
    if isinstance(got, tuple):
        got = got[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    named = list(port.named_parameters())
    grads = torch.autograd.grad(got, [p for _, p in named] + tensors, torch.from_numpy(g))
    pg = _flat(flax_from_state_dict(dict(zip([n for n, _ in named], grads[:len(named)])), port))
    jg = _flat(jgrads[0])
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k, **TOL)
    for name, a, b in zip(named_inputs, grads[len(named):], jgrads[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("two_inputs", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_attention_matches_flax(heads, two_inputs):
    rng = np.random.default_rng(heads)
    b, lq, lk, d, qkv = 5, 7, 4 if two_inputs else 7, 6, 16
    xq = rng.standard_normal((b, lq, d)).astype(np.float32)
    xkv = rng.standard_normal((b, lk, d)).astype(np.float32)
    m = fnn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=qkv, deterministic=True)
    params = _perturbed(m.init(jax.random.key(heads), xq, xkv)["params"], heads)
    port = MultiHeadDotProductAttention(d, heads, qkv, device="cpu")
    load_flax_params(port, params)
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        "query.kernel": (d, heads, qkv // heads), "query.bias": (heads, qkv // heads),
        "key.kernel": (d, heads, qkv // heads), "key.bias": (heads, qkv // heads),
        "value.kernel": (d, heads, qkv // heads), "value.bias": (heads, qkv // heads),
        "out.kernel": (heads, qkv // heads, d), "out.bias": (d,)}
    back = _flat(flax_from_state_dict(port.state_dict(), port))
    assert back.keys() == _flat(params).keys()
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if two_inputs:
        _grads_match(port, ["inputs_q", "inputs_kv"],
                     lambda p, q, kv: m.apply({"params": p}, q, kv), params, [xq, xkv],
                     (b, lq, d), seed=3)
    else:
        _grads_match(port, ["inputs_q"], lambda p, q: m.apply({"params": p}, q), params, [xq],
                     (b, lq, d), seed=3)
        with torch.no_grad():  # layer(x) is layer(x, x)
            x = torch.from_numpy(xq)
            assert torch.equal(port(x), port(x, x))


@pytest.mark.parametrize("n_in", [8, 5])
def test_gru_cell_matches_flax(n_in):
    rng = np.random.default_rng(n_in)
    n, f = 11, 8
    h = rng.standard_normal((n, f)).astype(np.float32)
    x = rng.standard_normal((n, n_in)).astype(np.float32)
    m = fnn.GRUCell(features=f)
    params = _perturbed(m.init(jax.random.key(n_in), h, x)["params"], n_in)
    port = GRUCell(n_in, f, device="cpu")
    load_flax_params(port, params)
    sd = port.state_dict()
    assert sorted(sd) == ["hn.bias", "hn.weight", "hr.weight", "hz.weight", "in.bias",
                          "in.weight", "ir.bias", "ir.weight", "iz.bias", "iz.weight"]
    np.testing.assert_array_equal(sd["in.weight"].numpy(), params["in"]["kernel"].T)
    with torch.no_grad():
        new_h, out = port(torch.from_numpy(h), torch.from_numpy(x))
    assert torch.equal(new_h, out)
    _grads_match(port, ["carry", "inputs"], lambda p, c, i: m.apply({"params": p}, c, i)[0],
                 params, [h, x], (n, f), seed=4)


def test_layers_draw_at_flax_scales():
    """The port's own init (not flax's draws) at flax's scales: lecun
    normal kernels, orthogonal recurrent kernels, zero biases."""
    g = torch.Generator().manual_seed(0)
    attn = MultiHeadDotProductAttention(64, 2, 64, device="cpu", generator=g)
    assert abs(float(attn.query.kernel.detach().std()) - 64 ** -0.5) < 0.01
    assert abs(float(attn.out.kernel.detach().std()) - 64 ** -0.5) < 0.01
    assert not attn.query.bias.any() and not attn.out.bias.any()
    gru = GRUCell(32, 16, device="cpu", generator=g)
    w = gru.hr.weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(16), atol=1e-5)
    assert not gru.ir.bias.any() and not gru.hn.bias.any()

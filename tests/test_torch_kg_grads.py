"""The ten knowledge models' losses and gradients against the JAX
package, on the CPU.

On `test_torch_kg_models.py`'s seeded graph and split, each model at
embedding 8 with its flax params bridged into the port gives JAX's loss
and the gradient of every parameter to 1e-5 (dropout 0; CFKG with both
losses, KGCN with each aggregator, KGAT over two layers). KGIN's JAX
gradient is NaN (`jnp.linalg.norm` differentiated at a zero row), so its
JAX side takes `finite_l2norm`, the same values with a zero gradient
there; `test_jax_kgin_gradient_is_nan` holds the fault.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict  # noqa: E402

from tests.test_torch_kg_models import CASES, TOL, _batch, _both, _flat, _tb  # noqa: E402


def finite_l2norm(x, axis=-1):
    """The JAX module's `_l2norm` with the same values and a zero gradient
    through the norm of a zero row (torch's `vector_norm` gives 0 there;
    `jnp.linalg.norm` gives NaN, ROADMAP.md §3)."""
    zero = jnp.all(x == 0, axis=axis, keepdims=True)
    norm = jnp.linalg.norm(jnp.where(zero, 1.0, x), axis=axis, keepdims=True)
    return x / jnp.maximum(jnp.where(zero, 0.0, norm), 1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case, monkeypatch):
    """KGIN's rows of users without interactions and of entities without
    triples aggregate to 0; there JAX's gradient is NaN, so the JAX side
    takes `finite_l2norm` (`test_jax_kgin_gradient_is_nan` holds the
    fault)."""
    if case == "KGIN":
        monkeypatch.setattr("oovrec_tpu.models.knowledge.more3._l2norm", finite_l2norm)
    batch = _batch(seed=2)
    jm, params, je, port = _both(case, batch, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jm.apply({"params": p}, jb, je, method=jm.calculate_loss,
                        rngs={"dropout": jax.random.key(5)})

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    port.train()
    named = list(port.named_parameters())
    loss = port.calculate_loss(_tb(batch))
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    pg = _flat(flax_from_state_dict({n: torch.zeros_like(p) if g is None else g
                                     for (n, p), g in zip(named, grads)}, port))
    jg = _flat(jgrads)
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k, **TOL)


def test_jax_kgin_gradient_is_nan():
    """The JAX fault: KGIN's `_l2norm` differentiates `jnp.linalg.norm` at
    a zero row (the PAD user, an entity without triples), which gives NaN
    for every parameter upstream of it, so the JAX model's first step
    makes its parameters NaN. The port's gradient is finite."""
    batch = _batch(seed=2)
    jm, params, je, port = _both("KGIN", batch, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jb, je,
                                                 method=jm.calculate_loss)))(params)
    assert np.isnan(np.asarray(jgrads["disen_weight_att"])).all()
    port.train()
    port.calculate_loss(_tb(batch)).backward()
    assert all(torch.isfinite(p.grad).all() for p in port.parameters())

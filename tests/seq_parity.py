"""Shared checks of a port sequential model against its flax original.

A JAX model (`oovrec_tpu/models/sequential/`) is initialised from a seed
at a small width (embedding 8, L 5, dropout 0), its biases and its
zero-initialised leaves moved off 0, and its params cross into the port
through `utils/jax_params.py`. The batch has every length from 0 (all
padding) to L and its last row at weight 0. The checks, each to 1e-5:
the outputs (`predict`, `full_sort_scores` and `seq_output` or
`forward`), the loss and the gradient of every parameter (`jax.grad`
against autograd), the bridge both ways unchanged, and a batch of
all-padding rows finite and equal to JAX's. A model with an `estate`
(the packed item features `seq_feat_tokens`) gets the arrays in JAX's
calls and as its constructor's buffers in the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oovrec_tpu.models import get_model_class as jax_model_class
from oovrec_tpu_torch.data.transform import InverseItemSequence
from oovrec_tpu_torch.models import get_model_class
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params

TOL = dict(rtol=1e-5, atol=1e-5)
N_USERS, N_ITEMS, D, L = 9, 13, 8, 5
LENGTHS = [0, 1, 2, 3, 4, 5, 5, 3]  # every length, two full rows
SMALL = dict(embedding_size=D, max_seq_length=L)
# the zero-initialised raw leaves and tables, moved off 0 with the biases
MOVED = {"bias", "b_g", "global_lambda", "global_t", "item_bias", "user_lambda"}
DROPOUT_SEED = 5  # the JAX loss's dropout stream
SEQ_CFG = {"MAX_ITEM_LIST_LENGTH": L, "ITEM_ID_FIELD": "item_id", "LIST_SUFFIX": "_list",
           "ITEM_LIST_LENGTH_FIELD": "item_length"}


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def make_batch(seed=0, inverse=False, presampled=False):
    """A numpy batch: sequences (0 after each length), the target, a
    negative, the click label, the user and the weights (the last row 0);
    `Inverse_item_id_list` (the port's transform) and DIEN's
    `neg_item_id_list` where asked."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    lengths = np.array(LENGTHS, np.int64)
    pad = np.arange(L)[None, :] >= lengths[:, None]
    seq = rng.integers(1, N_ITEMS, (B, L))
    seq[pad] = 0
    batch = {"user_id": rng.integers(1, N_USERS, B), "item_id": rng.integers(1, N_ITEMS, B),
             "neg_item_id": rng.integers(1, N_ITEMS, B), "item_id_list": seq,
             "item_length": lengths, "label": (rng.random(B) < 0.5).astype(np.float32),
             "weight": np.r_[np.ones(B - 1), 0.0].astype(np.float32)}
    if presampled:
        neg = rng.integers(1, N_ITEMS, (B, L))
        neg[pad] = 0
        batch["neg_item_id_list"] = neg
    if inverse:
        batch = InverseItemSequence(SEQ_CFG)(batch)
    return batch


def _est(estate):
    """JAX's trailing `estate` argument: none unless the model has one."""
    return () if estate is None else ({k: jnp.asarray(v) for k, v in estate.items()},)


def both(name, kw, batch, seed=0, estate=None):
    """(JAX model, its params with the biases and zero leaves moved off 0,
    the port's model holding those params and `estate` as buffers)."""
    jm = jax_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, **SMALL, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)}, jb,
                     *_est(estate), method=jm.calculate_loss)["params"]
    rng = np.random.default_rng(seed + 7)

    def move(path, v):
        keys = {getattr(p, "key", None) for p in path}
        shift = rng.standard_normal(v.shape).astype(np.float32) * 0.1
        return np.asarray(v) + (shift if keys & MOVED else 0)

    params = jax.tree_util.tree_map_with_path(move, params)
    port = get_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, device="cpu", **SMALL, **kw,
                                 **(estate or {}))
    load_flax_params(port, params)
    return jm, params, port


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_out(jm, params, batch, method, estate=None):
    return np.asarray(jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
                               *_est(estate), method=getattr(jm, method)))


def outputs_match(name, kw, batch, methods=("predict", "full_sort_scores", "seq_output"),
                  seed=0, setup=None, estate=None):
    jm, params, port = both(name, kw, batch, seed, estate)
    if setup is not None:
        setup(port)
    port.eval()
    with torch.no_grad():
        for method in methods:
            got = getattr(port, method)(to_torch(batch)).numpy()
            want = jax_out(jm, params, batch, method, estate)
            assert np.isfinite(got).all(), method
            np.testing.assert_allclose(got, want, err_msg=method, **TOL)
    return port


def loss_and_gradients_match(name, kw, batch, seed=1, jax_batch=None, setup=None, estate=None,
                             port_loss=None):
    """The loss and its gradients; JAX's loss over `jax_batch` where given
    (the port's over `batch`), with the dropout key 5; the port's loss is
    `port_loss(port, JAX's model, its params, the torch batch)` where
    given (S3Rec's on JAX's own draws), else `calculate_loss`."""
    jax_batch = batch if jax_batch is None else jax_batch
    jm, params, port = both(name, kw, jax_batch, seed, estate)
    if setup is not None:
        setup(port)
    jb = {k: jnp.asarray(v) for k, v in jax_batch.items()}

    def jloss(p):
        return jm.apply({"params": p}, jb, *_est(estate), method=jm.calculate_loss,
                        rngs={"dropout": jax.random.key(DROPOUT_SEED)})

    want, jgrads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
    port.train()
    named = list(port.named_parameters())
    tb = to_torch(batch)
    loss = port.calculate_loss(tb) if port_loss is None else port_loss(port, jm, params, tb)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    pg = flat(flax_from_state_dict({n: torch.zeros_like(p) if g is None else g
                                    for (n, p), g in zip(named, grads)}, port))
    jg = flat(jgrads)
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k, **TOL)
    return port


def bridge_round_trips(name, kw, batch, estate=None):
    _, params, port = both(name, kw, batch, estate=estate)
    back = flat(flax_from_state_dict(port.state_dict(), port))
    want = flat(params)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    again = get_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, device="cpu", **SMALL, **kw,
                                  **(estate or {}))
    load_flax_params(again, flax_from_state_dict(port.state_dict(), port))
    for k, v in port.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def all_padding(batch):
    out = dict(batch)
    for k in ("item_id_list", "item_length", "Inverse_item_id_list", "neg_item_id_list"):
        if k in out:
            out[k] = np.zeros_like(out[k])
    return out


def cases(models):
    """pytest params over a {case: (model name, kwargs)} table."""
    return [pytest.param(name, kw, id=case) for case, (name, kw) in sorted(models.items())]

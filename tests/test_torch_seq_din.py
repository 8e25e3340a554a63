"""DIN and DIEN (`models/sequential/din.py`) against flax.

At embedding 8, L 5, dropout 0 (`tests/seq_parity.py`), attention MLP
(6, 5), click MLP (8, 4): the outputs (`forward`, `predict`, the full
sort), the BCE loss and every gradient to 1e-5, the bridge both ways
(`att_<i>`, `att_out`, `mlp_layers`, `predict_layer`, DIEN's scanned
`interest_gru`), an all-padding batch finite and equal to JAX's. DIEN's
loss with the presampled `neg_item_id_list`, and with the draws on the
device: the port's draws (a fixed draw with collisions) bumped as
`din.py:185-188` bumps them give JAX's loss and gradients over the same
negatives. The full sort over blocks of 1, 3 and 13 targets equals the
JAX vmap over all 13.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from oovrec_tpu_torch.models.layers import RandomDraws, set_dropout_generator  # noqa: E402
from tests import seq_parity as sp  # noqa: E402

SMALL = dict(mlp_hidden_size=(8, 4), att_hidden=(6, 5))
MODELS = {
    "DIN": ("DIN", SMALL),
    "DIEN": ("DIEN", SMALL),
    "DIEN-alpha": ("DIEN", dict(SMALL, alpha=0.5)),
}
METHODS = ("forward", "predict", "full_sort_scores")


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_outputs_match_flax(name, kw):
    sp.outputs_match(name, kw, sp.make_batch(presampled=True), METHODS)


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_loss_and_gradients_match_flax(name, kw):
    """DIN's BCE; DIEN's with the auxiliary loss over the presampled
    negatives."""
    sp.loss_and_gradients_match(name, kw, sp.make_batch(seed=1, presampled=True))


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_bridge_round_trips(name, kw):
    sp.bridge_round_trips(name, kw, sp.make_batch(presampled=True))


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_all_padding_rows_match_flax(name, kw):
    sp.outputs_match(name, kw, sp.all_padding(sp.make_batch(seed=2, presampled=True)), METHODS)


@pytest.mark.parametrize("targets", [1, 3, 13])
@pytest.mark.parametrize("name", ["DIN", "DIEN"])
def test_blocked_full_sort_equals_the_vmap(name, targets):
    B, L = len(sp.LENGTHS), sp.L
    per_target = B * L * 4 * sp.D

    def blocks(port):
        port.full_sort_elems = targets * per_target

    sp.outputs_match(name, SMALL, sp.make_batch(seed=3), ("full_sort_scores",), setup=blocks)


def test_dien_draws_on_device_are_bumped_as_jax_bumps_them(monkeypatch):
    """The port's draw (fixed here, colliding with the sequence at every
    third position) after the bump equals what JAX's loss sees when given
    the bumped draw as its presampled list: the loss and every gradient."""
    batch = sp.make_batch(seed=4)
    seq = batch["item_id_list"]
    rng = np.random.default_rng(9)
    draw = rng.integers(1, sp.N_ITEMS, seq.shape)
    collide = (np.arange(seq.size).reshape(seq.shape) % 3 == 0) & (seq > 0)
    draw[collide] = seq[collide]
    bumped = np.where(draw == seq, draw % (sp.N_ITEMS - 1) + 1, draw)
    assert (bumped != seq)[seq > 0].all() and collide.sum() > 5
    calls = []

    def fixed(self, low, high, shape, device):
        assert self.generator is not None and (low, high) == (1, sp.N_ITEMS)
        calls.append(tuple(shape))
        return torch.from_numpy(draw)

    monkeypatch.setattr(RandomDraws, "randint", fixed)
    sp.loss_and_gradients_match(
        "DIEN", SMALL, batch, jax_batch=dict(batch, neg_item_id_list=bumped),
        setup=lambda port: set_dropout_generator(port, torch.Generator().manual_seed(0)))
    assert calls == [seq.shape]


def test_dien_draws_from_the_dropout_generator():
    """Without a generator the train-mode draw refuses; with one, two
    steps from the same seed give the same loss and the draws land in
    [1, n_items)."""
    batch = sp.to_torch(sp.make_batch(seed=5))
    _, _, port = sp.both("DIEN", SMALL, sp.make_batch(seed=5))
    port.train()
    with pytest.raises(RuntimeError, match="generator"):
        port.calculate_loss(batch)
    losses = []
    for _ in range(2):
        set_dropout_generator(port, torch.Generator().manual_seed(3))
        losses.append(port.calculate_loss(batch).item())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    g = torch.Generator().manual_seed(3)
    neg = RandomDraws.randint(type("R", (), {"generator": g})(), 1, sp.N_ITEMS, (64, 5), "cpu")
    assert neg.min() >= 1 and neg.max() < sp.N_ITEMS

"""HGN, FOSSIL, TransRec (`more2.py`), SHAN, NPE, HRM, CORE (`more3.py`),
SRGNN, GCSAN, LightSANs and SINE (`more4.py`) against flax.

At embedding 8, L 5, dropout 0 (`tests/seq_parity.py`): the outputs
(`seq_output`, `predict`, the full sort), the loss (CE, TransRec's BPR)
and every gradient to 1e-5, the bridge both ways (the raw leaves `b_g`,
`w4_kernel`, `global_lambda`, `global_t`, `item_bias`, `prototypes`;
SRGNN's compact `gnn` children `Dense_0`, `Dense_1`, `GRUCell_0`;
GCSAN's `attn_block`), and an all-padding batch finite and equal to
JAX's. Both pool types of HGN, the four pooling pairs of HRM, both
`dnn_type`s of CORE, SRGNN at 1 and 2 steps, LightSANs at 2 layers, SINE
with a tie at its threshold, and SHAN reading `Inverse_item_id_list`
and deriving the same items by index, to the same outputs.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from tests import seq_parity as sp  # noqa: E402

MODELS = {
    "HGN": ("HGN", {}),
    "HGN-max": ("HGN", dict(pool_type="max")),
    "FOSSIL": ("FOSSIL", {}),
    "FOSSIL-order2": ("FOSSIL", dict(order_len=2, alpha=0.3)),
    "TransRec": ("TransRec", {}),
    "SHAN": ("SHAN", {}),
    "SHAN-K3": ("SHAN", dict(short_item_length=3)),
    "NPE": ("NPE", dict(dropout_prob=0.0)),
    "CORE": ("CORE", {}),
    "CORE-trm": ("CORE", dict(dnn_type="trm")),
    "SRGNN": ("SRGNN", {}),
    "SRGNN-2steps": ("SRGNN", dict(step=2)),
    "GCSAN": ("GCSAN", dict(inner_size=16)),
    "GCSAN-2heads": ("GCSAN", dict(inner_size=16, n_heads=2, blend_weight=0.3)),
    "LightSANs": ("LightSANs", dict(k_interests=3, dropout_prob=0.0)),
    "LightSANs-2layers": ("LightSANs", dict(n_layers=2, k_interests=2, dropout_prob=0.0)),
    "SINE": ("SINE", dict(prototype_size=4)),
    "SINE-3": ("SINE", dict(prototype_size=5, interest_size=3, tau=0.5)),
    **{f"HRM-{a}-{b}": ("HRM", dict(pooling_type_layer_1=a, pooling_type_layer_2=b,
                                    dropout_prob=0.0))
       for a in ("avg", "max") for b in ("avg", "max")},
    "HRM-order3": ("HRM", dict(high_order=3, dropout_prob=0.0)),
}


def _methods(name):
    """TransRec scores pairs and has no `seq_output`, in either package."""
    methods = ("predict", "full_sort_scores", "seq_output")
    return methods[:2] if name == "TransRec" else methods


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_outputs_match_flax(name, kw):
    sp.outputs_match(name, kw, sp.make_batch(), _methods(name))


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_loss_and_gradients_match_flax(name, kw):
    sp.loss_and_gradients_match(name, kw, sp.make_batch(seed=1))


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_bridge_round_trips(name, kw):
    sp.bridge_round_trips(name, kw, sp.make_batch())


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_all_padding_rows_match_flax(name, kw):
    sp.outputs_match(name, kw, sp.all_padding(sp.make_batch(seed=2)), _methods(name))


@pytest.mark.parametrize("K", [2, 3])
def test_shan_reads_the_inverse_list_or_derives_it(K):
    """With `Inverse_item_id_list` in the batch (the `inverse_itemseq`
    transform) SHAN reads its tail; without, it derives the same items by
    index: JAX's outputs, loss and gradients either way, and the two
    paths equal."""
    kw = dict(short_item_length=K)
    inv, plain = sp.make_batch(seed=6, inverse=True), sp.make_batch(seed=6)
    assert "Inverse_item_id_list" in inv
    ports = [sp.outputs_match("SHAN", kw, b) for b in (inv, plain)]
    sp.loss_and_gradients_match("SHAN", kw, inv, seed=2)
    with torch.no_grad():
        a = ports[0].full_sort_scores(sp.to_torch(inv))
        b = ports[0].full_sort_scores(sp.to_torch(plain))
    assert torch.equal(a, b)


def test_sine_gates_every_tie_at_its_threshold():
    """Ties at the `interest_size`-th similarity all pass the gate
    (`su >= thresh`); two equal prototypes tie for every row, and the
    outputs still equal JAX's."""
    from oovrec_tpu_torch.utils.jax_params import load_flax_params

    kw = dict(prototype_size=4, interest_size=1)
    batch = sp.make_batch(seed=7)
    jm, params, port = sp.both("SINE", kw, batch)
    su = torch.tensor([[1.0, 1.0, 0.5, 0.2], [0.3, 0.9, 0.9, 0.9]])
    gate = port.gate(su)
    assert (gate > 0).tolist() == [[True, True, False, False], [False, True, True, True]]
    protos = np.asarray(params["prototypes"]).copy()
    protos[1] = protos[0]
    params = dict(params, prototypes=protos)
    load_flax_params(port, params)
    port.eval()
    with torch.no_grad():
        got = port.seq_output(sp.to_torch(batch)).numpy()
    np.testing.assert_allclose(got, sp.jax_out(jm, params, batch, "seq_output"), **sp.TOL)

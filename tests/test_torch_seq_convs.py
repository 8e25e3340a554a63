"""Caser and NextItNet (`models/sequential/convs.py`) against flax.

At embedding 8, L 5, dropout 0 (`tests/seq_parity.py`): the outputs, the
loss and every gradient to 1e-5, the bridge both ways (the conv kernels
in flax's layout: `hconv_<h>`, `v_conv`, `block_<i>` with `LayerNorm_0`,
`Conv_0`, `LayerNorm_1`, `Conv_1`), and an all-padding batch finite and
equal to JAX's. Caser at heights (2, 3, 4) and (1, 5) (a window as long
as the sequence), NextItNet at dilations (1, 4) and (2,) with kernel 2.
The convolutions as products equal `torch.nn.functional.conv2d` /
`conv1d` on the same kernels.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from tests import seq_parity as sp  # noqa: E402

MODELS = {
    "Caser": ("Caser", dict(n_h=3, n_v=2, dropout_prob=0.0)),
    "Caser-heights": ("Caser", dict(n_h=2, n_v=3, heights=(1, 5), dropout_prob=0.0)),
    "NextItNet": ("NextItNet", {}),
    "NextItNet-k2": ("NextItNet", dict(block_dilations=(2,), kernel_size=2)),
}


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_outputs_match_flax(name, kw):
    sp.outputs_match(name, kw, sp.make_batch())


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_loss_and_gradients_match_flax(name, kw):
    sp.loss_and_gradients_match(name, kw, sp.make_batch(seed=1))


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_bridge_round_trips(name, kw):
    sp.bridge_round_trips(name, kw, sp.make_batch())


@pytest.mark.parametrize("name,kw", sp.cases(MODELS))
def test_all_padding_rows_match_flax(name, kw):
    sp.outputs_match(name, kw, sp.all_padding(sp.make_batch(seed=2)))


def test_convs_as_products_equal_torch_convs():
    """Caser's horizontal and vertical convs and NextItNet's causal
    dilated conv against torch's convolutions on the same kernels."""
    from oovrec_tpu_torch.models.sequential.convs import DilatedBlock, windows

    g = torch.Generator().manual_seed(0)
    E = torch.randn(4, 7, 6, generator=g, dtype=torch.float64)
    K = torch.randn(3, 6, 1, 5, generator=g, dtype=torch.float64)  # flax (h, D, 1, n_h)
    got = windows(E, 3, 1, 5) @ K.reshape(18, 5)
    want = torch.nn.functional.conv2d(E[:, None], K[:, :, 0].permute(2, 0, 1)[:, None])
    np.testing.assert_allclose(got.numpy(), want[:, :, :, 0].permute(0, 2, 1).numpy(),
                               rtol=1e-12)
    Kv = torch.randn(7, 1, 1, 2, generator=g, dtype=torch.float64)  # (L, 1, 1, n_v)
    got = torch.einsum("bld,lc->bdc", E, Kv[:, 0, 0]).reshape(4, -1)
    want = torch.nn.functional.conv2d(E[:, None], Kv[:, :, 0].permute(2, 0, 1)[:, None, :, :])
    np.testing.assert_allclose(got.numpy(), want[:, :, 0].permute(0, 2, 1).reshape(4, -1).numpy(),
                               rtol=1e-12)
    blk = DilatedBlock(6, 2, 3, device="cpu").double()
    with torch.no_grad():
        blk.Conv_0.bias.normal_(generator=g)
    got = blk._causal(blk.Conv_0, E, 2)
    want = torch.nn.functional.conv1d(torch.nn.functional.pad(E.transpose(1, 2), (4, 0)),
                                      blk.Conv_0.kernel.permute(2, 1, 0), blk.Conv_0.bias,
                                      dilation=2).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-12)

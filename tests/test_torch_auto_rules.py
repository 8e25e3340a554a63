"""The `auto` rules of the port's kernels, on the CPU.

`fused_cin: auto` (xDeepFM, `models/context_aware/xdeepfm.py:fused_cin_rule`)
and `use_fused_topk: auto` (both evaluators, `eval/runner.py:fused_topk_rule`)
take the kernel on the card and the plain path elsewhere. On the card the
kernels take every width the model gives them: a CIN layer wider than one
launch goes through several (`ops/cin_fused.py:fwd_plan` / `bwd_plan`), a
large k or a deep tower through a wider k class or a streamed user tile
(`ops/topk_score.py:k_class` / `stream_users`). `True` forces the kernel
wrapper. The rules are plain functions of the device type and the flag, so
these tests reach the card's branch with the device type "cuda" and no card.
"""

import numpy as np
import pytest
import torch

from oovrec_tpu_torch.eval.runner import fused_topk_rule
from oovrec_tpu_torch.models import FieldSpec, xDeepFM
from oovrec_tpu_torch.models.context_aware import xdeepfm as xdeepfm_module
from oovrec_tpu_torch.models.context_aware.xdeepfm import fused_cin_rule
from oovrec_tpu_torch.ops import cin_fused
from oovrec_tpu_torch.ops.topk_score import K_CLASSES, k_class, kernel_smem_bytes, stream_users

# seven token fields, as the serving track's CTR layout has seven fields
FIELDS = FieldSpec(token_names=("user_id", "item_id", "a", "b", "c", "d", "e"),
                   token_dims=(30, 25, 4, 5, 6, 7, 8))
PUBLISHED = dict(embedding_size=10, cin_layer_size=(100, 100, 100))


def _model(fused_cin="auto", seed=0, **widths):
    kw = {**PUBLISHED, **widths}
    return xDeepFM(FIELDS, mlp_hidden_size=(16,), dropout_prob=0.0, fused_cin=fused_cin,
                   device="cpu", generator=torch.Generator().manual_seed(seed), **kw)


def _batch(B=9, seed=1):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.integers(0, d, B))
            for n, d in zip(FIELDS.token_names, FIELDS.token_dims)}


@pytest.fixture
def on_the_card(monkeypatch):
    """The model decides as it would on the card: its rule sees "cuda";
    the kernel wrapper it reaches runs its plain version on the CPU and is
    counted here."""
    rule = xdeepfm_module.fused_cin_rule
    monkeypatch.setattr(xdeepfm_module, "fused_cin_rule",
                        lambda flag, _device: rule(flag, "cuda"))
    calls = []
    wrapper = xdeepfm_module.cin_layer_pooled

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return wrapper(*args, **kw)

    monkeypatch.setattr(xdeepfm_module, "cin_layer_pooled", counted)
    return calls


@pytest.mark.parametrize("B", [8192, 37, 1])
def test_published_widths_take_the_kernel_to_serve_and_to_train(B):
    """One launch a layer each way at the published widths."""
    shapes = _model().cin_layer_shapes(B)
    assert shapes == [(B, 7, 7, 10, 100), (B, 50, 7, 10, 100), (B, 50, 7, 10, 100)]
    assert fused_cin_rule("auto", "cuda")
    for shape in shapes:
        assert cin_fused.fwd_plan(*shape) == ((0, 10),)
        assert cin_fused.bwd_plan(*shape) == (((0, 100),), ((0, 10),))


def test_cin_layer_size_200_trains_and_serves_on_the_kernel():
    """L = 200: the forward takes it in one launch (two column passes), the
    backward in two column groups."""
    shapes = _model(cin_layer_size=(200, 200, 200)).cin_layer_shapes(8192)
    assert [s[4] for s in shapes] == [200, 200, 200]
    with pytest.raises(ValueError, match="L=200"):
        cin_fused.bwd_geometry(*shapes[1])     # one launch does not take it
    for shape in shapes:
        assert cin_fused.fwd_plan(*shape) == ((0, 10),)
        assert cin_fused.fwd_geometry(*shape).passes == 2
        assert cin_fused.bwd_plan(*shape) == (((0, 100), (100, 200)), ((0, 10),))


def test_embedding_size_200_takes_the_kernel_in_spans_of_d():
    shapes = _model(embedding_size=200).cin_layer_shapes(8192)
    with pytest.raises(ValueError, match="D=200"):
        cin_fused.fwd_geometry(*shapes[0])     # one launch does not take it
    for shape in shapes:
        assert cin_fused.fwd_plan(*shape) == ((0, 100), (100, 200))
        assert cin_fused.bwd_plan(*shape) == (((0, 100),), ((0, 100), (100, 200)))


def test_auto_never_takes_a_kernel_on_the_cpu():
    for device in ("cpu", "mps"):
        assert not fused_cin_rule("auto", device)
        assert not fused_topk_rule("auto", device, True, 1_000_000)
    model = _model()
    x = torch.zeros((4, 7, 10))
    assert not model._use_fused_cin(x)
    with torch.no_grad():
        assert not model._use_fused_cin(x)


@pytest.mark.parametrize("widths", [dict(), dict(embedding_size=200),
                                    dict(cin_layer_size=(200, 200, 200))],
                         ids=["published", "D200", "L200"])
def test_true_routes_through_the_kernel_wrapper_whatever_the_shapes(on_the_card, widths):
    assert fused_cin_rule(True, "cuda") and fused_cin_rule("true", "cpu")
    assert not fused_cin_rule(False, "cuda") and not fused_cin_rule("false", "cuda")
    model = _model(fused_cin=True, **widths)
    model.eval()
    out = model.predict(_batch())
    assert len(on_the_card) == 3 and torch.isfinite(out).all()


def _auto_vs_plain(widths, grad):
    """(auto output, fused_cin=False output) of one model's weights."""
    auto = _model(**widths)
    plain = _model(fused_cin=False, **widths)
    plain.load_state_dict(auto.state_dict())
    auto.eval()
    plain.eval()
    with torch.set_grad_enabled(grad):
        return auto(_batch()), plain(_batch())


@pytest.mark.parametrize("widths", [dict(), dict(embedding_size=200),
                                    dict(cin_layer_size=(200, 200, 200))],
                         ids=["published", "D200", "L200"])
@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
def test_every_width_takes_the_kernel_wrapper_through_auto(on_the_card, widths, grad):
    got, want = _auto_vs_plain(widths, grad)
    assert len(on_the_card) == 3
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_use_fused_topk_auto_takes_the_kernel_at_any_k_class():
    assert fused_topk_rule("auto", "cuda", True, 1_000_000)
    # k = 20 at D = 64: the 32-list class with the user tile whole; k = 600
    # needs the 1024-list class; a deep tower streams the user tile
    assert k_class(20, 64) == 0 and not stream_users(0, 64)
    assert k_class(600, 64) == 3 and not stream_users(3, 64)
    assert k_class(20, 2048) == 0 and stream_users(0, 2048)
    assert k_class(1024, 5000) == 3 and stream_users(3, 5000)
    assert all(kernel_smem_bytes(c, 10**6, True) <= 232448 for c in range(len(K_CLASSES)))
    with pytest.raises(ValueError, match="k=1025"):
        k_class(1025, 64)
    # the rest of the rule: small corpora, other models, the flag
    assert not fused_topk_rule("auto", "cuda", True, 99_999)
    assert not fused_topk_rule("auto", "cuda", False, 1_000_000)
    assert not fused_topk_rule(False, "cuda", True, 1_000_000)
    assert fused_topk_rule(True, "cpu", True, 10)
    assert not fused_topk_rule(True, "cuda", False, 1_000_000)

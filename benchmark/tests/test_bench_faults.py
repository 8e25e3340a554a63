"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have, and so does each cell's control (the
reference in a lower precision in the program's place). On the CPU at tiny
sizes, past the harness's look for a card; the TF32 controls only change
anything on the card."""

import pytest
import torch

from benchmark.harness import main
from benchmark.tests.conftest import run_tiny

TRAIN = ["bpr-d64-1m.train-pairs", "xdeepfm-ml1m.train-oov"]
EVAL = "bpr-d64-1m.eval-7slice"


def _model_class(name):
    if name.startswith("bpr"):
        from oovrec_tpu_torch.models.bpr import BPR
        return BPR
    from oovrec_tpu_torch.models.context_aware.xdeepfm import xDeepFM
    return xDeepFM


# the number that reads a step's or a stage's change, by how the cell's
# reference follows the program (`follow` of its mix)
CHANGE = {"bpr-d64-1m.train-pairs": "change", "xdeepfm-ml1m.train-oov": "step"}


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_keeps_its_state(monkeypatch, name):
    from oovrec_tpu_torch.train.trainer import Trainer

    def no_update(self, batch, trainable=None, count=None):
        return self.model.calculate_loss(batch).detach()

    monkeypatch.setattr(Trainer, "_apply_step", no_update)
    _, out, line = run_tiny(name)
    assert not line["correct"]
    key = CHANGE[name]
    assert out["checks"][f"iv.{key}"] > 0.9 and out["checks"][f"oov.{key}"] > 0.9


@pytest.mark.parametrize("name", TRAIN)
def test_a_simulation_that_masks_nothing(monkeypatch, name):
    from oovrec_tpu_torch.inductive.transform import OOVSimulator

    init = OOVSimulator.__init__

    def unmasked(self, *args, **kw):
        init(self, *args, **kw)
        self.mask_rate = 0.0

    monkeypatch.setattr(OOVSimulator, "__init__", unmasked)
    _, out, line = run_tiny(name)
    assert not line["correct"] and out["checks"]["oov.mask_share"] > 0.9


@pytest.mark.parametrize("name", TRAIN)
def test_an_oov_sub_epoch_that_keeps_every_step(monkeypatch, name):
    from oovrec_tpu_torch.train.trainer import Trainer

    init = Trainer.__init__

    def keep_all(self, *args, **kw):
        init(self, *args, **kw)
        self.oov_train_ratio = 1.0

    monkeypatch.setattr(Trainer, "__init__", keep_all)
    _, out, line = run_tiny(name)
    assert not line["correct"] and out["checks"]["oov.keep_share"] > 1.5


def test_negatives_drawn_without_the_used_pair_check(monkeypatch):
    from oovrec_tpu_torch.train.device_epoch import DeviceEpoch

    monkeypatch.setattr(DeviceEpoch, "sample_negs",
                        lambda self, gen, users: self.draw(gen, users.shape))
    _, out, line = run_tiny("bpr-d64-1m.train-pairs")
    assert not line["correct"] and out["checks"]["neg_used"] > 1e-3


def test_a_feature_altered_where_the_simulation_produces_it(monkeypatch):
    from oovrec_tpu_torch.inductive.transform import OOVSimulator

    call = OOVSimulator.__call__

    def altered(self, batch):
        out = call(self, batch)
        if "gender" in out:
            g = out["gender"]
            out["gender"] = g.where(g == 0, 3 - g) if hasattr(g, "where") else \
                (g != 0) * (3 - g)
        return out

    monkeypatch.setattr(OOVSimulator, "__call__", altered)
    _, out, line = run_tiny("xdeepfm-ml1m.train-oov")
    assert not line["correct"] and out["checks"]["oov.features_off"] >= 1


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(monkeypatch, name):
    cls = _model_class(name)
    loss = cls.calculate_loss

    def halved(self, batch):
        w = batch["weight"].clone()
        w[w.shape[0] // 2:] = 0
        return loss(self, dict(batch, weight=w))

    monkeypatch.setattr(cls, "calculate_loss", halved)
    _, _, line = run_tiny(name)
    assert not line["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_loss_altered_where_it_is_produced(monkeypatch, name):
    from oovrec_tpu_torch.train.cuda_graph import StepGraphs

    step = StepGraphs.step
    monkeypatch.setattr(StepGraphs, "step", lambda self, b, t=None: step(self, b, t) * 1.01)
    _, out, line = run_tiny(name)
    assert not line["correct"] and out["checks"]["iv.loss"] > 1e-3


def test_a_ranking_altered_where_it_is_produced(monkeypatch):
    from oovrec_tpu_torch.eval import inductive

    kernel = inductive.fused_topk_scores

    def altered(*args, **kw):
        vals, idx = kernel(*args, **kw)
        idx = idx.clone()
        idx[0, -1] = idx[0, 0]  # the first user's best item given twice
        return vals, idx

    monkeypatch.setattr(inductive, "fused_topk_scores", altered)
    _, out, line = run_tiny(EVAL)
    assert not line["correct"] and out["checks"]["topk_gap"] > 1.0


def test_a_slice_altered_where_it_is_produced(monkeypatch):
    from oovrec_tpu_torch.eval.inductive import InductiveEvaluator

    results = InductiveEvaluator._results

    def altered(self, collectors):
        out = results(self, collectors)
        out["new_users"]["recall@10"] += 1e-6
        return out

    monkeypatch.setattr(InductiveEvaluator, "_results", altered)
    _, out, line = run_tiny(EVAL)
    assert not line["correct"] and out["checks"]["slices_off"] >= 1


def test_bpr_training_control_bf16_is_not_correct():
    cell, out, _ = run_tiny("bpr-d64-1m.train-pairs", controls=("bf16",))
    assert not main.verdict(out["control_checks"]["bf16"], main.limits(cell.name))


@pytest.mark.card
@pytest.mark.parametrize("name", ["xdeepfm-ml1m.train-oov", EVAL])
def test_tf32_control_is_not_correct_on_the_card(card, name):
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, out, line = run_tiny(name, controls=("tf32",), device=card)
    assert line["correct"]
    assert not main.verdict(out["control_checks"]["tf32"], main.limits(cell.name))

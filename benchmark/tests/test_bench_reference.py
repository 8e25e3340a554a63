"""The plain reference against the port's plain CPU path, at tiny sizes."""

import numpy as np
import pytest
import torch

from benchmark.harness import models, weights
from benchmark.reference import bpr as ref_bpr
from benchmark.reference import hashes, retrieval
from benchmark.reference import xdeepfm as ref_xdeepfm
from benchmark.tests.conftest import run_tiny, tiny_cell

CPU = torch.device("cpu")


def _grads(loss, params):
    names = list(params)
    g = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(params[n]) if x is None else x for n, x in zip(names, g)}


def _simulated(batch, cfg, n_users, n_items, seed):
    from oovrec_tpu_torch.inductive.transform import OOVSimulator

    sim = OOVSimulator(models.inductive_spec(cfg), n_users, n_items,
                       cfg["port"]["oov_feature_mask_rate"], np.random.default_rng(seed))
    return sim(batch)


def _close(port_loss, ref_loss, port_g, ref_g):
    p, r = float(port_loss.detach()), float(ref_loss.detach())
    assert abs(p - r) <= 1e-6 * abs(r)
    for n in ref_g:
        assert torch.allclose(port_g[n], ref_g[n], rtol=1e-5, atol=1e-8), n


def test_hash_is_the_ports():
    from oovrec_tpu_torch.inductive.hashes import hash_ids

    ids = np.concatenate([np.arange(-5, 5000), np.array([2**40 + 3, 112062759511 + 77])])
    for n in (1, 7, 200, 1 << 16):
        assert np.array_equal(hashes.bucket_of(ids, n), hash_ids(ids, n, "3round"))


@pytest.mark.parametrize("simulated", [False, True])
def test_bpr_loss_and_gradients(simulated):
    cfg = tiny_cell("bpr-d64-1m.train-pairs").config
    c = cfg["corpus"]
    model = models.adapter(cfg).build(CPU)
    w = weights.make(models.weight_shapes(model), 5, CPU)
    weights.load_into(model, w)
    rng = np.random.default_rng(5)
    n = 512
    batch = {"user_id": rng.integers(1, c["n_old_users"], n),
             "item_id": rng.integers(1, c["n_old_items"], n),
             "neg_item_id": rng.integers(1, c["n_old_items"], n),
             "weight": (np.arange(n) < 500).astype(np.float32)}
    if simulated:
        batch = _simulated(batch, cfg, c["n_old_users"], c["n_old_items"], 5)
        assert any(k.endswith("_oov") for k in batch)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    params = dict(model.named_parameters())
    port_loss = model.calculate_loss(batch)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_loss = ref_bpr.loss(leaves, batch, models.spec_of(cfg))
    _close(port_loss, ref_loss, _grads(port_loss, params), _grads(ref_loss, leaves))


@pytest.mark.parametrize("simulated", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_xdeepfm_loss_and_gradients(simulated, fused):
    from oovrec_tpu_torch.data.dataloader import TrainBatcher
    from oovrec_tpu_torch.data.dataset import DatasetSplit
    from oovrec_tpu_torch.models.layers import set_dropout_generator
    from oovrec_tpu_torch.utils.enums import InputType

    from benchmark.harness import generate
    from benchmark.harness.kinds.train import port_config

    cell = tiny_cell("xdeepfm-ml1m.train-oov")
    cfg = cell.config
    c = cfg["corpus"]
    rows, uf, itf = generate.ctr_rows(c, 9)
    keep = (rows["user_id"] < c["n_old_users"]) & (rows["item_id"] < c["n_old_items"])
    split = DatasetSplit({k: v[keep] for k, v in rows.items()}, c["n_old_users"],
                         c["n_old_items"], user_feat=uf, item_feat=itf)
    loader = TrainBatcher(split, None, port_config(cfg, cell.traffic, 9), InputType.POINTWISE)
    batch = next(iter(loader))
    if simulated:
        batch = _simulated(batch, cfg, c["n_old_users"], c["n_old_items"], 9)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    model = models.adapter(cfg).build(CPU)
    model.fused_cin = fused  # True: the CIN kernels' plain versions
    w = weights.make(models.weight_shapes(model), 9, CPU)
    weights.load_into(model, w)
    set_dropout_generator(model, torch.Generator().manual_seed(11))
    params = dict(model.named_parameters())
    port_loss = model.calculate_loss(batch)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_loss = ref_xdeepfm.loss(leaves, batch, models.spec_of(cfg), c["schema"],
                                cfg["model_args"], torch.Generator().manual_seed(11))
    _close(port_loss, ref_loss, _grads(port_loss, params), _grads(ref_loss, leaves))


def test_topk_metrics_are_the_ports():
    from oovrec_tpu_torch.eval.metrics import TOPK_METRICS

    rng = np.random.default_rng(3)
    hits = rng.random((300, 10)) < 0.2
    pos_len = rng.integers(1, 16, 300)
    ref = retrieval.topk_metrics(hits, pos_len, [3, 10], ["hit", "recall", "mrr", "ndcg",
                                                          "precision"])
    for m in ("hit", "recall", "mrr", "ndcg", "precision"):
        per_user = TOPK_METRICS[m](hits, pos_len)
        for k in (3, 10):
            assert abs(per_user[:, k - 1].mean() - ref[f"{m}@{k}"]) < 1e-12


@pytest.mark.parametrize("name", ["bpr-d64-1m.eval-7slice", "bpr-d64-1m.train-pairs",
                                  "xdeepfm-ml1m.train-oov"])
def test_a_tiny_run_is_correct(name):
    _, out, line = run_tiny(name)
    assert line["correct"], line["checks"]
    assert out["attempted"] > 0 and line["failed"] == 0


def test_eval_gap_sees_a_masked_or_repeated_item():
    g = torch.Generator().manual_seed(0)
    u, items = torch.randn(4, 8, generator=g), torch.randn(50, 8, generator=g)
    hist = [np.array([1, 2]), np.array([], np.int64), np.array([7]), np.array([3])]
    s = u @ items.T
    for r, h in enumerate(hist):
        s[r, torch.from_numpy(h)] = -float("inf")
    answers = {}
    for v in retrieval.VARIANTS:
        a, b = retrieval.variant_range(v, 30, 50)
        answers[v] = torch.topk(s[:, a:b], 5, dim=1).indices + a
    assert retrieval.topk_gap(u, items, hist, answers, 30) == 0.0
    bad = dict(answers, old=answers["old"].clone())
    bad["old"][0, 0] = 1  # in user 0's history
    assert retrieval.topk_gap(u, items, hist, bad, 30) == float("inf")
    bad["old"][0, 0] = answers["old"][0, 1]  # given twice
    assert retrieval.topk_gap(u, items, hist, bad, 30) == float("inf")

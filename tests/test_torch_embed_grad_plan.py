"""The segment plans of `oovrec_tpu_torch/ops/embed_grad.py` on the CPU.

A plan is the sort of a fixed index vector done once (`build_plan`): its
integers against numpy (`np.argsort(kind="stable")`, `np.bincount`
cumsums, the chunk split walked position by position in
`tests/test_torch_embed_grad.py:_spans`) for random ids, one id repeated
20,000 times, empty rows, few ids into many rows (more than the card's
one-block sort holds offsets for) and an empty input, int32 and int64. The models
that own fixed edges hold plans (`IndexPlans`): LightGCN's and KGAT's
forward and every gradient with their plans equal a run without them bit
for bit, every call that takes a plan takes its ids' own (the kernel's
steps on the plan's arrays equal the plain version), `state_dict()` keys
are the same, and edges loaded through `load_state_dict` and through
`set_embedder_state` are followed by the next call; a rebuild during a
CUDA graph capture raises (the capture is stubbed: there is no card
here).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from oovrec_tpu_torch.models import get_model_class  # noqa: E402
from oovrec_tpu_torch.ops import embed_grad  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import set_embedder_state  # noqa: E402

from tests.test_torch_embed_grad import _kernel_steps, _spans  # noqa: E402
from tests.test_torch_general_graph import ESTATE, N_ITEMS, N_USERS, _split  # noqa: E402
from tests.test_torch_kg_models import (ESTATES, N_ENT, N_REL, _batch,  # noqa: E402
                                        _estate, make_split)


def _ids(case, dtype):
    rng = np.random.default_rng(3)
    n_rows = {"random": 500, "repeated": 40, "empty-rows": 1000, "few-ids-many-rows": 100_000,
              "empty": 7}[case]
    ids = {"random": lambda: rng.integers(0, n_rows, 3000),
           "repeated": lambda: np.r_[rng.integers(0, n_rows, 300), np.full(20_000, 17),
                                     rng.integers(0, n_rows, 300)],
           "empty-rows": lambda: rng.integers(200, 260, 2500) * 3,  # most rows get nothing
           "few-ids-many-rows": lambda: rng.integers(0, n_rows, 2000),
           "empty": lambda: np.zeros(0, np.int64)}[case]()
    return ids.astype(dtype), n_rows


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("case", ["random", "repeated", "empty-rows", "few-ids-many-rows",
                                  "empty"])
def test_plan_integers_match_numpy(case, dtype):
    ids, n_rows = _ids(case, dtype)
    plan = embed_grad.build_plan(torch.from_numpy(ids), n_rows)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(plan.perm.numpy(), order)
    np.testing.assert_array_equal(plan.keys.numpy(), ids[order])
    np.testing.assert_array_equal(plan.offsets.numpy(),
                                  np.r_[0, np.cumsum(np.bincount(ids, minlength=n_rows))])
    np.testing.assert_array_equal(plan.spans.numpy(),
                                  _spans(ids[order], embed_grad.PLAN_CHUNK, n_rows))
    assert not plan.counters.any()
    length = embed_grad.SegmentPlan.length(len(ids), n_rows, embed_grad.PLAN_CHUNK)
    assert plan.packed.dtype == torch.int32 and plan.packed.numel() == length
    assert plan.matches(torch.from_numpy(ids))
    if len(ids):
        assert not plan.matches(torch.from_numpy(np.roll(ids, 1)))


def test_chunk_spans_match_the_walk_with_dead_keys():
    """The discarded rows (key n_rows) sort last and make no run."""
    rng = np.random.default_rng(9)
    sk = np.sort(np.where(rng.random(5000) < 0.8, rng.integers(0, 30, 5000), 30))
    for chunk in (embed_grad.SMALL_CHUNK, embed_grad.PLAN_CHUNK):
        np.testing.assert_array_equal(embed_grad.chunk_spans(torch.from_numpy(sk), chunk,
                                                             30).numpy(),
                                      _spans(sk, chunk, 30))


def test_plan_refuses_the_wrong_call():
    ids = torch.tensor([2, 0, 2, 1])
    plan = embed_grad.build_plan(ids, 3)
    g = torch.ones((4, 2))
    with pytest.raises(ValueError, match="plan of 4 ids into 3 rows"):
        embed_grad.scatter_rows_kernel(g, ids, 4, plan=plan)
    with pytest.raises(ValueError, match="plan of 4 ids"):
        embed_grad.scatter_rows_kernel(torch.ones((3, 2)), ids[:3], 3, plan=plan)
    got = embed_grad.scatter_rows_kernel(g, ids, 3, plan=plan)
    assert got.tolist() == [[1, 1], [1, 1], [2, 2]]
    assert embed_grad.scatter_rows_kernel.launches == 0 and embed_grad.build_plan.launches == 0


def _checked_scatter(calls):
    """`scatter_rows` that holds each call with a plan: the plan is its
    ids' own, and the kernel's steps on the plan route equal the plain
    version (1e-6 of the terms' magnitudes); it returns the plain result,
    so the model's bits are those of a run without plans."""
    def scatter(g, ids, n_rows, live=None, plan=None):
        if plan is not None:
            assert plan.matches(ids) and plan.n_rows == n_rows
            gn, idn = g.detach().numpy(), ids.numpy()
            got = _kernel_steps(gn, idn, np.ones(len(idn), bool), n_rows, "plan")
            size = embed_grad.scatter_rows_plain(g.detach().abs(), ids, n_rows).numpy()
            want = embed_grad.scatter_rows_plain(g.detach(), ids, n_rows).numpy()
            assert (np.abs(got - want) <= 1e-6 * np.maximum(size, 1.0)).all()
            calls.append(n_rows)
        return embed_grad.scatter_rows_plain(g.contiguous(), ids, n_rows, live)
    return scatter


GRAPH_KW = {"LightGCN": {}, "DGCF": {"n_factors": 2}}
KG_KW = {"KGAT": {"kg_embedding_size": 6, "layers": (8, 5), "mess_dropout": 0.0},
         "KGIN": {"n_factors": 2, "mess_dropout_rate": 0.0},
         "MCCLK": {"knn_k": 3, "n_hops": 2}}
# model → the index buffers it plans
PLANNED = {"LightGCN": ("edge_src", "edge_dst"), "DGCF": ("edge_src", "edge_dst"),
           "KGAT": ("ckg_src", "ckg_dst", "ckg_rel", "ckg_src_rows", "ckg_dst_rows"),
           "KGIN": ("kgin_head", "kgin_tail", "kgin_rel", "kgin_uid", "kgin_iid"),
           "MCCLK": ("kgin_head", "kgin_tail", "kgin_rel", "kgin_uid", "kgin_iid")}


def _estate_of(name, seed=None):
    """The model's edges: the shared fixtures' (seed None) or those of
    another split of the same size."""
    if name in GRAPH_KW:
        if seed is None:
            return ESTATE
        from tests.test_torch_general_graph import jax_model_class
        return jax_model_class("LightGCN").build_estate(_split(seed=seed))
    if seed is None:
        return ESTATES[name]
    import tests.test_torch_kg_models as kg
    saved = kg.SPLIT
    kg.SPLIT = make_split(seed=seed)
    try:
        return _estate(name)
    finally:
        kg.SPLIT = saved


def _make(name, estate=None, seed=0):
    """The model on copies of its edges: a buffer built from an int32
    array shares its memory, and the tests here write into the buffers."""
    torch.manual_seed(seed)
    estate = {k: np.array(v) for k, v in (_estate_of(name) if estate is None else estate).items()}
    if name in GRAPH_KW:
        return get_model_class(name)(N_USERS, N_ITEMS, embedding_size=8, device="cpu",
                                     **GRAPH_KW[name], **estate)
    return get_model_class(name)(N_USERS, 20, embedding_size=8, device="cpu", n_entities=N_ENT,
                                 n_relations=N_REL, **KG_KW[name], **estate)


def _batch_of(name):
    if name in GRAPH_KW:
        rng = np.random.default_rng(1)
        return {"user_id": torch.from_numpy(rng.integers(1, N_USERS, 9)),
                "item_id": torch.from_numpy(rng.integers(0, N_ITEMS, 9)),
                "neg_item_id": torch.from_numpy(rng.integers(0, N_ITEMS, 9))}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()}


def _run(model, batch):
    """(loss, predict, every parameter's gradient)."""
    model.train()
    params = [p for _, p in model.named_parameters()]
    loss = model.calculate_loss(batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    with torch.no_grad():
        pred = model.predict(batch)
    return [loss.detach(), pred] + [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(params, grads)]


@pytest.mark.parametrize("name", sorted(PLANNED))
def test_plans_keep_the_bits(name, monkeypatch):
    model, batch = _make(name), _batch_of(name)
    assert set(model._plan_specs) == set(PLANNED[name])
    calls = []
    monkeypatch.setattr(embed_grad, "scatter_rows", _checked_scatter(calls))
    with_plans = _run(model, batch)
    assert len(calls) > 0  # the fixed edges' sums and gathers took their plans
    n_calls = len(calls)
    monkeypatch.setattr(type(model), "planned", lambda self, key: (getattr(self, key), None))
    without = _run(model, batch)
    assert len(calls) == n_calls
    for got, want in zip(with_plans, without):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(PLANNED))
def test_state_dict_keeps_its_keys(name):
    model = _make(name)
    params = {n for n, _ in model.named_parameters()}
    assert set(model.state_dict()) - params == set(_estate_of(name))
    buffers = dict(model.named_buffers())
    assert all(f"{k}_plan" in buffers for k in PLANNED[name])


def _fresh(model, name):
    for key in PLANNED[name]:
        ids, plan = model.planned(key)
        assert plan.matches(ids), key


@pytest.mark.parametrize("how", ["load_state_dict", "set_embedder_state"])
@pytest.mark.parametrize("name", ["KGAT", "LightGCN"])
def test_plans_follow_loaded_edges(name, how, monkeypatch):
    other = _estate_of(name, seed=11)
    a, b = _make(name), _make(name, estate=other, seed=1)
    assert all(getattr(a, k).shape == getattr(b, k).shape for k in other)
    assert any(not torch.equal(getattr(a, k), getattr(b, k)) for k in other)
    builds = []
    real = embed_grad.build_plan
    monkeypatch.setattr(embed_grad, "build_plan", lambda ids, n: builds.append(n) or real(ids, n))
    if how == "load_state_dict":
        a.load_state_dict(b.state_dict())
    else:  # the weights alone, then the edges as a JAX checkpoint's estate
        a.load_state_dict({k: v for k, v in b.state_dict().items() if k not in other},
                          strict=False)
        assert not builds
        set_embedder_state(a, other)
    n_builds = len(builds)
    assert n_builds > 0
    _fresh(a, name)
    batch = _batch_of(name)
    for got, want in zip(_run(a, batch), _run(b, batch)):
        assert torch.equal(got, want)
    a.to("cpu")
    a.load_state_dict(b.state_dict())  # the same edges again: checked, not rebuilt
    assert len(builds) == n_builds
    _fresh(a, name)


def test_edges_written_in_place_are_followed():
    model = _make("LightGCN")
    other = _estate_of("LightGCN", seed=11)
    with torch.no_grad():
        model.edge_dst.copy_(torch.from_numpy(other["edge_dst"]))
    ids, plan = model.planned("edge_dst")
    assert plan.matches(ids) and torch.equal(ids, torch.from_numpy(other["edge_dst"]))


def test_a_rebuild_during_a_capture_raises(monkeypatch):
    model = _make("LightGCN")
    other = _estate_of("LightGCN", seed=11)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    ids, plan = model.planned("edge_src")  # fresh: no rebuild, no raise
    assert plan.matches(ids)
    with torch.no_grad():
        model.edge_src.copy_(torch.from_numpy(other["edge_src"]))
    with pytest.raises(RuntimeError, match="capture"):
        model.planned("edge_src")
    with pytest.raises(RuntimeError, match="capture"):
        model.load_state_dict(model.state_dict())
    with pytest.raises(RuntimeError, match="capture"):
        embed_grad.build_plan(ids, model.n_nodes)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    ids, plan = model.planned("edge_src")
    assert plan.matches(ids) and torch.equal(ids, torch.from_numpy(other["edge_src"]))

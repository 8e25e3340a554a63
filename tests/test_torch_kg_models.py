"""The ten knowledge models against the JAX package, on the CPU.

On a seeded graph (30 users, 20 items, 45 entities, 5 relations plus
[PAD] and [UI-Relation]; 120 triples with a self-loop and a repeated
triple) and a split of 150 interactions, the JAX `build_estate` gives
the states (`test_torch_kg_data.py` holds the port's own against them).
Each model, at embedding 8 with its flax params bridged into the port,
gives JAX's `predict` and `full_sort_scores` to 1e-5 (CFKG with both
losses, KGCN with each aggregator, KGAT over two layers), and its tree is
flax's (`test_torch_kg_grads.py` holds the losses and gradients). The blocked full sorts of KGCN,
KGNNLS, KTUP and RippleNet, at the default budget, one item a block and
three, and MKR's hoisted one equal JAX's vmap and the per-pair
definition. KGAT's per-relation projection table equals the per-edge
projections. MCCLK's kNN graph equals JAX's on the test's rows, exact ties
with the k-th similarity kept (more than k a row); on these data no
near-tie crosses the threshold by rounding (the supports are equal). A
JAX `estate` loads into the port's state buffers, and the registry holds
the JAX package's 87 names.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu_torch.models import get_model_class  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N_USERS, N_ITEMS, N_ENT, N_REL, D = 30, 20, 45, 7, 8


def make_split(seed=4, n=150, n_triples=120):
    """A training split over a seeded graph: ids from 1 (0 pads), the
    last item never drawn."""
    rng = np.random.default_rng(seed)
    inter = {"user_id": rng.integers(1, N_USERS, n), "item_id": rng.integers(1, N_ITEMS - 1, n)}
    heads = np.where(rng.random(n_triples) < 0.7, rng.integers(1, N_ITEMS, n_triples),
                     rng.integers(1, N_ENT, n_triples))
    tails = rng.integers(1, N_ENT, n_triples)
    rels = rng.integers(1, N_REL - 1, n_triples)
    heads[-1] = tails[-1] = 5
    heads[1], rels[1], tails[1] = heads[0], rels[0], tails[0]
    parent = types.SimpleNamespace(kg_triples=(heads, rels, tails), entity_num=N_ENT,
                                   relation_num=N_REL, user_num=N_USERS)
    from oovrec_tpu.data.dataset import DatasetSplit as JaxSplit

    split = types.SimpleNamespace(inter=inter, uid_field="user_id", iid_field="item_id",
                                  user_num=N_USERS, item_num=N_ITEMS, parent=parent)
    split.used_ids_per_user = types.MethodType(JaxSplit.used_ids_per_user, split)
    return split


SPLIT = make_split()
# case → (model, constructor keywords, build_estate keywords)
CASES = {
    "CKE": ("CKE", {"kg_embedding_size": 6}, {}),
    "CFKG": ("CFKG", {}, {}),
    "CFKG-transe": ("CFKG", {"loss_function": "transe"}, {}),
    "KGAT": ("KGAT", {"kg_embedding_size": 6, "layers": (8, 5), "mess_dropout": 0.0}, {}),
    "KGCN": ("KGCN", {"neighbor_sample_size": 3, "n_iter": 2}, {"neighbor_sample_size": 3}),
    "KGCN-concat": ("KGCN", {"aggregator": "concat"}, {}),
    "KGCN-neighbor": ("KGCN", {"aggregator": "neighbor", "n_iter": 2}, {}),
    "KGNNLS": ("KGNNLS", {"neighbor_sample_size": 3}, {"neighbor_sample_size": 3}),
    "MKR": ("MKR", {"low_layers_num": 2}, {}),
    "KTUP": ("KTUP", {}, {}),
    "RippleNet": ("RippleNet", {"n_memory": 4}, {"n_memory": 4}),
    "KGIN": ("KGIN", {"n_factors": 2, "mess_dropout_rate": 0.0}, {}),
    "MCCLK": ("MCCLK", {"knn_k": 3, "n_hops": 2}, {}),
}
BLOCKED = ("KGCN", "KGCN-concat", "KGNNLS", "KTUP", "RippleNet")


def _estate(case):
    name, _, kw = CASES[case]
    cls = jax_model_class(name)
    return cls.build_estate(SPLIT, **kw) if hasattr(cls, "build_estate") else {}


ESTATES = {case: _estate(case) for case in CASES}


def _batch(seed=1, B=9):
    rng = np.random.default_rng(seed)
    heads, rels, tails = SPLIT.parent.kg_triples
    pick = rng.integers(0, len(heads), B)
    batch = {"user_id": rng.integers(1, N_USERS, B), "item_id": rng.integers(0, N_ITEMS, B),
             "neg_item_id": rng.integers(0, N_ITEMS, B),
             "label": (rng.random(B) < 0.5).astype(np.float32),
             "weight": np.r_[np.ones(B - 1), 0.0].astype(np.float32),
             "kg_head": heads[pick], "kg_relation": rels[pick], "kg_pos_tail": tails[pick],
             "kg_neg_tail": rng.integers(1, N_ENT, B), "kg_weight": np.ones(B, np.float32)}
    batch["user_id"][-1] = batch["item_id"][-1] = 0
    return batch


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _both(case, batch, seed=0):
    """(JAX model, its params with every leaf moved a little (the zero
    biases off 0), its estate, the port's model holding them)."""
    name, kw, _ = CASES[case]
    sizes = dict(n_entities=N_ENT, n_relations=N_REL)
    jm = jax_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, embedding_size=D, **sizes, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    je = {k: jnp.asarray(v) for k, v in ESTATES[case].items()}
    params = jm.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)}, jb, je,
                     method=jm.calculate_loss)["params"]
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32)
                              * 0.1), params)
    port = get_model_class(name)(N_USERS, N_ITEMS, embedding_size=D, device="cpu", **sizes,
                                 **kw, **ESTATES[case])
    load_flax_params(port, params)
    return jm, params, je, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_match_jax(case):
    batch = _batch()
    jm, params, je, port = _both(case, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    port.eval()
    with torch.no_grad():
        for method in ("predict", "full_sort_scores"):
            want = np.asarray(jm.apply({"params": params}, jb, je, method=getattr(jm, method)))
            got = getattr(port, method)(_tb(batch)).numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, err_msg=method, **TOL)
    assert _flat(flax_from_state_dict(port.state_dict(), port)).keys() == _flat(params).keys()


def _per_pair(port, batch):
    """(B, n_items) from the per-pair definition, every pair in one call."""
    users = _tb(batch)["user_id"]
    items = torch.arange(N_ITEMS)
    return port._score(users.repeat_interleave(N_ITEMS), items.repeat(len(users))).reshape(
        len(users), N_ITEMS)


@pytest.mark.parametrize("case", BLOCKED + ("MKR",))
def test_blocked_full_sort_matches_the_vmap(case, monkeypatch):
    """One block at the default budget, then one item a block, then three
    (the last block short): each equals JAX's vmap, and so does the
    per-pair definition. MKR's towers run once a call (no blocks)."""
    batch = _batch(seed=3)
    jm, params, je, port = _both(case, batch, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jm.apply({"params": params}, jb, je, method=jm.full_sort_scores))
    port.eval()
    import oovrec_tpu_torch.models.base as base

    blocks, sizes, budgets = base.score_item_blocks, [], [base.FULL_SORT_ELEMS]

    def counted(n, per_item, device, score, budget=base.FULL_SORT_ELEMS):
        sizes.append((per_item, max(1, budgets[-1] // per_item)))
        return blocks(n, per_item, device, score, budget=budgets[-1])

    for module in ("more", "more2"):
        monkeypatch.setattr(f"oovrec_tpu_torch.models.knowledge.{module}.score_item_blocks",
                            counted)
    with torch.no_grad():
        got = [port.full_sort_scores(_tb(batch))]
        if case != "MKR":
            budgets.append(1)
            got.append(port.full_sort_scores(_tb(batch)))
            budgets.append(3 * sizes[0][0])
            got.append(port.full_sort_scores(_tb(batch)))
        pairs = _per_pair(port, batch)
    assert [t for _, t in sizes][1:] == ([] if case == "MKR" else [1, 3])
    assert case == "MKR" or sizes[0][1] >= N_ITEMS, sizes
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, **TOL)
    np.testing.assert_allclose(pairs.numpy(), want, **TOL)


def test_kgat_projection_table_is_the_per_edge_projection():
    """Row r·N + v of `_projections` is W_r e_v: the (E, D, K) per-edge
    products of the JAX model, read at (rel, src) and (rel, dst)."""
    _, _, _, port = _both("KGAT", _batch())
    e = port.node_embedding.weight.detach()
    n, R, K = port.n_nodes, N_REL, 6
    with torch.no_grad():
        table = port._projections(e)
        W = port.trans_w.reshape(R, D, K)[port.ckg_rel.long()]
        for ids in (port.ckg_src, port.ckg_dst):
            per_edge = torch.einsum("ed,edk->ek", e[ids.long()], W)
            got = table[port.ckg_rel.long() * n + ids.long()]
            torch.testing.assert_close(got, per_edge, rtol=1e-6, atol=1e-6)


def test_mcclk_knn_graph_matches_jax():
    """The kNN graph (top-k, then `sim >= kth`): on the test's structural
    rows the supports are JAX's (no near-tie crosses the threshold by
    rounding here); rows with exact ties (duplicated entities) keep every
    tie with the k-th, more than k a row, as JAX's does."""
    from oovrec_tpu.models.knowledge.more3 import MCCLK as JaxMCCLK

    jm, params, je, port = _both("MCCLK", _batch())
    with torch.no_grad():
        rows = port._structural_items()
        rng = np.random.default_rng(3)
        dup = rows.clone()
        dup[5:9] = dup[4]  # ties: five equal rows
        for x in (rows, dup, torch.from_numpy(rng.standard_normal((30, D)).astype(np.float32))):
            got = port.semantic_adjacency(x)
            want = np.asarray(jm.apply({"params": params}, jnp.asarray(x.numpy()),
                                       method=JaxMCCLK._semantic_items))
            np.testing.assert_array_equal(got.numpy() != 0, _jax_support(x.numpy(), 3))
            np.testing.assert_allclose((got @ x).numpy(), want, **TOL)
        assert ((port.semantic_adjacency(dup) != 0).sum(dim=1)[4:9] == 5).all()


def _jax_support(x, k):
    """JAX's kNN support: `sim >= top_k(sim)[k-th]`, on JAX's own sims."""
    xn = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    sim = jnp.asarray(xn) @ jnp.asarray(xn).T
    kth = jax.lax.top_k(sim, k)[0][:, -1][:, None]
    return np.asarray(sim >= kth)


def test_registry_holds_every_jax_model():
    """With every family imported, the port's registry and the JAX
    package's hold the same 87 names."""
    import oovrec_tpu.models.context_aware  # noqa: F401
    import oovrec_tpu.models.general  # noqa: F401
    import oovrec_tpu.models.knowledge  # noqa: F401
    import oovrec_tpu.models.sequential  # noqa: F401
    from oovrec_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from oovrec_tpu_torch.models import MODEL_REGISTRY

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY) and len(MODEL_REGISTRY) == 87


@pytest.mark.parametrize("case", ["KGAT", "KGCN", "RippleNet", "KGIN"])
def test_jax_estate_loads_into_the_buffers(case):
    """A JAX `estate` (KGAT's collaborative graph, KGCN's neighbours,
    RippleNet's numbered ripple sets, KGIN's edges) loads into the port's
    buffers of those names (`set_embedder_state`), which the bridge and
    `load_params` leave alone."""
    from oovrec_tpu_torch.models.base import load_params
    from oovrec_tpu_torch.utils.jax_params import is_model_state, set_embedder_state

    name, kw, _ = CASES[case]
    estate = ESTATES[case]
    port = get_model_class(name)(N_USERS, N_ITEMS, embedding_size=D, device="cpu",
                                 n_entities=N_ENT, n_relations=N_REL, **kw, **estate)
    blank = get_model_class(name)(N_USERS, N_ITEMS, embedding_size=D, device="cpu",
                                  n_entities=N_ENT, n_relations=N_REL, **kw,
                                  **{k: np.zeros_like(v) for k, v in estate.items()})
    set_embedder_state(blank, estate)
    own = dict(blank.named_buffers())
    assert set(estate) <= set(own) and all(is_model_state(k) for k in estate)
    for k, v in estate.items():
        np.testing.assert_array_equal(own[k].numpy(), v, err_msg=k)
    assert not set(estate) & set(flax_from_state_dict(port.state_dict(), port))
    load_params(blank, port.state_dict())  # the states are the model's own, not loaded
    for k, v in estate.items():
        np.testing.assert_array_equal(dict(blank.named_buffers())[k].numpy(), v, err_msg=k)

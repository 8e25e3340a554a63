"""The port's OOV hashing, routing, weight bridge and BPR serving methods
against the JAX package.

Hashes, buckets and RNG streams must be bit-exact. Embeddings and scores of
the port's BPR with bridged weights must equal flax BPR's to atol 1e-6 on
a batch that mixes IV and OOV users and items.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.inductive import hashes as jax_hashes  # noqa: E402
from oovrec_tpu.inductive.mapper import RandomOOVMapper as JaxMapper  # noqa: E402
from oovrec_tpu.inductive.routing import route as jax_route  # noqa: E402
from oovrec_tpu.inductive.spec import InductiveSpec as JaxSpec  # noqa: E402
from oovrec_tpu.models.bpr import BPR as JaxBPR  # noqa: E402
from oovrec_tpu.utils import seeding as jax_seeding  # noqa: E402
from oovrec_tpu_torch.inductive import hashes  # noqa: E402
from oovrec_tpu_torch.inductive.mapper import RandomOOVMapper  # noqa: E402
from oovrec_tpu_torch.inductive.routing import route  # noqa: E402
from oovrec_tpu_torch.inductive.spec import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.models import BPR, get_model_class  # noqa: E402
from oovrec_tpu_torch.models.init import xavier_normal_  # noqa: E402
from oovrec_tpu_torch.utils import seeding  # noqa: E402
from oovrec_tpu_torch.utils.device import resolve_device  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)

N_USERS, N_ITEMS, DIM = 23, 31, 8
SPEC_ARGS = dict(mapper="random", add_oov_buckets=True,
                 n_user_buckets=13, n_item_buckets=11, embedding_size=DIM)


@pytest.mark.parametrize("fn", hashes.HASH_FUNCTIONS)
def test_hashes_bit_exact(fn):
    rng = np.random.default_rng(0)
    ids = np.concatenate([
        np.arange(-50, 200),
        rng.integers(-2**62, 2**62, size=2000),
        np.array([2**63 - 1, -2**63, 112062759511, 112062759511 + 10**6]),
    ]).astype(np.int64)
    for n_buckets in (1, 7, 100, 2**31 - 1):
        got = hashes.hash_ids(ids, n_buckets, fn)
        want = jax_hashes.hash_ids(ids, n_buckets, fn)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all() and (got < n_buckets).all()


def test_mapper_buckets_match_jax():
    ids = np.arange(0, 400, dtype=np.int64)
    port = RandomOOVMapper(InductiveSpec(**SPEC_ARGS), N_USERS, N_ITEMS, 300, 400)
    ref = JaxMapper(JaxSpec(**SPEC_ARGS), N_USERS, N_ITEMS, 300, 400)
    for m in (port, ref):
        m.set_eval()
    np.testing.assert_array_equal(port.user_buckets(ids), ref.user_buckets(ids))
    np.testing.assert_array_equal(port.item_buckets(ids), ref.item_buckets(ids))
    np.testing.assert_array_equal(port.map_user_ids(ids), ref.map_user_ids(ids))
    pb, rb = {"user_id": ids, "item_id": ids[::-1]}, {"user_id": ids, "item_id": ids[::-1]}
    port.annotate(pb, "user_id", "item_id")
    ref.annotate(rb, "user_id", "item_id")
    for key in rb:
        np.testing.assert_array_equal(pb[key], rb[key], err_msg=key)


def test_host_rng_streams_bit_identical():
    for tag in ("perturbed_hits", "negative_sampler", ""):
        assert seeding._stable_hash32(tag) == jax_seeding._stable_hash32(tag)
        a, b = seeding.host_rng(2020, tag), jax_seeding.host_rng(2020, tag)
        np.testing.assert_array_equal(a.permutation(1000), b.permutation(1000))
    g1, g2 = seeding.torch_generator(5), seeding.torch_generator(5)
    assert torch.equal(torch.randn(4, generator=g1), torch.randn(4, generator=g2))


def _flax_bpr():
    model = JaxBPR(n_users=N_USERS, n_items=N_ITEMS, embedding_size=DIM,
                   spec=JaxSpec(**SPEC_ARGS))
    B = 4
    tmpl = {f: np.zeros(B, np.int32) for f in ("user_id", "item_id", "neg_item_id")}
    tmpl["weight"] = np.ones(B, np.float32)
    for f in ("user_id", "item_id", "neg_item_id"):
        tmpl[f + "_oov"] = np.zeros(B, np.int32)
        tmpl[f + "_bucket"] = np.zeros(B, np.int32)
    variables = model.init(jax.random.key(0), tmpl, {}, method=model.calculate_loss)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, variables, params


def _port_bpr(params):
    model = BPR(N_USERS, N_ITEMS, DIM, InductiveSpec(**SPEC_ARGS), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return model


def test_weight_bridge_round_trip():
    _, _, params = _flax_bpr()
    sd = state_dict_from_flax(params)
    assert set(sd) == {
        "user_embedding.weight", "item_embedding.weight",
        "user_oov_buckets.weight", "item_oov_buckets.weight",
    }
    model = _port_bpr(params)
    assert set(model.state_dict()) == set(sd)
    back = flax_from_state_dict(model.state_dict())
    assert set(back) == set(params)
    for name, leaves in params.items():
        np.testing.assert_array_equal(back[name]["embedding"], leaves["embedding"])
    with pytest.raises(ValueError):
        state_dict_from_flax({"mlp": {"kernel": np.zeros((2, 2))}})


def test_bpr_serving_matches_flax():
    jmodel, variables, params = _flax_bpr()
    model = _port_bpr(params)
    assert get_model_class("BPR") is BPR

    mapper = RandomOOVMapper(InductiveSpec(**SPEC_ARGS), N_USERS, N_ITEMS, 60, 70)
    mapper.set_eval()
    user_ids = np.array([1, 3, N_USERS + 2, N_USERS + 30, 2, N_USERS + 7], np.int64)
    item_ids = np.array([2, N_ITEMS + 1, 4, N_ITEMS + 33, N_ITEMS + 5, 1], np.int64)
    batch = mapper.annotate({"user_id": user_ids, "item_id": item_ids},
                            "user_id", "item_id")
    jbatch = {k: jnp.asarray(np.asarray(v, np.int32)) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    all_ids = np.arange(70, dtype=np.int64)
    all_b = np.where(all_ids >= N_ITEMS, mapper.item_buckets(all_ids), 0)
    j_items = jmodel.apply(variables, jnp.asarray(all_ids, jnp.int32),
                           jnp.asarray(all_b, jnp.int32), {}, None,
                           method=jmodel.all_item_embeddings)
    with torch.no_grad():
        t_items = model.all_item_embeddings(
            torch.from_numpy(all_ids), torch.from_numpy(all_b))
        pairs = [
            (model.user_tower(tbatch),
             jmodel.apply(variables, jbatch, {}, method=jmodel.user_tower)),
            (t_items, j_items),
            (model.score_against(tbatch, t_items),
             jmodel.apply(variables, jbatch, j_items, {}, method=jmodel.score_against)),
            (model.predict(tbatch),
             jmodel.apply(variables, jbatch, {}, method=jmodel.predict)),
            (model.full_sort_scores(tbatch),
             jmodel.apply(variables, jbatch, {}, method=jmodel.full_sort_scores)),
            (model.item_tower(),
             jmodel.apply(variables, method=jmodel.item_tower)),
        ]
    for got, want in pairs:
        np.testing.assert_allclose(
            got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the batch really mixes IV and OOV rows on both sides
    assert 0 < batch["user_id_oov"].sum() < len(user_ids)
    assert 0 < batch["item_id_oov"].sum() < len(item_ids)


@pytest.mark.parametrize("embedder", [None, "zero", "mean"])
def test_route_matches_jax(embedder):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((10, 3)).astype(np.float32)
    bucket_t = rng.standard_normal((4, 3)).astype(np.float32)
    args = dict(mapper="random" if embedder is None else None,
                embedder=embedder, add_oov_buckets=embedder is None,
                n_user_buckets=4, n_item_buckets=4)
    ids = np.array([1, 2, 3, 12, 0])
    flags = np.array([0, 1, 0, 0, 1])
    bks = np.array([0, 2, 0, 1, 3])
    want = jax_route(JaxSpec(**args), "user", jnp.asarray(ids), jnp.asarray(flags),
                     jnp.asarray(bks), jnp.asarray(table), jnp.asarray(bucket_t), {})
    got = route(InductiveSpec(**args), "user", torch.from_numpy(ids),
                torch.from_numpy(flags), torch.from_numpy(bks),
                torch.from_numpy(table), torch.from_numpy(bucket_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_later_embedders_raise():
    spec = InductiveSpec(embedder="lsh")
    table = torch.zeros((5, 2))
    with pytest.raises(NotImplementedError, match="later slice"):
        route(spec, "user", torch.tensor([7]), None, None, table, torch.zeros((3, 2)))


def test_xavier_scale_and_explicit_device():
    w = torch.empty(4000, 64)
    xavier_normal_(w, seeding.torch_generator(0))
    assert abs(float(w.std()) - (2.0 / (4000 + 64)) ** 0.5) < 1e-3
    assert resolve_device("cpu").type == "cpu"


def test_cuda_requested_and_absent_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BPR(5, 5, 4, device="cuda")

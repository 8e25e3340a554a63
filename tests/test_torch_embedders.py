"""The port's inductive layer against the JAX package's, on the CPU.

  * `inductive/factory.py`: the feature matrix under each normalization
    (toy-ind, toy-ind with discretized (value, bucket) pairs, synth-ind
    with its float_seq `*_vector` columns, and synth-ind's `_ind` corpus),
    the embedder state (LSH planes, knn neighbors, DHE keys) and the knn
    search chunked and whole, bit for bit against
    `oovrec_tpu.inductive.factory`;
  * `ops/siphash.py` against `siphash24_batch` and `siphash24_py`, and the
    int64 `ops/siphash_device.py:dhe_codes_device` against the JAX uint32
    one, with ids above 2^31 and with the sign bit set, bit for bit;
  * `inductive/dhe.py`: key files crossing between the two `DHEHasher`s
    both ways, `annotate_batch` with padded ids, host and on-card hashing;
  * `inductive/routing.py:route` for each of the nine embedders against
    the JAX `route`, from the same state and bridged tower weights, to
    1e-6, and its gradients to 1e-5;
  * `EmbedderMLP` and the embedder state across the weight bridge.
"""

import copy
import functools
import json
import os
import secrets

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.dataset import Dataset as JaxDataset  # noqa: E402
from oovrec_tpu.inductive import factory as jax_factory  # noqa: E402
from oovrec_tpu.inductive.dhe import DHEHasher as JaxHasher  # noqa: E402
from oovrec_tpu.inductive.routing import route as jax_route  # noqa: E402
from oovrec_tpu.inductive.spec import InductiveSpec as JaxSpec  # noqa: E402
from oovrec_tpu.models.base import EmbedderMLP as JaxMLP  # noqa: E402
from oovrec_tpu.ops import siphash as jax_siphash  # noqa: E402
from oovrec_tpu.ops.siphash_device import dhe_codes_device as jax_dhe_codes  # noqa: E402
from oovrec_tpu.ops.siphash_device import split_ids, split_keys  # noqa: E402
from oovrec_tpu_torch.cli.inductive_eval import create_ind_dataset  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.dataset import Dataset  # noqa: E402
from oovrec_tpu_torch.inductive import factory  # noqa: E402
from oovrec_tpu_torch.inductive.dhe import DHEHasher  # noqa: E402
from oovrec_tpu_torch.inductive.routing import route  # noqa: E402
from oovrec_tpu_torch.inductive.spec import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.models import BPR  # noqa: E402
from oovrec_tpu_torch.models.base import EmbedderMLP, dhe_hashes_for  # noqa: E402
from oovrec_tpu_torch.ops import siphash  # noqa: E402
from oovrec_tpu_torch.ops.siphash_device import dhe_codes_device  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    embedder_state_to_numpy,
    flax_from_state_dict,
    load_flax_params,
    set_embedder_state,
)

from tests.test_torch_dataset import DATASET_CASES, SYNTH, SYNTH_LOAD_COL  # noqa: E402

NORMS = ("per-feature", "global", "none")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these tiny shapes run fastest on one thread:
    several test workers each spreading a 512-element GELU over every core
    spend milliseconds a call on the thread pool alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

FEATURE_CASES = ("toy_rs_ro_user", "toy_discretized_dedup", "synth_all_columns")
IDS = np.array([0, 1, 7, 2**31 - 1, 2**31, 2**32 + 5, 112062759511 + 3, 2**62, -1,
                -(2**63)], np.int64)


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages keep a module-global feature cache per mode; each test
    starts from an empty one and leaves one."""
    factory._global_cache = factory.InductiveFeatureCache("unset")
    jax_factory._global_cache = jax_factory.InductiveFeatureCache("unset")
    yield
    factory._global_cache = factory.InductiveFeatureCache("unset")
    jax_factory._global_cache = jax_factory.InductiveFeatureCache("unset")


def _datasets(cfg):
    """The port's and the JAX package's dataset for `cfg`, built once per
    module (the state builders only read them)."""
    return _built(json.dumps(cfg, sort_keys=True))


@functools.lru_cache(maxsize=None)
def _built(key):
    cfg = json.loads(key)
    return (Dataset(Config(copy.deepcopy(cfg))),
            JaxDataset(JaxConfig(config_dict=copy.deepcopy(cfg))))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("case", FEATURE_CASES)
def test_feature_matrix_matches_jax(case, norm):
    port, jds = _datasets(DATASET_CASES[case])
    for side in ("user", "item"):
        id_field = port.uid_field if side == "user" else port.iid_field
        got = factory.build_feature_matrix(getattr(port, f"{side}_feat"), id_field, norm)
        want = jax_factory.build_feature_matrix(getattr(jds, f"{side}_feat"), id_field, norm)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"{case} {side}")
    if case == "synth_all_columns":  # the 4-wide *_vector blocks are in
        assert got.shape[1] >= 5
    with pytest.raises(ValueError, match="normalization"):
        factory.build_feature_matrix(port.user_feat, port.uid_field, "row")


def test_inductive_feature_matrix_matches_jax():
    """Over the `_ind` corpus, vocabularies reconciled to training."""
    from oovrec_tpu.cli.inductive_eval import create_ind_dataset as jax_create_ind

    cfg = dict(SYNTH, load_col=None, numerical_features=["age", "price"])
    port_orig, jax_orig = _datasets(cfg)
    _, port = create_ind_dataset(Config(copy.deepcopy(cfg)), port_orig)
    _, jds = jax_create_ind(JaxConfig(config_dict=copy.deepcopy(cfg)), jax_orig)
    port.remap_features()
    jds.remap_features()
    for side, fid in (("user", port.uid_field), ("item", port.iid_field)):
        got = factory.build_feature_matrix(getattr(port, f"{side}_feat"), fid)
        want = jax_factory.build_feature_matrix(getattr(jds, f"{side}_feat"), fid)
        np.testing.assert_array_equal(got, want, err_msg=side)
        assert got.shape[0] > getattr(port_orig, f"{side}_num") or side == "item"


@pytest.mark.parametrize("embedder", ["lsh", "slsh", "knn", "dnn", "fdhe", "dhe"])
@pytest.mark.parametrize("mode", ["transductive", "inductive"])
def test_embedder_state_matches_jax(embedder, mode, tmp_path):
    cfg = dict(SYNTH, load_col=dict(SYNTH_LOAD_COL, user=SYNTH_LOAD_COL["user"] + ["user_vector"],
                                     item=SYNTH_LOAD_COL["item"] + ["item_vector"]))
    port, jds = _datasets(cfg)
    kw = dict(embedder=embedder, add_oov_buckets=True, n_user_buckets=200,
              n_item_buckets=13, dhe_num_hashes=8, knn_neighbors=3)
    n_u, n_i = port.user_num - 5, port.item_num - 3
    got = factory.build_embedder_state(InductiveSpec(**kw), port, n_u, n_i, mode=mode, seed=9,
                                       hash_key_dir=str(tmp_path))
    want = jax_factory.build_embedder_state(JaxSpec(**kw), jds, n_u, n_i, mode=mode, seed=9,
                                            hash_key_dir=str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if embedder in ("lsh", "slsh"):
        assert got["user_planes"].shape[0] == (200 if embedder == "lsh" else 8)


@pytest.mark.parametrize("second", ["other normalization", "other dataset"])
def test_feature_cache_keyed_by_tables(second):
    """Two state builds in one process and one mode, the second on another
    normalization or dataset, each get the matrices of their own tables
    (a cache keyed by mode alone gave the second the first's)."""
    toy, _ = _datasets(DATASET_CASES["toy_rs_ro_user"])
    synth, _ = _datasets(DATASET_CASES["synth_all_columns"])
    first = dict(embedder="dnn", add_oov_buckets=True, n_user_buckets=4, n_item_buckets=4)
    ds, norm = (toy, "global") if second == "other normalization" else (synth, "per-feature")
    factory.build_embedder_state(InductiveSpec(**first), toy, 1, 1)
    got = factory.build_embedder_state(InductiveSpec(**first, normalization_type=norm), ds, 1, 1)
    for side, fid in (("user", ds.uid_field), ("item", ds.iid_field)):
        want = factory.build_feature_matrix(getattr(ds, f"{side}_feat"), fid, norm)
        np.testing.assert_array_equal(got[f"{side}_feat_mat"], want, err_msg=side)


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("chunk_rows", [None, 1, 7, 64])
def test_knn_neighbors_chunked_match_jax(chunk_rows, exclude_self):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((150, 6)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    feats[40] = feats[41]  # a tie
    corpus = feats[:90]
    want = jax_factory.exact_knn_neighbors(feats, corpus, 4, exclude_self)
    got = factory.exact_knn_neighbors(feats, corpus, 4, exclude_self, chunk_rows=chunk_rows)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert not (got == 0).any()


def _keys(n):
    return siphash.keys_to_u64([secrets.token_bytes(16) for _ in range(n)])


def test_numpy_siphash_matches_jax_and_oracle():
    keys = _keys(16)
    msgs = IDS.astype(np.uint64)
    got = siphash.siphash24_batch(msgs, keys)
    np.testing.assert_array_equal(got, jax_siphash.siphash24_batch(msgs, keys))
    np.testing.assert_array_equal(siphash.keys_to_u64([b"\x01" * 16]),
                                  jax_siphash.keys_to_u64([b"\x01" * 16]))
    for i in (0, 3, 8):
        for j in (0, 15):
            kb = int(keys[j, 0]).to_bytes(8, "little") + int(keys[j, 1]).to_bytes(8, "little")
            mb = int(msgs[i]).to_bytes(8, "little")
            assert siphash.siphash24_py(kb, mb) == jax_siphash.siphash24_py(kb, mb)
            assert int.from_bytes(siphash.siphash24_py(kb, mb), "little") == int(got[i, j])
    assert siphash.siphash24_py(b"k" * 16, b"abc") == jax_siphash.siphash24_py(b"k" * 16, b"abc")


def test_device_siphash_matches_jax():
    keys = _keys(32)
    ids = np.concatenate([IDS, np.random.default_rng(1).integers(-2**63, 2**63 - 1, 200)])
    got = dhe_codes_device(torch.from_numpy(ids), torch.from_numpy(keys.view(np.int64)))
    lo, hi = split_ids(ids)
    want = jax_dhe_codes(jnp.asarray(lo), jnp.asarray(hi), split_keys(keys))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host = (siphash.siphash24_batch(ids.astype(np.uint64), keys) % np.uint64(2**24))
    np.testing.assert_array_equal(got.numpy(), host.astype(np.float32))


def test_key_files_cross_both_ways(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    jh = JaxHasher(8, str(a))
    assert os.path.isfile(a / "8.hashes")
    np.testing.assert_array_equal(DHEHasher(8, str(a)).keys, jh.keys)
    ph = DHEHasher(12, str(b))
    np.testing.assert_array_equal(JaxHasher(12, str(b)).keys, ph.keys)
    np.testing.assert_array_equal(ph.hash_ids(IDS), JaxHasher(12, str(b)).hash_ids(IDS))


def test_annotate_batch_matches_jax(tmp_path):
    """Flagged rows hash their prime-padded id; the on-card route ships the
    id column and hashes it where the batch lives, to the same codes."""
    keys = _keys(8)
    pad = 112062759511
    batch = {"user_id": np.array([3, 5, 5, 0, 9]), "user_id_oov": np.array([0, 1, 0, 1, 1])}
    jb = JaxHasher(8, str(tmp_path), keys_u64=keys).annotate_batch(dict(batch), "user_id", pad)
    hasher = DHEHasher(8, str(tmp_path), keys_u64=keys)
    pb = hasher.annotate_batch(dict(batch), "user_id", pad)
    np.testing.assert_array_equal(pb["user_id_dhe"], jb["user_id_dhe"])
    again = hasher.annotate_batch(dict(batch), "user_id", pad)  # from the memo
    np.testing.assert_array_equal(again["user_id_dhe"], jb["user_id_dhe"])
    raw = hasher.annotate_batch(dict(batch), "user_id", pad, padded_when_flagged=False)
    np.testing.assert_array_equal(raw["user_id_dhe"], hasher.hash_ids(batch["user_id"]))
    ob = DHEHasher(8, str(tmp_path), keys_u64=keys, on_device=True).annotate_batch(
        dict(batch), "user_id", pad)
    assert "user_id_dhe" not in ob
    np.testing.assert_array_equal(ob["user_id_dhe_id"], [3, 5 + pad, 5, pad, 9 + pad])
    codes = dhe_hashes_for({"user_id_dhe_id": torch.from_numpy(ob["user_id_dhe_id"])},
                           "user_id", {"dhe_keys": torch.from_numpy(keys.view(np.int64))})
    np.testing.assert_array_equal(codes.numpy(), jb["user_id_dhe"])


# ------------------------------------------------------------------ route

V, NB, D, B, LAYER, NH = 30, 8, 6, 64, 16, 8
EMBEDDERS = [None, "zero", "mean", "lsh", "slsh", "dnn", "dhe", "fdhe", "knn"]


def _route_state(tmp_path):
    """A state over synth-ind's users (feature rows past the IV vocabulary)."""
    port, _ = _datasets(DATASET_CASES["synth_all_columns"])
    rng = np.random.default_rng(4)
    mat = factory.build_feature_matrix(port.user_feat, port.uid_field)[:V + 10]
    return {
        "user_feat_mat": mat,
        "user_planes": rng.standard_normal((NB, mat.shape[1])).astype(np.float32),
        "user_knn_neighbors": factory.exact_knn_neighbors(mat, mat[:V], 3),
        "dhe_keys": _keys(NH),
    }


@pytest.mark.parametrize("embedder", EMBEDDERS, ids=[str(e) for e in EMBEDDERS])
def test_route_matches_jax(embedder, tmp_path):
    state = _route_state(tmp_path)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, V + 10, B)
    flags = (rng.random(B) < 0.4).astype(np.int32)
    buckets = np.where(flags > 0, rng.integers(0, NB, B), 0)
    iv = rng.standard_normal((V, D)).astype(np.float32)
    bt = rng.standard_normal((NB, D)).astype(np.float32)
    hashes = DHEHasher(NH, str(tmp_path), keys_u64=state["dhe_keys"]).hash_ids(ids)
    kw = dict(mapper="random" if embedder is None else None, embedder=embedder,
              add_oov_buckets=True, n_user_buckets=NB, n_item_buckets=NB,
              dhe_num_hashes=NH, dhe_layer_size=LAYER, embedding_size=D)
    spec, jspec = InductiveSpec(**kw), JaxSpec(**kw)

    width = {"dnn": state["user_feat_mat"].shape[1], "dhe": NH,
             "fdhe": NH + state["user_feat_mat"].shape[1]}.get(embedder)
    jmlp = mlp_params = mlp = None
    if width is not None:
        jmlp = JaxMLP(LAYER, D)
        mlp_params = jmlp.init(jax.random.key(1), jnp.zeros((1, width)))["params"]
        mlp = load_flax_params(EmbedderMLP(width, LAYER, D, device="cpu"), mlp_params)
    estate = {k: jnp.asarray(v) for k, v in state.items()}

    def jfn(iv_, bt_, mp):
        return jax_route(jspec, "user", jnp.asarray(ids), jnp.asarray(flags),
                         jnp.asarray(buckets), iv_, bt_, estate,
                         mlp_apply=None if jmlp is None else (
                             lambda x: jmlp.apply({"params": mp}, x)),
                         dhe_hashes=jnp.asarray(hashes))

    want = np.asarray(jfn(jnp.asarray(iv), jnp.asarray(bt), mlp_params))
    buffers = factory.EmbedderBuffers(state)
    a = torch.from_numpy(iv).requires_grad_()
    b = torch.from_numpy(bt).requires_grad_()
    got = route(spec, "user", torch.from_numpy(ids), torch.from_numpy(flags),
                torch.from_numpy(buckets), a, b, buffers, mlp=mlp,
                dhe_hashes=torch.from_numpy(hashes))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)

    g = rng.standard_normal((B, D)).astype(np.float32)
    jg = jax.grad(lambda x, y, p: jnp.sum(jfn(x, y, p) * g), argnums=(0, 1, 2))(
        jnp.asarray(iv), jnp.asarray(bt), mlp_params)
    leaves = [a, b] + ([] if mlp is None else list(mlp.parameters()))
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g), allow_unused=True)
    for x, y, what in ((grads[0], jg[0], "iv"), (grads[1], jg[1], "buckets")):
        y = np.asarray(y)
        np.testing.assert_allclose(np.zeros_like(y) if x is None else x.numpy(), y,
                                   rtol=0, atol=1e-5, err_msg=what)
    if mlp is not None:
        port_grads = flax_from_state_dict(
            dict(zip([n for n, _ in mlp.named_parameters()], grads[2:])), mlp)
        for layer, leaf in port_grads.items():
            for name, arr in leaf.items():
                np.testing.assert_allclose(arr, np.asarray(jg[2][layer][name]), rtol=0,
                                           atol=1e-5, err_msg=f"{layer}.{name}")


def test_embedder_mlp_and_state_cross_the_bridge(tmp_path):
    """flax tower params → port → flax, the same outputs; a BPR model's
    state from the JAX package's arrays and back, and in its state_dict."""
    jmlp = JaxMLP(LAYER, D)
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    params = jmlp.init(jax.random.key(3), jnp.asarray(x))["params"]
    mlp = load_flax_params(EmbedderMLP(7, LAYER, D, device="cpu"), params)
    back = flax_from_state_dict(mlp.state_dict(), mlp)
    assert set(back) == {f"Dense_{j}" for j in range(4)}
    for layer in back:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[layer][leaf], np.asarray(params[layer][leaf]))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmlp.apply({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=1e-6)

    state = _route_state(tmp_path)
    item = {"item_feat_mat": state["user_feat_mat"][:12],
            "item_planes": state["user_planes"]}
    spec = InductiveSpec(embedder="lsh", n_user_buckets=NB, n_item_buckets=NB)
    zeros = {k: np.zeros_like(v) for k, v in dict(state, **item).items()
             if k not in ("dhe_keys", "user_knn_neighbors")}
    model = BPR(V, 12, D, spec, device="cpu", embedder_state=zeros)
    set_embedder_state(model, dict(state, **item, dhe_key_parts=None))
    got = embedder_state_to_numpy(model)
    for k, v in zeros.items():
        np.testing.assert_array_equal(got[k], dict(state, **item)[k], err_msg=k)
    sd = model.state_dict()
    assert "embedder_state.user_planes" in sd and "user_oov_buckets.weight" in sd
    assert not any(k.startswith("embedder_state") for k in flax_from_state_dict(sd, model))
    with pytest.raises(ValueError, match="embedder state"):
        set_embedder_state(model, {"user_planes": np.zeros((2, 2), np.float32)})

"""The port's parallel package in one process, against the JAX package's
(`oovrec_tpu/parallel/`) on the conftest's virtual CPU devices.

  * `to_sharded_layout` / `from_sharded_layout` and `reconcile_layouts` in
    every direction (`tests/test_sharded_embedding.py:18-26, 228-266`), bit
    for bit with JAX's, and the flat form the port's checkpoints take
    (`reconcile_state`);
  * `param_sharding`'s decisions on BPR's and xDeepFM's trees (the JAX
    driver's initial params at `row_shard_threshold` 8) and on
    `tests/test_parallel.py:59-69`'s tree, equal to JAX's; the port's
    placement report (`port_placement`) and the optimizer state's
    placements mirroring the parameters';
  * `mesh_active`, `make_mesh`'s refusal, `pad_batch` against JAX's and
    `local_rows`' deduplication of model-replicated shards against a JAX
    array's addressable shards;
  * `ShardedEmbedding`: the blocks of its folded init are the dense
    xavier init at (V_pad, D) in the mod layout, a block-layout table
    holds its dense rows, and at one rank both exchanges equal the plain
    gather bit for bit, values and gradients.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.parallel import mesh as jmesh  # noqa: E402
from oovrec_tpu.parallel import sharded_embedding as jse  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec  # noqa: E402
from oovrec_tpu_torch.models import BPR  # noqa: E402
from oovrec_tpu_torch.ops.embed_grad import gather_rows  # noqa: E402
from oovrec_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from oovrec_tpu_torch.parallel import sharded_embedding as pse  # noqa: E402
from oovrec_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed,
    map_reduce_metrics,
)
from oovrec_tpu_torch.parallel.train_step import opt_state_sharding  # noqa: E402
from oovrec_tpu_torch.train.trainer import Trainer  # noqa: E402

from tests.test_torch_multiprocess import bpr_cfg, xdeepfm_cfg  # noqa: E402


@pytest.fixture(autouse=True)
def _no_mesh_left():
    yield
    pmesh.clear_meshes()


# ----------------------------------------------------------------- layouts


@pytest.mark.parametrize("V,S", [(10, 4), (10, 2), (12, 3), (1, 2), (7, 1)])
def test_layouts_match_jax(V, S):
    t = np.random.default_rng(V * 10 + S).standard_normal((V, 4)).astype(np.float32)
    lay = pse.to_sharded_layout(t, S)
    np.testing.assert_array_equal(lay, jse.to_sharded_layout(t, S))
    assert lay.shape == (S, -(-V // S), 4)
    np.testing.assert_array_equal(pse.from_sharded_layout(lay, V), t)
    np.testing.assert_array_equal(pse.from_sharded_layout(lay, V),
                                  jse.from_sharded_layout(lay, V))


def _reconcile_cases(dense):
    return {
        "sharded-to-dense": ({"t": {"embedding_sharded": pse.to_sharded_layout(dense, 2)}},
                             {"t": {"embedding": np.zeros((10, 4), np.float32)}}),
        "dense-to-sharded": ({"t": {"embedding": dense.copy()}},
                             {"t": {"embedding_sharded": np.zeros((4, 3, 4), np.float32)}}),
        "s2-to-s4": ({"t": {"embedding_sharded": pse.to_sharded_layout(dense, 2)}},
                     {"t": {"embedding_sharded": np.zeros((4, 3, 4), np.float32)}}),
        "s4-to-s3": ({"t": {"embedding_sharded": pse.to_sharded_layout(dense, 4)}},
                     {"t": {"embedding_sharded": np.zeros((3, 4, 4), np.float32)}}),
        "count-rename": ({"t": {"embedding_sharded": np.int32(5)}},
                         {"t": {"embedding": np.int32(0)}}),
        "nested-moments": ({"mu": {"t": {"embedding_sharded": pse.to_sharded_layout(dense, 2)},
                                   "d": {"kernel": dense[:2]}}},
                           {"mu": {"t": {"embedding": np.zeros((10, 4), np.float32)},
                                   "d": {"kernel": np.zeros((2, 4), np.float32)}}}),
    }


@pytest.mark.parametrize("case", sorted(_reconcile_cases(np.zeros((10, 4)))))
def test_reconcile_layouts_matches_jax(case):
    dense = np.random.default_rng(3).standard_normal((10, 4)).astype(np.float32)
    raw, tgt = _reconcile_cases(dense)[case]
    mine = jax.tree_util.tree_map(np.copy, raw)
    theirs = jax.tree_util.tree_map(np.copy, raw)
    pse.reconcile_layouts(tgt, mine)
    jse.reconcile_layouts(tgt, theirs)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(a, b)
    if case == "sharded-to-dense":
        np.testing.assert_array_equal(mine["t"]["embedding"], dense)


def test_reconcile_state_flat_names():
    """The port's flat checkpoints: sharded → dense `weight`, dense →
    sharded, S 2 → 4; the other entries untouched (the same tensors)."""
    dense = torch.randn(10, 4)
    bias = torch.randn(3)
    raw = {"a.embedding_sharded": torch.from_numpy(pse.to_sharded_layout(dense.numpy(), 2)),
           "lin.weight": dense[:3], "lin.bias": bias}
    out = pse.reconcile_state({"a.weight": (10, 4), "lin.weight": (3, 4), "lin.bias": (3,)},
                              raw)
    assert set(out) == {"a.weight", "lin.weight", "lin.bias"}
    assert torch.equal(out["a.weight"], dense) and out["lin.bias"] is bias
    back = pse.reconcile_state({"a.embedding_sharded": (4, 3, 4)}, {"a.weight": dense})
    np.testing.assert_array_equal(back["a.embedding_sharded"].numpy(),
                                  pse.to_sharded_layout(dense.numpy(), 4))
    again = pse.reconcile_state({"a.embedding_sharded": (4, 3, 4)}, raw)
    assert torch.equal(again["a.embedding_sharded"], back["a.embedding_sharded"])


# ------------------------------------------------------------------ rules


def _spec(sharding):
    return tuple(sharding.spec)


def _jax_params(cfg):
    from oovrec_tpu.cli.quick_start import build_model_and_state
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.utils import create_dataset, data_preparation

    jcfg = JaxConfig(config_dict=cfg)
    ds = create_dataset(jcfg)
    template = data_preparation(jcfg, ds)[0]._make_batch(np.arange(2))
    _, variables, _ = build_model_and_state(jcfg, ds, template_batch=template)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


TREES = {
    "bpr": lambda: _jax_params(bpr_cfg()),
    "xdeepfm": lambda: _jax_params(xdeepfm_cfg()),
    # tests/test_parallel.py:59-69
    "test-parallel": lambda: {"big": np.zeros((8192, 64)), "small": np.zeros((10, 64)),
                              "vec": np.zeros((100,))},
    # a ShardedEmbed layout leaf
    "sharded-leaf": lambda: {"t": {"embedding_sharded": np.zeros((2, 5, 4))},
                             "u": {"embedding_sharded": np.zeros((4, 5, 4))}},
}


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("threshold", [8, 4096])
def test_param_sharding_matches_jax(tree, threshold):
    params = TREES[tree]()
    want = jax.tree_util.tree_map(_spec, jmesh.param_sharding(jmesh.make_mesh(4, 2), params,
                                                              threshold))
    got = pmesh.param_sharding(pmesh.Mesh(4, 2), params, threshold)
    flat_want = {jax.tree_util.keystr(p): v for p, v in
                 jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, tuple))}
    flat_got = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_leaves_with_path(got, is_leaf=lambda x: isinstance(x, tuple))}
    assert flat_got == flat_want
    if tree == "test-parallel" and threshold == 4096:
        assert got["big"] == ("model", None) and got["small"] == () and got["vec"] == ()


def test_port_placement_reports_what_it_shards():
    """BPR on 11 items, 8 buckets a side, D 8, threshold 8: the JAX rule
    row-shards the 8-row bucket tables, which the port shards; xDeepFM's
    Dense kernel of 8 rows the rule picks stays replicated."""
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=8,
                         n_item_buckets=8)
    model = BPR(7, 11, 8, spec, device="cpu")
    mesh = pmesh.Mesh(4, 2)
    rep = pmesh.port_placement(mesh, model, 8)
    assert rep["user_oov_buckets.weight"] == rep["item_oov_buckets.weight"] == "sharded"
    assert rep["user_embedding.weight"] == "replicated"       # 7 rows < 8
    assert rep["item_embedding.weight"] == "replicated"       # 11 rows, odd
    lin = torch.nn.Linear(3, 8)
    model.extra = lin
    assert pmesh.port_placement(mesh, model, 8)["extra.weight"] == "replicated (rule: rows)"


def test_opt_state_mirrors_param_placement():
    mesh = pmesh.Mesh(1, 2, rank=1)
    model = torch.nn.Module()
    model.t = pse.ShardedEmbedding(10, 4, mesh, generator=torch.Generator().manual_seed(0))
    model.lin = torch.nn.Linear(4, 2)
    places = pmesh.port_placement(mesh, model)
    assert places == {"t.embedding_sharded": "sharded", "lin.weight": "replicated",
                      "lin.bias": "replicated"}
    state = {"count": 3, "mu": {n: torch.zeros_like(p) for n, p in model.named_parameters()},
             "nu": {n: torch.zeros_like(p) for n, p in model.named_parameters()}}
    assert opt_state_sharding(state, places) == {"count": (), "mu": places, "nu": places}
    assert state["mu"]["t.embedding_sharded"].shape == (1, 5, 4)


# ------------------------------------------------------------- mesh basics


def test_mesh_active_and_make_mesh():
    for cfg in ({}, {"mesh": {"data": -1, "model": 1}}, {"use_mesh": False}):
        assert pmesh.mesh_active(cfg) == jmesh.mesh_active(cfg) is False
    for cfg in ({"use_mesh": True}, {"mesh": {"data": 2}}, {"mesh": {"model": 2}}):
        assert pmesh.mesh_active(cfg) == jmesh.mesh_active(cfg) is True
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and pmesh.active_mesh() is mesh
    assert pmesh.make_mesh(1, 1) is mesh  # made once
    with pytest.raises(ValueError, match="does not cover"):
        pmesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="does not cover"):
        jmesh.make_mesh(3, 2)
    assert pmesh.maybe_mesh_from_config({}) is None
    assert initialize_distributed() == {"process_index": 0, "process_count": 1,
                                        "local_device_count": 1, "global_device_count": 1}
    assert map_reduce_metrics({"a": 0.5}, 3) == {"a": 0.5}


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(0)
    batch = {"a": rng.integers(0, 9, 7), "b": rng.standard_normal((7, 3)).astype(np.float32),
             "weight": np.ones(7, np.float32), "s": np.float32(2.0)}
    for m in (1, 2, 4, 8):
        got, want = pmesh.pad_batch(batch, m), jmesh.pad_batch(batch, m)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_data_rows_take_the_data_coordinate_block():
    batch = {"a": np.arange(7), "w": torch.ones(7), "s": np.float32(1)}
    blocks = [pmesh.data_rows(pmesh.Mesh(2, 2, rank=r), batch) for r in range(4)]
    np.testing.assert_array_equal(blocks[0]["a"], np.arange(4))
    np.testing.assert_array_equal(blocks[1]["a"], np.arange(4))      # same model group
    np.testing.assert_array_equal(blocks[2]["a"], [4, 5, 6, 0])      # padded tail
    assert blocks[3]["w"].tolist() == [1.0, 1.0, 1.0, 0.0]


def test_local_rows_dedups_model_replicas():
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmesh.make_mesh(4, 2)
    x = np.arange(24.0).reshape(8, 3)
    arr = jax.device_put(x, NamedSharding(mesh, P("data")))
    shards = [(s.index, np.asarray(s.data)) for s in arr.addressable_shards]
    assert len(shards) == 8  # each row block twice, once a model coordinate
    np.testing.assert_array_equal(pmesh.local_rows(shards), x)
    np.testing.assert_array_equal(pmesh.local_rows(shards[::-1]), x)
    np.testing.assert_array_equal(pmesh.local_rows(x), jmesh.local_rows(arr))


# ------------------------------------------------------- ShardedEmbedding


@pytest.mark.parametrize("V,S", [(10, 4), (37, 2), (8, 1)])
def test_sharded_embedding_folds_the_dense_init(V, S):
    from oovrec_tpu_torch.models.init import xavier_normal_

    blocks = [pse.ShardedEmbedding(V, 6, pmesh.Mesh(1, S, rank=r),
                                   generator=torch.Generator().manual_seed(5))
              for r in range(S)]
    rows = -(-V // S)
    dense = torch.empty(S * rows, 6)
    xavier_normal_(dense, torch.Generator().manual_seed(5))
    layout = np.concatenate([b.embedding_sharded.detach().numpy() for b in blocks])
    np.testing.assert_array_equal(layout, pse.to_sharded_layout(dense.numpy(), S))
    np.testing.assert_array_equal(pse.from_sharded_layout(layout, V), dense[:V].numpy())
    # a block-layout table holds its rows of the dense table
    if V % S == 0:
        for r in range(S):
            blk = pse.ShardedEmbedding(V, 6, pmesh.Mesh(1, S, rank=r), layout="block",
                                       dense=dense[:V])
            assert torch.equal(blk.weight_shard, dense[r * (V // S):(r + 1) * (V // S)])


@pytest.mark.parametrize("kind", ["psum", "alltoall"])
def test_one_rank_exchange_is_the_plain_gather(kind):
    """At one rank (no process group) both exchanges give the plain
    gather's rows and gradients bit for bit."""
    mesh = pmesh.Mesh(1, 1)
    g = torch.Generator().manual_seed(1)
    table = torch.randn(100, 8, generator=g)
    ids = torch.randint(0, 100, (64,), generator=g)
    emb = pse.ShardedEmbedding(100, 8, mesh, kind=kind, dense=table)
    out = emb(ids)
    leaf = table.clone().requires_grad_(True)
    plain = gather_rows(leaf, ids)
    assert torch.equal(out, plain)
    cot = torch.randn(64, 8, generator=g)
    (ga,) = torch.autograd.grad(out, [emb.embedding_sharded], cot)
    (gb,) = torch.autograd.grad(plain, [leaf], cot)
    assert torch.equal(ga[0], gb)
    assert torch.equal(emb.dense(), table) and torch.equal(emb.weight, table)


def test_alltoall_overflow_without_ranks():
    """A capacity of 1 a destination at one rank: the rows past it are
    zero and counted."""
    table = torch.randn(10, 4)
    ids = torch.tensor([3, 3, 5, 7])
    rows, overflow = pse.alltoall_lookup(table, ids, None, 1, 0, capacity_factor=0.25)
    assert int(overflow) == 3
    assert torch.equal(rows[0], table[3]) and torch.equal(rows[1:], torch.zeros(3, 4))
    with pytest.raises(ValueError, match="unknown sharded_lookup"):
        pse.make_lookup(pmesh.Mesh(1, 1), "bogus")


def test_jax_pickle_with_sharded_tables_resumes(tmp_path):
    """A JAX checkpoint of a {data: 4, model: 2} psum run stores its ID
    tables as (2, V/2, D) `embedding_sharded` layouts (params and adam
    moments); the port's dense model resumes it through
    `reconcile_layouts`: its tables and their first moments are the
    layouts' dense form."""
    from oovrec_tpu.cli.quick_start import run as jax_run
    from oovrec_tpu_torch.cli.quick_start import build_model_and_state
    from oovrec_tpu_torch.data.utils import create_dataset
    from oovrec_tpu_torch.utils.jax_checkpoint import read_jax_checkpoint

    cfg = bpr_cfg(epochs=1, mesh={"data": 4, "model": 2}, row_shard_threshold=4,
                  sharded_lookup="psum", checkpoint_dir=str(tmp_path / "jax"))
    res = jax_run(config_dict=cfg, saved=True)
    path = res["trainer"].saved_model_file
    stored = read_jax_checkpoint(path)
    layout = stored["params"]["user_embedding"]["embedding_sharded"]
    assert layout.shape[0] == 2
    pcfg = Config(bpr_cfg(device="cpu", epochs=1, checkpoint_dir=str(tmp_path / "port")))
    model = build_model_and_state(pcfg, create_dataset(pcfg))
    trainer = Trainer(pcfg, model)
    trainer.resume_checkpoint(path)
    user = model.user_embedding.weight.detach().numpy()
    np.testing.assert_array_equal(user, pse.from_sharded_layout(layout, user.shape[0]))
    item = stored["params"]["item_embedding"]["embedding_sharded"]
    np.testing.assert_array_equal(model.item_embedding.weight.detach().numpy(),
                                  pse.from_sharded_layout(item, model.n_items))

    def moments(tree):
        if isinstance(tree, dict):
            if "mu" in tree:
                return tree["mu"]
            for v in tree.values():
                found = moments(v)
                if found is not None:
                    return found
        return None

    mu = moments(stored["opt_state"])["user_embedding"]["embedding_sharded"]
    np.testing.assert_array_equal(trainer.opt_state["mu"]["user_embedding.weight"].numpy(),
                                  pse.from_sharded_layout(mu, user.shape[0]))

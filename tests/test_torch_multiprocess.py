"""The port's mesh on several ranks (gloo, on the CPU) against the JAX
package's mesh on the conftest's virtual devices.

Each test spawns this file as its worker processes (`python
tests/test_torch_multiprocess.py <scenario> <rank> <world> <dir>`), so
neither JAX nor `tests/conftest.py` runs in them: they import the port
only, meet at a `file://` rendezvous in the test's own directory (test
workers run side by side, so no TCP port is shared) and run on gloo with a
timeout; a group that has not finished after `TIMEOUT` seconds is killed
and its test fails. The parent pickles the scenario's inputs (configs,
the JAX run's initial weights) and reads each rank's pickled result.

  * the psum and all-to-all lookups at 2 and 4 ranks against JAX's
    `shard_map` lookups on 2- and 4-device meshes: values bit for bit,
    gradients to 1e-6, the overflow counts at a capacity factor of 0.5;
  * the loaders' slices by data coordinate: disjoint and covering;
  * BPR on toy-ind (random-mapper buckets, the OOV sub-epoch) at mesh
    {data: 2}, and at {data: 2, model: 2} with `row_shard_threshold: 4`
    under gspmd (block-sharded tables), psum and alltoall, from the JAX
    run's initial weights, against the JAX run of the same config (its
    single-device run, which JAX's own mesh tests hold equal to its mesh
    runs; and JAX's {data: 4, model: 2} psum run, which covers the 8
    devices as `mesh_from_config` requires): losses within rel 1e-4, test
    metrics within 1e-6; rank 0 alone writes its checkpoint, and the other
    rank's best-model reload takes it by broadcast;
  * xDeepFM on the ranking track, 2 ranks data-parallel, likewise;
  * BPR's device epoch on 2 ranks against the port's 1-rank run;
  * the eval map-reduce of a fixed checkpoint on 2 ranks (full sort and
    uni3) against the single-process metrics;
  * a psum checkpoint (S = 2) resumed into a dense model and on 4 ranks
    at S = 4.
"""

import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tests", "assets")
TIMEOUT = 120
LOAD_COL = {
    "inter": ["user_id", "item_id", "rating", "timestamp", "is_new"],
    "user": ["user_id", "age", "gender"],
    "item": ["item_id", "price", "category"],
}
OOV = dict(inductive_mapper="random", add_oov_buckets=True, n_user_oov_buckets=8,
           n_item_oov_buckets=8, train_oov=True, oov_only_epoch=True,
           oov_train_ratio=0.8, oov_feature_mask_rate=0.2)


def bpr_cfg(**over):
    d = dict(OOV, model="BPR", dataset="toy-ind", data_path=ASSETS, load_col=LOAD_COL,
             epochs=2, train_batch_size=16, eval_batch_size=64, embedding_size=8,
             topk=[2, 5], valid_metric="MRR@2", metric_decimal_place=12,
             eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO",
                        "group_by": "user", "mode": "full"},
             seed=7, host_scan_steps=1, device_epoch=False, log_tensorboard=False)
    d.update(over)
    return d


def xdeepfm_cfg(**over):
    d = dict(OOV, model="xDeepFM", dataset="toy-ind", data_path=ASSETS, load_col=LOAD_COL,
             numerical_features=["age", "price"], threshold={"rating": 4}, epochs=2,
             train_batch_size=16, eval_batch_size=200, embedding_size=8,
             mlp_hidden_size=[16, 8], cin_layer_size=[8, 8], dropout_prob=0.0,
             metrics=["AUC", "LogLoss"], valid_metric="AUC", metric_decimal_place=12,
             eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO",
                        "group_by": None, "mode": "labeled"},
             seed=7, host_scan_steps=1, device_epoch=False, log_tensorboard=False)
    d.update(over)
    return d


# ---------------------------------------------------------------- workers


def _worker_setup(rank, world, tmp):
    import torch

    from oovrec_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    info = initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", world, rank,
                                  device="cpu", timeout_s=TIMEOUT - 20)
    assert info["process_count"] == world and info["process_index"] == rank, info


def _lookup_cases(payload, rank, world, tmp):
    """Each case's rows of this rank's data coordinate, its table block's
    gradient of sum(rows²) summed over the data group, and the overflow
    count of an all-to-all case."""
    import torch

    from oovrec_tpu_torch.parallel.mesh import make_mesh
    from oovrec_tpu_torch.parallel.sharded_embedding import (
        alltoall_lookup,
        psum_lookup,
        to_sharded_layout,
    )
    from oovrec_tpu_torch.parallel.train_step import allreduce_grads

    out = []
    for kind, n_data, n_model, cf, table, ids in payload["cases"]:
        mesh = make_mesh(n_data, n_model)
        S, s, d = n_model, mesh.model_index, mesh.data_index
        block = torch.from_numpy(to_sharded_layout(table, S)[s]).requires_grad_(True)
        b = len(ids) // n_data
        mine = torch.from_numpy(ids[d * b:(d + 1) * b])
        overflow = None
        if kind == "psum":
            rows = psum_lookup(block, mine, mesh.model_group, S, s)
        else:
            rows, overflow = alltoall_lookup(block, mine, mesh.model_group, S, s, cf)
            overflow = int(overflow)
        (g,) = torch.autograd.grad((rows ** 2).sum(), [block])
        (g,) = allreduce_grads([g], mesh.data_group)
        out.append({"data": d, "model": s, "rows": rows.detach().numpy(),
                    "grad": g.numpy(), "overflow": overflow})
    return out


def _loaders(payload, rank, world, tmp):
    """The rows of a train loader and the users of a full-sort loader
    built without a (rank, world) pair under a {data: world} mesh."""
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.data.dataloader import FullSortEvalBatcher, TrainBatcher
    from oovrec_tpu_torch.data.sampler import Sampler
    from oovrec_tpu_torch.data.utils import create_dataset
    from oovrec_tpu_torch.parallel.mesh import make_mesh
    from oovrec_tpu_torch.utils.enums import InputType

    make_mesh(world, 1)
    cfg = Config(payload["cfg"])
    splits = create_dataset(cfg).build()[:3]
    sampler = Sampler(["train", "valid", "test"], splits, seed=7)
    train = TrainBatcher(splits[0], sampler, cfg, InputType.PAIRWISE, phase="train")
    rows = []
    for batch in train:
        keep = batch["weight"] > 0
        rows += [(int(u), int(i), float(t)) for u, i, t in zip(
            batch["user_id"][keep], batch["item_id"][keep], batch["timestamp"][keep])]
    test = FullSortEvalBatcher(splits[2], sampler, cfg, phase="test")
    return {"rows": rows, "n_batches": len(train), "pair": (train.process_index,
                                                            train.process_count),
            "users": [int(u) for u in test.uid_list]}


def _bridged_build(params):
    """The port driver's model builder, loading `params` (a flax tree of
    numpy arrays) into the transductive model."""
    import oovrec_tpu_torch.cli.quick_start as qs
    from oovrec_tpu_torch.utils.jax_params import load_flax_params

    build = qs.build_model_and_state

    def bridged(config, dataset, mode="transductive", **kw):
        model = build(config, dataset, mode=mode, **kw)
        if mode == "transductive" and params is not None:
            load_flax_params(model, params)
        return model

    qs.build_model_and_state = bridged


def _train(payload, rank, world, tmp):
    """`quick_start.run` of the config on this rank (its own checkpoint
    directory), from the given initial weights."""
    from oovrec_tpu_torch.cli.quick_start import run
    from oovrec_tpu_torch.parallel.mesh import port_placement
    from oovrec_tpu_torch.parallel.sharded_embedding import sharded_tables

    _bridged_build(payload.get("params"))
    cfg = dict(payload["cfg"], device="cpu", checkpoint_dir=os.path.join(tmp, f"ckpt_{rank}"))
    res = run(config_dict=cfg, saved=True)
    tr = res["trainer"]
    return {
        "losses": {int(k): float(v) for k, v in tr.train_loss_dict.items()},
        "oov_losses": {int(k): float(v) for k, v in tr.oov_loss_dict.items()},
        "test_result": {k: float(v) for k, v in res["test_result"].items()},
        "ckpt": tr.saved_model_file if os.path.isfile(tr.saved_model_file) else None,
        "mesh": tr.mesh.shape if tr.mesh is not None else None,
        "sharded": sorted(sharded_tables(tr.model)),
        "placement": port_placement(tr.mesh, tr.model, int(cfg.get("row_shard_threshold", 4096)))
        if tr.mesh is not None else None,
        "device_epochs": len(tr._device_epochs),
    }


def _evaluate(payload, rank, world, tmp):
    """A fixed checkpoint's test metrics under a {data: world} mesh."""
    from oovrec_tpu_torch.cli.quick_start import load_data_and_model

    over = dict(payload.get("over") or {}, device="cpu", mesh={"data": world},
                checkpoint_dir=os.path.join(tmp, f"ckpt_{rank}"))
    loaded = load_data_and_model(payload["ckpt"], config_overrides=over)
    result = loaded.trainer.evaluate(loaded.test_loader, load_best_model=False)
    return {"test_result": {k: float(v) for k, v in result.items()},
            "users": len(loaded.test_loader.uid_list)}


def _resume(payload, rank, world, tmp):
    """A checkpoint resumed into this rank's model; → the dense tables."""
    import torch

    from oovrec_tpu_torch.cli.quick_start import build_model_and_state, bootstrap
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.data.utils import create_dataset
    from oovrec_tpu_torch.train.trainer import Trainer

    cfg = Config(dict(payload["cfg"], device="cpu",
                      checkpoint_dir=os.path.join(tmp, f"ckpt_{rank}")))
    bootstrap(cfg)
    model = build_model_and_state(cfg, create_dataset(cfg))
    trainer = Trainer(cfg, model)
    trainer.resume_checkpoint(payload["ckpt"])
    with torch.no_grad():
        return {name: getattr(model, name).weight.numpy().copy()
                for name in ("user_embedding", "item_embedding")}


SCENARIOS = {"lookup": _lookup_cases, "loaders": _loaders, "train": _train,
             "evaluate": _evaluate, "resume": _resume}


def _worker_main(argv):
    scenario, rank, world, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, REPO)
    _worker_setup(rank, world, tmp)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    out = SCENARIOS[scenario](payload, rank, world, tmp)
    with open(os.path.join(tmp, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def spawn(scenario, tmp_path, world, payload):
    """Run `scenario` on `world` gloo ranks; → each rank's result."""
    tmp = tmp_path / f"{scenario}-{world}-{time.monotonic_ns()}"
    tmp.mkdir()
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r),
                               str(world), str(tmp)], cwd=str(tmp), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + TIMEOUT
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{scenario} on {world} ranks did not finish in {TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{log[-6000:]}"
    results = []
    for r in range(world):
        with open(tmp / f"out_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ----------------------------------------------------------- JAX references


@pytest.fixture()
def jax_mod():
    jax = pytest.importorskip("jax")
    from oovrec_tpu.inductive import factory as jax_factory

    jax_factory._global_cache = jax_factory.InductiveFeatureCache("unset")
    yield jax
    jax_factory._global_cache = jax_factory.InductiveFeatureCache("unset")


def _jax_run(cfg, tmp):
    """The JAX driver's run of `cfg`; → (losses, oov losses, test metrics,
    the initial params as a numpy tree, float-field tables scaled down as
    in `tests/test_torch_cli.py`)."""
    import jax

    import oovrec_tpu.cli.quick_start as jqs

    recorded = {}
    build = jqs.build_model_and_state

    def recording(config, dataset, mode="transductive", **kw):
        model, variables, estate = build(config, dataset, mode=mode, **kw)
        if mode == "transductive":
            params = jax.tree_util.tree_map_with_path(
                lambda p, v: np.array(v) * np.float32(
                    0.01 if p[-2:-1] and p[-2].key == "float_embedding_table" else 1),
                variables["params"])
            recorded.setdefault("params", params)
            variables = dict(variables, params=jax.tree_util.tree_map(np.array, params))
        return model, variables, estate

    jqs.build_model_and_state = recording
    try:
        res = jqs.run(config_dict=dict(cfg, checkpoint_dir=str(tmp)), saved=True)
    finally:
        jqs.build_model_and_state = build
    tr = res["trainer"]
    return ({int(k): float(v) for k, v in tr.train_loss_dict.items()},
            {int(k): float(v) for k, v in tr.oov_loss_dict.items()},
            {k: float(v) for k, v in res["test_result"].items()}, recorded["params"])


def _agree_run(port, losses, oov_losses, test_result):
    assert set(port["losses"]) == set(losses)
    for k, v in losses.items():
        assert port["losses"][k] == pytest.approx(v, rel=1e-4), ("loss", k)
    for k, v in oov_losses.items():
        assert port["oov_losses"][k] == pytest.approx(v, rel=1e-4), ("oov loss", k)
    assert set(port["test_result"]) == set(test_result)
    for k, v in test_result.items():
        assert abs(port["test_result"][k] - v) <= 1e-6, (k, port["test_result"][k], v)


# ------------------------------------------------------------------ lookups


def _jax_lookup(kind, n_data, n_model, cf, table, ids):
    import jax
    import jax.numpy as jnp

    from oovrec_tpu.parallel.mesh import make_mesh
    from oovrec_tpu.parallel.sharded_embedding import (
        from_sharded_layout,
        make_alltoall_lookup,
        make_sharded_lookup,
        place_sharded_table,
    )

    mesh = make_mesh(n_data, n_model, devices=jax.devices()[: n_data * n_model])
    st = place_sharded_table(mesh, table)
    if kind == "psum":
        f = make_sharded_lookup(mesh)
        call = lambda t: (f(t, jnp.asarray(ids)), None)  # noqa: E731
    else:
        g = make_alltoall_lookup(mesh, capacity_factor=cf)
        call = lambda t: g(t, jnp.asarray(ids))  # noqa: E731
    rows, overflow = jax.jit(call)(st)
    grad = jax.jit(jax.grad(lambda t: jnp.sum(call(t)[0] ** 2)))(st)
    return (np.asarray(rows), from_sharded_layout(np.asarray(grad), table.shape[0]),
            None if overflow is None else int(overflow))


LOOKUP_MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}


@pytest.mark.parametrize("world", [2, 4])
def test_lookups_match_jax_shard_map(world, tmp_path, jax_mod):
    from oovrec_tpu_torch.parallel.sharded_embedding import from_sharded_layout

    rng = np.random.default_rng(world)
    cases = []
    for n_data, n_model in LOOKUP_MESHES[world]:
        V, D, B = 37, 8, 16 * n_data * n_model
        table = rng.standard_normal((V, D)).astype(np.float32)
        ids = rng.integers(0, V, B).astype(np.int32)
        cases += [("psum", n_data, n_model, 2.0, table, ids),
                  ("alltoall", n_data, n_model, 8.0, table, ids)]
        # every id owned by model rank 0: capacity 1 a destination overflows
        bad = (rng.integers(0, V // n_model, B) * n_model).astype(np.int32)
        cases.append(("alltoall", n_data, n_model, 0.5, table, bad))
    results = spawn("lookup", tmp_path, world, {"cases": cases})
    for c, (kind, n_data, n_model, cf, table, ids) in enumerate(cases):
        rows_j, grad_j, over_j = _jax_lookup(kind, n_data, n_model, cf, table, ids)
        per = [r[c] for r in results]
        rows = np.concatenate([next(p["rows"] for p in per if p["data"] == d and p["model"] == 0)
                               for d in range(n_data)])
        np.testing.assert_array_equal(rows, rows_j, err_msg=str(c))
        blocks = np.stack([next(p["grad"] for p in per if p["data"] == 0 and p["model"] == m)
                           for m in range(n_model)])
        grad = from_sharded_layout(blocks, table.shape[0])
        np.testing.assert_allclose(grad, grad_j, rtol=1e-6, atol=1e-6, err_msg=str(c))
        if kind == "alltoall":
            # JAX returns the overflow of data coordinate 0's model group
            assert [p["overflow"] for p in per if p["data"] == 0][0] == over_j, c
            if cf < 1:
                assert over_j > 0
                assert np.any(np.all(rows == 0.0, axis=1))
            else:
                assert over_j == 0


# ------------------------------------------------------------------ loaders


def test_loader_slices_by_data_coordinate(tmp_path):
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.data.dataloader import FullSortEvalBatcher, TrainBatcher
    from oovrec_tpu_torch.data.sampler import Sampler
    from oovrec_tpu_torch.data.utils import create_dataset
    from oovrec_tpu_torch.utils.enums import InputType

    cfg_dict = bpr_cfg(device="cpu")
    r0, r1 = spawn("loaders", tmp_path, 2, {"cfg": cfg_dict})
    assert r0["pair"] == (0, 2) and r1["pair"] == (1, 2)
    assert r0["n_batches"] == r1["n_batches"]
    rows0, rows1 = set(r0["rows"]), set(r1["rows"])
    assert rows0 and rows1 and not rows0 & rows1
    cfg = Config(cfg_dict)
    splits = create_dataset(cfg).build()[:3]
    sampler = Sampler(["train", "valid", "test"], splits, seed=7)
    full = set()
    for batch in TrainBatcher(splits[0], sampler, cfg, InputType.PAIRWISE, phase="train",
                              process_index=0, process_count=1):
        keep = batch["weight"] > 0
        full |= {(int(u), int(i), float(t)) for u, i, t in zip(
            batch["user_id"][keep], batch["item_id"][keep], batch["timestamp"][keep])}
    assert rows0 | rows1 == full
    users = FullSortEvalBatcher(splits[2], sampler, cfg, phase="test", process_index=0,
                                process_count=1).uid_list
    assert not set(r0["users"]) & set(r1["users"])
    assert sorted(r0["users"] + r1["users"]) == sorted(int(u) for u in users)


# ------------------------------------------------------------------ training


BPR_MESHES = {
    "data2": dict(mesh={"data": 2}),
    "data2-model2-gspmd": dict(mesh={"data": 2, "model": 2}, row_shard_threshold=4),
    "data2-model2-psum": dict(mesh={"data": 2, "model": 2}, row_shard_threshold=4,
                              sharded_lookup="psum"),
    "data2-model2-alltoall": dict(mesh={"data": 2, "model": 2}, row_shard_threshold=4,
                                  sharded_lookup="alltoall"),
}


@pytest.fixture(scope="module")
def jax_bpr(tmp_path_factory):
    pytest.importorskip("jax")
    from oovrec_tpu.inductive import factory as jax_factory

    jax_factory._global_cache = jax_factory.InductiveFeatureCache("unset")
    return _jax_run(bpr_cfg(), tmp_path_factory.mktemp("jax_bpr"))


@pytest.mark.parametrize("case", sorted(BPR_MESHES))
def test_bpr_mesh_matches_jax(case, tmp_path, jax_bpr):
    losses, oov_losses, test_result, params = jax_bpr
    over = BPR_MESHES[case]
    world = over["mesh"]["data"] * over["mesh"].get("model", 1)
    results = spawn("train", tmp_path, world, {"cfg": bpr_cfg(**over), "params": params})
    for r in results:
        _agree_run(r, losses, oov_losses, test_result)
        assert r["mesh"] == {"data": 2, "model": over["mesh"].get("model", 1)}
    # rank 0 alone writes; the others' best-model reload took it by broadcast
    assert results[0]["ckpt"] is not None
    assert all(r["ckpt"] is None for r in results[1:])
    placement = results[0]["placement"]
    if "model2" in case:
        # the 8-row OOV bucket tables split in blocks (the rule: 2 | 8)
        for side in ("user", "item"):
            assert placement[f"{side}_oov_buckets.weight_shard"] == "sharded"
    if case.endswith("gspmd"):
        # 7 users and 11 items do not split over 2: replicated
        assert placement["user_embedding.weight"] == "replicated"
        assert placement["item_embedding.weight"] == "replicated"
    elif "model2" in case:
        assert "user_embedding.embedding_sharded" in results[0]["sharded"]
        assert "item_embedding.embedding_sharded" in results[0]["sharded"]


def test_bpr_model_axis_matches_jax_mesh(tmp_path, jax_mod):
    """JAX's {data: 4, model: 2} psum run (its ShardedEmbed tables, their
    initial (2, V/2, D) layouts loaded as the port's blocks) against the
    port's {data: 2, model: 2} psum run."""
    cfg = bpr_cfg(**BPR_MESHES["data2-model2-psum"])
    losses, oov_losses, test_result, params = _jax_run(
        dict(cfg, mesh={"data": 4, "model": 2}), tmp_path / "jax")
    assert params["user_embedding"]["embedding_sharded"].shape[0] == 2
    results = spawn("train", tmp_path, 4, {"cfg": cfg, "params": params})
    for r in results:
        _agree_run(r, losses, oov_losses, test_result)


def test_xdeepfm_data_parallel_matches_jax(tmp_path, jax_mod):
    cfg = xdeepfm_cfg()
    losses, oov_losses, test_result, params = _jax_run(cfg, tmp_path / "jax")
    results = spawn("train", tmp_path, 2, {"cfg": dict(cfg, mesh={"data": 2}, fused_cin=True),
                                           "params": params})
    for r in results:
        _agree_run(r, losses, oov_losses, test_result)
    assert results[0]["ckpt"] is not None and results[1]["ckpt"] is None


def test_device_epoch_two_ranks_match_one(tmp_path):
    """The device epoch builds the same global batches on every rank:
    two ranks' trajectory is the port's one-rank trajectory."""
    cfg = bpr_cfg(device_epoch=True, epochs=3)
    one = spawn("train", tmp_path, 1, {"cfg": cfg})[0]
    two = spawn("train", tmp_path, 2, {"cfg": dict(cfg, mesh={"data": 2})})
    assert one["device_epochs"] == 2  # the normal epoch and the OOV sub-epoch
    for r in two:
        assert r["device_epochs"] == 2
        _agree_run(r, one["losses"], one["oov_losses"], one["test_result"])


@pytest.mark.parametrize("mode", ["full", "uni3"])
def test_eval_map_reduce_matches_one_process(mode, tmp_path):
    from oovrec_tpu_torch.cli.quick_start import load_data_and_model, run

    cfg = bpr_cfg(device="cpu", checkpoint_dir=str(tmp_path / "one"))
    res = run(config_dict=cfg, saved=True)
    ckpt = str(tmp_path / "shared.pth")
    shutil.copy(res["trainer"].saved_model_file, ckpt)
    over = None
    if mode != "full":
        over = {"eval_args": {"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO",
                              "group_by": "user", "mode": mode}}
    loaded = load_data_and_model(ckpt, config_overrides=dict(over or {}, device="cpu"))
    want = loaded.trainer.evaluate(loaded.test_loader, load_best_model=False)
    r0, r1 = spawn("evaluate", tmp_path, 2, {"ckpt": ckpt, "over": over})
    assert r0["users"] + r1["users"] == len(loaded.test_loader.uid_list)
    for k, v in want.items():
        assert r0["test_result"][k] == pytest.approx(float(v), abs=1e-6), k
        assert r0["test_result"][k] == r1["test_result"][k], k


def test_sharded_checkpoint_resumes_across_layouts(tmp_path):
    """A checkpoint of {model: 2} psum tables ((2, V/2, D) layouts) resumes
    into a dense model and into {model: 4} tables, the same dense tables."""
    import torch

    from oovrec_tpu_torch.cli.quick_start import build_model_and_state
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.data.utils import create_dataset
    from oovrec_tpu_torch.parallel.sharded_embedding import from_sharded_layout
    from oovrec_tpu_torch.train.trainer import Trainer

    cfg = bpr_cfg(mesh={"data": 1, "model": 2}, row_shard_threshold=4, sharded_lookup="psum",
                  epochs=1)
    r0, _ = spawn("train", tmp_path, 2, {"cfg": cfg})
    stored = torch.load(r0["ckpt"], weights_only=True)["params"]
    layout = stored["user_embedding.embedding_sharded"].numpy()
    assert layout.shape[0] == 2
    dense_cfg = Config(bpr_cfg(device="cpu", checkpoint_dir=str(tmp_path / "dense")))
    model = build_model_and_state(dense_cfg, create_dataset(dense_cfg))
    Trainer(dense_cfg, model).resume_checkpoint(r0["ckpt"])
    user = model.user_embedding.weight.detach().numpy()
    np.testing.assert_array_equal(user, from_sharded_layout(layout, user.shape[0]))
    four = spawn("resume", tmp_path, 4, {
        "ckpt": r0["ckpt"], "cfg": dict(cfg, mesh={"data": 1, "model": 4})})
    for r in four:
        np.testing.assert_array_equal(r["user_embedding"], user)
        np.testing.assert_array_equal(r["item_embedding"],
                                      model.item_embedding.weight.detach().numpy())


if __name__ == "__main__":
    _worker_main(sys.argv[1:])

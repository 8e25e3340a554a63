"""The test pass and whole runs on the port's mesh for any model.

The test pass: the representatives of
`tests/test_torch_mesh_jax.py` (the full sort, the value eval of FM, the
full sort over row-sharded tables), LightGCN under the uni-N mode and
DirectAU on the fused top-k path (`use_fused_topk`), on 2 gloo ranks,
each rank evaluating its data coordinate's slice of the eval loader
(`data/dataloader.py:_process_info`) and the metrics map-reduced over the
data group, equal the single-rank test pass of the same weights to 1e-9.

Whole runs: `quick_start.run` (two epochs, validation, the best model saved
by rank 0 and reloaded on both, the test pass) of models that were
refused on the mesh before, without per-row draws (DirectAU's uniformity,
NCL's InfoNCE, SGL's edge masks, KGAT's knowledge batches), on {data: 2}
against the same run at one rank: every epoch's loss to 1e-5 relative, the
test metrics to 1e-6.

The workers are this file run as a script (`tests/torch_mesh_harness.py:
run_ranks`).
"""

import os
import sys

import pytest

from tests.test_torch_mesh_jax import CASES as STEP_CASES
from tests.test_torch_mesh_jax import MESHES
from tests.torch_mesh_harness import join_group, leave_group, run_ranks

# the loaders every rank reads whole (the value eval's rows, the sequential
# full sort): their metrics reduce to the same values
SLICE_FREE = {"FM", "GRU4Rec", "BERT4Rec", "S3Rec"}
CASES = {name: dict(cfg, epochs=1) for name, cfg in STEP_CASES.items()}
CASES.update({
    "LightGCN-uni3": dict(STEP_CASES["LightGCN"],
                          eval_args=dict(STEP_CASES["LightGCN"]["eval_args"], mode="uni3")),
    "DirectAU-fused": dict(STEP_CASES["DirectAU"], use_fused_topk=True),
})
RUNS = {name: dict(STEP_CASES[name], epochs=2, valid_metric="MRR@5", topk=[5])
        for name in ("DirectAU", "NCL", "SGL", "KGAT")}


def _worker(rank, world, tmp):
    from oovrec_tpu_torch.cli.quick_start import build_model_and_state, run
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.data.utils import create_dataset, data_preparation
    from oovrec_tpu_torch.parallel.mesh import clear_meshes, make_mesh
    from oovrec_tpu_torch.train.trainer import Trainer

    join_group(rank, world, tmp)
    out = {}
    for case, cfg in CASES.items():
        cfg = dict(cfg, device="cpu", checkpoint_dir=os.path.join(tmp, f"ck{rank}"))
        clear_meshes()
        ds = create_dataset(Config(cfg))
        _train, _valid, test = data_preparation(Config(cfg), ds)
        model = build_model_and_state(Config(cfg), ds)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        plain = Trainer(Config(cfg), model).evaluate(test, load_best_model=False)

        n_data, n_model = MESHES.get(case, (world, 1))
        mesh_cfg = Config(dict(cfg, use_mesh=True, mesh={"data": n_data, "model": n_model}))
        make_mesh(n_data, n_model)  # the eval loaders take their slices
        _train, _valid, test = data_preparation(mesh_cfg, ds)
        model = build_model_and_state(mesh_cfg, ds)
        model.load_state_dict(state)
        trainer = Trainer(mesh_cfg, model)
        on_mesh = trainer.evaluate(test, load_best_model=False)
        out[case] = {"plain": {k: float(v) for k, v in plain.items()},
                     "mesh": {k: float(v) for k, v in on_mesh.items()},
                     "slice": (getattr(test, "process_index", 0),
                               getattr(test, "process_count", 1))}
    for case, cfg in RUNS.items():
        runs = {}
        for where, over in (("plain", {}), ("mesh", {"use_mesh": True, "mesh": {"data": world}})):
            clear_meshes()
            res = run(config_dict=dict(cfg, device="cpu", **over,
                                       checkpoint_dir=os.path.join(tmp, f"{where}{rank}")))
            tr = res["trainer"]
            runs[where] = {"losses": dict(tr.train_loss_dict),
                           "test": {k: float(v) for k, v in res["test_result"].items()},
                           "mesh": tr.mesh is not None}
        out["run-" + case] = runs
    leave_group(out, rank, tmp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(__file__, 2, tmp_path_factory.mktemp("mesheval"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_test_pass_equals_the_single_rank_pass(ranks, case):
    for rank, res in enumerate(ranks):
        got = res[case]
        assert got["mesh"].keys() == got["plain"].keys() and got["plain"], got
        for k, v in got["plain"].items():
            assert abs(got["mesh"][k] - v) <= 1e-9, (rank, k, got["mesh"][k], v)
    assert ranks[0][case]["mesh"] == ranks[1][case]["mesh"]
    if case not in SLICE_FREE:  # each data coordinate evaluates its slice of the users
        n_data = MESHES.get(case, (2, 1))[0]
        assert [r[case]["slice"] for r in ranks] == [(r * n_data // 2, n_data)
                                                      for r in range(2)]


@pytest.mark.parametrize("case", sorted(RUNS))
def test_mesh_run_equals_the_single_rank_run(ranks, case):
    for rank, res in enumerate(ranks):
        got = res["run-" + case]
        assert got["mesh"]["mesh"] and not got["plain"]["mesh"]
        plain, mesh = got["plain"], got["mesh"]
        assert sorted(mesh["losses"]) == sorted(plain["losses"]) == [0, 1]
        for epoch, loss in plain["losses"].items():
            assert mesh["losses"][epoch] == pytest.approx(loss, rel=1e-5), (rank, epoch)
        assert mesh["test"].keys() == plain["test"].keys() and plain["test"]
        for k, v in plain["test"].items():
            assert abs(mesh["test"][k] - v) <= 1e-6, (rank, k, mesh["test"][k], v)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

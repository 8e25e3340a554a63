"""The port's retrieval serving slice against the JAX package, end to end.

A JAX BPR with random-mapper OOV buckets is trained once on the toy-ind
fixture; its checkpointed weights and the `_ind` corpus's split arrays
cross to the port (numpy only). The port's 7-slice inductive metrics,
full-sort metrics and eval batches must equal the JAX package's, on the
dense and the fused path (the fused path runs the kernel's plain version
on the CPU), with perturbed hits on and off. Tolerance 1e-9: both sides
round the same integer hit matrices.
"""

import pickle

import numpy as np
import pytest

pytest.importorskip("jax")

from flax import serialization  # noqa: E402

from oovrec_tpu.cli.inductive_eval import (  # noqa: E402
    check_feature_consistency,
    create_ind_dataset,
    perform_inductive_eval,
)
from oovrec_tpu.cli.quick_start import run  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.dataloader import (  # noqa: E402
    FullSortEvalBatcher as JaxFullSortEvalBatcher,
)
from oovrec_tpu.data.sampler import Sampler as JaxSampler  # noqa: E402
from oovrec_tpu.data.utils import data_preparation  # noqa: E402
from oovrec_tpu.eval.runner import EvalRunner as JaxEvalRunner  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data import DatasetSplit, FullSortEvalBatcher, Sampler  # noqa: E402
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper  # noqa: E402
from oovrec_tpu_torch.models import BPR  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import state_dict_from_flax  # noqa: E402

from tests.test_inductive import _ind_cfg  # noqa: E402

EVAL_KEYS = (
    "topk", "metrics", "metric_decimal_place", "seed", "eval_batch_size",
    "inductive_mapper", "add_oov_buckets", "n_user_oov_buckets",
    "n_item_oov_buckets", "oov_hash_function", "embedding_size",
)


def _port_split(split):
    return DatasetSplit(
        {f: split.inter[f] for f in (split.uid_field, split.iid_field)},
        split.user_num, split.item_num, split.uid_field, split.iid_field,
    )


def _port_sampler(jax_splits):
    return Sampler(["train", "valid", "test"], [_port_split(s) for s in jax_splits])


def _port_config(jax_cfg, **over):
    d = {k: jax_cfg[k] for k in EVAL_KEYS}
    d.update(over)
    return Config(d)


def _port_bpr(params, n_users, n_items, cfg):
    spec = InductiveSpec(
        mapper=cfg["inductive_mapper"],
        add_oov_buckets=bool(cfg["add_oov_buckets"]),
        n_user_buckets=int(cfg["n_user_oov_buckets"]),
        n_item_buckets=int(cfg["n_item_oov_buckets"]),
        hash_function=cfg["oov_hash_function"],
    )
    model = BPR(n_users, n_items, int(cfg["embedding_size"]), spec, device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return model


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = _ind_cfg(checkpoint_dir=str(tmp_path_factory.mktemp("ind")))
    res = run(config_dict=cfg, saved=True)
    ckpt_path = res["trainer"].saved_model_file
    with open(ckpt_path, "rb") as f:
        params = serialization.msgpack_restore(pickle.load(f)["params"])
    ind_cfg, ind_ds = create_ind_dataset(res["config"], res["dataset"])
    check_feature_consistency(res["dataset"], ind_ds)
    _, _, jax_test_loader = data_preparation(ind_cfg, ind_ds)
    # the same weights with items tied in threes: ranking then rests on the
    # tie-break rules and on the perturbed-hits permutations
    tied = {k: {"embedding": np.array(v["embedding"])} for k, v in params.items()}
    items = tied["item_embedding"]["embedding"]
    items[1:] = items[1 + (np.arange(len(items) - 1) // 3) * 3]
    with open(ckpt_path, "rb") as f:
        ckpt = pickle.load(f)
    ckpt["params"] = serialization.msgpack_serialize(tied)
    tied_path = str(tmp_path_factory.mktemp("tied") / "tied.pth")
    with open(tied_path, "wb") as f:
        pickle.dump(ckpt, f)
    return {
        "res": res, "ind_cfg": ind_cfg, "ind_ds": ind_ds,
        "jax_test_loader": jax_test_loader,
        "weights": {"trained": (ckpt_path, params), "tied": (tied_path, tied)},
    }


def _port_ind_loader(trained, cfg):
    ind_splits = trained["ind_ds"].build()
    return FullSortEvalBatcher(
        _port_split(ind_splits[2]), _port_sampler(ind_splits), cfg, phase="test"
    )


@pytest.mark.parametrize("rank,world", [(None, None), (0, 2), (1, 2)])
def test_full_sort_batches_match_jax(trained, rank, world):
    """Same batches as the JAX batcher, also when users are sharded over
    processes (rank and world given explicitly, as the port requires)."""
    cfg = _port_config(trained["ind_cfg"])
    ind_splits = trained["ind_ds"].build()
    port = list(FullSortEvalBatcher(
        _port_split(ind_splits[2]), _port_sampler(ind_splits), cfg,
        phase="test", process_index=rank, process_count=world,
    ))
    if world is None:
        ref = list(trained["jax_test_loader"])
    else:
        jax_sampler = JaxSampler(["train", "valid", "test"], ind_splits)
        ref = list(JaxFullSortEvalBatcher(
            ind_splits[2], jax_sampler, trained["ind_cfg"], phase="test",
            process_index=rank, process_count=world,
        ))
    assert len(port) == len(ref) > 0
    for pb, jb in zip(port, ref):
        assert set(pb) == set(jb)
        for key in jb:
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]), err_msg=key)


@pytest.mark.parametrize("weights", ["trained", "tied"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("perturbed", [True, False], ids=["perturbed", "plain"])
def test_seven_slices_match_jax(trained, fused, perturbed, weights):
    res = trained["res"]
    ckpt_path, params = trained["weights"][weights]
    jcfg = JaxConfig(config_dict=res["config"].as_dict())
    jcfg["use_perturbed_hits"] = perturbed
    jcfg["use_fused_topk"] = fused
    ref = perform_inductive_eval(res["dataset"], ckpt_path, config=jcfg)

    ind_cfg, ind_ds = trained["ind_cfg"], trained["ind_ds"]
    cfg = _port_config(ind_cfg, use_perturbed_hits=perturbed, use_fused_topk=fused)
    n_old_users, n_old_items = res["dataset"].user_num, res["dataset"].item_num
    model = _port_bpr(params, n_old_users, n_old_items, cfg)
    mapper = RandomOOVMapper(
        model.spec, n_old_users, n_old_items, ind_ds.user_num, ind_ds.item_num
    )
    mapper.set_eval()
    evaluator = InductiveEvaluator(model, cfg, n_old_users, n_old_items, mapper=mapper)
    got = evaluator.evaluate_model(_port_ind_loader(trained, cfg))
    assert evaluator._fused is fused

    assert list(got) == list(ref)
    assert len(got["overall"]) > 0
    for s in ref:
        assert set(got[s]) == set(ref[s]), s
        for m, v in ref[s].items():
            assert abs(v - got[s][m]) < 1e-9, (s, m, v, got[s][m])


# GAUC reads the masked score matrix, the item metrics the top-k items and
# the train split's item counts
EXTENDED = ["Recall", "NDCG", "GAUC", "ItemCoverage", "AveragePopularity"]


@pytest.mark.parametrize("metrics", [None, EXTENDED], ids=["default", "extended"])
@pytest.mark.parametrize("weights", ["trained", "tied"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_eval_runner_full_sort_matches_jax(trained, fused, weights, metrics):
    res = trained["res"]
    jcfg = res["config"]
    if metrics is not None:
        jcfg = JaxConfig(config_dict=dict(jcfg.as_dict(), metrics=metrics))
    tr = res["trainer"]
    _, params = trained["weights"][weights]
    jax_train, _, jax_test = data_preparation(jcfg, res["dataset"])
    jax_runner = JaxEvalRunner(tr.model, jcfg, estate=tr.estate)
    jax_runner.train_split = jax_train.split
    ref = jax_runner.evaluate({"params": params}, jax_test)

    cfg = _port_config(jcfg, use_fused_topk=fused)
    model = _port_bpr(params, res["dataset"].user_num, res["dataset"].item_num, cfg)
    splits = res["dataset"].build()
    loader = FullSortEvalBatcher(
        _port_split(splits[2]), _port_sampler(splits), cfg, phase="test"
    )
    runner = EvalRunner(model, cfg)
    runner.train_split = _port_split(splits[0])
    got = runner.evaluate(loader)
    assert runner._use_fused(loader.item_num) is fused
    assert list(got) == list(ref) and len(got) > 0
    for m, v in ref.items():
        assert abs(v - got[m]) < 1e-9, (m, v, got[m])

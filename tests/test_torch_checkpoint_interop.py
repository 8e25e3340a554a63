"""Checkpoints across the packages: a reference `.pth` imported, and the
JAX package's own checkpoints resumed, without flax on the port's side.

Reference import (`utils/torch_import.py`): on synthetic reference-layout
state_dicts (RecBole key names, random values) the port's
`import_state_dict` equals the JAX map leaf for leaf for BPR, DirectAU,
LightGCN, WideDeep, xDeepFM and DCNv2 (stacked without BatchNorm, and mixed with its
gates). On a DCNv2 MLP with its BatchNorm1d modules (RecBole's layout) the
JAX map counts each BatchNorm weight as one more Linear and puts it in
`Dense_1` (`_mlp_direct` there); the port maps the Linears and the
BatchNorms apart, and agrees with JAX on every other leaf. An unmapped
model raises JAX's text. Then from a `.pth` that covers part of the model,
JAX's predictions after `import_reference_checkpoint` and its `run`'s
merge equal the port's after `import_torch_checkpoint` to 1e-5 (BPR and
xDeepFM on toy-ind), and with a whole-model `.pth` the port's
`quick_start.run` (`import_torch_checkpoint`, no training epoch) gives the
JAX run's test metrics to 1e-9.

JAX checkpoints: the JAX `Trainer` writes its pickle (one epoch) for BPR
under adam, sparse_adam, rmsprop, bf16 first moments with lsh (an
embedder state) and the torch-faithful Adam with clipping (per-leaf
counts, the clip wrapper), xDeepFM under adagrad and DCNv2 with its
`batch_stats`; the port's `Trainer.resume_checkpoint` takes each: params,
BatchNorm statistics, embedder state and optimizer state bit for bit,
epoch and best score; one more epoch from it equals the JAX trainer's
resumed epoch (losses 1e-5 relative, parameters 1e-5 absolute). The
msgpack decoder equals flax's on every leaf type (bf16 arrays as their f32
values), and an orbax checkpoint raises (its tensorstore trees have no
numpy reader).

The committed fixture `tests/assets/jax_checkpoints/BPR-synth-ind.ckpt`
(BPR at D 16 on dataset/synth-ind, random-mapper buckets, sparse_adam, one
epoch; 590 KB) was written from the repo root by

    import jax
    jax.config.update("jax_platforms", "cpu")
    from oovrec_tpu.cli.quick_start import run

    run(config_dict=dict(
        model="BPR", dataset="synth-ind", data_path="dataset",
        load_col={"inter": ["user_id", "item_id", "timestamp", "is_new"]},
        embedding_size=16, inductive_mapper="random", add_oov_buckets=True,
        n_user_oov_buckets=32, n_item_oov_buckets=32, train_oov=True, oov_train_ratio=0.3,
        learner="sparse_adam", learning_rate=1e-2, epochs=1, train_batch_size=2048,
        eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO", "group_by": "user",
                   "mode": "full"},
        topk=[10], valid_metric="NDCG@10", device_epoch=False, host_scan_steps=1,
        log_tensorboard=False, checkpoint_dir="tests/assets/jax_checkpoints"))

JAX's `resume_checkpoint` reads it, the port reads it in a process where
flax, msgpack and JAX cannot be imported, and `load_data_and_model` on it
trains on for one epoch (the row-sparse step on resumed moments).
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

from oovrec_tpu.cli import quick_start as jax_quick_start  # noqa: E402
from oovrec_tpu.eval.runner import to_device_batch as jax_device_batch  # noqa: E402
from oovrec_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from oovrec_tpu.utils import torch_import as jax_import  # noqa: E402
from oovrec_tpu_torch.cli import quick_start  # noqa: E402
from oovrec_tpu_torch.data.transfer import to_device_batch  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.utils import torch_import  # noqa: E402
from oovrec_tpu_torch.utils.flax_msgpack import msgpack_restore  # noqa: E402
from oovrec_tpu_torch.utils.jax_checkpoint import is_jax_checkpoint, read_jax_checkpoint  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    batch_stats_from_module,
    embedder_state_to_numpy,
    flax_from_state_dict,
    opt_state_from_flax,
)

from tests.test_torch_trainer import (  # noqa: E402
    EMB,
    _bpr_cfg,
    _dcnv2_cfg,
    _flat,
    _setup,
    _xdfm_cfg,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "assets" / "jax_checkpoints" / "BPR-synth-ind.ckpt"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


# ------------------------------------------------- reference-layout .pth


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _context_sd(rng, first_order=True, buckets=True):
    sd = {"token_embedding_table.embedding.weight": _r(rng, 40, 4),
          "float_embedding_table.embedding.weight": _r(rng, 3, 4)}
    if buckets:
        sd.update({"user_oov_buckets.weight": _r(rng, 5, 4),
                   "item_oov_buckets.weight": _r(rng, 6, 4)})
    if first_order:
        sd.update({"first_order_linear.bias": _r(rng, 1),
                   "first_order_linear.token_embedding_table.embedding.weight": _r(rng, 40, 1),
                   "first_order_linear.float_embedding_table.embedding.weight": _r(rng, 3, 1),
                   "first_order_linear.user_oov_buckets.weight": _r(rng, 5, 1),
                   "first_order_linear.item_oov_buckets.weight": _r(rng, 6, 1)})
    return sd


def _mlp_sd(rng, widths, bn=False):
    """RecBole's `MLPLayers` module list: dropout, Linear, (BatchNorm1d),
    activation for each layer."""
    sd, i = {}, 0
    for a, b in zip(widths[:-1], widths[1:]):
        i += 1  # the dropout
        sd[f"mlp_layers.mlp_layers.{i}.weight"] = _r(rng, b, a)
        sd[f"mlp_layers.mlp_layers.{i}.bias"] = _r(rng, b)
        i += 1
        if bn:
            sd.update({f"mlp_layers.mlp_layers.{i}.{k}": v for k, v in (
                ("weight", _r(rng, b)), ("bias", _r(rng, b)), ("running_mean", _r(rng, b)),
                ("running_var", np.abs(_r(rng, b)) + 0.5),
                ("num_batches_tracked", np.array(7)))})
            i += 1
        i += 1  # the activation
    return sd


def reference_sd(name, rng):
    if name in ("BPR", "DirectAU"):
        return {"user_embedding.weight": _r(rng, 7, 4), "item_embedding.weight": _r(rng, 9, 4),
                "user_oov_buckets.weight": _r(rng, 3, 4), "item_oov_buckets.weight": _r(rng, 5, 4)}
    if name == "LightGCN":
        return {"user_embedding.weight": _r(rng, 7, 4), "item_embedding.weight": _r(rng, 9, 4)}
    if name == "WideDeep":
        return {**_context_sd(rng), **_mlp_sd(rng, (24, 8, 4)),
                "deep_predict_layer.weight": _r(rng, 1, 4), "deep_predict_layer.bias": _r(rng, 1)}
    if name == "xDeepFM":
        return {**_context_sd(rng), **_mlp_sd(rng, (24, 8, 1)),
                "conv1d_list.0.weight": _r(rng, 6, 36, 1), "conv1d_list.0.bias": _r(rng, 6),
                "conv1d_list.1.weight": _r(rng, 6, 18, 1), "conv1d_list.1.bias": _r(rng, 6),
                "cin_linear.weight": _r(rng, 1, 9), "cin_linear.bias": _r(rng, 1)}
    bn = name == "DCNV2-bn"
    sd = {**_context_sd(rng, first_order=False), **_mlp_sd(rng, (24, 8, 4), bn=bn),
          "predict_layer.weight": _r(rng, 1, 28), "predict_layer.bias": _r(rng, 1),
          **{f"bias.{i}": _r(rng, 24, 1) for i in range(2)}}
    if name == "DCNV2-mixed":
        for i in range(2):
            sd.update({f"cross_layer_u.{i}": _r(rng, 3, 24, 4),
                       f"cross_layer_v.{i}": _r(rng, 3, 24, 4),
                       f"cross_layer_c.{i}": _r(rng, 3, 4, 4)})
        sd.update({f"gating.{e}.weight": _r(rng, 1, 24) for e in range(3)})
    else:
        sd.update({f"cross_layer_w.{i}": _r(rng, 24, 24) for i in range(2)})
    return sd


IMPORT_CASES = ["BPR", "DirectAU", "LightGCN", "WideDeep", "xDeepFM", "DCNV2", "DCNV2-mixed",
                "DCNV2-bn"]


@pytest.mark.parametrize("case", IMPORT_CASES)
def test_import_state_dict_matches_jax(case):
    sd = reference_sd(case, np.random.default_rng(IMPORT_CASES.index(case)))
    name = case.split("-")[0]
    got, want = _flat(torch_import.import_state_dict(name, sd)), _flat(
        jax_import.import_state_dict(name, sd))
    if case != "DCNV2-bn":
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert torch_import.import_batch_stats(sd) == {}
        return
    # the JAX map's fault: the BatchNorm weight as a second Linear
    mlp = [k for k in want if "mlp_layers" in k]
    for k in set(want) - set(mlp):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(want["['mlp_layers']['Dense_1']['kernel']"],
                                  sd["mlp_layers.mlp_layers.2.weight"])
    np.testing.assert_array_equal(got["['mlp_layers']['Dense_1']['kernel']"],
                                  sd["mlp_layers.mlp_layers.5.weight"].T)
    np.testing.assert_array_equal(got["['mlp_layers']['BatchNorm_1']['scale']"],
                                  sd["mlp_layers.mlp_layers.6.weight"])
    stats = _flat(torch_import.import_batch_stats(sd))
    np.testing.assert_array_equal(stats["['mlp_layers']['BatchNorm_0']['var']"],
                                  sd["mlp_layers.mlp_layers.2.running_var"])
    assert len(stats) == 4


def test_unmapped_model_raises_the_jax_text():
    with pytest.raises(NotImplementedError) as want:
        jax_import.import_state_dict("NoSuchModel", {})
    with pytest.raises(NotImplementedError) as got:
        torch_import.import_state_dict("NoSuchModel", {})
    prefix = "No torch-import map for model [NoSuchModel] yet; supported:"
    assert str(got.value).startswith(prefix) and str(want.value).startswith(prefix)


def _jax_merge(ours, new):
    """The JAX `run`'s `_merge` (`cli/quick_start.py:219-224` there)."""
    if isinstance(new, dict) and isinstance(ours, dict):
        return {k: (_jax_merge(ours[k], new[k]) if k in new else ours[k]) for k in ours}
    return jnp.asarray(new)


def _to_reference(name, params, rng, partial):
    """A reference-layout state_dict for a model with the flax `params`'
    shapes, random values; `partial` leaves out the first-order tables."""
    def rnd(a):
        return torch.from_numpy(_r(rng, *np.shape(a)))

    if name == "BPR":
        return {f"{k}.weight": rnd(v["embedding"]) for k, v in params.items()}
    f = params["fields"]
    sd = {"token_embedding_table.embedding.weight": rnd(f["token_embedding_table"]["embedding"]),
          "float_embedding_table.embedding.weight": rnd(f["float_embedding_table"]["embedding"]),
          "user_oov_buckets.weight": rnd(f["user_oov_buckets"]["embedding"]),
          "item_oov_buckets.weight": rnd(f["item_oov_buckets"]["embedding"])}
    if not partial:
        fo = params["first_order_linear"]["fo"]
        sd["first_order_linear.bias"] = rnd(params["first_order_linear"]["bias"])
        for k in ("token_embedding_table", "float_embedding_table"):
            sd[f"first_order_linear.{k}.embedding.weight"] = rnd(fo[k]["embedding"])
        for k in ("user_oov_buckets", "item_oov_buckets"):
            sd[f"first_order_linear.{k}.weight"] = rnd(fo[k]["embedding"])
    for i in range(10):
        if f"conv1d_{i}" in params:
            k = params[f"conv1d_{i}"]["kernel"]
            sd[f"conv1d_list.{i}.weight"] = rnd(k.T)[:, :, None]
            sd[f"conv1d_list.{i}.bias"] = rnd(params[f"conv1d_{i}"]["bias"])
    sd["cin_linear.weight"] = rnd(params["cin_linear"]["kernel"].T)
    sd["cin_linear.bias"] = rnd(params["cin_linear"]["bias"])
    for j in range(len(params["mlp_layers"])):
        d = params["mlp_layers"][f"Dense_{j}"]
        sd[f"mlp_layers.mlp_layers.{3 * j + 1}.weight"] = rnd(d["kernel"].T)
        sd[f"mlp_layers.mlp_layers.{3 * j + 1}.bias"] = rnd(d["bias"])
    return sd


@pytest.mark.parametrize("name,partial", [("BPR", False), ("xDeepFM", False), ("xDeepFM", True)],
                         ids=["bpr", "xdeepfm", "xdeepfm-partial"])
def test_imported_predictions_match_jax(name, partial, tmp_path):
    make = _bpr_cfg if name == "BPR" else _xdfm_cfg
    s = _setup(make(tmp_path))
    jcfg, jm, variables, estate, jtrain, _, _ = s["jax"]
    cfg, model, train, _, _ = s["port"]
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": _to_reference(name, variables["params"],
                                            np.random.default_rng(3), partial)}, path)
    params = _jax_merge(variables["params"], jax_import.import_reference_checkpoint(name, path))
    quick_start.import_torch_checkpoint(model, name, str(path))
    got_params = _flat(flax_from_state_dict(model.state_dict(), model))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(got_params[k], v, err_msg=k)
    if partial:  # the first-order tables keep their initial values
        np.testing.assert_array_equal(got_params["['first_order_linear']['bias']"],
                                      np.asarray(variables["params"]["first_order_linear"]["bias"]))
    batch = next(iter(jtrain))
    want = np.asarray(jm.apply({**variables, "params": params}, jax_device_batch(batch),
                               {k: jnp.asarray(v) for k, v in estate.items()},
                               method=jm.predict))
    model.eval()
    with torch.no_grad():
        got = model.predict(to_device_batch(batch, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_import_through_run_matches_jax(tmp_path):
    """`import_torch_checkpoint` in both packages' `run` with no training
    epoch: every leaf of BPR comes from the `.pth`, so the test metrics
    agree."""
    cfg = _bpr_cfg(tmp_path, epochs=0)
    s = _setup(cfg)
    path = tmp_path / "ref.pth"
    torch.save(_to_reference("BPR", s["jax"][2]["params"], np.random.default_rng(5), False),
               path)
    cfg = dict(cfg, import_torch_checkpoint=str(path))
    want = jax_quick_start.run(config_dict=dict(cfg), saved=False)["test_result"]
    got = quick_start.run(config_dict=dict(cfg, device="cpu"), saved=False)["test_result"]
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-9, (k, got[k], want[k])


# -------------------------------------------------------- JAX checkpoints

RESUME = {
    "bpr-adam": (_bpr_cfg, {}),
    "bpr-sparse-adam": (_bpr_cfg, dict(learner="sparse_adam", learning_rate=1e-2)),
    "bpr-rmsprop": (_bpr_cfg, dict(learner="rmsprop")),
    "bpr-adam-bf16-lsh": (_bpr_cfg, dict(optimizer_mu_dtype="bfloat16", **EMB["lsh"])),
    "bpr-torch-adam-clip": (_bpr_cfg, dict(optimizer_skip_zero_grads=True,
                                           clip_grad_norm={"max_norm": 0.5})),
    "xdeepfm-adagrad": (_xdfm_cfg, dict(learner="adagrad", learning_rate=0.02)),
    "dcnv2-batch-stats": (_dcnv2_cfg, {}),
}


@pytest.mark.parametrize("case", list(RESUME))
def test_resume_a_jax_checkpoint(case, tmp_path):
    make, over = RESUME[case]
    s = _setup(make(tmp_path, epochs=1, oov_freeze_embedding=True, **over))
    jcfg, jm, variables, estate, jtrain, jvalid, _ = s["jax"]
    jt = JaxTrainer(jcfg, jm, variables, dict(estate))
    jt.fit(jtrain, jvalid, saved=True)
    path = jt.saved_model_file
    assert is_jax_checkpoint(path)

    cfg, model, _, _, _ = s["port"]
    pt = Trainer(cfg, model)
    state = pt.resume_checkpoint(path)
    assert state["epoch"] == 0 and pt.start_epoch == 1
    assert pt.best_valid_score == jt.best_valid_score
    got = _flat(flax_from_state_dict(model.state_dict(), model))
    for k, v in _flat(jt.variables["params"]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    stats = _flat(batch_stats_from_module(model))
    assert stats.keys() == _flat(jt.variables.get("batch_stats", {})).keys()
    assert bool(stats) == case.startswith("dcnv2")
    for k, v in _flat(jt.variables.get("batch_stats", {})).items():
        np.testing.assert_array_equal(stats[k], v, err_msg=k)
    if estate:
        mine = embedder_state_to_numpy(model)
        for k, v in estate.items():
            if k in mine:
                np.testing.assert_array_equal(mine[k], np.asarray(v), err_msg=k)
    want_opt = opt_state_from_flax(jt.opt_state, pt.optimizer.rule, model)
    for part, tree in want_opt.items():
        if isinstance(tree, dict):
            for n, t in tree.items():
                live = pt.opt_state[part][n]
                assert torch.equal(live.float(), t.float()), (part, n)
        else:
            assert pt.opt_state[part] == tree, part
    if "bf16" in case:
        assert pt.opt_state["mu"]["user_embedding.weight"].dtype == torch.bfloat16
        assert any(v.dtype == jnp.bfloat16 for v in jax.tree_util.tree_leaves(jt.opt_state))
    if case == "bpr-torch-adam-clip":
        assert pt.opt_state["count"]["user_embedding.weight"].dtype == torch.int32
        assert int(pt.opt_state["count"]["user_embedding.weight"]) > 0

    # one more epoch from the checkpoint in both packages, fresh loaders
    s2 = _setup(make(tmp_path, epochs=2, oov_freeze_embedding=True, **over))
    jcfg2, jm2, variables2, estate2, jtrain2, jvalid2, _ = s2["jax"]
    jt2 = JaxTrainer(jcfg2, jm2, variables2, dict(estate2))
    jt2.resume_checkpoint(path)
    jt2.fit(jtrain2, jvalid2, saved=False)
    cfg2, model2, train2, valid2, _ = s2["port"]
    pt2 = Trainer(cfg2, model2)
    pt2.resume_checkpoint(path)
    pt2.fit(train2, valid2, saved=False)
    assert list(pt2.train_loss_dict) == list(jt2.train_loss_dict) == [1]
    np.testing.assert_allclose(pt2.train_loss_dict[1], jt2.train_loss_dict[1], rtol=1e-5)
    got = _flat(flax_from_state_dict(model2.state_dict(), model2))
    for k, v in _flat(jt2.variables["params"]).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


def test_msgpack_decoder_matches_flax():
    rng = np.random.default_rng(0)
    tree = {"a": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                  "c": np.arange(5, dtype=np.int64)},
            "scalar": np.float32(3.5), "count": np.int32(7), "long": list(range(300)),
            "neg": -5, "negbig": -100000, "u64": np.array([2 ** 63 + 5], np.uint64),
            "bf16": jnp.asarray(rng.standard_normal(10), jnp.bfloat16), "cx": 1 + 2j,
            "text": "x" * 40, "none": None, "flag": True, "float": 1.5, "empty": {},
            "many": {str(i): np.float32(i) for i in range(20)},
            "no_rows": np.zeros((0, 3), np.float32), "f16": np.ones(70000, np.float16)}
    data = serialization.msgpack_serialize(tree)
    got, want = msgpack_restore(data), serialization.msgpack_restore(data)

    def same(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                same(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, np.ndarray) and w.dtype == jnp.bfloat16:
            assert g.dtype == np.float32, path
            np.testing.assert_array_equal(g, w.astype(np.float32), err_msg=path)
        elif isinstance(w, (np.ndarray, np.generic)):
            assert np.asarray(g).dtype == np.asarray(w).dtype and np.shape(g) == np.shape(w)
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert g == w and type(g) is type(w), path

    same(got, want, "")
    # a chunked array (flax splits arrays above 2^30 bytes) joins again
    chunked = serialization.msgpack_serialize({"t": {
        "__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 3},
        "chunks": {"0": np.arange(4.0), "1": np.arange(4.0, 6.0)}}})
    np.testing.assert_array_equal(msgpack_restore(chunked)["t"],
                                  np.arange(6.0).reshape(2, 3))


def test_sharded_checkpoint_raises(tmp_path):
    path = tmp_path / "sharded.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"epoch": 0, "__orbax__": ["opt_state", "params"]}, f)
    with pytest.raises(NotImplementedError, match="tensorstore"):
        read_jax_checkpoint(str(path))
    with open(path, "wb") as f:
        pickle.dump({"epoch": 0, "unsafe": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|nt.getcwd"):
        read_jax_checkpoint(str(path))


def test_committed_fixture_reads_in_both_packages_and_trains_on(tmp_path, monkeypatch):
    assert FIXTURE.stat().st_size < 1 << 20
    monkeypatch.chdir(ROOT)
    # JAX's own reader
    loaded = jax_quick_start.load_data_and_model(str(FIXTURE), {"log_tensorboard": False,
                                                                "checkpoint_dir": str(tmp_path)})
    jparams = _flat(loaded.trainer.variables["params"])
    # the port's, then one more epoch on the resumed moments
    run = quick_start.load_data_and_model(str(FIXTURE), {"device": "cpu",
                                                         "checkpoint_dir": str(tmp_path)})
    trainer = run.trainer
    got = _flat(flax_from_state_dict(run.model.state_dict(), run.model))
    assert got.keys() == jparams.keys()
    for k, v in jparams.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert trainer.optimizer.rule == "lazy_adam" and trainer.start_epoch == 1
    assert trainer.sparse_tables and trainer.opt_state["count"] > 0
    want_opt = opt_state_from_flax(loaded.trainer.opt_state, "lazy_adam", run.model)
    for part in ("mu", "nu"):
        for n, t in want_opt[part].items():
            assert torch.equal(trainer.opt_state[part][n], t), (part, n)
    count = trainer.opt_state["count"]
    trainer.epochs = 2
    trainer.fit(run.train_loader, run.valid_loader, saved=False)
    assert list(trainer.train_loss_dict) == [1] and np.isfinite(trainer.train_loss_dict[1])
    assert trainer.opt_state["count"] > count
    # the port's reader needs neither flax, msgpack nor JAX
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('flax', 'msgpack', 'jax', 'jaxlib', 'optax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from oovrec_tpu_torch.utils.jax_checkpoint import read_jax_checkpoint\n"
        f"s = read_jax_checkpoint({str(FIXTURE)!r})\n"
        "print(sorted(s['params']), s['opt_state']['0']['count'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "item_embedding" in out.stdout

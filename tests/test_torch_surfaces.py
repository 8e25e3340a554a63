"""The surfaces users reach for after a run, against the JAX package's, on
the CPU: the significance test (`cli/significance_test.py`), the model
cost reports (`utils/flops.py`), the case study (`utils/case_study.py`)
and the TensorBoard and wandb hooks (`utils/tensorboard.py`,
`utils/wandblogger.py`, the trainer's and `cli/run.py:backup_weights`).

Runs that train start the port from the JAX run's initial weights: the
JAX package's `build_model_and_state` is wrapped to record them and the
port's to load them through `utils/jax_params.py`. Their metrics, losses
and logged values agree to 1e-5, the tolerance `test_torch_trainer.py`
holds a run's metrics to.
"""

import math
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli import run as jax_run  # noqa: E402
from oovrec_tpu.cli import significance_test as jax_sig  # noqa: E402
from oovrec_tpu.config import parse_cli_args as jax_parse  # noqa: E402
from oovrec_tpu.utils import case_study as jax_case  # noqa: E402
from oovrec_tpu.utils import flops as jax_flops  # noqa: E402
from oovrec_tpu_torch.cli import run as port_run  # noqa: E402
from oovrec_tpu_torch.cli import significance_test as port_sig  # noqa: E402
from oovrec_tpu_torch.config import parse_cli_args as port_parse  # noqa: E402
from oovrec_tpu_torch.data.transfer import to_device_batch  # noqa: E402
from oovrec_tpu_torch.data.utils import data_preparation as port_data_preparation  # noqa: E402
from oovrec_tpu_torch.ops import cin_fused, embed_grad, launches, sparse_rows, topk_score  # noqa: E402,E501
from oovrec_tpu_torch.utils import case_study as port_case  # noqa: E402
from oovrec_tpu_torch.utils import flops as port_flops  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import load_flax_params  # noqa: E402

from tests.test_torch_dataset import ASSETS  # noqa: E402
from tests.test_torch_hyper_tuning import bridge_trials  # noqa: E402

TOL = 1e-5
LOAD_COL = ("--load_col={'inter': ['user_id','item_id','rating','timestamp','is_new'], "
            "'user': ['user_id','age','gender'], 'item': ['item_id','price','category']}")
TOY = ["--dataset=toy", f"--data_path={ASSETS}", "--train_batch_size=16",
       "--embedding_size=8", "--log_tensorboard=False", "--metric_decimal_place=12"]
TOY_IND = ["--dataset=toy-ind", f"--data_path={ASSETS}", "--train_batch_size=16",
           "--embedding_size=8", LOAD_COL, "--log_tensorboard=False",
           "--metric_decimal_place=12"]
RANKING = ["--model_eval_type=ranking", "--numerical_features=['age','price']",
           "--threshold={'rating': 4}", "--dropout_prob=0.0", "--mlp_hidden_size=[16,8]"]
OOV = ["--inductive_mapper=random", "--add_oov_buckets=True", "--n_user_oov_buckets=8",
       "--n_item_oov_buckets=8", "--train_oov=True"]
KNOWLEDGE = ["--dataset=toy-kg", f"--data_path={ASSETS}", "--train_batch_size=16",
             "--embedding_size=8", "--log_tensorboard=False",
             "--load_col={'inter': ['user_id','item_id','rating','timestamp']}"]


@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    """Both packages keep a module-global feature cache per mode: each test
    starts from an empty one and leaves one."""
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


def _agree(a, b, what, tol=TOL):
    assert list(a) == list(b), what
    for k in a:
        assert abs(float(a[k]) - float(b[k])) <= tol, (what, k, a[k], b[k])


# ------------------------------------------------------------ significance


def test_significance_test_under_a_fake_objective_matches_jax(monkeypatch):
    def fake(config_dict=None, config_file_list=None, saved=False):
        s = config_dict["seed"]
        v = math.sin(s * config_dict["learning_rate"]) + 0.01 * (s % 7)
        return {"test_result": {"mrr@10": v, "recall@10": 2 * v}}

    monkeypatch.setattr(jax_quick_start, "objective_function", fake)
    monkeypatch.setattr(port_quick_start, "objective_function", fake)
    for metric in (None, "Recall@10"):
        a, b = {"learning_rate": 0.3}, {"learning_rate": 0.7}
        want = jax_sig.significance_test(a, b, metric=metric)
        got = port_sig.significance_test(a, b, metric=metric)
        assert got == want
        assert len(got["a_values"]) == 5
    assert port_sig.run_seeds({"learning_rate": 0.5}, [1, 2]) == jax_sig.run_seeds(
        {"learning_rate": 0.5}, [1, 2])


def test_significance_test_runs_match_jax(tmp_path, monkeypatch):
    bridge_trials(monkeypatch)
    monkeypatch.chdir(tmp_path)
    base = dict(port_parse(["--model=BPR", *TOY, "--epochs=1"]))
    res = {}
    for side, mod, extra in (("jax", jax_sig, {}), ("port", port_sig, {"device": "cpu"})):
        a = {**base, **extra, "learning_rate": 0.01}
        b = {**base, **extra, "learning_rate": 0.05}
        res[side] = mod.significance_test(a, b, seeds=[2020, 2021], metric="mrr@10")
    j, p = res["jax"], res["port"]
    assert list(p) == list(j)
    for k in ("a_values", "b_values"):
        np.testing.assert_allclose(p[k], j[k], rtol=0, atol=TOL, err_msg=k)
    for k in ("a_mean", "b_mean"):
        assert abs(p[k] - j[k]) <= TOL, k
    for k in ("t_statistic", "p_value"):  # NaN where a and b differ alike in both seeds
        assert math.isnan(p[k]) == math.isnan(j[k]), k


# ------------------------------------------------------------ cost reports


class _Built(Exception):
    """Raised by the wrapped build functions once a model exists: no training."""


def _models_of(flags):
    """The JAX package's (model, variables, estate) and the port's model,
    config and dataset for the same command line, the port's model with
    the JAX weights loaded."""
    built = {}
    jax_build = jax_quick_start.build_model_and_state
    port_build = port_quick_start.build_model_and_state

    def jax_stop(config, dataset, **kw):
        built["jax"] = jax_build(config, dataset, **kw)
        raise _Built

    def port_stop(config, dataset, **kw):
        built.update(port=port_build(config, dataset, **kw), config=config, dataset=dataset)
        raise _Built

    jax_quick_start.build_model_and_state = jax_stop
    port_quick_start.build_model_and_state = port_stop
    try:
        with pytest.raises(_Built):
            jax_quick_start.run(config_dict=jax_parse(flags))
        with pytest.raises(_Built):
            port_quick_start.run(config_dict=port_parse(flags + ["--device=cpu"]))
    finally:
        jax_quick_start.build_model_and_state = jax_build
        port_quick_start.build_model_and_state = port_build
    load_flax_params(built["port"], built["jax"][1]["params"])
    return built


COUNT_CASES = {
    "BPR": ["--model=BPR", *TOY],
    "DirectAU": ["--model=DirectAU", *TOY],
    "LightGCN": ["--model=LightGCN", *TOY],
    "WideDeep": ["--model=WideDeep", *TOY_IND, *RANKING, *OOV],
    "DCNV2": ["--model=DCNV2", *TOY_IND, *RANKING, *OOV, "--cross_layer_num=2"],
    "xDeepFM": ["--model=xDeepFM", *TOY_IND, *RANKING, *OOV, "--cin_layer_size=[8,8]"],
    "SASRec": ["--model=SASRec", *TOY_IND, "--MAX_ITEM_LIST_LENGTH=4"],
    "KGAT": ["--model=KGAT", *KNOWLEDGE, "--layers=[8,8]", "--kg_embedding_size=8"],
}


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_count_params_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    built = _models_of(COUNT_CASES[case])
    model = built["port"]
    want = jax_flops.count_params(built["jax"][1]["params"])
    assert port_flops.count_params(model) == want > 0


def test_get_flops_counts_a_toy_xdeepfm_by_hand(tmp_path, monkeypatch):
    """Every matrix product of the loss and its backward: the CIN layers
    through the kernel wrapper's plain version (2·B·H·F·D·L forward, three
    times that backward), the MLP and `cin_linear` (2·B·in·out forward,
    twice that backward: the input's and the weight's gradients)."""
    monkeypatch.chdir(tmp_path)
    flags = COUNT_CASES["xDeepFM"] + ["--fused_cin=True", "--mlp_hidden_size=[16,8]"]
    built = _models_of(flags)
    model = built["port"]
    train = port_data_preparation(built["config"], built["dataset"])[0]
    batch = to_device_batch(train._make_batch(np.arange(8)), "cpu")
    b = len(batch["weight"])  # the rows the model computes, the padding's included
    want = sum(8 * bb * h * f * d * l for bb, h, f, d, l in model.cin_layer_shapes(b))
    widths = [model.in_feature_num, 16, 8, 1]
    want += sum(6 * b * i * o for i, o in zip(widths, widths[1:]))
    want += 6 * b * model.cin_linear.in_features
    drawing = [m.generator for m in model.modules() if hasattr(m, "generator")]
    got = port_flops.get_flops(model, batch)
    assert got["flops_per_step"] == want
    # its own dropout stream: the model's generators are left as they were
    assert [m.generator for m in model.modules() if hasattr(m, "generator")] == drawing
    assert got["params"] == port_flops.count_params(model)
    assert math.isnan(got["bytes_per_step"])
    assert all(p.grad is None for p in model.parameters())


def test_get_flops_adds_the_launched_operations():
    """A launch is invisible to FlopCounterMode: `get_flops` adds what the
    wrappers tally (`ops/launches.py`) to what it counts."""

    class Launching(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3, 2))

        def calculate_loss(self, batch):
            launches.add_operations(1000)
            return (batch["x"] @ self.w).sum()

    got = port_flops.get_flops(Launching(), {"x": torch.ones(5, 3)})
    assert got["flops_per_step"] == 2 * 5 * 3 * 2 * 2 + 1000
    with launches.operation_tally() as outer:
        launches.add_operations(7)
        with launches.operation_tally() as inner:
            launches.add_operations(5)
    launches.add_operations(3)  # no tally open
    assert (outer.total, inner.total) == (12, 5)

    class Broken(Launching):
        def calculate_loss(self, batch):
            raise RuntimeError("no loss")

    assert math.isnan(port_flops.get_flops(Broken(), {})["flops_per_step"])


def _counted(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        fn(*args)
    return mode.get_total_flops()


@pytest.mark.parametrize("shape", [(4, 3, 5, 7, 6), (9, 2, 2, 1, 3), (2, 10, 3, 16, 20)])
def test_wrapper_operations_are_their_plain_versions_count(shape):
    """Each formula a wrapper adds at a launch is what FlopCounterMode
    counts in its plain version; the plain versions of kernel 6 and the
    gathers' backward count nothing."""
    B, H, F, D, L = shape
    g = torch.Generator().manual_seed(B * L)
    a, b0 = torch.randn(B, H, D, generator=g), torch.randn(B, F, D, generator=g)
    w, bias = torch.randn(H * F, L, generator=g), torch.randn(L, generator=g)
    nh = L // 2
    fwd, bwd = cin_fused.cin_operations(*shape), cin_fused.cin_operations(*shape, backward=True)
    for dt in ("float32", "bfloat16"):
        assert _counted(cin_fused.cin_layer_plain, a, b0, w, bias, dt) == fwd
        assert _counted(cin_fused.cin_layer_pooled_plain, a, b0, w, bias, dt, nh) == fwd
        gh, gp = torch.randn(B, nh, D, generator=g), torch.randn(B, L - nh, generator=g)
        assert _counted(cin_fused.cin_layer_pooled_bwd_plain, a, b0, w, bias, gh, gp, dt,
                        nh) == bwd
        assert _counted(cin_fused.cin_layer_bwd_plain, a, b0, w, bias,
                        torch.randn(B, L, D, generator=g), dt) == bwd
    n_items = 40 * D
    u, it = torch.randn(B, D, generator=g), torch.randn(n_items, D, generator=g)
    bitmap = torch.zeros(B, -(-n_items // 32), dtype=torch.int32)
    assert (_counted(topk_score.fused_topk_scores_plain, u, it, bitmap, 5)
            == topk_score.topk_operations(B, n_items, D))
    ids = torch.randint(0, 9, (B * H,), generator=g)
    assert _counted(embed_grad.scatter_rows_plain, torch.randn(B * H, D, generator=g), ids,
                    9) == 0
    p, mu, nu = (torch.randn(9, D, generator=g) for _ in range(3))
    assert _counted(sparse_rows.sparse_adam_rows_plain, p, mu, nu, torch.arange(3),
                    torch.randn(3, D, generator=g), 1, 1e-3, 0.9, 0.999, 1e-8) == 0


def test_list_to_latex_matches_jax():
    rows = [{"model": "BPR", "recall@10": 0.31234, "mrr@10": 0.1},
            {"model": "LightGCN", "recall@10": 0.4, "mrr@10": None},
            {"model": "xDeepFM", "recall@10": 0.2, "mrr@10": 0.15}]
    for kw in ({}, {"bigger_flag": False}, {"subset_columns": ["mrr@10"]}):
        assert port_flops.list_to_latex(rows, **kw) == jax_flops.list_to_latex(rows, **kw)
    assert port_flops.list_to_latex([]) == jax_flops.list_to_latex([]) == ("", None)


def test_environment_and_device_usage_on_the_cpu():
    env = port_flops.get_environment()
    assert env["devices"] == ["cpu"] and env["device_kind"] == "cpu"
    assert env["process_count"] == 1 and env["platform"]
    assert port_flops.get_device_usage() == "no devices"


# ------------------------------------------------------------ case study


def test_full_sort_topk_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    built = _models_of(["--model=BPR", *TOY])
    jm, variables, estate = built["jax"]
    model, ds = built["port"], built["dataset"]
    rng = np.random.default_rng(5)
    uids = np.arange(1, ds.user_num)
    hist = {int(u): rng.choice(np.arange(1, ds.item_num), size=int(u) % 3, replace=False)
            for u in uids}
    k = ds.item_num - 1
    for h in (None, hist):
        js, ji = jax_case.full_sort_topk(uids, jm, variables, k, estate=estate,
                                         hist_per_user=h)
        ps, pi = port_case.full_sort_topk(uids, model, k, hist_per_user=h)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(ps, js, rtol=0, atol=1e-6)
        assert np.isneginf(ps[pi == 0]).all()  # column 0 is masked
    # ties go to the lowest item id, as JAX's stable argsort
    with torch.no_grad():
        model.item_embedding.weight[3] = model.item_embedding.weight[5]
    _, tied = port_case.full_sort_topk(uids, model, k)
    for row in tied:
        pos = list(row)
        assert pos.index(3) < pos.index(5)


def test_case_study_from_a_port_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["--model=BPR", *TOY, "--epochs=1", "--device=cpu",
             f"--checkpoint_dir={tmp_path / 'saved'}"]
    res = port_quick_start.run(config_dict=port_parse(flags), saved=True)
    ckpt = res["trainer"].saved_model_file
    scores, tokens = port_case.case_study_from_checkpoint(["u1", "u2"], ckpt, k=3)
    assert scores.shape == tokens.shape == (2, 3)
    assert np.isfinite(scores).all() and (np.diff(scores, axis=1) <= 0).all()
    ds = res["dataset"]
    train = res["trainer"].eval_runner.train_split
    for row, tok in zip(tokens, ("u1", "u2")):
        u = ds.token2id(ds.uid_field, tok)
        seen = set(np.asarray(train.inter[ds.iid_field])[
            np.asarray(train.inter[ds.uid_field]) == u].tolist())
        ids = ds.token2id(ds.iid_field, [str(t) for t in row])
        assert not seen & set(ids.tolist())
        assert 0 not in ids
    assert ds.id2token(ds.iid_field, ids).tolist() == [str(t) for t in row]


# ------------------------------------------------------------ TensorBoard, wandb


def _events(root):
    """{(run-relative directory, tag): [(step, value)]} of every event file
    under `root`."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    out = {}
    for path in sorted(root.rglob("events.out.tfevents.*")):
        acc = EventAccumulator(str(path.parent))
        acc.Reload()
        rel = "hparams" if path.parent.parent != root else "run"
        for tag in acc.Tags()["scalars"]:
            out[(rel, tag)] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out


TB_FLAGS = ["--model=BPR", *TOY_IND, *OOV, "--oov_only_epoch=True", "--oov_train_ratio=0.5",
            "--epochs=2"]


def test_tensorboard_event_files_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("OOVREC_DISABLE_TENSORBOARD", raising=False)
    # a stub that a JAX-side test installed on this worker
    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard", raising=False)
    bridge_trials(monkeypatch)
    got = {}
    for side, qs, extra in (("jax", jax_quick_start, []),
                            ("port", port_quick_start, ["--device=cpu"])):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        tb = tmp_path / side / "tb"
        flags = [f for f in TB_FLAGS if f != "--log_tensorboard=False"]
        parse = jax_parse if side == "jax" else port_parse
        qs.run(config_dict=parse(flags + extra + ["--log_tensorboard=True",
                                                  f"--tensorboard_dir={tb}"]), saved=False)
        (run_dir,) = list(tb.iterdir())
        assert run_dir.name.startswith("BPR-toy-ind-")
        got[side] = _events(run_dir)
    j, p = got["jax"], got["port"]
    assert sorted(p) == sorted(j)
    tags = {t for _, t in p}
    assert {"Loss/Train", "Loss/OOV", "Valid_score", "hparam/best_valid_result",
            "Valid/mrr@10"} <= tags
    for key in j:
        assert [s for s, _ in p[key]] == [s for s, _ in j[key]], key
        for (_, pv), (_, jv) in zip(p[key], j[key]):
            assert abs(pv - jv) <= TOL * max(1.0, abs(jv)), (key, pv, jv)


def test_tensorboard_is_off_without_the_wheel_or_when_disabled(tmp_path, monkeypatch):
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.utils.tensorboard import TensorboardLogger, get_tensorboard

    cfg = Config({"model": "BPR", "dataset": "toy", "log_tensorboard": True})
    monkeypatch.setenv("OOVREC_DISABLE_TENSORBOARD", "1")
    assert get_tensorboard(cfg, str(tmp_path)) is None
    monkeypatch.delenv("OOVREC_DISABLE_TENSORBOARD")
    assert get_tensorboard(Config({"model": "BPR", "dataset": "toy",
                                   "log_tensorboard": False}), str(tmp_path)) is None
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    logger = TensorboardLogger(cfg, str(tmp_path))
    logger.add_scalar("Loss/Train", 1.0, 0)
    logger.add_scalars("Valid", {"mrr@10": 0.5}, 0)
    logger.add_hparams(0.5)
    logger.close()
    assert logger._writer is None and not list(tmp_path.iterdir())


class _FakeWandb(types.ModuleType):
    """A `wandb` module that records every call."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, payload, commit=True):
        self.calls.append(("log", dict(payload), commit))

    def alert(self, title, text):
        self.calls.append(("alert", title, text))


def _payloads_agree(p, j):
    assert [c[0] for c in p] == [c[0] for c in j]
    for pc, jc in zip(p, j):
        if pc[0] == "init":
            assert pc[1]["project"] == jc[1]["project"] == "oovrec_tpu"
            for key in ("model", "dataset", "epochs", "log_wandb", "learning_rate"):
                assert pc[1]["config"][key] == jc[1]["config"][key], key
        elif pc[0] == "log":
            assert list(pc[1]) == list(jc[1]) and pc[2] == jc[2]
            for k, v in jc[1].items():
                if isinstance(v, str):
                    assert pc[1][k] == v
                else:
                    assert abs(float(pc[1][k]) - float(v)) <= TOL, (k, pc[1][k], v)
        else:
            assert pc == jc


def test_wandb_payloads_match_jax(tmp_path, monkeypatch):
    bridge_trials(monkeypatch)
    calls = {}
    for side, mod, extra in (("jax", jax_run, []), ("port", port_run, ["--device=cpu"])):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        mod.main(["--model=BPR", *TOY, "--epochs=2", "--log_wandb=True", *extra,
                  f"--checkpoint_dir={tmp_path / side / 'saved'}",
                  f"--nfs_backup_path={tmp_path / side / 'nfs'}"])
        calls[side] = fake.calls
    j, p = calls["jax"], calls["port"]
    assert [c[0] for c in p] == ["init", "log", "log", "log"]
    assert p[-1] == ("log", {"file_backup_medium": "nfs"}, False)
    assert all(k.startswith("valid/") for k in p[1][1])
    _payloads_agree(p, j)

    # every medium fails: the alert, in both packages
    (tmp_path / "fail").mkdir()
    monkeypatch.chdir(tmp_path / "fail")
    (tmp_path / "fail" / "saved").write_text("a file where the local backup's directory goes")
    weights = tmp_path / "fail" / "w.pth"
    weights.write_bytes(b"0")
    failed = {}
    for side, mod in (("jax", jax_run), ("port", port_run)):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        from oovrec_tpu_torch.utils.wandblogger import WandbLogger as PortLogger
        from oovrec_tpu.utils.wandblogger import WandbLogger as JaxLogger

        logger = (JaxLogger if side == "jax" else PortLogger)({"log_wandb": True})
        media = mod.backup_weights([str(weights)], config={"dataset": "toy"},
                                   nfs_path=str(tmp_path / "fail" / "saved" / "nfs"),
                                   wandb_logger=logger)
        assert media == []
        failed[side] = fake.calls
    assert failed["port"] == failed["jax"]
    assert failed["port"][-1] == ("alert", "Backup Failure", "Failed to backup to any medium!")


def test_wandb_is_off_without_the_module(monkeypatch):
    from oovrec_tpu_torch.utils.wandblogger import WandbLogger

    monkeypatch.setitem(sys.modules, "wandb", None)
    logger = WandbLogger({"log_wandb": True})
    assert not logger.log_wandb and not logger.setup_complete
    logger.log_metrics({"mrr@10": 1.0})
    logger.log_raw({"file_backup_medium": "nfs"})
    logger.alert("t", "x")
    assert not WandbLogger({"log_wandb": False}).log_wandb

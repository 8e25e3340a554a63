"""The hyper-parameter search (`oovrec_tpu_torch/train/hyper_tuning.py`,
`cli/run_hyper.py`) against the JAX package's, on the CPU.

The `.hyper` parameters parse, sample, grid and transform as JAX's do,
and refuse what JAX's refuse. Under one fake objective (a fixed function
of the trial's parameters, monkeypatched into nothing: it is passed to
both searches) the trial sequences are JAX's bit for bit, for each
algorithm, under `valid_score_bigger` False and with NaN scores: the
parameters, the scores, the best trial and the text of `export_result`.
Then `run_hyper.main` on toy BPR in both packages: the port's trials
start from the JAX trials' initial weights (the JAX package's
`build_model_and_state` is wrapped to record them, the port's to load
them through `utils/jax_params.py`), the trial parameters are equal and
the valid scores agree to 1e-5, the tolerance `test_torch_trainer.py`
holds a run's metrics to. `--tool=ray` exits at once without ray.
"""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli import run_hyper as jax_run_hyper  # noqa: E402
from oovrec_tpu.train import hyper_tuning as jax_ht  # noqa: E402
from oovrec_tpu_torch import train as port_train  # noqa: E402
from oovrec_tpu_torch.cli import run_hyper as port_run_hyper  # noqa: E402
from oovrec_tpu_torch.train import hyper_tuning as port_ht  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import load_flax_params  # noqa: E402

from tests.test_torch_dataset import ASSETS  # noqa: E402

TOL = 1e-5
HYPER = """learning_rate loguniform (1e-4, 1e-1)
dropout_prob uniform (0.0, 0.5)
hidden_size quniform (8, 64, 8)
embedding_size choice [16, 32, 64]
loss_type choice ['BPR', 'CE']
"""
GRID = """embedding_size choice [16, 32, 64]
reg_weight choice [0.0, 1e-3]
"""
LINES = HYPER.splitlines() + ["layers choice [[64, 32], [128]]", "w uniform [-1.5, 2]",
                              "q quniform (0.1, 1.0, 0.25)"]


def test_package_exports_hyper_tuning():
    assert port_train.HyperTuning is port_ht.HyperTuning


@pytest.mark.parametrize("line", LINES)
def test_parameter_parses_samples_and_transforms_as_jax(line):
    jp, pp = jax_ht.Parameter.parse(line), port_ht.Parameter.parse(line)
    assert (pp.name, pp.kind, pp.spec) == (jp.name, jp.kind, jp.spec)
    jr, pr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(50):
        a, b = jp.sample(jr), pp.sample(pr)
        assert type(a) is type(b) and repr(a) == repr(b)
    if jp.kind == "choice":
        assert pp.grid() == jp.grid()
        return
    with pytest.raises(ValueError, match="Exhaustive search only supports 'choice'"):
        jp.grid()
    with pytest.raises(ValueError, match="Exhaustive search only supports 'choice'"):
        pp.grid()
    assert pp._bounds() == jp._bounds()
    lo, hi = jp._bounds()
    for z in np.linspace(lo, hi, 9):
        x = jp._untransform(float(z))
        assert repr(pp._untransform(float(z))) == repr(x)
        if x > 0 or jp.kind != "loguniform":
            assert repr(pp._transform(x)) == repr(jp._transform(x))


def test_unknown_kind_and_algo_are_refused_as_in_jax():
    for mod in (jax_ht, port_ht):
        p = mod.Parameter.parse("x normal (0, 1)")
        with pytest.raises(ValueError, match=r"Unknown parameter kind \[normal\]"):
            p.sample(np.random.default_rng(0))
        ht = mod.HyperTuning(lambda **kw: None, algo="grid", params_dict={"a": [1]})
        with pytest.raises(NotImplementedError, match=r"algo \[grid\] not supported"):
            ht.run()


def _fake_objective(bigger=True, nan_every=0):
    """A score from the trial's parameters alone, NaN every `nan_every`-th
    call; the same function for both searches."""
    calls = []

    def objective(config_dict=None, config_file_list=None):
        calls.append(dict(config_dict))
        n = len(calls)
        lr = float(config_dict.get("learning_rate", 1e-2))
        score = (-(math.log10(lr) + 2.3) ** 2 + 0.01 * config_dict.get("embedding_size", 0)
                 + 0.3 * config_dict.get("dropout_prob", 0.0)
                 - 0.002 * config_dict.get("hidden_size", 0)
                 + (0.05 if config_dict.get("loss_type") == "CE" else 0.0)
                 - 10 * config_dict.get("reg_weight", 0.0))
        if nan_every and n % nan_every == 0:
            score = float("nan")
        return {"best_valid_score": score if bigger or score != score else -score,
                "valid_score_bigger": bigger,
                "test_result": {"recall@10": n / 10, "fixed": config_dict.get("fixed")}}

    return objective


CASES = {  # algo, .hyper text, max_evals, fake objective's arguments, TPE knobs
    "exhaustive": ("exhaustive", GRID, 5, {}, {}),
    "exhaustive-all": ("exhaustive", GRID, 100, {}, {}),
    "random": ("random", HYPER, 12, {}, {}),
    "bayes": ("bayes", HYPER, 24, {}, {"n_startup": 4}),
    "bayes-default-knobs": ("bayes", HYPER, 10, {}, {}),
    "bayes-smaller-is-better": ("bayes", HYPER, 20, {"bigger": False},
                                {"n_startup": 3, "gamma": 0.4, "n_candidates": 8}),
    "bayes-nan": ("bayes", HYPER, 20, {"nan_every": 3}, {"n_startup": 4}),
    "random-nan": ("random", HYPER, 9, {"nan_every": 2}, {}),
}


def _text(x):
    return repr(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trial_sequence_matches_jax_bit_for_bit(case, tmp_path):
    algo, text, max_evals, obj_kw, knobs = CASES[case]
    params = tmp_path / "p.hyper"
    params.write_text(text)
    out = {}
    for side, mod in (("jax", jax_ht), ("port", port_ht)):
        ht = mod.HyperTuning(_fake_objective(**obj_kw), algo=algo, params_file=str(params),
                             fixed_config_dict={"fixed": 3}, max_evals=max_evals, seed=11,
                             **knobs)
        ht.run()
        ht.export_result(str(tmp_path / f"{side}.txt"))
        out[side] = ht
    j, p = out["jax"], out["port"]
    assert len(p.params_list) == min(max_evals, 6 if algo == "exhaustive" else max_evals)
    assert _text(p.params_list) == _text(j.params_list)
    assert _text(p.score_list) == _text(j.score_list)
    assert _text(p.best_params) == _text(j.best_params)
    assert _text(p.best_score) == _text(j.best_score)
    assert p.best_test_result == j.best_test_result
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    if obj_kw.get("nan_every"):
        assert any(s != s for s in p.score_list)


HYPER_BPR = """learning_rate loguniform (1e-3, 1e-1)
embedding_size choice [4, 8]
"""
BPR_ARGS = ["--model=BPR", "--dataset=toy", f"--data_path={ASSETS}", "--epochs=1",
            "--train_batch_size=16", "--algo=random", "--max_evals=2",
            "--metric_decimal_place=12", "--log_tensorboard=False"]


def bridge_trials(monkeypatch):
    """Record each JAX trial's initial weights; start the port's trials, in
    the same order, from them."""
    recorded = []
    jax_build = jax_quick_start.build_model_and_state

    def recording(config, dataset, mode="transductive", **kw):
        model, variables, estate = jax_build(config, dataset, mode=mode, **kw)
        params = jax.tree_util.tree_map(np.array, variables["params"])
        recorded.append(params)
        return model, dict(variables, params=jax.tree_util.tree_map(np.array, params)), estate

    port_build = port_quick_start.build_model_and_state

    def bridged(config, dataset, mode="transductive", **kw):
        model = port_build(config, dataset, mode=mode, **kw)
        load_flax_params(model, recorded.pop(0))
        return model

    monkeypatch.setattr(jax_quick_start, "build_model_and_state", recording)
    monkeypatch.setattr(port_quick_start, "build_model_and_state", bridged)
    return recorded


def test_run_hyper_on_toy_bpr_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "bpr.hyper").write_text(HYPER_BPR)
    recorded = bridge_trials(monkeypatch)
    res = {}
    for side, mod, extra in (("jax", jax_run_hyper, []), ("port", port_run_hyper,
                                                          ["--device=cpu"])):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        res[side] = mod.main(BPR_ARGS + extra + [
            f"--params_file={tmp_path / 'bpr.hyper'}",
            f"--output_file={tmp_path / side / 'result.txt'}",
            f"--checkpoint_dir={tmp_path / side / 'saved'}"])
    assert not recorded  # every JAX trial's weights went to a port trial
    j, p = res["jax"], res["port"]
    assert _text(p.params_list) == _text(j.params_list)
    assert len(p.score_list) == 2
    np.testing.assert_allclose(p.score_list, j.score_list, rtol=0, atol=TOL)
    assert p.best_params == j.best_params
    assert list(p.best_test_result) == list(j.best_test_result)
    for k, v in j.best_test_result.items():
        assert abs(float(p.best_test_result[k]) - float(v)) <= TOL, k
    text = (tmp_path / "port" / "result.txt").read_text()
    assert text.count("valid_score:") == 2 and "best params:" in text


def test_run_hyper_ray_fails_fast_without_ray(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_ray(name, *args, **kw):
        if name == "ray" or name.startswith("ray."):
            raise ImportError(f"No module named '{name}'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_ray)
    (tmp_path / "bpr.hyper").write_text(HYPER_BPR)
    argv = BPR_ARGS + [f"--params_file={tmp_path / 'bpr.hyper'}", "--tool=ray"]
    for mod in (jax_run_hyper, port_run_hyper):
        with pytest.raises(SystemExit, match="--tool=ray requires the ray wheel"):
            mod.main(argv)

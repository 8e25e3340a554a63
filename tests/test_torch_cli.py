"""The whole slice: `python -m oovrec_tpu_torch.cli.run` against the JAX
package's `oovrec_tpu.cli.run`, on the CPU.

Both CLIs run the verify-skill commands on the toy-ind fixture: the
retrieval track (BPR, random-mapper OOV buckets, OOV training, the paper
protocol's uni250 eval, the 7-slice inductive eval), the ranking track
verbatim (WideDeep with `--inductive_embedder=lsh`, dropout 0 added) and
with xDeepFM, each with the random mapper and with the lsh embedder, the
retrieval track with fdhe (host hashing, one key file under the test's
directory that both CLIs read) and with DirectAU, and the ranking track
with DCNv2 (under SGD at 1e-2, its N(0, 1) cross weights starting at 1/10:
`tests/test_torch_trainer.py:_dcnv2_cfg` says why) and with AutoInt (two
attention layers, under SGD at 1e-2: `test_torch_context_zoo.py` says
why). The embedder state
each CLI builds (feature matrices, planes, keys; in 'inductive' mode over
the `_ind` corpus for the 7 slices) is its own. The port runs with `--device=cpu`, xDeepFM's
CIN through the kernel wrapper's plain version (`--fused_cin=True`), and
starts from the JAX run's initial weights: the test wraps the JAX
driver's `build_model_and_state` to record them and the port's to load
them through `utils/jax_params.py`. Dropout is 0 (the two packages'
random streams differ) and metrics keep 12 decimals. xDeepFM's float-field
tables start at 1/100 of their drawn values in both runs, as in
`test_torch_trainer.py`: ages and prices of ~20 saturate its logits, and
the saturated sigmoids tie differently in the two packages (XLA's CPU
sigmoid gives 0 where torch's gives a subnormal, 6e-39 at -88), which
moves AUC without any difference in the models. The test metrics
and all 7 slices must agree to 1e-5; no top-k rank flipped on an f32 tie
in these runs. `--eval_only` on the port's checkpoint must reproduce its
run to 1e-9, and `--device=cuda` on a host without CUDA raises.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
from oovrec_tpu.cli.run import main as jax_main  # noqa: E402
from oovrec_tpu_torch.cli.run import main as port_main  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import load_flax_params  # noqa: E402

from tests.test_torch_dataset import ASSETS  # noqa: E402

LOAD_COL = ("--load_col={'inter': ['user_id','item_id','rating','timestamp','is_new'], "
            "'user': ['user_id','age','gender'], 'item': ['item_id','price','category']}")
COMMON = [
    "--dataset=toy-ind", f"--data_path={ASSETS}", "--epochs=2", "--train_batch_size=16",
    "--embedding_size=8", "--add_oov_buckets=True",
    "--n_user_oov_buckets=8", "--n_item_oov_buckets=8", "--train_oov=True",
    "--inductive_eval=True", LOAD_COL, "--log_tensorboard=False",
    "--metric_decimal_place=12",
]
RETRIEVAL = ["--model=BPR"]
RANKING = ["--model=xDeepFM", "--model_eval_type=ranking",
           "--numerical_features=['age','price']", "--threshold={'rating': 4}",
           "--dropout_prob=0.0", "--mlp_hidden_size=[16,8]", "--cin_layer_size=[8,8]"]
MAPPER = ["--inductive_mapper=random"]
# the verify skill's ranking command, verbatim
SKILL_RANKING = [
    "--model=WideDeep", "--dataset=toy-ind", f"--data_path={ASSETS}", "--epochs=2",
    "--train_batch_size=16", "--embedding_size=8", "--inductive_mapper=random",
    "--add_oov_buckets=True", "--n_user_oov_buckets=8", "--n_item_oov_buckets=8",
    "--train_oov=True", "--inductive_eval=True", "--checkpoint_dir=/tmp/vfy/saved",
    LOAD_COL, "--model_eval_type=ranking", "--inductive_embedder=lsh",
    "--numerical_features=['age','price']", "--threshold={'rating': 4}",
]
TRACKS = {
    "retrieval": RETRIEVAL + MAPPER,
    "ranking": RANKING + MAPPER,
    "retrieval-lsh": RETRIEVAL + ["--inductive_embedder=lsh"],
    "retrieval-fdhe": RETRIEVAL + ["--inductive_embedder=fdhe", "--dhe_num_hashes=8",
                                   "--dhe_layer_size=16"],
    "ranking-lsh": RANKING + ["--inductive_embedder=lsh"],
    "ranking-widedeep-lsh": SKILL_RANKING + ["--dropout_prob=0.0"],
    "ranking-dcnv2": ["--model=DCNV2", *RANKING[1:], *MAPPER, "--cross_layer_num=2",
                      "--learner=sgd", "--learning_rate=0.01"],
    "retrieval-directau": ["--model=DirectAU", *MAPPER],
    # under SGD: the attention's key bias has a gradient that is rounding
    # noise, which Adam scales up to whole steps (test_torch_context_zoo.py)
    "ranking-autoint": ["--model=AutoInt", *RANKING[1:], *MAPPER, "--attention_size=8",
                        "--n_layers=2", "--dropout_probs=[0.0,0.0,0.0]", "--learner=sgd",
                        "--learning_rate=0.01"],
}
# the embedder each track runs with
EMBEDDER = {"retrieval-lsh": "lsh", "retrieval-fdhe": "fdhe", "ranking-lsh": "lsh",
            "ranking-widedeep-lsh": "lsh"}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these tiny shapes run fastest on one thread:
    several test workers each spreading a 512-element GELU over every core
    spend milliseconds a call on the thread pool alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    """Both packages keep a module-global feature cache per mode: each test
    starts from an empty one and leaves one, so no other test's corpus is
    taken for this one's."""
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


def _agree(a, b, tol, what):
    assert list(a) == list(b), what
    for k in a:
        assert abs(float(a[k]) - float(b[k])) <= tol, (what, k, a[k], b[k])


def _slices_agree(a, b, tol, what):
    assert list(a) == list(b) and len(a) == 7, what
    for s in a:
        _agree(a[s], b[s], tol, f"{what} [{s}]")


def _run_pair(track, tmp_path, monkeypatch):
    """The JAX CLI, then the port's from the JAX run's initial weights.
    → (jax result, port result, port checkpoint, port results json)."""
    recorded = {}
    jax_build = jax_quick_start.build_model_and_state

    def recording(config, dataset, mode="transductive", **kw):
        model, variables, estate = jax_build(config, dataset, mode=mode, **kw)
        if mode == "transductive":
            # host copies (the JAX trainer donates the arrays it starts
            # from), float-field tables scaled down
            params = jax.tree_util.tree_map_with_path(
                lambda p, v: np.array(v) * np.float32(
                    0.01 if p[-2:-1] and p[-2].key == "float_embedding_table"
                    else 0.1 if p[-1].key.startswith("cross_layer_") else 1),
                variables["params"])
            recorded.setdefault("params", params)
            variables = dict(variables, params=jax.tree_util.tree_map(np.array, params))
        return model, variables, estate

    port_build = port_quick_start.build_model_and_state

    def bridged(config, dataset, mode="transductive", **kw):
        model = port_build(config, dataset, mode=mode, **kw)
        if mode == "transductive":
            load_flax_params(model, recorded["params"])
        return model

    monkeypatch.setattr(jax_quick_start, "build_model_and_state", recording)
    monkeypatch.setattr(port_quick_start, "build_model_and_state", bridged)
    argv = (TRACKS[track] if "widedeep" in track else COMMON + TRACKS[track]) + [
        f"--hash_key_dir={tmp_path / 'keys'}", "--log_tensorboard=False",
        "--metric_decimal_place=12"]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jres = jax_main(argv + [f"--checkpoint_dir={tmp_path / 'jax' / 'saved'}"])
    monkeypatch.chdir(tmp_path / "port")
    results_json = tmp_path / "port" / "results.json"
    extra = ["--device=cpu", f"--checkpoint_dir={tmp_path / 'port' / 'saved'}",
             f"--results_json={results_json}"]
    if track in ("ranking", "ranking-lsh"):
        extra.append("--fused_cin=True")
    pres = port_main(argv + extra)
    return jres, pres, pres["trainer"].saved_model_file, results_json


@pytest.mark.parametrize("track", sorted(TRACKS))
def test_port_cli_matches_the_jax_cli(track, tmp_path, monkeypatch):
    jres, pres, ckpt, results_json = _run_pair(track, tmp_path, monkeypatch)
    assert pres["config"]["eval_args"]["mode"] == {"valid": "uni250", "test": "uni250"}
    assert pres["trainer"].model.spec.embedder == EMBEDDER.get(track)
    assert type(pres["trainer"].model).__name__ == pres["config"]["model"]
    _agree(jres["test_result"], pres["test_result"], TOL, f"{track} test result")
    _slices_agree(jres["inductive_results"], pres["inductive_results"], TOL,
                  f"{track} inductive slices")
    assert any(pres["inductive_results"][s] for s in ("new_users", "new_old"))
    written = json.loads(results_json.read_text())
    assert set(written["inductive"]) == set(pres["inductive_results"])

    # --eval_only on the port's checkpoint reproduces the run
    again = port_main([f"--eval_only={ckpt}", "--inductive_eval=True"])
    _agree(pres["test_result"], again["test_result"], 1e-9, f"{track} eval_only test")
    _slices_agree(pres["inductive_results"], again["inductive_results"], 1e-9,
                  f"{track} eval_only slices")


def test_port_cli_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(COMMON + TRACKS["retrieval"] + [
            "--device=cuda", f"--checkpoint_dir={tmp_path / 'saved'}"])

"""The port's config layer against the JAX package's, key for key.

`parse_cli_args`, `apply_paper_protocol`, `merge_dataset_config` and the
merged `Config` (defaults, model file, `config_file_list` in YAML and JSON,
the command line) for both verify-skill commands and the flags of the
chip's CLI phases A (BPR on synth-ind) and B (xDeepFM ranking). The
ranking command names xDeepFM in place of WideDeep: the port keeps the
model files of the models it has, and WideDeep is not one. The port
holds two keys of its own (`device`, `fused_cin`, `PORT_DEFAULTS`); the
derived enums compare by name.
"""

import copy
import enum
import json

import pytest

pytest.importorskip("jax")

from oovrec_tpu.cli.run import apply_paper_protocol as jax_protocol  # noqa: E402
from oovrec_tpu.cli.run import merge_dataset_config as jax_merge  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.config import parse_cli_args as jax_parse  # noqa: E402
from oovrec_tpu_torch.cli.quick_start import model_kwargs  # noqa: E402
from oovrec_tpu_torch.cli.run import apply_paper_protocol, merge_dataset_config  # noqa: E402
from oovrec_tpu_torch.config import PORT_DEFAULTS, Config, parse_cli_args  # noqa: E402
from oovrec_tpu_torch.models import get_model_class  # noqa: E402

SKILL_LOAD_COL = ("--load_col={'inter': ['user_id','item_id','rating','timestamp','is_new'], "
                  "'user': ['user_id','age','gender'], 'item': ['item_id','price','category']}")
SYNTH_LOAD_COL = ("--load_col={'inter': ['user_id','item_id','timestamp','is_new'], "
                  "'user': ['user_id','age','group'], 'item': ['item_id','price','category']}")
RETRIEVAL = [
    "--model=BPR", "--dataset=toy-ind", "--data_path=tests/assets", "--epochs=2",
    "--train_batch_size=16", "--embedding_size=8", "--inductive_mapper=random",
    "--add_oov_buckets=True", "--n_user_oov_buckets=8", "--n_item_oov_buckets=8",
    "--train_oov=True", "--inductive_eval=True", "--checkpoint_dir=/tmp/vfy/saved",
    SKILL_LOAD_COL,
]
RANKING = RETRIEVAL[1:] + [
    "--model=xDeepFM", "--model_eval_type=ranking", "--inductive_embedder=lsh",
    "--numerical_features=['age','price']", "--threshold={'rating': 4}",
]
PHASE_A = [
    "--model=BPR", "--dataset=synth-ind", "--data_path=dataset", SYNTH_LOAD_COL,
    "--inductive_mapper=random", "--add_oov_buckets=True", "--n_user_oov_buckets=200",
    "--n_item_oov_buckets=200", "--train_oov=True", "--oov_train_ratio=0.3",
    "--inductive_eval=True", "--epochs=5", "--results_json=build/cli_a.json",
]
PHASE_B = PHASE_A[1:-2] + [
    "--model=xDeepFM", "--model_eval_type=ranking", "--numerical_features=['age','price']",
    "--epochs=3",
]
SKILL_RANKING = RETRIEVAL[1:] + [
    "--model=WideDeep", "--model_eval_type=ranking", "--inductive_embedder=lsh",
    "--numerical_features=['age','price']", "--threshold={'rating': 4}",
]
COMMANDS = {"skill_retrieval": RETRIEVAL, "skill_ranking": RANKING,
            "skill_ranking_widedeep": SKILL_RANKING, "phase_a": PHASE_A, "phase_b": PHASE_B}


def plain(value):
    """Enums by name, containers recursively."""
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def assert_same_config(port: Config, jax_cfg: JaxConfig):
    p, j = plain(port.as_dict()), plain(jax_cfg.as_dict())
    for k in PORT_DEFAULTS:
        assert p.pop(k) == PORT_DEFAULTS[k]
    assert list(p) == list(j)
    for k in j:
        assert p[k] == j[k] and type(p[k]) is type(j[k]), k


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_parse_cli_args_and_protocol_match(name, tmp_path):
    argv = COMMANDS[name]
    args, jargs = parse_cli_args(argv), jax_parse(argv)
    assert plain(args) == plain(jargs)
    args, jargs = apply_paper_protocol(args), jax_protocol(jargs)
    assert args == jargs
    (tmp_path / f"{args['dataset']}.json").write_text(json.dumps(
        {"epochs": 99, "seed": 7, "USER_ID_FIELD": "user_id"}))
    args = merge_dataset_config(args, str(tmp_path))
    jargs = jax_merge(jargs, str(tmp_path))
    assert args == jargs and args["seed"] == 7 and args["epochs"] != 99
    assert_same_config(Config(copy.deepcopy(args), model=args["model"], dataset=args["dataset"]),
                       JaxConfig(args["model"], args["dataset"], None, copy.deepcopy(args)))


def test_config_files_layer_as_in_jax(tmp_path):
    y = tmp_path / "user.yaml"
    y.write_text("epochs: 7  # from a file\neval_args:\n  split: {'LS': valid_and_test}\n"
                 "  order: TO\nlearning_rate: 1e-05\nload_col:\n  inter: [user_id, item_id]\n")
    j = tmp_path / "more.json"
    j.write_text(json.dumps({"train_batch_size": 64, "metrics": ["AUC", "LogLoss"],
                             "valid_metric": "LogLoss"}))
    files = [str(y), str(j)]
    over = {"embedding_size": 16, "eval_args": {"mode": "uni100"}}
    port = Config(copy.deepcopy(over), model="xDeepFM", dataset="toy-ind", config_file_list=files)
    jax_cfg = JaxConfig("xDeepFM", "toy-ind", files, copy.deepcopy(over))
    assert_same_config(port, jax_cfg)
    assert port["eval_args"] == {"split": {"LS": "valid_and_test"}, "order": "TO",
                                 "mode": {"valid": "uni100", "test": "uni100"},
                                 "group_by": "user"}
    assert port["learning_rate"] == "1e-05" and port["valid_metric_bigger"] is False


def test_unported_model_defaults_to_pointwise():
    port = Config({"model": "LightGCN"})
    assert port["MODEL_INPUT_TYPE"].name == "POINTWISE"
    assert Config({"model": "BPR"})["MODEL_INPUT_TYPE"].name == "PAIRWISE"
    assert Config()["device"] == "cuda"


# the constructor arguments `model_kwargs` takes from each model file: YAML
# lists as tuples, YAML ints as floats where the default is one, a CLI
# string as a bool
MODEL_KWARGS = {
    "WideDeep": ({}, {"mlp_hidden_size": (32, 16, 8), "dropout_prob": 0.1}),
    "DCNV2": ({}, {"mixed": False, "structure": "stacked", "cross_layer_num": 3,
                   "expert_num": 4, "low_rank": 128, "mlp_hidden_size": (768, 768),
                   "reg_weight": 2.0, "dropout_prob": 0.2}),
    "DCNV2-mixed": ({"mixed": "True", "mlp_hidden_size": [8, 4]},
                    {"mixed": True, "structure": "stacked", "cross_layer_num": 3,
                     "expert_num": 4, "low_rank": 128, "mlp_hidden_size": (8, 4),
                     "reg_weight": 2.0, "dropout_prob": 0.2}),
    "DirectAU": ({}, {"gamma": 1.0}),
}


@pytest.mark.parametrize("name", sorted(MODEL_KWARGS))
def test_model_kwargs_from_the_model_files(name):
    model = name.split("-")[0]
    over, want = MODEL_KWARGS[name]
    kw = model_kwargs(Config(dict(over, model=model)), get_model_class(model))
    assert kw == want
    assert all(type(kw[k]) is type(v) for k, v in want.items()), kw

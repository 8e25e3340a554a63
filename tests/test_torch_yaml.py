"""The port's YAML subset reader against `yaml.safe_load`.

`oovrec_tpu_torch/config/yaml_subset.py` must give what PyYAML gives, type
for type, on every config file the JAX package ships (the defaults and
all 87 model files, read in place), on the flow values of the verify-skill
and chip-phase flags, and on the YAML 1.1 scalars that trouble a reader
(`1e-05` stays a string, `yes/off` are booleans, `~` is None, octal and
base-60 integers, quoted strings with escapes). What lies outside the
subset raises. The port's copies of the defaults and of the BPR and
xDeepFM files stay byte-equal to the JAX package's.
"""

import math
import pathlib

import pytest

yaml = pytest.importorskip("yaml")

from oovrec_tpu_torch.config import yaml_subset  # noqa: E402
from oovrec_tpu_torch.config.configurator import _infer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_CONFIG = ROOT / "oovrec_tpu" / "config"
PORT_CONFIG = ROOT / "oovrec_tpu_torch" / "config"
MODEL_FILES = sorted((JAX_CONFIG / "model").glob("*.yaml"))
CONFIG_FILES = [JAX_CONFIG / "defaults.yaml"] + MODEL_FILES


def same(a, b) -> bool:
    """Equal values of equal types, recursively (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_every_model_file_is_read():
    assert len(MODEL_FILES) == 87


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.name)
def test_config_file_reads_as_pyyaml_reads_it(path):
    text = path.read_text()
    assert same(yaml_subset.load(text), yaml.safe_load(text))


FLAG_VALUES = [
    "{'inter': ['user_id','item_id','rating','timestamp','is_new'], "
    "'user': ['user_id','age','gender'], 'item': ['item_id','price','category']}",
    "{'inter': ['user_id','item_id','timestamp','is_new'], "
    "'user': ['user_id','age','group','user_vector'], "
    "'item': ['item_id','price','category','item_vector']}",
    "{'inter': ['user_id','item_id','timestamp','is_new'], 'user': ['user_id','age','group'], "
    "'item': ['item_id','price','category']}",
    "['age','price']",
    "{'rating': 4}",
    '{"data":4,"model":2}',
    "[16,8]",
    "[100, 100, 100]",
    "{'RS': [0.88, 0.02, 0.1]}",
    "{'LS': 'valid_and_test'}",
    "[0,inf)",
]


@pytest.mark.parametrize("value", FLAG_VALUES)
def test_flag_value_parses_as_the_jax_cli_parses_it(value):
    from oovrec_tpu.config.configurator import _infer as jax_infer

    assert same(_infer(value), jax_infer(value))


SCALARS = [
    "1e-05", "1.0e-5", "1.0e5", "1.5E+3", ".5", "-.inf", ".NaN", "+1", "-0", "0x1F", "017",
    "0b101", "1_000", "1:30", "1:30.5", "yes", "No", "ON", "off", "True", "FALSE", "~",
    "null", "Null", "", "'a''b'", '"a\\tb\\u00e9\\x41"', '"\\t"', "it's", "plain text",
    "[1, [2, {a: b}], '']", "{a: 1, b, c: }", "{'k': [0.8, 0.1, 0.1]}", "[a b, c]",
    "a: 1  # comment\nb:\n  c: [1,\n   2]\n  d: 'x # y'\n",
    "k:\n- 1\n- two\n", "- 1\n- 2\n", "'[0,inf)'", "x: \"\\t\"\n",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_11_resolution_as_pyyaml(text):
    assert same(yaml_subset.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: |\n  text\n", "a: !!str 1\n", "a: b: c\n",
    "a: 1\n---\nb: 2\n", "when: 2020-01-01\n", "a: 'open\n",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.load(text)


@pytest.mark.parametrize("name", ["defaults.yaml", "model/BPR.yaml", "model/xDeepFM.yaml",
                                  "model/WideDeep.yaml", "model/DCNV2.yaml",
                                  "model/DirectAU.yaml"])
def test_port_copies_are_byte_equal(name):
    assert (PORT_CONFIG / name).read_bytes() == (JAX_CONFIG / name).read_bytes()

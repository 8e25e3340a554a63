"""The kernel wrappers' launch counts (`oovrec_tpu_torch/ops/launches.py`).

Every wrapper that launches a kernel of `oovrec_tpu_torch/csrc/` is
registered with the name of a `__global__` function of its source (the
name a profiler trace shows for its launches), counts from 0, and is
reset with the others. Runs on the CPU: nothing launches here.
"""

import pathlib
import re

import pytest

from oovrec_tpu_torch.ops import cin_fused, embed_grad, launches, sparse_rows, topk_score

CSRC = pathlib.Path(__file__).resolve().parents[1] / "oovrec_tpu_torch" / "csrc"
# wrapper → (its module, the source of its kernel)
WRAPPERS = {
    "fused_topk_scores": (topk_score, "topk_score.cu"),
    "cin_layer_pooled": (cin_fused, "cin_fused.cu"),
    "cin_layer": (cin_fused, "cin_fused.cu"),
    "cin_layer_pooled_bwd": (cin_fused, "cin_fused_bwd.cu"),
    "cin_layer_bwd": (cin_fused, "cin_fused_bwd.cu"),
    "sparse_adam_rows_kernel": (sparse_rows, "sparse_rows.cu"),
    "scatter_rows_kernel": (embed_grad, "embed_grad.cu"),
}


def _globals(source):
    """The `__global__` functions of a CUDA source, by name."""
    text = (CSRC / source).read_text()
    return set(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                          r"(?:void\s+)?(\w+)\s*\(", text))


def test_every_wrapper_is_registered():
    assert set(launches.WRAPPERS) == set(WRAPPERS)
    assert set(launches.launch_counts()) == set(WRAPPERS)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_names_a_kernel_of_its_source(name):
    module, source = WRAPPERS[name]
    fn = launches.WRAPPERS[name]
    assert getattr(module, name) is fn
    assert fn.kernel in _globals(source), (fn.kernel, source)
    # the C entry the wrapper calls launches that kernel
    assert re.search(rf"{fn.kernel}(<[^>]*>)?<<<", (CSRC / source).read_text())


def test_reset_zeroes_every_count():
    saved = launches.launch_counts()
    try:
        for i, fn in enumerate(launches.WRAPPERS.values()):
            fn.launches = i + 1
        assert launches.launch_counts() == {n: i + 1 for i, n in enumerate(launches.WRAPPERS)}
        launches.reset_launch_counts()
        assert set(launches.launch_counts().values()) == {0}
    finally:
        for n, c in saved.items():
            launches.WRAPPERS[n].launches = c

"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either. Every module name is
compared whole by its top-level part (`oovrec_tpu_torch` begins with
`oovrec_tpu`)."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import main, manifest

JAX_SIDE = {"jax", "jaxlib", "flax", "oovrec_tpu"}


def _sources(sub=""):
    top = os.path.join(manifest.BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_imports_the_jax_side():
    for path in _sources():
        for name in _imported(path):
            assert name.split(".")[0] not in JAX_SIDE, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imported(path):
            top = name.split(".")[0]
            assert top not in JAX_SIDE | {"oovrec_tpu_torch"}, (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_names_are_compared_whole():
    assert "oovrec_tpu_torch".split(".")[0] not in main.FORBIDDEN
    assert "oovrec_tpu.models".split(".")[0] in main.FORBIDDEN


def _loaded_after(code):
    env = dict(os.environ, PYTHONPATH=manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=manifest.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_nothing_of_the_jax_side():
    loaded = _loaded_after(
        "from benchmark.harness import main, models, generate, readers\n"
        "from benchmark.harness.kinds import train, eval_full_sort\n"
        "from benchmark.harness.adapters import BPR, xDeepFM\n"
        "import oovrec_tpu_torch.train, oovrec_tpu_torch.eval.inductive\n"
        "import oovrec_tpu_torch.models.bpr, oovrec_tpu_torch.models.context_aware.xdeepfm\n"
        "import oovrec_tpu_torch.data.dataloader, oovrec_tpu_torch.inductive.mapper\n"
        "from benchmark.harness.manifest import Cell, manifest\n"
        "[m.read for c in manifest()['workloads'] for m in Cell(c['name']).readers().values()]")
    assert "oovrec_tpu_torch" in loaded and not loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    names = [os.path.splitext(f)[0] for f in os.listdir(os.path.join(manifest.BENCH_DIR,
                                                                     "reference"))
             if f.endswith(".py") and f != "__init__.py"]
    loaded = _loaded_after("\n".join(f"import benchmark.reference.{n}" for n in names))
    assert not loaded & (JAX_SIDE | {"oovrec_tpu_torch"})


@pytest.mark.parametrize("trace", ["0", "1"])
def test_without_the_port_a_run_fails_and_prints_nothing(tmp_path, trace):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    a run exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bpr-d64-1m.eval-7slice", "--seed", "1", "--seconds", "1",
                          "--trace", trace], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()

"""The port stands alone: no module under `oovrec_tpu_torch/`, and not
`chip_smoke.py` or `tools/chip_phase.py`, imports JAX, flax, msgpack,
orbax, pandas, PyYAML, sklearn or the JAX package.
The card's machine has none of them."""

import ast
import pathlib

import pytest

pytest.importorskip("jax")  # tests/conftest.py needs it; the scan does not

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "orbax", "pandas", "yaml",
             "oovrec_tpu", "sklearn")
SOURCES = sorted((ROOT / "oovrec_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                ROOT / "tools" / "chip_phase.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_nothing_forbidden(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "oovrec_tpu_torch/ops/topk_score.py" in names
    assert "oovrec_tpu_torch/ops/cin_fused.py" in names
    assert "oovrec_tpu_torch/models/context_aware/xdeepfm.py" in names
    assert "oovrec_tpu_torch/train/trainer.py" in names
    assert "oovrec_tpu_torch/train/optimizers.py" in names
    assert "oovrec_tpu_torch/inductive/transform.py" in names
    assert "oovrec_tpu_torch/ops/sparse_rows.py" in names
    assert "oovrec_tpu_torch/ops/inthash_device.py" in names
    assert "oovrec_tpu_torch/train/sparse_update.py" in names
    assert "oovrec_tpu_torch/train/device_epoch.py" in names
    assert "oovrec_tpu_torch/data/alias.py" in names
    assert "oovrec_tpu_torch/config/yaml_subset.py" in names
    assert "oovrec_tpu_torch/data/atomic.py" in names
    assert "oovrec_tpu_torch/data/inductive_dataset.py" in names
    assert "oovrec_tpu_torch/data/utils.py" in names
    assert "oovrec_tpu_torch/cli/run.py" in names
    assert "oovrec_tpu_torch/cli/quick_start.py" in names
    assert "oovrec_tpu_torch/cli/inductive_eval.py" in names
    assert "chip_smoke.py" in names and "tools/chip_phase.py" in names
    for mod in ("parallel/distributed.py", "parallel/mesh.py", "parallel/sharded_embedding.py",
                "parallel/train_step.py", "models/exlib/decision_tree.py",
                "data/decisiontree.py", "train/decision_tree_trainer.py"):
        assert f"oovrec_tpu_torch/{mod}" in names, mod
    for module in ("ops/embed_grad.py", "ops/siphash.py", "ops/siphash_device.py",
                   "inductive/dhe.py", "inductive/factory.py",
                   "models/context_aware/widedeep.py", "models/context_aware/dcnv2.py",
                   "models/directau.py", "data/prefetch.py", "train/cuda_graph.py",
                   "data/transfer.py", "ops/launches.py", "utils/flax_msgpack.py",
                   "utils/jax_checkpoint.py", "utils/torch_import.py",
                   "models/context_aware/basic.py", "models/context_aware/ffm.py",
                   "data/sequential.py", "data/transform.py", "models/sequential/base.py",
                   "models/sequential/gru4rec.py", "models/sequential/sasrec.py",
                   "models/sequential/more.py", "models/sequential/bert4rec.py",
                   "models/sequential/convs.py", "models/sequential/din.py",
                   "models/sequential/more2.py", "models/sequential/more3.py",
                   "models/sequential/more4.py", "models/sequential/featseq.py",
                   "models/sequential/more5.py", "models/sequential/s3rec.py",
                   "models/general/base.py", "models/general/pop.py",
                   "models/general/itemknn.py", "models/general/lightgcn.py",
                   "models/general/more.py", "models/general/more2.py",
                   "models/general/more3.py", "models/general/more4.py",
                   "models/general/more5.py", "models/general/neumf.py",
                   "models/general/ract.py", "data/dataloader.py", "data/kg_dataset.py",
                   "data/kg_seq_dataset.py", "models/knowledge/base.py",
                   "models/knowledge/cke.py", "models/knowledge/cfkg.py",
                   "models/knowledge/kgat.py", "models/knowledge/more.py",
                   "models/knowledge/more2.py", "models/knowledge/more3.py",
                   "train/hyper_tuning.py", "cli/run_hyper.py", "cli/significance_test.py",
                   "utils/flops.py", "utils/tensorboard.py", "utils/wandblogger.py",
                   "utils/case_study.py"):
        assert f"oovrec_tpu_torch/{module}" in names, module
    assert len(names) >= 25

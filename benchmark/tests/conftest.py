"""The benchmark's own tests: on the CPU at tiny sizes, with the kernels'
plain versions; a test that needs the card is marked `card` and skips here.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["OOVREC_DISABLE_TENSORBOARD"] = "1"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, in the
    test, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_cell(name: str):
    """A cell of BENCHMARK.json at a size the CPU runs in seconds: the same
    files, the corpus and the batches shrunk, the device epoch forced on."""
    from benchmark.harness.manifest import Cell

    cell = Cell(name)
    c, mix = cell.config["corpus"], cell.traffic
    if cell.config["model"] == "BPR":
        c.update(n_old_users=300, n_new_users=40, n_old_items=2000, n_new_items=300,
                 train_interactions=15000)
        mix.update(test_users=128, users_per_batch=32)
    else:
        c.update(n_old_users=300, n_new_users=40, n_old_items=200, n_new_items=30, rows=20000,
                 positive_rows=11500)
        c["schema"]["token_dims"][:2] = [300, 200]
    if mix["kind"] == "train":
        mix["port"].update(train_batch_size=256, device_epoch=True)
    else:
        mix["port"]["use_fused_topk"] = True  # the kernel's plain version on the CPU
    return cell


def run_tiny(name: str, seed: int = 3_000_000_001, seconds: float = 0.2, controls=(),
             device=None):
    """One run of a tiny cell (`harness/main.py:run_cell`) → (out, line)."""
    import time

    import torch

    from benchmark.harness import main

    cell = tiny_cell(name)
    device = device or torch.device("cpu")
    out = main.run_cell(cell, seed, seconds, False, device, main.Clock(time.perf_counter()),
                        controls)
    return cell, out, main.result_line(cell, out, False, device, "cpu", main.limits(cell.name))

"""The general models, BPR and DirectAU among them (and RaCT's stages) on the port's mesh.

One spawn of `tests/torch_mesh_harness.py` on 2 gloo ranks, and one on 1:
at 2 ranks each case's mesh step on an odd global batch (padded to 2
blocks) equals the single-process step on the padded batch, the loss to
1e-5 relative and each parameter's and buffer's change to 1e-5 of its
largest magnitude plus 1e-7, and after two more steps with the trainer's
own draws both ranks hold bit-identical parameters and buffers; at 1 rank
the mesh step is the plain step bit for bit. `learner: sgd` at a learning
rate of 1 makes the parameters' change the gradient (the harness's
docstring).
"""

import pytest

from tests import torch_mesh_harness as harness

FAMILY = "general"
CASES = sorted(harness.CASES[FAMILY])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return harness.spawn(FAMILY, tmp_path_factory.mktemp("mesh2"), world=2)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return harness.spawn(FAMILY, tmp_path_factory.mktemp("mesh1"), world=1)


@pytest.mark.parametrize("case", CASES)
def test_mesh_step_is_the_global_batch_step(two_ranks, case):
    harness.check_case(two_ranks, case)


@pytest.mark.parametrize("case", CASES)
def test_one_rank_mesh_step_is_the_plain_step(one_rank, case):
    harness.check_case(one_rank, case, exact=True)

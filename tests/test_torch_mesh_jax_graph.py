"""The port's mesh step against the JAX package's `make_sharded_train_step`
for the graph, pair, user-batch and knowledge representatives: LightGCN
(also on {data: 1, model: 2} with row-sharded tables), SGL on JAX's edge
masks, NCL, SimpleX, RaCT's finetuning on JAX's draws, ENMF, DirectAU,
KGAT and MCCLK. The cases, the workers and the tolerances are
`tests/test_torch_mesh_jax.py`'s.
"""

import pytest

from tests import test_torch_mesh_jax as mesh_jax

HERE = ["LightGCN", "LightGCN-sharded", "SGL", "NCL", "SimpleX", "RaCT", "ENMF", "DirectAU",
        "KGAT", "MCCLK"]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return mesh_jax.run_both(tmp_path_factory, HERE)


@pytest.mark.parametrize("case", HERE)
def test_mesh_step_matches_jax_sharded_step(both, case):
    mesh_jax.check_case(both, case)

"""The mesh's batch reductions (`parallel/train_step.py`) on 1, 2 and 3
gloo ranks against the plain op on the concatenated padded batch.

Each rank takes its block of a global (n·b, ...) batch drawn from a seed,
evaluates a helper inside `data_scope` on its rows and differentiates the
result (a fixed cotangent where it is not a scalar) divided by n, as the
mesh step does; the value must be the plain op's on the whole batch and
the gradient the plain gradient's block of rows, in float64 to 1e-12
(relative). Outside the scope each helper is the plain op bit for bit, in
float32. The workers are this file run as a script
(`tests/torch_mesh_harness.py:run_ranks`: neither JAX nor the conftest
runs in them).
"""

import sys

import numpy as np
import pytest
import torch

from oovrec_tpu_torch.models.losses import _wmean, emb_loss
from oovrec_tpu_torch.parallel import train_step as ts

from tests.torch_mesh_harness import join_group, leave_group, run_ranks

B = 5  # rows a rank
RTOL = 1e-12


def _inputs(world, seed=3):
    """The global padded batch: x (n·B, 4), w (n·B,) with the last rows of
    the last block at weight 0 (padding), and a fixed cotangent for each
    non-scalar result."""
    rng = np.random.default_rng(seed + world)
    n = world * B
    w = (rng.random(n) < 0.8).astype(np.float64)
    w[-2:] = 0.0
    return {"x": rng.standard_normal((n, 4)), "w": w,
            "c_col": rng.standard_normal((1, 4)), "c_rows": rng.standard_normal((n, 4)),
            "c_roll": rng.standard_normal((B, 4))}


def _functions():
    """name → f(x, w, inputs) on one rank's rows, with its plain
    counterpart on the whole batch given by the same code outside the
    scope (the helpers are the plain ops there)."""
    def roll(x, w, c):
        rows, first = ts.global_rows(x)
        prev = torch.roll(rows, 1, dims=0)[first:first + x.shape[0]]
        return ts.batch_sum(prev * torch.as_tensor(c["c_roll_local"]))

    def in_batch(x, w, c):
        rows, first = ts.global_rows(x)
        logits = x @ rows.T
        return ts.batch_mean(torch.log_softmax(logits, dim=1).diagonal(offset=first))

    return {
        "batch_sum": lambda x, w, c: ts.batch_sum(x * x),
        "batch_sum_dim0": lambda x, w, c: (ts.batch_sum(x, dim=0, keepdim=True)
                                           * torch.as_tensor(c["c_col"])).sum(),
        "batch_mean": lambda x, w, c: ts.batch_mean(torch.sin(x)),
        "batch_mean_dim0": lambda x, w, c: (ts.batch_mean(x * x, dim=0, keepdim=True)
                                            * torch.as_tensor(c["c_col"])).sum(),
        "batch_std": lambda x, w, c: (ts.batch_std(x) * torch.as_tensor(c["c_col"])).sum(),
        "batch_wmean": lambda x, w, c: ts.batch_wmean(torch.exp(x[:, 0]), w),
        "batch_vector_norm_2": lambda x, w, c: ts.batch_vector_norm(x),
        "batch_vector_norm_3": lambda x, w, c: ts.batch_vector_norm(x, ord=3),
        "wmean": lambda x, w, c: _wmean(x[:, 1] ** 2, w),
        "wmean_unweighted": lambda x, w, c: _wmean(x[:, 1] ** 2),
        "emb_loss": lambda x, w, c: emb_loss(x[:, :2], x[:, 2:]),
        "emb_loss_pow": lambda x, w, c: emb_loss(x, norm=2, require_pow=True),
        "global_rows": lambda x, w, c: (ts.global_rows(x)[0]
                                        * torch.as_tensor(c["c_rows"])).sum(),
        "global_rows_roll": roll,
        "global_rows_in_batch": in_batch,
        "batch_rows": lambda x, w, c: ts.batch_sum(x) * ts.batch_rows(x.shape[0]),
    }


FUNCTIONS = sorted(_functions())


def _local_cot(c, rank, world):
    """The cotangents as the rank sees them: the roll's (B, 4) block is
    every rank's; on the whole batch it is tiled."""
    return dict(c, c_roll_local=c["c_roll"])


def _plain(world):
    """Each function's value and gradient on the whole batch, outside the
    scope (one process)."""
    c = _inputs(world)
    cc = dict(c, c_roll_local=np.tile(c["c_roll"], (world, 1)))
    out = {}
    for name, f in _functions().items():
        x = torch.tensor(c["x"], requires_grad=True)
        v = f(x, torch.tensor(c["w"]), cc)
        (g,) = torch.autograd.grad(v, [x])
        out[name] = (float(v.detach()), g.numpy())
    return out


def _worker(rank, world, tmp):
    import torch.distributed as dist

    join_group(rank, world, tmp)
    group = dist.new_group(list(range(world)))
    c = _local_cot(_inputs(world), rank, world)
    rows = slice(rank * B, (rank + 1) * B)
    out = {}
    for name, f in _functions().items():
        x = torch.tensor(c["x"][rows], requires_grad=True)
        with ts.data_scope(group):
            v = f(x, torch.tensor(c["w"][rows]), c)
        (g,) = torch.autograd.grad(v / world, [x])
        out[name] = (float(v.detach()), g.numpy())
    leave_group(out, rank, tmp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reduce")
    return {world: run_ranks(__file__, world, tmp) for world in (1, 2, 3)}


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_reduction_is_the_plain_op_on_the_global_batch(ranks, name, world):
    value, grad = _plain(world)[name]
    for rank, res in enumerate(ranks[world]):
        v, g = res[name]
        assert abs(v - value) <= RTOL * max(abs(value), 1.0), (rank, v, value)
        np.testing.assert_allclose(g, grad[rank * B:(rank + 1) * B], rtol=RTOL,
                                   atol=RTOL * max(np.abs(grad).max(), 1.0))


@pytest.mark.parametrize("name", FUNCTIONS)
def test_outside_the_scope_each_helper_is_the_plain_op(name):
    """In float32 with no scope, and in a scope of no group (a data group
    of one rank), a helper gives the plain op's bits."""
    c = _inputs(2)
    cc = dict(c, c_roll_local=np.tile(c["c_roll"], (2, 1)).astype(np.float32))
    cc = {k: np.asarray(v, np.float32) for k, v in cc.items()}
    x, w = torch.tensor(cc["x"]), torch.tensor(cc["w"])
    f = _functions()[name]
    plain = f(x, w, cc)
    with ts.data_scope(None):
        scoped = f(x, w, cc)
    assert ts.data_group() is None
    assert torch.equal(plain, scoped)
    reference = {
        "batch_sum": lambda: (x * x).sum(),
        "batch_mean": lambda: torch.sin(x).mean(),
        "batch_wmean": lambda: (torch.exp(x[:, 0]) * w).sum() / torch.clamp(w.sum(), min=1.0),
        "batch_vector_norm_2": lambda: torch.linalg.vector_norm(x.reshape(-1)),
        "batch_std": lambda: (x.std(dim=0, correction=0, keepdim=True)
                              * torch.as_tensor(cc["c_col"])).sum(),
    }
    if name in reference:
        assert torch.equal(plain, reference[name]())


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

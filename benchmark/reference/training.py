"""The training comparison: the reference follows the program's first epoch.

A stage is a run of consecutive steps that the program took through its own
call and feed: the whole normal epoch, then the whole OOV sub-epoch. The
reference starts the normal epoch from the benchmark's weights and a fresh
Adam, takes the same batches, computes each step's loss and gradient by
autograd and updates with its own Adam (`adam.py`); it starts the OOV
sub-epoch from its own state at the end of the normal epoch. The numbers of
a stage judge the program:

  * `loss`: the widest relative gap between the program's loss and the
    reference's over every step of the stage;
  * `grad`: the first step's gradient as the program's optimizer got it,
    worked out from its first moment, g1 = (mu_1 - b1 mu_0) / (1 - b1); for
    each leaf the gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's; the
    worst leaf;
  * `grad2`: the same for the second step, g2 = (mu_2 - b1 mu_1) / (1 - b1),
    the first step that the program replays from a captured graph;
  * `change`: the same for each leaf's change over the whole stage, each
    side from its own start, on the leaves whose reference gradient is at
    least a thousandth of the median leaf's (below that a leaf moves under
    Adam by round-off alone); the worst leaf.

The normal epoch's `change` compares the state the OOV sub-epoch starts
from; its end state is the window's start.

Where rounding gaps grow from step to step along a stage (a model whose
ReLUs, dropout and Adam turn a gradient that rounds either way into a
change of up to the learning rate), the reference follows the program step
by step from the program's own state instead (`reference_step`): each
step's loss, gradient and change (`step_numbers`) against the reference's
from the same state, with the same batch and dropout masks. The start of
that chain, the program's state before its first step, is checked by itself
against the benchmark's weights.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from benchmark.reference import adam

Params = Dict[str, torch.Tensor]

ROUNDOFF_LEAF = 1e-3  # a leaf whose reference gradient is below this share of the median's


def _norms(tree: Params) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tree.items()}


def _median(values) -> float:
    v = sorted(values)
    m = len(v) // 2
    return v[m] if len(v) % 2 else 0.5 * (v[m - 1] + v[m])


def leaf_gaps(program: Params, reference: Params, keep=None) -> list:
    """Each leaf's |‖program‖ - ‖reference‖| / max(‖reference‖, the median
    leaf's reference norm)."""
    ref, got = _norms(reference), _norms(program)
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return [0.0]
    med = _median([ref[n] for n in names])
    return [abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def fresh(params0: Params) -> dict:
    """A stage's start: the params and a fresh Adam state."""
    return {"params": {n: p.detach().clone() for n, p in params0.items()},
            "state": adam.init_state(params0)}


def follow(loss_fn: Callable, start: dict, batches: List[dict], lr: float, **loss_kw) -> dict:
    """The reference's steps from `start` ({params, state}) over `batches`.
    → {losses, g1, g2 (the first two steps' gradients), params0, params,
    state}: the end, from which the next stage starts."""
    params = {n: p.detach().clone() for n, p in start["params"].items()}
    s0 = start["state"]
    state = {"mu": {n: t.clone() for n, t in s0["mu"].items()},
             "nu": {n: t.clone() for n, t in s0["nu"].items()}, "count": int(s0["count"])}
    losses, grads = [], []
    for batch in batches:
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        value = loss_fn(leaves, batch, **loss_kw)
        names = list(leaves)
        g = torch.autograd.grad(value, [leaves[n] for n in names], allow_unused=True)
        g = {n: torch.zeros_like(params[n]) if x is None else x for n, x in zip(names, g)}
        if len(grads) < 2:
            grads.append(g)
        losses.append(float(value.detach()))
        with torch.no_grad():
            adam.step(params, g, state, lr)
        del leaves, value, g
    return {"losses": losses, "g1": grads[0], "g2": grads[1], "params0": start["params"],
            "params": params, "state": state}


def moment_grads(mu0: Optional[Params], mu1: Params, mu2: Params):
    """The first two steps' gradients from the optimizer's first moments."""
    b1 = adam.B1
    g1 = {n: (m - (0 if mu0 is None else b1 * mu0[n])) / (1 - b1) for n, m in mu1.items()}
    g2 = {n: (m - b1 * mu1[n]) / (1 - b1) for n, m in mu2.items()}
    return g1, g2


def stage_numbers(program: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one stage. `program` holds `losses`, `g1`, `g2`,
    `params0` and `params` as the program (or a side in its place) gave
    them; `ref` is `follow`'s result."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(program["losses"], ref["losses"]))
    ref_gn = _norms(ref["g1"])
    med = _median(list(ref_gn.values()))
    keep = {n for n, v in ref_gn.items() if v >= ROUNDOFF_LEAF * med}
    p0, r0 = program["params0"], ref["params0"]
    prog_change = {n: program["params"][n] - p0[n] for n in p0}
    ref_change = {n: ref["params"][n] - r0[n] for n in r0}
    return {"loss": loss_gap,
            "grad": max(leaf_gaps(program["g1"], ref["g1"])),
            "grad2": max(leaf_gaps(program["g2"], ref["g2"])),
            "change": max(leaf_gaps(prog_change, ref_change, keep))}


def reference_step(loss_fn: Callable, state: dict, batch: dict, lr: float, **loss_kw):
    """One step of the reference from a given state ({params, mu, nu,
    count}). → (loss, gradient, the change the update makes)."""
    leaves = {n: p.detach().clone().requires_grad_(True) for n, p in state["params"].items()}
    value = loss_fn(leaves, batch, **loss_kw)
    names = list(leaves)
    g = torch.autograd.grad(value, [leaves[n] for n in names], allow_unused=True)
    g = {n: torch.zeros_like(leaves[n]) if x is None else x.detach() for n, x in zip(names, g)}
    with torch.no_grad():
        upd = adam.update(state["params"], g, state["mu"], state["nu"], state["count"], lr)
    return float(value.detach()), g, upd


def program_step(state: dict, after: dict):
    """What the program's step did between two recorded states: its
    gradient from the first moments, g = (mu' - b1 mu) / (1 - b1), and its
    change to each leaf."""
    b1 = adam.B1
    g = {n: (after["mu"][n] - b1 * state["mu"][n]) / (1 - b1) for n in state["mu"]}
    upd = {n: after["params"][n] - state["params"][n] for n in state["params"]}
    return g, upd


def step_numbers(side: tuple, ref: tuple) -> Dict[str, float]:
    """The gaps of one step: `side` and `ref` are (loss, gradient, change).
    The change is judged on the leaves whose reference gradient is at least
    a thousandth of the median leaf's."""
    loss, g, upd = side
    r_loss, r_g, r_upd = ref
    gn = _norms(r_g)
    med = _median(list(gn.values()))
    keep = {n for n, v in gn.items() if v >= ROUNDOFF_LEAF * med}
    return {"loss": abs(loss - r_loss) / max(abs(r_loss), 1e-30),
            "grad": max(leaf_gaps(g, r_g)),
            "step": max(leaf_gaps(upd, r_upd, keep))}

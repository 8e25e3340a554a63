"""Adam as optax's `scale_by_adam` then `scale(-lr)`.

One count shared by every leaf, advanced before the update; every leaf steps,
a leaf with a zero gradient too; the update is mu_hat / (sqrt(nu_hat) + eps)
with the bias corrections 1 - b**count (optax, and the recommender's default
`learner: adam`).
"""

from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def init_state(params: Dict[str, torch.Tensor]) -> dict:
    return {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
            "count": 0}


def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
         lr: float) -> None:
    """One update of `params` and `state` in place."""
    state["count"] += 1
    k = state["count"]
    c1, c2 = 1.0 - B1 ** k, 1.0 - B2 ** k
    for n, p in params.items():
        g = grads[n]
        mu = state["mu"][n].mul_(B1).add_((1 - B1) * g)
        nu = state["nu"][n].mul_(B2).add_((1 - B2) * g * g)
        p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS))


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], mu, nu, count: int,
           lr: float) -> Dict[str, torch.Tensor]:
    """The change that one update from the state (mu, nu, count) makes to
    each leaf, leaving everything it is given as it is."""
    k = int(count) + 1
    c1, c2 = 1.0 - B1 ** k, 1.0 - B2 ** k
    out = {}
    for n in params:
        g = grads[n]
        m = B1 * mu[n] + (1 - B1) * g
        v = B2 * nu[n] + (1 - B2) * g * g
        out[n] = -lr * (m / c1) / (torch.sqrt(v / c2) + EPS)
    return out

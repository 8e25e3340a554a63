"""SLIMElastic: an ElasticNet per item over the training matrix, all the
items' problems solved at once on the model's device.

Port of `oovrec_tpu/models/general/more3.py:321-359` (the module's other
models, FISM, NAIS, ENMF, LINE and ConvNCF, are not ported yet). A
traditional model (`models/general/base.py`); scoring is
`user_hist_matrix[users] @ slim_W` on the model's device.

The JAX package fits `sklearn.linear_model.ElasticNet(alpha, l1_ratio,
positive=True, fit_intercept=False, max_iter=100, tol=1e-4)` once per
item j ≥ 1 on the matrix X with column j zeroed (y = X[:, j]); column 0
stays zero. sklearn is not a dependency of the port, and a loop of such
fits is hours at MovieLens-1M's shape, so `slim_elastic_solve` runs the
same cyclic coordinate descent for every column at once, on the Gram
matrix G = XᵀX (integer counts, exact in float32):
  * problem j's feature k sees ρ = G[k, j] − G[k, :]·W[:, j] + G[k, k]·W[k, j]
    (X_kᵀ of the residual with feature k's own part added back; W[j, j]
    is 0, so X with column j zeroed and X give the same product);
  * a sweep visits k = 0 … n − 1 in order and sets row k of W for every
    column at once: max(ρ − α·l1·N, 0) / (G[k, k] + α·(1 − l1)·N), with
    N = n_users, the positive branch of sklearn's update; feature k is
    absent from problem k, so W[k, k] stays 0, and a feature with
    G[k, k] = 0 is skipped, as sklearn skips it;
  * sklearn's stopping rule, per column, checked after each sweep (and
    once before the first): where the largest change of the sweep is at
    most `tol` times the largest coefficient (or every coefficient is 0,
    or the sweep is the last), the duality gap of its formulation A
    (`_cd_fast.pyx:gap_enet`, positive: the dual norm is the largest
    entry of X_{-j}ᵀR − βw) is computed, and a column whose gap is at
    most `tol`·‖y‖² stops moving: a mask, no host branch per item.
sklearn 1.9 also screens features out by the gap (gap-safe rules) before
and between sweeps; the port does not, so its iterates differ from
sklearn's while both converge to the same optimum: each stopped column's
objective lies within its duality tolerance `tol`·‖y‖² of the optimum.
On the card a sweep is captured once as a CUDA graph and replayed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.general.base import (
    HistoryProductRecommender,
    config_values,
    history_matrix,
)
from oovrec_tpu_torch.utils.device import resolve_device


def elastic_net_gaps(X: torch.Tensor, W: torch.Tensor, l1: float, l2: float) -> torch.Tensor:
    """(n,) duality gap of each column's problem at W (formulation A,
    positive): min ½‖y_j − X_{-j}w‖² + l1‖w‖₁ + ½·l2‖w‖², y_j = X[:, j]."""
    R = X - X @ W
    r2 = (R * R).sum(dim=0)
    ry = (R * X).sum(dim=0)
    xta = X.T @ R - l2 * W
    xta.diagonal().zero_()  # feature j is absent from problem j
    dual_norm = xta.amax(dim=0)
    w_l1 = W.abs().sum(dim=0)
    w_l2 = (W * W).sum(dim=0)
    primal = 0.5 * (r2 + l2 * w_l2) + l1 * w_l1
    scale = torch.where(dual_norm > l1, l1 / dual_norm, torch.ones_like(dual_norm))
    dual = -0.5 * scale**2 * (r2 + l2 * w_l2) + scale * ry
    return primal - dual


@torch.no_grad()
def slim_elastic_solve(X: torch.Tensor, alpha: float = 0.2, l1_ratio: float = 0.02,
                       max_iter: int = 100, tol: float = 1e-4):
    """(W (n, n), info) for the (N, n) float32 0/1 matrix `X` on its
    device; `info`: the sweeps run, the columns stopped by the rule and
    those that reached `max_iter` (column 0 is in neither)."""
    N, n = X.shape
    l1 = alpha * l1_ratio * N
    l2 = alpha * (1.0 - l1_ratio) * N
    G = X.T @ X
    gdiag = torch.diagonal(G).tolist()
    tol_y = tol * torch.diagonal(G)  # tol · ‖y_j‖²
    W = torch.zeros((n, n), dtype=X.dtype, device=X.device)
    W_old = torch.empty_like(W)
    live = torch.ones(n, dtype=torch.bool, device=X.device)
    live[0] = False  # the JAX loop starts at item 1
    fitted = live.clone()
    live &= ~(elastic_net_gaps(X, W, l1, l2) <= tol_y)

    def sweep():
        W_old.copy_(W)
        for k in range(n):
            gkk = gdiag[k]
            if gkk == 0.0:
                continue
            rho = torch.add(G[k] - G[k] @ W, W[k], alpha=gkk)
            new = (rho - l1).clamp_(min=0.0).div_(gkk + l2)
            new[k:k + 1].zero_()  # a fill on the card: no host copy inside the capture
            torch.where(live, new, W[k], out=W[k])

    graph = None
    if X.device.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the warm-up is the first sweep
            sweep()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):  # records the sweep, runs nothing
            sweep()
    sweeps = 0
    for it in range(max_iter):
        if it > 0 or graph is None:
            if not bool(live.any()):
                break
            if graph is None:
                sweep()
            else:
                graph.replay()
        sweeps += 1
        w_max = W.abs().amax(dim=0)
        d_max = (W - W_old).abs().amax(dim=0)
        check = (w_max == 0) | (d_max / w_max <= tol) | (it == max_iter - 1)
        live &= ~(check & (elastic_net_gaps(X, W, l1, l2) <= tol_y))
    return W, {"sweeps": sweeps, "stopped": int((fitted & ~live).sum()),
               "max_iter": int(live.sum())}


def slim_elastic_state(train_split, alpha: float = 0.2, l1_ratio: float = 0.02,
                       device="cpu") -> dict:
    """{"slim_W", "user_hist_matrix"} of a training split, solved on
    `device` (`more3.py:335-359` of the JAX package, by `sklearn` there);
    `slim_info` holds the solve's counts."""
    X = history_matrix(train_split)
    W, info = slim_elastic_solve(torch.from_numpy(X).to(resolve_device(device)),
                                 alpha, l1_ratio)
    return {"slim_W": W.cpu().numpy(), "user_hist_matrix": X, "slim_info": info}


@register_model
class SLIMElastic(HistoryProductRecommender):
    matrix = "slim_W"

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, alpha: float = 0.2,
                 l1_ratio: float = 0.02, slim_W: Optional[np.ndarray] = None,
                 user_hist_matrix: Optional[np.ndarray] = None,
                 slim_info: Optional[dict] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.alpha, self.l1_ratio = float(alpha), float(l1_ratio)
        self.slim_info = slim_info
        self._init_state(user_hist_matrix, slim_W)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        kw = config_values(config, {"alpha": 0.2, "l1_ratio": 0.02})
        return slim_elastic_state(train_split, device=config["device"] if config else "cpu",
                                  **kw)

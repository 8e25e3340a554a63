"""Optimizers as plain functions on tensors.

Port of `oovrec_tpu/train/optimizers.py:75-178` and of the chain the JAX
trainer builds (`trainer.py:67-88, 215-218`). One step is the optax chain

    clip_by_global_norm (clip_grad_norm) → add_decayed_weights (weight_decay)
    → scale_by_adam | scale_by_lazy_adam | scale_by_torch_adam | nothing (sgd)
    → scale(-lr)

applied to every parameter, then `p + update`. Not `torch.optim.Adam`,
whose semantics differ:
  * optax's Adam (the default) advances ONE shared count every step and
    steps every leaf, zero-gradient leaves included (momentum glide on the
    bucket tables between OOV sub-epochs); its update is
    mu_hat / (sqrt(nu_hat) + eps);
  * `learner: sparse_adam` is `scale_by_lazy_adam` (`optimizers.py:24-66`):
    in a 2-D leaf a row whose gradient is all zero keeps its moments and
    gets a zero step, a leaf of another rank takes dense Adam, and the
    count is the shared one (the device epoch's row-sparse path,
    `train/sparse_update.py`, is the O(touched rows) form of the same
    rule);
  * `optimizer_skip_zero_grads: true` is the torch-faithful Adam of
    `scale_by_torch_adam`: per-leaf counts, and a leaf whose gradient is
    all zero this step neither moves nor advances its moments or count;
  * clipping is optax's: scale by max_norm / ‖g‖ only when ‖g‖ ≥ max_norm
    (`torch.nn.utils.clip_grad_norm_` adds 1e-6 and always rescales);
  * weight decay adds wd · p to the gradient before the moments.
The state updates in place. A frozen step (`trainable` given) leaves the
other leaves' parameters, moments and per-leaf counts as they were, while
the shared count advances: `trainer.py:250-259` with `_select_opt_state`.
`adagrad`, `rmsprop` and `optimizer_mu_dtype` are not ported.

The shared count is a Python int in the state, and the bias corrections
are host floats. A step captured in a CUDA graph (`train/cuda_graph.py`)
cannot read either: it passes `count`, a 0-dim int64 tensor on the
parameters' device that the step advances there, and the corrections come
from device tables of the same host floats (`correction_tables`). They
give the eager step's bits: on a CUDA tensor `m / float` multiplies by the
f32 reciprocal (PyTorch's division by a CPU scalar), so the device path
multiplies by the tabled reciprocal there; on the CPU both divide.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from oovrec_tpu_torch.ops.sparse_rows import B1, B2, EPS, bias_correction

NOT_PORTED = ("adagrad", "rmsprop")
# counts whose corrections are tabled; from far below this count on both
# corrections are exactly 1.0 in f32 (checked where the tables are built)
CORRECTION_STEPS = 1 << 15

# a bias correction: a host float (eager), or (c, 1 / c) as 0-dim tensors
Correction = Union[float, Tuple[torch.Tensor, torch.Tensor]]


@functools.lru_cache(maxsize=None)
def correction_tables(device: str) -> torch.Tensor:
    """(2, 2, CORRECTION_STEPS) f32 on `device`: [b1, b2] × [c, 1 / c] of
    `bias_correction` at every count below CORRECTION_STEPS (each the same
    host float the eager step uses; count 0 holds c = 0)."""
    out = np.zeros((2, 2, CORRECTION_STEPS), np.float32)
    for j, decay in enumerate((B1, B2)):
        c = np.array([bias_correction(decay, k) for k in range(CORRECTION_STEPS)], np.float32)
        if c[-1] != 1.0:
            raise AssertionError(f"bias correction of {decay} not 1.0 at the table's end")
        out[j, 0] = c
        with np.errstate(divide="ignore"):
            out[j, 1] = np.float32(1) / c
    return torch.from_numpy(out).to(device)


def device_corrections(count: torch.Tensor) -> Tuple[Correction, Correction]:
    """The b1 and b2 corrections at the (already advanced) 0-dim device
    `count`, read from `correction_tables` with no host read."""
    tab = correction_tables(str(count.device))
    idx = count.clamp(max=CORRECTION_STEPS - 1).view(1)
    sel = tab.index_select(2, idx)
    return ((sel[0, 0].view(()), sel[0, 1].view(())),
            (sel[1, 0].view(()), sel[1, 1].view(())))


def unbias(m: torch.Tensor, corr: Correction) -> torch.Tensor:
    """m / corr, with the eager step's bits on either device."""
    if isinstance(corr, float):
        return m / corr
    c, inv = corr
    return m * inv if m.device.type == "cuda" else m / c


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor
    (`optax.global_norm`)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(updates: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax `clip_by_global_norm`: unchanged below `max_norm`, else each
    tensor scaled to (t / ‖g‖) · max_norm. No host sync."""
    norm = global_norm(updates)
    keep = norm < max_norm
    return [torch.where(keep, t, (t / norm) * max_norm) for t in updates]


def add_decayed_weights(updates: List[torch.Tensor], params: List[torch.Tensor],
                        weight_decay: float) -> List[torch.Tensor]:
    """optax `add_decayed_weights`: g + wd · p (torch's coupled decay)."""
    return [g + weight_decay * p for g, p in zip(updates, params)]


def _corrections(count, b1: float, b2: float) -> Tuple[Correction, Correction]:
    if isinstance(count, tuple):
        return count  # already the (b1, b2) corrections
    return bias_correction(b1, count), bias_correction(b2, count)


def adam_direction(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count,
                   b1: float = B1, b2: float = B2, eps: float = EPS) -> torch.Tensor:
    """optax `scale_by_adam` on one leaf with the already incremented shared
    `count` (or its `device_corrections`): updates mu and nu in place,
    returns mu_hat / (sqrt(nu_hat) + eps)."""
    c1, c2 = _corrections(count, b1, b2)
    mu.copy_((1 - b1) * g + b1 * mu)
    nu.copy_((1 - b2) * (g * g) + b2 * nu)
    mu_hat = unbias(mu, c1)
    nu_hat = unbias(nu, c2)
    return mu_hat / (torch.sqrt(nu_hat) + eps)


def lazy_adam_direction(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count,
                        b1: float = B1, b2: float = B2, eps: float = EPS) -> torch.Tensor:
    """`scale_by_lazy_adam` on one leaf with the already incremented shared
    `count` (or its `device_corrections`). A 2-D leaf's rows with an
    all-zero gradient keep their moments and get a zero step; any other leaf
    takes dense Adam. Moments update in place. No host sync."""
    if g.dim() != 2:
        return adam_direction(g, mu, nu, count, b1, b2, eps)
    c1, c2 = _corrections(count, b1, b2)
    touched = (g != 0).any(dim=1, keepdim=True)
    mu.copy_(torch.where(touched, b1 * mu + (1 - b1) * g, mu))
    nu.copy_(torch.where(touched, b2 * nu + (1 - b2) * g * g, nu))
    mu_hat = unbias(mu, c1)
    nu_hat = unbias(nu, c2)
    return torch.where(touched, mu_hat / (torch.sqrt(nu_hat) + eps), 0.0)


def torch_adam_direction(g: torch.Tensor, count: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, b1: float = B1, b2: float = B2,
                         eps: float = EPS) -> torch.Tensor:
    """`scale_by_torch_adam` on one leaf: a leaf touched this step (any
    non-zero gradient) advances its own `count` and moments in place; an
    untouched leaf keeps them and gets a zero step. No host sync."""
    touched = torch.any(g != 0)
    count.add_(touched.to(count.dtype))
    mu.copy_(torch.where(touched, b1 * mu + (1 - b1) * g, mu))
    nu.copy_(torch.where(touched, b2 * nu + (1 - b2) * g * g, nu))
    k = torch.clamp(count, min=1).to(g.dtype)
    mu_hat = mu / (1 - b1 ** k)
    nu_hat = nu / (1 - b2 ** k)
    return torch.where(touched, mu_hat / (torch.sqrt(nu_hat) + eps), torch.zeros_like(g))


class Optimizer:
    """The trainer's optimizer: configuration plus `init` / `step` over a
    name → tensor dict of parameters."""

    def __init__(self, learner: str = "adam", learning_rate: float = 1e-3,
                 weight_decay: float = 0.0, clip_grad_norm: Optional[dict] = None,
                 skip_zero_grads: bool = False, mu_dtype=None):
        learner = (learner or "adam").lower()
        if learner in NOT_PORTED:
            raise NotImplementedError(f"learner [{learner}] is not ported")
        if mu_dtype:
            raise NotImplementedError("optimizer_mu_dtype is not ported")
        # the JAX trainer's torch-faithful Adam replaces the whole chain,
        # whatever the learner; an unknown learner falls back to adam
        if skip_zero_grads:
            self.rule = "torch_adam"
        elif learner == "sgd":
            self.rule = "sgd"
        elif learner == "sparse_adam":
            self.rule = "lazy_adam"
        else:
            self.rule = "adam"
        self.learning_rate = float(learning_rate)
        self.weight_decay = float(weight_decay or 0.0)
        self.max_norm = None
        if clip_grad_norm:
            self.max_norm = float(clip_grad_norm.get("max_norm", clip_grad_norm.get("max", 1.0)))

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        if self.rule == "sgd":
            return {}
        moments = {
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }
        if self.rule == "torch_adam":
            return {"count": {n: torch.zeros((), dtype=torch.int32, device=p.device)
                              for n, p in params.items()}, **moments}
        return {"count": 0, **moments}

    @property
    def shared_count(self) -> bool:
        """Whether the rule advances one count for every leaf."""
        return self.rule in ("adam", "lazy_adam")

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict, trainable: Optional[set] = None,
             count: Optional[torch.Tensor] = None) -> None:
        """One update of every parameter in place. `trainable` (a set of
        names) freezes the others: no update, moments and per-leaf counts
        kept; the shared count advances all the same. `count`, a 0-dim
        int64 tensor on the parameters' device, stands in for the state's
        shared count and advances there; the caller then advances the
        state's count itself."""
        names = list(params)
        g = [grads[n] for n in names]
        if self.max_norm is not None:
            g = clip_by_global_norm(g, self.max_norm)
        if self.weight_decay:
            g = add_decayed_weights(g, [params[n] for n in names], self.weight_decay)
        corr = None
        if self.shared_count:
            if count is None:
                state["count"] += 1
                corr = state["count"]
            else:
                count.add_(1)
                corr = device_corrections(count)
        for n, gn in zip(names, g):
            if trainable is not None and n not in trainable:
                continue
            if self.rule == "adam":
                u = adam_direction(gn, state["mu"][n], state["nu"][n], corr)
            elif self.rule == "lazy_adam":
                u = lazy_adam_direction(gn, state["mu"][n], state["nu"][n], corr)
            elif self.rule == "torch_adam":
                u = torch_adam_direction(gn, state["count"][n], state["mu"][n], state["nu"][n])
            else:
                u = gn
            params[n].add_(u * -self.learning_rate)


def build_optimizer(config) -> Optimizer:
    """The optimizer a config asks for (`learner`, `learning_rate`,
    `weight_decay`, `clip_grad_norm`, `optimizer_skip_zero_grads`,
    `optimizer_mu_dtype`)."""
    return Optimizer(
        config["learner"], config["learning_rate"], config["weight_decay"],
        config["clip_grad_norm"], bool(config["optimizer_skip_zero_grads"]),
        config["optimizer_mu_dtype"],
    )


def clone_state(state):
    """A true copy of an optimizer state (tensors cloned), for the
    `oov_freeze_skip_optim` rollback: an alias of tensors that update in
    place would restore nothing."""
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.clone()
    return state

"""Shared model layers.

Port of `oovrec_tpu/models/layers.py:13-62`: the activation lookup, the
Dropout → Dense → (BatchNorm) → activation stacks of `MLPLayers` and
`masked_mean_pool`. Each Dense is an `nn.Linear` named `Dense_<j>` and each
batch norm a `BatchNorm` named `BatchNorm_<j>`, as in the flax tree, so the
weight bridge (`utils/jax_params.py`) maps names one to one.

`BatchNorm` is flax's `nn.BatchNorm` (flax 0.12), not
`torch.nn.BatchNorm1d`: running averages as `ra = 0.99·ra + 0.01·batch`,
the biased batch variance `mean(x²) − mean(x)²` clipped at 0, statistics
in f32 whatever the compute dtype, epsilon 1e-5, parameters `scale` /
`bias` and running buffers `mean` / `var` (flax's `batch_stats`). Every
row of the batch counts in its statistics, the padded rows of a last
batch included, as the JAX package's fixed-shape batches count them.

Dropout draws its masks from an explicit `torch.Generator` that the
trainer owns and seeds (`set_dropout_generator`), never from the global
RNG; in train mode without one it raises. The masks cannot match
`jax.random`'s, so parity with the JAX package holds at dropout 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.utils.precision import compute_dtype


def activation_fn(name: Optional[str]):
    if name is None or name == "none":
        return lambda x: x
    return {
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "relu": torch.relu,
        "gelu": nn.functional.gelu,
        "leakyrelu": nn.functional.leaky_relu,
        "softmax": lambda x: torch.softmax(x, dim=-1),
    }.get(name.lower(), torch.relu)


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over the last axis of a (B, features) input:
    train mode normalises with the batch's statistics and moves the
    running ones (under `torch.no_grad()`), eval mode uses the running
    ones. The statistics and the normalisation run in f32; the output
    takes the input's dtype."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=0)
            # jnp.maximum's gradient at a tie: half to each side
            var = torch.maximum((xf * xf).mean(dim=0) - mean * mean, torch.zeros_like(mean))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(x.dtype)


class MLPLayers(nn.Module):
    """Dropout → Dense → (BatchNorm) → activation stacks (`layers.py:33-95`
    of the reference).

    `layers` lists every width including the input width; the activation
    (and the batch norm, `use_bn`) follow every Dense, the last one
    included, exactly like the reference's module list. Dense layers
    compute in the precision policy (`utils/precision.py`) and the output
    is f32. Dropout keeps each input with probability 1 - `dropout` and
    scales it by 1 / (1 - `dropout`) when `train` (the module's mode
    unless given), drawing from `self.generator`; the batch norms follow
    the same `train`.
    """

    def __init__(
        self,
        layers: Sequence[int],
        dropout: float = 0.0,
        activation: str = "relu",
        use_bn: bool = False,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = activation_fn(activation)
        self.dropout = float(dropout)
        self.generator: Optional[torch.Generator] = None
        self.dense = []
        self.bn = []
        for j, (n_in, n_out) in enumerate(zip(layers[:-1], layers[1:])):
            lin = nn.Linear(n_in, n_out, device=device)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"Dense_{j}", lin)
            self.dense.append(lin)
            if use_bn:
                bn = BatchNorm(n_out, device=device)
                self.add_module(f"BatchNorm_{j}", bn)
                self.bn.append(bn)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError(
                "MLPLayers dropout in train mode draws from an explicit "
                "generator: call set_dropout_generator(model, generator) first")
        keep = 1.0 - self.dropout
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        dt = compute_dtype()
        for j, lin in enumerate(self.dense):
            if train and self.dropout > 0:
                x = self._drop(x)
            x = nn.functional.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
            if self.bn:
                x = self.bn[j](x, train)
            x = self.act(x)
        return x.float()


def masked_mean_pool(emb: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(B, L, D) × (B, L) → (B, D): the reference's token_seq mean mode
    (`abstract_recommender.py:553-566`)."""
    m = mask.to(emb.dtype)[..., None]
    return (emb * m).sum(dim=1) / (mask.to(emb.dtype).sum(dim=1, keepdim=True) + eps)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every `MLPLayers` under `module` the generator its dropout
    masks draw from."""
    for m in module.modules():
        if isinstance(m, MLPLayers):
            m.generator = generator

"""Shared model layers.

Port of `oovrec_tpu/models/layers.py:13-53`: the activation lookup and the
Dropout → Dense → activation stacks of `MLPLayers`. Each Dense is an
`nn.Linear` named `Dense_<j>` as in the flax tree, so the weight bridge
(`utils/jax_params.py`) maps names one to one.

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


class MLPLayers(nn.Module):
    """Dropout → Dense → activation stacks (`layers.py:33-95` of the
    reference).

    `layers` lists every width including the input width; the activation
    follows every Dense, the last one included, exactly like the
    reference's module list. Dense layers compute in the precision policy
    (`utils/precision.py`) and the output is f32. Dropout keeps each
    input with probability 1 - `dropout` and scales it by 1 / (1 -
    `dropout`) when `train` (the module's mode unless given), drawing from
    `self.generator`. (The JAX layer's batch norm comes with the first
    ported model that uses it.)
    """

    def __init__(
        self,
        layers: Sequence[int],
        dropout: float = 0.0,
        activation: str = "relu",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = activation_fn(activation)
        self.dropout = float(dropout)
        self.generator: Optional[torch.Generator] = None
        self.dense = []
        for j, (n_in, n_out) in enumerate(zip(layers[:-1], layers[1:])):
            lin = nn.Linear(n_in, n_out, device=device)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"Dense_{j}", lin)
            self.dense.append(lin)

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
        for lin in self.dense:
            if train and self.dropout > 0:
                x = self._drop(x)
            x = nn.functional.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
            x = self.act(x)
        return x.float()


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every `MLPLayers` under `module` the generator its dropout
    masks draw from."""
    for m in module.modules():
        if isinstance(m, MLPLayers):
            m.generator = generator

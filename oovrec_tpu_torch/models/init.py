"""Parameter initializers matching the reference's scales.

The reference applies `xavier_normal_initialization` to every Embedding /
Linear (`recbole/model/init.py`): std = gain*sqrt(2/(fan_in+fan_out)) with
torch's 2D convention fan_in=dim1, fan_out=dim0. The JAX package draws from
`jax.random`; the port draws from a `torch.Generator`, so the two match in
scale only. Exact parity goes through the weight bridge
(`utils/jax_params.py`).
"""

from __future__ import annotations

import torch


@torch.no_grad()
def xavier_normal_(weight: torch.Tensor, generator: torch.Generator = None):
    """In-place torch xavier_normal_ for a 2D (out, in) tensor or
    (vocab, dim) table, drawn from `generator`."""
    fan_out, fan_in = weight.shape[0], weight.shape[-1]
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return weight.normal_(0.0, std, generator=generator)


def normal_init(std: float):
    """An in-place normal(0, std) initializer, `f(weight, generator)`,
    drawn from the caller's generator (`normal_init` of the JAX package;
    DCNv2's cross weights take `normal_init(1.0)`, the reference's
    `torch.randn`)."""

    @torch.no_grad()
    def init(weight: torch.Tensor, generator: torch.Generator = None):
        return weight.normal_(0.0, std, generator=generator)

    return init

"""The model's starting weights, made by the benchmark on the device.

One `torch.Generator` on the card seeded with `--seed`, one normal draw for
every parameter at once, in the dtype they are served in (float32): each
matrix scaled to Xavier's normal width sqrt(2 / (rows + cols)), as the
recommender initialises its tables and layers, each vector (the biases) 0.
The same tensors go into the program's model and to the reference.
"""

from __future__ import annotations

from typing import Dict

import torch


def make(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """name → tensor of that shape, drawn as the module says."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    sizes = {n: int(torch.Size(s).numel()) for n, s in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n, shape in shapes.items():
        if len(shape) >= 2:
            std = (2.0 / (shape[0] + shape[-1])) ** 0.5
            out[n] = flat[at: at + sizes[n]].view(shape).mul_(std)
        else:
            out[n] = torch.zeros(shape, device=device)
        at += sizes[n]
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the weights into the model's own parameters (in place)."""
    params = dict(model.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise KeyError(f"weights and model differ on {sorted(missing)}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])

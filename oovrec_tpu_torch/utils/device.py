"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises when CUDA is asked for and
    absent instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev

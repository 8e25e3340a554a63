"""Seeding and PRNG plumbing.

Host-side randomness (negative sampling, tie-break permutations) uses
per-component `numpy.random.Generator` streams. `host_rng` and
`_stable_hash32` are copies of `oovrec_tpu/utils/seeding.py` and must stay
bit-identical with it: the inductive evaluator's perturbed-hits
permutations come from `host_rng(seed, "perturbed_hits")` in both packages.
Device randomness (weight init) takes an explicit `torch.Generator`.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def init_seed(seed: int, reproducibility: bool = True) -> None:
    """Seed the host-global RNGs (python + legacy numpy).

    Components that need their own stream should call `host_rng(seed, tag)`
    or `torch_generator(seed, device)` instead of relying on the globals.
    """
    random.seed(seed)
    np.random.seed(seed)


def host_rng(seed: int, tag: str = "") -> np.random.Generator:
    """A dedicated, reproducible host RNG stream for component `tag`."""
    ss = np.random.SeedSequence([seed, _stable_hash32(tag)])
    return np.random.Generator(np.random.PCG64(ss))


def _stable_hash32(s: str) -> int:
    """Stable (process-independent) 32-bit hash of a string (FNV-1a)."""
    h = 2166136261
    for ch in s.encode("utf-8"):
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def torch_generator(seed: int, device="cpu") -> torch.Generator:
    """A seeded `torch.Generator` on `device` (a CUDA tensor draws only
    from a CUDA generator)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g

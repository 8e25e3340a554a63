"""O(1) alias-table sampling for the device popularity draw.

Port of `oovrec_tpu/data/alias.py`. The device epoch draws popularity
negatives (the host sampler's counts**alpha distribution,
`data/sampler.py:_draw`) with Walker's alias method: two table gathers and
one compare a draw, static shapes. The table is built on the host once per
epoch runner (Vose's algorithm, float64); the draw is

    u ~ U[0, n);  k = floor(u);  frac = u - k
    id = frac < prob[k] ? k : alias[k]

`build_alias_table` and `reconstruct_p` are copies of the JAX package's
numpy functions and stay bit-exact with them; `alias_draw` takes a
`torch.Generator`.

Exactness invariant (tested): a correct table reconstructs p via
    p[i] = (prob[i] + Σ_{j: alias[j]=i} (1 - prob[j])) / n.
"""

from __future__ import annotations

import numpy as np
import torch


def build_alias_table(p) -> tuple[np.ndarray, np.ndarray]:
    """Vose's algorithm: probabilities `p` (any nonnegative weights; they
    are normalized) → (prob float32 (n,), alias int32 (n,))."""
    p = np.asarray(p, dtype=np.float64)
    n = p.size
    if n == 0:
        raise ValueError("empty probability vector")
    total = p.sum()
    if not (total > 0):
        raise ValueError("probability vector sums to zero")
    scaled = p * (n / total)
    alias = np.arange(n, dtype=np.int32)
    prob = np.ones(n, dtype=np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        if scaled[l_i] < 1.0:
            small.append(l_i)
        else:
            large.append(l_i)
    # leftovers sit at 1.0 within float error: prob already 1, alias=self
    return prob.astype(np.float32), alias


def alias_draw(generator: torch.Generator, shape, prob: torch.Tensor,
               alias: torch.Tensor) -> torch.Tensor:
    """O(1) categorical draws (int64) from a (prob, alias) table on the
    generator's device: two gathers and one compare an element."""
    n = prob.shape[0]
    u = torch.rand(shape, generator=generator, device=prob.device) * n
    k = torch.clamp(u.long(), max=n - 1)  # floor; u may round up to n
    frac = u - k.to(u.dtype)
    return torch.where(frac < prob[k], k, alias[k].long())


def reconstruct_p(prob: np.ndarray, alias: np.ndarray) -> np.ndarray:
    """Fold a (prob, alias) table back into the distribution it encodes —
    the exactness oracle for tests."""
    out = prob.astype(np.float64).copy()
    np.add.at(out, alias, 1.0 - prob.astype(np.float64))
    return out / prob.size

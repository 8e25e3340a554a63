"""Operation and byte counts of the port's kernels, from their shapes.

Frozen copies, at commit f404fe0, of the arithmetic that `PERF.md` section 6
and `chip_smoke.py` bound the kernels with (`topk_operations`,
`cin_operations`, `cin_bound`, `cin_bwd_bound`, `embed_grad_bound`): each
input byte read once, each output byte written once, float32 products.
"""

from __future__ import annotations

import torch

SMALL_MAX = 16384  # ids a gathers' backward call sorts in one block


def topk_launch(B: int, N: int, D: int, k: int):
    """Kernel 1, one launch over the whole corpus: (operations, bytes). The
    scores 2·B·N·D; the users and items read, the exclusion bitmap read,
    k (value, index) pairs a user written."""
    flops = 2 * B * N * D
    nbytes = 4 * (B * D + N * D) + 4 * B * -(-N // 32) + 8 * B * k
    return flops, nbytes


def cin_layers(B: int, F: int, D: int, sizes, direct: bool):
    """(b, h, f, d, l, n_hidden, pooled) of each CIN layer."""
    out, h = [], F
    for i, L in enumerate(sizes):
        last = i == len(sizes) - 1
        nh = 0 if (last or direct) else L // 2
        pooled = L if (last or direct) else L - L // 2
        out.append((B, h, F, D, L, nh, pooled))
        h = L if direct else L // 2
    return out


def cin_forward(layers):
    """Kernel 4 over a stack: (operations, bytes)."""
    flops = sum(2 * b * d * h * f * l for b, h, f, d, l, nh, lp in layers)
    nbytes = sum(4 * (b * h * d + b * f * d + h * f * l + l + b * nh * d + b * lp)
                 for b, h, f, d, l, nh, lp in layers)
    return flops, nbytes


def cin_backward(layers):
    """Kernel 5 over a stack: three products (the pre-activation again, dW,
    dz) against each input read and each output written once."""
    flops = sum(3 * 2 * b * d * h * f * l for b, h, f, d, l, nh, lp in layers)
    nbytes = sum(4 * (2 * (b * h * d + b * f * d + h * f * l + l) + b * nh * d + b * lp)
                 for b, h, f, d, l, nh, lp in layers)
    return flops, nbytes


def gather_backward(ids: torch.Tensor, live: torch.Tensor, n_rows: int, width: int) -> int:
    """The bytes of one call of the gathers' backward: the ids, the live
    mask and the cotangent rows read once; the rows written, which are every
    row of the table where the call's one-block sort writes the table whole
    (n <= SMALL_MAX and no more rows than ids), else the distinct live rows
    (the zeroing of the others is not counted)."""
    n = ids.numel()
    if n <= SMALL_MAX and n_rows <= n:
        written = n_rows
    else:
        written = int(torch.unique(ids[live]).numel())
    return n * (8 + 1 + 4 * width) + 4 * width * written


def adam_dense(n_params: int) -> int:
    """Dense Adam's bytes: params, first and second moments read and written."""
    return 6 * 4 * n_params

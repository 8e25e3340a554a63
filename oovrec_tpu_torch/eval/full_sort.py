"""Full-sort scoring steps on dense (U, N) score matrices.

Port of `oovrec_tpu/eval/full_sort.py:20-142`: score a block of users
against the item corpus, mask PAD + history, build the positive matrix and
take the top-k, all on the device; only the small (U, maxk) hit matrices
travel back to the host. Top-k is stable (ties to the lowest column), as
`lax.top_k` is. The sampled-negative helpers are not ported yet.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.ops.topk_score import stable_topk

NEG_INF = float("-inf")


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def apply_masks(scores, hist_items, hist_len):
    """PAD + history −inf masking (a masked copy of `scores`)."""
    U, H = hist_items.shape
    scores = scores.clone()
    scores[:, 0] = NEG_INF
    valid = _arange(H, hist_items)[None, :] < hist_len[:, None]
    rows = _arange(U, hist_items)[:, None].expand(U, H)
    scores[rows[valid], hist_items[valid].long()] = NEG_INF
    return scores


def _positives(pos_items, pos_len, n_items):
    """(pos_valid (U,P) bool, pos_matrix (U,N) int32 with column 0 zero)."""
    U, P = pos_items.shape
    pos_valid = _arange(P, pos_items)[None, :] < pos_len[:, None]
    pos_matrix = torch.zeros((U, n_items), dtype=torch.int32, device=pos_items.device)
    rows = _arange(U, pos_items)[:, None].expand(U, P)
    pos_matrix[rows[pos_valid], pos_items[pos_valid].long()] = 1
    pos_matrix[:, 0] = 0
    return pos_valid, pos_matrix


def _pad_k(topk_idx, pos_idx, maxk):
    k_eff = topk_idx.shape[-1]
    if k_eff < maxk:
        pad = topk_idx.new_zeros(topk_idx.shape[:-1] + (maxk - k_eff,))
        topk_idx = torch.cat([topk_idx, pad], dim=-1)
        pos_idx = torch.cat([pos_idx, pad.to(pos_idx.dtype)], dim=-1)
    return topk_idx, pos_idx


def mask_and_topk(
    scores: torch.Tensor,       # (U, N)
    hist_items: torch.Tensor,   # (U, H) padded with 0
    hist_len: torch.Tensor,     # (U,)
    pos_items: torch.Tensor,    # (U, P) padded with 0
    pos_len: torch.Tensor,      # (U,)
    maxk: int,
):
    """PAD/history masking + positive matrix + top-k.

    Returns (topk_idx, pos_idx, pos_len) each (U, k)/(U,). The JAX
    version's `perm`/`item_mask` arguments have no caller; the slice
    variants go through `variant_topk`.
    """
    N = scores.shape[1]
    scores = apply_masks(scores, hist_items, hist_len)
    pos_valid, pos_matrix = _positives(pos_items, pos_len, N)
    k_eff = min(maxk, N)  # tiny corpora: ranks beyond N can never be hits
    _, topk_idx = stable_topk(scores, k_eff)
    pos_idx = torch.gather(pos_matrix, 1, topk_idx)
    topk_idx, pos_idx = _pad_k(topk_idx, pos_idx, maxk)
    return topk_idx, pos_idx, pos_valid.sum(dim=1)


def variant_topk(
    scores: torch.Tensor,       # (U, N) raw scores
    hist_items: torch.Tensor,   # (U, H) padded with 0
    hist_len: torch.Tensor,     # (U,)
    pos_items: torch.Tensor,    # (U, P) padded with 0
    pos_len: torch.Tensor,      # (U,)
    maxk: int,
    perms: torch.Tensor,        # (V, N) per-variant tie-break permutations
    item_masks: torch.Tensor,   # (V, N) per-variant 1 = keep column
):
    """All V slice variants of one score matrix.

    The PAD/history mask and the positive matrix are built once; only the
    item-mask + permuted top-k tail runs per variant (the JAX version
    vmaps that tail). Returns (topk_idx, pos_idx, slice_pos_len) with
    leading axis V.
    """
    N = scores.shape[1]
    masked = apply_masks(scores, hist_items, hist_len)
    pos_valid, pos_matrix = _positives(pos_items, pos_len, N)
    k_eff = min(maxk, N)
    pos_long = pos_items.long()

    out_idx, out_pos, out_len = [], [], []
    for perm, imask in zip(perms, item_masks):
        s = torch.where(imask[None, :] > 0, masked, NEG_INF)
        _, topk_p = stable_topk(s[:, perm], k_eff)
        topk_idx = perm[topk_p]
        # indices outside the slice can only surface when the slice has
        # fewer than k live columns; the gather below must not count them
        in_slice = imask[topk_idx] > 0
        pos_idx = torch.gather(pos_matrix, 1, topk_idx)
        out_idx.append(topk_idx)
        out_pos.append(torch.where(in_slice, pos_idx, 0))
        out_len.append((pos_valid & (imask[pos_long] > 0)).sum(dim=1))
    topk_idx, pos_idx = _pad_k(torch.stack(out_idx), torch.stack(out_pos), maxk)
    return topk_idx, pos_idx, torch.stack(out_len)

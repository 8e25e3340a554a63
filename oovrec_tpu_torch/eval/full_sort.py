"""Full-sort scoring steps on dense (U, N) score matrices.

Port of `oovrec_tpu/eval/full_sort.py`: score a block of users against
the item corpus, mask PAD + history, build the positive matrix and take
the top-k, all on the device; only the small (U, maxk) hit matrices
travel back to the host. The sampled-negative path scatters the scored
rows into a (U, N) matrix that is −inf where unscored
(`sampled_matrices`) and takes the top-k of that (`matrix_topk`,
`variant_matrix_topk`). Top-k is stable (ties to the lowest column), as
`lax.top_k` is.
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


def matrix_topk(mat: torch.Tensor, pos_matrix: torch.Tensor, maxk: int):
    """Top-k over a pre-scattered (U, N) score matrix (−inf where
    unscored) with its 0/1 positives. → (topk_idx, pos_idx, pos_len).
    The JAX version's `perm` / `item_mask` arguments have no caller there
    either; the slice variants go through `variant_matrix_topk`."""
    k_eff = min(maxk, mat.shape[1])
    _, topk_idx = stable_topk(mat, k_eff)
    pos_idx = torch.gather(pos_matrix, 1, topk_idx)
    topk_idx, pos_idx = _pad_k(topk_idx, pos_idx, maxk)
    return topk_idx, pos_idx, pos_matrix.sum(dim=1)


def variant_matrix_topk(mat, pos_matrix, maxk: int, perms, item_masks):
    """`variant_topk` for the sampled-negative path: the V slice variants
    (item mask + permuted top-k) of one pre-scattered score matrix."""
    k_eff = min(maxk, mat.shape[1])
    out_idx, out_pos, out_len = [], [], []
    for perm, imask in zip(perms, item_masks):
        m = torch.where(imask[None, :] > 0, mat, NEG_INF)
        pm = pos_matrix * imask[None, :].to(pos_matrix.dtype)
        _, topk_p = stable_topk(m[:, perm], k_eff)
        topk_idx = perm[topk_p]
        out_idx.append(topk_idx)
        out_pos.append(torch.gather(pm, 1, topk_idx))
        out_len.append(pm.sum(dim=1))
    topk_idx, pos_idx = _pad_k(torch.stack(out_idx), torch.stack(out_pos), maxk)
    return topk_idx, pos_idx, torch.stack(out_len)


def scatter_scores(row_user, item_ids, scores, weight, n_users: int, n_items: int):
    """The rows' scores scattered into a (n_users, n_items) −inf matrix,
    the max where a (user, item) cell repeats; padded rows (weight 0) go
    nowhere."""
    mat = torch.full((n_users, n_items), NEG_INF, dtype=scores.dtype, device=scores.device)
    real = weight > 0
    flat = row_user[real].long() * n_items + item_ids[real].long()
    mat.view(-1).scatter_reduce_(0, flat, scores[real], reduce="amax")
    return mat


def positives_matrix(positive_u, positive_i, positive_weight, n_users: int, n_items: int):
    """(n_users, n_items) int32, 1 at each real positive, column 0 zero."""
    mat = torch.zeros((n_users, n_items), dtype=torch.int32, device=positive_u.device)
    real = positive_weight > 0
    mat[positive_u[real].long(), positive_i[real].long()] = 1
    mat[:, 0] = 0
    return mat


def sampled_matrices(batch, scores, iid_field: str, n_users: int, n_items: int):
    """One uni-N batch as (its scores scattered per user slot, column 0
    masked; its positives matrix)."""
    mat = scatter_scores(batch["row_user"], batch[iid_field], scores, batch["weight"],
                         n_users, n_items)
    mat[:, 0] = NEG_INF
    pos = positives_matrix(batch["positive_u"], batch["positive_i"],
                           batch["positive_weight"], n_users, n_items)
    return mat, pos

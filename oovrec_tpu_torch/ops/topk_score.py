"""Fused full-corpus retrieval scoring: scores, exclusion mask and top-k.

Port of `oovrec_tpu/ops/topk_score.py`. The retrieval eval hot path is
`scores = U @ Iᵀ` over the whole item corpus, then PAD/history masking and
top-k. On a CUDA tensor `fused_topk_scores` launches the hand-written
kernel in `csrc/topk_score.cu`, which keeps each score tile in shared
memory and reduces it to k candidates per item block; a stable sort merges
the candidates. On a CPU tensor it runs `fused_topk_scores_plain`, a dense
masked matmul with a stable top-k: the same function, the kernel's
reference in `chip_smoke.py`.

Contract (both versions):
  * values are f32 scores, excluded items score `NEG_INF`;
  * ties go to the lowest item index, dead slots included: once a user's
    live items run out the slots hold the lowest excluded items (value
    `NEG_INF`), then, past the corpus, indices N, N+1, … with value -inf;
  * the exclusion bitmap is (B, ⌈N/32⌉) int32 with item i at bit i % 32
    of word i // 32 (the JAX package's bit-plane layout served TPU lanes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from oovrec_tpu_torch.utils.cuda_build import check, load_kernel

NEG_INF = float(-3.0e38)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stable_topk(x: torch.Tensor, k: int):
    """Row-wise top-k with ties to the lowest column (as `lax.top_k`)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) → the int32 with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bitmap(bitmap: torch.Tensor, n_items: int) -> torch.Tensor:
    """(B, W) int32 words → (B, n_items) bool exclusion mask."""
    cols = torch.arange(n_items, device=bitmap.device)
    words = bitmap[:, cols // 32]
    return ((words >> (cols % 32).to(torch.int32)) & 1).bool()


def build_hist_bitmap(
    hist_items: torch.Tensor,  # (B, H) padded with 0
    hist_len: torch.Tensor,    # (B,)
    n_items: int,
    exclude_col0: bool = True,
) -> torch.Tensor:
    """Exclusion bitmap (B, ⌈n_items/32⌉) int32: history bits ∪ PAD column 0.

    `exclude_col0=False` skips the PAD-column bit — used when the item axis
    is permuted (the PAD item no longer sits at position 0; its exclusion
    then rides in the caller's class bitmap instead). Histories must be
    unique per row, as in the JAX `build_hist_bitmap` (bits are added, not
    or-ed).
    """
    B, H = hist_items.shape
    W = _cdiv(n_items, 32)
    hist_items = hist_items.long()
    valid = torch.arange(H, device=hist_items.device)[None, :] < hist_len[:, None]
    contrib = torch.where(
        valid, torch.ones_like(hist_items) << (hist_items % 32), 0
    )
    bm = torch.zeros((B, W), dtype=torch.int64, device=hist_items.device)
    bm.scatter_add_(1, hist_items // 32, contrib)
    if exclude_col0:
        bm[:, 0] |= 1
    return _as_int32_words(bm)


def pack_bitplane(mask: torch.Tensor) -> torch.Tensor:
    """Pack a dense (N,) 0/1 exclusion mask into the (⌈N/32⌉,) int32 word
    vector `fused_topk_scores` reads (or it into a history bitmap)."""
    n = mask.shape[0]
    W = _cdiv(n, 32)
    m = torch.zeros(W * 32, dtype=torch.int64, device=mask.device)
    m[:n] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return _as_int32_words((m.view(W, 32) << shifts).sum(dim=1))


def _check_inputs(user_e, item_e, hist_bitmap, k):
    if user_e.dim() != 2 or item_e.dim() != 2 or user_e.shape[1] != item_e.shape[1]:
        raise ValueError(
            f"user_e {tuple(user_e.shape)} and item_e {tuple(item_e.shape)} "
            "must be (B, D) and (N, D)"
        )
    B, N = user_e.shape[0], item_e.shape[0]
    if tuple(hist_bitmap.shape) != (B, _cdiv(N, 32)):
        raise ValueError(
            f"bitmap shape {tuple(hist_bitmap.shape)} != {(B, _cdiv(N, 32))}"
        )
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")


def fused_topk_scores_plain(
    user_e: torch.Tensor,       # (B, D) f32
    item_e: torch.Tensor,       # (N, D) f32
    hist_bitmap: torch.Tensor,  # (B, ⌈N/32⌉) int32
    k: int = 20,
):
    """Dense masked matmul + stable top-k → (values (B,k) f32, indices
    (B,k) int32). Same contract as the kernel."""
    _check_inputs(user_e, item_e, hist_bitmap, k)
    N = item_e.shape[0]
    scores = user_e.float() @ item_e.float().T
    scores = scores.masked_fill(unpack_bitmap(hist_bitmap, N), NEG_INF)
    if N < k:
        pad = scores.new_full((scores.shape[0], k - N), float("-inf"))
        scores = torch.cat([scores, pad], dim=1)
    vals, idx = stable_topk(scores, k)
    return vals, idx.to(torch.int32)


def fused_topk_scores(
    user_e: torch.Tensor,       # (B, D) f32
    item_e: torch.Tensor,       # (N, D) f32
    hist_bitmap: torch.Tensor,  # (B, ⌈N/32⌉) int32
    k: int = 20,
):
    """Exact top-k of masked U@Iᵀ → (values (B,k) f32, indices (B,k) int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`fused_topk_scores.launches` counts the launches) or raise.
    """
    if user_e.device.type == "cpu":
        return fused_topk_scores_plain(user_e, item_e, hist_bitmap, k)
    _check_inputs(user_e, item_e, hist_bitmap, k)
    for name, t, dt in (
        ("user_e", user_e, torch.float32),
        ("item_e", item_e, torch.float32),
        ("hist_bitmap", hist_bitmap, torch.int32),
    ):
        if t.device.type != "cuda" or t.device != user_e.device:
            raise ValueError(f"{name} must lie on {user_e.device}, not {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, D = user_e.shape
    N = item_e.shape[0]
    lib = _kernel_library()
    tn = lib.topk_block_items()
    if k > tn:
        raise ValueError(f"k={k} exceeds the kernel's item block ({tn})")
    n_blocks = _cdiv(N, tn)
    if n_blocks > 65535:
        raise ValueError(f"N={N} needs {n_blocks} item blocks; at most 65535")
    vals = torch.empty((n_blocks, B, k), dtype=torch.float32, device=user_e.device)
    idx = torch.empty((n_blocks, B, k), dtype=torch.int32, device=user_e.device)
    with torch.cuda.device(user_e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.topk_score_launch(
            user_e.data_ptr(), item_e.data_ptr(), hist_bitmap.data_ptr(),
            B, N, D, _cdiv(N, 32), k, vals.data_ptr(), idx.data_ptr(), stream,
        )
    check(err, "topk_score_launch")
    fused_topk_scores.launches += 1
    # block-major candidates: among equal values, lower blocks and lower
    # ranks hold lower indices, so a stable sort keeps ties lowest-first
    cand_v = vals.permute(1, 0, 2).reshape(B, n_blocks * k)
    cand_i = idx.permute(1, 0, 2).reshape(B, n_blocks * k)
    top_v, pos = stable_topk(cand_v, min(k, cand_v.shape[1]))
    return top_v, torch.gather(cand_i, 1, pos)


fused_topk_scores.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library with its C signatures (once per process)."""
    lib = load_kernel("topk_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_score_launch.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
    lib.topk_score_launch.restype = ctypes.c_int
    lib.topk_block_items.argtypes = []
    lib.topk_block_items.restype = ctypes.c_int
    return lib

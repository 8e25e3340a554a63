"""Fused full-corpus retrieval scoring: scores, exclusion mask and top-k.

Port of `oovrec_tpu/ops/topk_score.py`. The retrieval eval hot path is
`scores = U @ Iᵀ` over the whole item corpus, then PAD/history masking and
top-k. On a CUDA tensor `fused_topk_scores` launches the hand-written
kernel in `csrc/topk_score.cu`, which scores contiguous ranges of the item
axis in registers and keeps each user's running top-k of a range behind a
threshold; a stable sort merges the ranges' candidates
(`merge_candidates`; the kernel's output has a plain version of its own,
`range_candidates_plain`). On a CPU tensor it runs `fused_topk_scores_plain`, a dense
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

from oovrec_tpu_torch.ops.launches import register
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


# The kernel's blocking (csrc/topk_score.cu): 128-item tiles, a 3-stage ring
# of 32-deep item slices, and k classes of (users per block, list capacity,
# survivor buffer per user). Mirrored here so that the split into ranges is
# plain Python the CPU tests reach; `_kernel_library` checks the kernel
# agrees.
TILE_ITEMS = 128
K_CLASSES = ((128, 32, 64), (64, 128, 64), (16, 512, 128), (16, 1024, 128))
MAX_SMEM = 232448
_STAGES, _DEPTH = 3, 32


def kernel_smem_bytes(cls: int, d: int, stream_users: bool = False) -> int:
    """Shared memory (bytes) of the kernel's k class `cls` at depth d: the
    user tile stays whole, or with `stream_users` rides the ring in 32-deep
    slices beside the item slices."""
    tu, cap, buf = K_CLASSES[cls]
    users = _STAGES * tu * (_DEPTH + 4) if stream_users else tu * (_cdiv(d, _DEPTH) * _DEPTH + 4)
    return (8 * tu * (cap + buf + 1) + 8 * tu + 16 + 4 * _STAGES * tu * TILE_ITEMS // 32
            + 4 * users + 4 * _STAGES * TILE_ITEMS * (_DEPTH + 4))


def k_class(k: int, d: int) -> int:
    """The first k class whose lists hold k and whose tiles fit in shared
    memory at depth d with the user tile whole, else the first whose tiles
    fit with it streamed (`stream_users`)."""
    for stream in (False, True):
        for cls, (_, cap, _) in enumerate(K_CLASSES):
            if k <= cap and kernel_smem_bytes(cls, d, stream) <= MAX_SMEM:
                return cls
    raise ValueError(f"k={k}: no k class of the kernel holds k (at most {K_CLASSES[-1][1]})")


def stream_users(cls: int, d: int) -> bool:
    """Whether k class `cls` streams the user tile at depth d (it does not
    fit whole)."""
    return kernel_smem_bytes(cls, d) > MAX_SMEM


def range_split(n_items: int, k: int, users_per_block: int, n_users: int,
                n_sm: int = 132):
    """(n_tiles, n_ranges): how the kernel splits the item axis.

    The padded index space [0, n_tiles·128) covers max(N, k) indices; items
    past N score -inf. Range r holds tiles [r·n_tiles // n_ranges,
    (r+1)·n_tiles // n_ranges): contiguous, ascending, at least ⌈k/128⌉
    tiles each, so every range emits k real candidates. About one block per
    SM: n_sm // (user tiles) ranges."""
    n_tiles = _cdiv(max(n_items, k), TILE_ITEMS)
    want = max(1, n_sm // _cdiv(n_users, users_per_block))
    n_ranges = max(1, min(want, n_tiles // _cdiv(k, TILE_ITEMS), 65535))
    return n_tiles, n_ranges


def range_bounds(n_tiles: int, n_ranges: int):
    """[(first item, end item)] of each range, in the padded index space."""
    return [(r * n_tiles // n_ranges * TILE_ITEMS,
             (r + 1) * n_tiles // n_ranges * TILE_ITEMS) for r in range(n_ranges)]


def range_candidates_plain(user_e, item_e, hist_bitmap, k: int, n_tiles: int,
                           n_ranges: int):
    """Plain version of the kernel's own output: each range's exact top-k
    of the masked scores (padded with -inf past N), (n_ranges, B, k) values
    f32 and global indices int32, ranges in ascending item order."""
    _check_inputs(user_e, item_e, hist_bitmap, k)
    N = item_e.shape[0]
    scores = user_e.float() @ item_e.float().T
    scores = scores.masked_fill(unpack_bitmap(hist_bitmap, N), NEG_INF)
    pad = scores.new_full((scores.shape[0], n_tiles * TILE_ITEMS - N), float("-inf"))
    scores = torch.cat([scores, pad], dim=1)
    vals, idx = [], []
    for lo, hi in range_bounds(n_tiles, n_ranges):
        v, i = stable_topk(scores[:, lo:hi], k)
        vals.append(v)
        idx.append((i + lo).to(torch.int32))
    return torch.stack(vals), torch.stack(idx)


def merge_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """(n_ranges, B, k) range candidates → the (B, k) top-k. Among equal
    values, lower ranges and lower ranks hold lower indices, so a stable
    sort of the range-major list keeps ties lowest-first."""
    n_ranges, B, kk = vals.shape
    cand_v = vals.permute(1, 0, 2).reshape(B, n_ranges * kk)
    cand_i = idx.permute(1, 0, 2).reshape(B, n_ranges * kk)
    top_v, pos = stable_topk(cand_v, k)
    return top_v, torch.gather(cand_i, 1, pos)


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
    cls = k_class(k, D)
    n_sm = torch.cuda.get_device_properties(user_e.device).multi_processor_count
    n_tiles, n_ranges = range_split(N, k, K_CLASSES[cls][0], B, n_sm)
    lib = _kernel_library()
    vals = torch.empty((n_ranges, B, k), dtype=torch.float32, device=user_e.device)
    idx = torch.empty((n_ranges, B, k), dtype=torch.int32, device=user_e.device)
    vec = D % 4 == 0 and item_e.data_ptr() % 16 == 0
    with torch.cuda.device(user_e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.topk_score_launch(
            user_e.data_ptr(), item_e.data_ptr(), hist_bitmap.data_ptr(),
            B, N, D, _cdiv(N, 32), k, cls, int(stream_users(cls, D)), n_tiles, n_ranges,
            int(vec), vals.data_ptr(), idx.data_ptr(), stream,
        )
    check(err, "topk_score_launch")
    fused_topk_scores.launches += 1
    return merge_candidates(vals, idx, k)


register(fused_topk_scores, "topk_range_kernel")


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library with its C signatures (once per process);
    raises if its blocking differs from the one mirrored above."""
    lib = load_kernel("topk_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_score_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p]
    lib.topk_score_launch.restype = ctypes.c_int
    for name in ("topk_tile_items", "topk_class_count"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    for name in ("topk_class_users", "topk_class_capacity", "topk_class_buffer"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    lib.topk_smem_bytes.argtypes = [i, i, i]
    lib.topk_smem_bytes.restype = ctypes.c_longlong
    got = (lib.topk_tile_items(), tuple(
        (lib.topk_class_users(c), lib.topk_class_capacity(c), lib.topk_class_buffer(c))
        for c in range(lib.topk_class_count())))
    if got != (TILE_ITEMS, K_CLASSES) or any(
            lib.topk_smem_bytes(c, d, su) != kernel_smem_bytes(c, d, bool(su))
            for c in range(len(K_CLASSES)) for d in (7, 64, 100, 2048) for su in (0, 1)):
        raise RuntimeError(f"topk_score kernel blocking {got} differs from the wrapper's")
    return lib

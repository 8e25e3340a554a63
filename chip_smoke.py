"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase failure is caught):
  1. build: `nvcc` builds every kernel of the port from `oovrec_tpu_torch/csrc`,
     one process per source, all at once;
  2. kernels: each kernel against its plain PyTorch version on the card,
     exactly, on ragged, tied and all-masked shapes, k = 1 / 20 / 100 /
     512 / 600 / 1,024, B = 1 and 257, D = 1,000 / 2,048 (the user tile
     streamed) and ties across item ranges (top-k) and on integer-valued
     inputs at every CIN layer mode, odd and ragged shape and the edges of
     its geometry (L = 128 / 200, D = 1 / 128 / 200, a pair axis of 700,
     2,450 pairs at D = 128: several launches over D spans and column
     groups) (CIN); the CIN kernel also on random inputs to a stated
     tolerance and against a repeat run; then each timed at the main-path
     shapes beside its bound and a PyTorch yardstick;
  3. retrieval serving: BPR at embedding_size 64 with random-mapper OOV
     buckets over 110,000 users and 1,000,000 items (10 % new), 7-slice
     inductive eval and IV full-sort eval, fused path vs dense path to
     1e-9, with the top-k kernel's launch count read around the fused run;
  4. ranking serving: xDeepFM at its published widths (embedding_size 10,
     CIN 100/100/100, MLP 128/128/128) over 7 fields, 220,000 users and
     110,000 items (10 % new) with OOV buckets, 1,048,576 labelled rows in
     batches of 8,192: value eval (AUC, LogLoss) and the 7 value slices,
     CIN kernel vs plain slab path to 1e-6, with the CIN kernel's launch
     count read around each run; then a profile of one fused pass;
  5. ranking training: the same xDeepFM from another seed through
     `Trainer.fit` over the IV rows of the first 90 % of those rows, one
     epoch plus the frozen OOV-only sub-epoch (adam lr 1e-3, batches of
     8,192): 3 forward and 3 backward CIN launches a step, IV tables
     bitwise unchanged by the frozen sub-epoch and bucket tables moved, the
     loss falling, held-out AUC up, then the 7 value slices on the trained
     weights; 16 steps on the kernel path against the plain slab path from
     identical weights; wall ms per step and a profile of fused steps; then
     4 steps at cin_layer_size 200 through `fused_cin: auto` on the CIN
     kernels (two column groups a backward) against 4 on the slab path,
     the backward against its plain version at those layers' shapes, and
     one batch served on the forward kernel;
  6. retrieval training: BPR at embedding_size 64 over the serving scale,
     64 pairwise steps of 2,048 rows plus an OOV sub-epoch through
     `Trainer.fit`, then the 7-slice eval fused vs dense to 1e-9; then BPR
     with `learner: sparse_adam` on the device epoch (kernel 6);
  7. the CLI, the main path's own entry (`build/cli/`):
     A. `python -m oovrec_tpu_torch.cli.run` as a subprocess on the tracked
        corpus dataset/synth-ind: BPR (D 64), random-mapper OOV buckets,
        the OOV regime, the paper protocol (uni250), 5 epochs, the 7-slice
        inductive eval and `--results_json`; rc 0, finite metrics, all 7
        slices; `--eval_only` on its checkpoint reproduces it to 1e-9;
     B. `cli.run.main` in this process: xDeepFM at its published widths
        under the ranking protocol, 3 epochs, the CIN forward and backward
        kernels counted (> 0) and held against their plain versions at a
        training batch's and a uni250 test batch's shapes (2,048 and about
        100,000 rows); `--eval_only` with `--fused_cin` True and False
        agree on AUC, RMSE and the 7 value slices to 1e-6;
     C. an atomic-file family written here (the generator of
        tools/make_synth_dataset.py at 50,000 users x 100,000 items x
        1,000,000 rows) through `quick_start.run`: BPR at D 64 with 1,024
        buckets a side, `learner: sparse_adam` on the device epoch (kernel
        6 counted), full-sort eval, then `perform_inductive_eval` (kernel 1
        counted); the wall time of each stage; `--eval_only` with
        `use_fused_topk` True and False (perturbed hits off, as in phase
        3) agree to 1e-9.
Phase 2 also holds the CIN backward kernel against its plain version,
bit for bit on integer inputs and gradients (and against itself on a
repeat run), and times it per layer and for the 3-layer stack.
The last line is the device record; the line before it lists the kernels,
each with its launches on the earlier phases' paths (`launches`) and on
the CLI phases (`launches_cli`).

TF32 is switched off for matmuls and cuDNN below: the plain versions and
the dense path must compute in full f32, as the kernel does.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from oovrec_tpu_torch.cli import quick_start
from oovrec_tpu_torch.cli import run as cli_run
from oovrec_tpu_torch.cli.inductive_eval import perform_inductive_eval
from oovrec_tpu_torch.config import Config
from oovrec_tpu_torch.data import dataset as dataset_module
from oovrec_tpu_torch.data.utils import data_preparation
from oovrec_tpu_torch.data import (
    DatasetSplit,
    FullSortEvalBatcher,
    PlainEvalBatcher,
    Sampler,
    TrainBatcher,
)
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator
from oovrec_tpu_torch.eval.runner import to_device_batch
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper
from oovrec_tpu_torch.models import BPR, FieldSpec, xDeepFM
from oovrec_tpu_torch.ops import topk_score
from oovrec_tpu_torch.ops.cin_fused import (
    cin_layer,
    cin_layer_bwd,
    cin_layer_bwd_plain,
    cin_layer_plain,
    cin_layer_pooled,
    cin_layer_pooled_bwd,
    cin_layer_pooled_bwd_plain,
    cin_layer_pooled_plain,
    bwd_plan,
    fwd_geometry,
    fwd_plan,
)
from oovrec_tpu_torch.ops.topk_score import (
    K_CLASSES,
    NEG_INF,
    build_hist_bitmap,
    fused_topk_scores,
    fused_topk_scores_plain,
    k_class,
    pack_bitplane,
    range_split,
    stream_users,
    unpack_bitmap,
)
from oovrec_tpu_torch.ops.sparse_rows import sparse_adam_rows_kernel, sparse_adam_rows_plain
from oovrec_tpu_torch.train import Trainer
from oovrec_tpu_torch.train.sparse_update import coalesce_rows
from oovrec_tpu_torch.utils import cuda_build
from oovrec_tpu_torch.utils.enums import InputType
from oovrec_tpu_torch.utils.precision import set_policy
from oovrec_tpu_torch.utils.seeding import torch_generator

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEED = 2020
DEVICE = "cuda"
# published peaks of one H100 SXM: HBM3 bandwidth and dense FP32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the repo's real serving scale (tools/bench_inductive_eval.py:1-40)
N_OLD_USERS, N_NEW_USERS = 100_000, 10_000
N_OLD_ITEMS, N_NEW_ITEMS = 900_000, 100_000
B, D, K = 256, 64, 20
N_TEST_USERS, MAX_HIST, MAX_POS = 1024, 64, 16
TOPK = [3, 5, 10, 20]
# the ranking track: xDeepFM at its published widths
# (oovrec_tpu/config/model/xDeepFM.yaml) over the repo's CTR field layout
# (bench.py:515-562) with 10 % new users and items
N_CTR_OLD_USERS, N_CTR_NEW_USERS = 200_000, 20_000
N_CTR_OLD_ITEMS, N_CTR_NEW_ITEMS = 100_000, 10_000
CTR_B, CTR_BATCHES, CTR_D = 8192, 128, 10
CIN_SIZES, MLP_SIZES = (100, 100, 100), (128, 128, 128)
# random inputs, outputs of order 1: f32 sums taken in another order. The
# bf16 mode is held to the same bound, tighter than a bf16 tolerance: kernel
# and plain version round the same operands and products to bf16. The
# backward's outputs sum up to B*D terms, so each is held to CIN_TOL
# relative to max(1, its largest magnitude)
CIN_TOL = 1e-4
# random backward inputs: the incoming gradient is zeroed where the f64
# pre-activation lies within this band of 0, so that the ReLU mask there (a
# rounding matter between two summation orders) does not decide the result
CIN_MASK_BAND = 1e-3
# training: the ranking and retrieval trainers' batch sizes (bench.py's
# CTR_BATCH and the train_batch_size default) and the kernel-vs-plain
# training comparison
CTR_TRAIN_FRACTION = 0.9
BPR_TRAIN_B, BPR_TRAIN_STEPS = 2048, 64
COMPARE_STEPS, LOSS_RTOL, PARAM_ATOL = 16, 1e-5, 1e-4
# a CIN wider than one backward launch takes (L > 128): `fused_cin: auto`
# trains it on the kernels (two column groups a backward) and serves it
WIDE_CIN_SIZES, WIDE_STEPS = (200, 200, 200), 4
# the retrieval track's sparse-adam training (bench.py:61-65, 348-510): BPR
# at D = 64 over 200,000 users x 100,000 items, 1,024 random-mapper buckets
# a side, pairwise steps of 8,192 rows, 100 steps (bench.py's STEPS); each
# user in one of 64 groups, 90 % of its items from the group's slice, so the
# loss can fall; lr 1e-2 moves it within the one epoch (bench.py times the
# step at 1e-3)
SP_USERS, SP_ITEMS, SP_BUCKETS, SP_B, SP_STEPS = 200_000, 100_000, 1024, 8192, 100
SP_GROUPS, SP_IN_GROUP, SP_LR = 64, 0.9, 1e-2
# an element beyond PARAM_ATOL is explained when at some step its gradient
# differed between the paths by more than this (relative): more than f32
# summation rounding (about 1e-6 here) can do
EXPLAINED_GRAD_RTOL, MAX_EXPLAINED_FRACTION = 1e-3, 1e-5


def log(*args):
    print(*args, flush=True)


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------- kernels


def exact_inputs(b, n, d, seed, tied=False):
    """Inputs whose f32 dot products are exact in any summation order, so
    kernel and plain must agree bit for bit. Column 0 gives every item a
    distinct fraction perm(i)·2⁻²⁰ (no ties) unless `tied`, where all
    scores are small integers (ties everywhere)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-1, 2, size=(b, d)).astype(np.float32)
    u[:, 0] = 1.0
    it = np.zeros((n, d), np.float32)
    cols = rng.integers(1, d, size=(n, 3))
    np.put_along_axis(it, cols, 1.0, axis=1)
    if not tied:
        it[:, 0] = rng.permutation(n).astype(np.float32) * 2.0**-20
    return (torch.from_numpy(u).to(DEVICE), torch.from_numpy(it).to(DEVICE))


def random_hist(b, n, h, seed):
    rng = np.random.default_rng(seed)
    hist = np.zeros((b, h), np.int64)
    hist_len = rng.integers(0, h + 1, size=b)
    for r in range(b):
        hist[r, : hist_len[r]] = rng.choice(np.arange(1, n), hist_len[r], replace=False)
    return torch.from_numpy(hist).to(DEVICE), torch.from_numpy(hist_len).to(DEVICE)


def check_exact(name, u, it, bm, k):
    kv, ki = fused_topk_scores(u, it, bm, k=k)
    sync()
    pv, pi = fused_topk_scores_plain(u, it, bm, k=k)
    require(kv.shape == (u.shape[0], k) and ki.dtype == torch.int32, f"{name}: shape")
    require(torch.equal(kv, pv), f"{name}: values differ from the plain version")
    require(torch.equal(ki, pi), f"{name}: indices differ from the plain version")
    return kv, ki


def lowest_index_ties(u, it, bm, vals, idx):
    """Every selected index is the lowest unexcluded item not selected
    before it among the items of its score."""
    scores = (u @ it.T).masked_fill(unpack_bitmap(bm, it.shape[0]), NEG_INF)
    for r in range(min(8, u.shape[0])):
        picked = set()
        for v, i in zip(vals[r].tolist(), idx[r].tolist()):
            same = torch.nonzero(scores[r] == v).flatten().tolist()
            first = next(j for j in same if j not in picked)
            require(i == first, f"tie row {r}: index {i}, lowest is {first}")
            picked.add(i)


def kernel_cases():
    """Kernel vs plain on the card, exactly."""
    cases = [
        # name, B, N, D, k, exclude_col0
        ("main", B, N_OLD_ITEMS + N_NEW_ITEMS, D, K, True),
        ("ragged", 37, 4099, 64, 10, False),
        ("odd-depth", 5, 700, 48, 20, True),
        ("n-below-k", 6, 13, 64, 20, True),
        ("depth-7", 11, 3000, 7, 20, True),
        ("k1", B, 200_000, D, 1, True),
        ("k100", 70, 200_003, D, 100, True),
        ("k512", 20, 100_001, D, 512, False),
        ("k512-n-below-k", 3, 300, D, 512, True),
        ("k600", 20, 100_001, D, 600, False),
        ("k1024-ragged", 7, 5003, D, 1024, True),
        ("deep-D2048", 37, 20_000, 2048, 20, True),  # the user tile streams
        ("deep-D1000-k600", 5, 10_000, 1000, 600, True),
        ("B1", 1, 300_000, D, K, True),
        ("B257", 257, 50_000, D, K, True),
    ]
    for i, (name, b, n, d, k, ex) in enumerate(cases):
        u, it = exact_inputs(b, n, d, seed=SEED + i)
        hist, hist_len = random_hist(b, n, min(64, n - 1), seed=SEED + 100 + i)
        bm = build_hist_bitmap(hist, hist_len, n, exclude_col0=ex)
        check_exact(name, u, it, bm, k)
        cls = k_class(k, d)
        log(f"kernel check {name}: B={b} N={n} D={d} k={k} exclude_col0={ex} "
            f"({topk_ranges(b, n, d, k)} item ranges, k class {cls}, user tile "
            f"{'streamed' if stream_users(cls, d) else 'whole'}): exact")

    # users with fewer than k live items: their tail slots hold the lowest
    # excluded items, in the kernel as in the plain version
    b, n, k = 9, 600, 20
    u, it = exact_inputs(b, n, 64, seed=SEED + 7)
    rng = np.random.default_rng(SEED + 8)
    dense = torch.zeros((b, n), dtype=torch.bool, device=DEVICE)
    for r in range(b):
        live = rng.choice(np.arange(1, n), size=int(rng.integers(0, 2 * k)), replace=False)
        dense[r] = True
        dense[r, torch.from_numpy(live).to(DEVICE)] = False
    bm = torch.stack([pack_bitplane(m) for m in dense])
    kv, _ = check_exact("all-masked-tail", u, it, bm, k)
    require(bool((kv == NEG_INF).any()), "all-masked-tail: no dead slot exercised")
    log("kernel check all-masked-tail: exact, dead slots present")

    for name, b, n in (("tied", 64, 100_003), ("tied-ragged", 33, 5000)):
        u, it = exact_inputs(b, n, 64, seed=SEED + 9, tied=True)
        hist, hist_len = random_hist(b, n, 64, seed=SEED + 10)
        bm = build_hist_bitmap(hist, hist_len, n)
        kv, ki = check_exact(name, u, it, bm, K)
        lowest_index_ties(u, it, bm, kv, ki)
        log(f"kernel check {name}: B={b} N={n}: exact, ties to the lowest index")

    # every item scores the same: each range offers its lowest live items
    # and the merge must keep the lowest across range boundaries
    for name, b, n, k in (("tied-across-ranges", 40, 60_000, K),
                          ("tied-across-ranges-k100", 9, 60_000, 100)):
        u = torch.ones((b, D), device=DEVICE)
        it = torch.full((n, D), 0.5, device=DEVICE)
        hist, hist_len = random_hist(b, n, 64, seed=SEED + 11)
        bm = build_hist_bitmap(hist, hist_len, n)
        _, ki = check_exact(name, u, it, bm, k)
        live = ~unpack_bitmap(bm, n)
        for r in range(b):
            lowest = torch.nonzero(live[r]).flatten()[:k].to(torch.int32)
            require(torch.equal(ki[r], lowest), f"{name}: row {r} is not the lowest live items")
        ranges = topk_ranges(b, n, D, k)
        require(ranges > 1, f"{name}: one item range only")
        log(f"kernel check {name}: B={b} N={n} k={k}, {ranges} item ranges: exact, "
            "ties to the lowest index across range boundaries")


def topk_ranges(b, n, d, k):
    """The number of item ranges the top-k kernel splits N into."""
    cls = k_class(k, d)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return range_split(n, k, K_CLASSES[cls][0], b, n_sm)[1]


def time_ms(fn, inputs, reps):
    """Median ms of `fn(*inputs[r % len(inputs)])`, CUDA events, a
    synchronize after every launch."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for r in range(reps):
        args = inputs[r % len(inputs)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(fn, inputs, n=10, reps=10):
    """Median ms a call of `fn` over n calls enqueued back to back between
    two events: the device's time, without the host's time of one call."""
    return time_ms(lambda *args: [fn(*args) for _ in range(n)], inputs, reps) / n


def kernel_timing():
    """Kernel, plain and library times at the main-path shapes on random
    f32 inputs, with the kernel's largest difference from the plain
    version (tolerance: 1e-4 absolute on scores of order 1, f32 sums of 64
    products taken in another order)."""
    n = N_OLD_ITEMS + N_NEW_ITEMS
    g = torch_generator(SEED, DEVICE)
    item_e = torch.randn((n, D), generator=g, device=DEVICE) / math.sqrt(D)
    inputs = []
    for i in range(3):
        user_e = torch.randn((B, D), generator=g, device=DEVICE)
        hist, hist_len = random_hist(B, n, MAX_HIST, seed=SEED + 20 + i)
        bm = build_hist_bitmap(hist, hist_len, n)
        inputs.append((user_e, item_e, bm))

    kv, ki = fused_topk_scores(*inputs[0], k=K)
    sync()
    pv, pi = fused_topk_scores_plain(*inputs[0], k=K)
    max_abs_err = float((kv - pv).abs().max())
    require(max_abs_err <= 1e-4, f"main shape: max |kernel - plain| {max_abs_err}")
    # an index may differ only where two scores are within the tolerance
    user_e, _, bm = inputs[0]
    plain_at_kernel = (user_e @ item_e.T).gather(1, ki.long())
    require(float((plain_at_kernel - pv).abs().max()) <= 1e-4,
            "main shape: kernel picked an item the plain version ranks lower")
    idx_agree = float((ki == pi).float().mean())

    def fused(u, it, m):
        return fused_topk_scores(u, it, m, k=K)

    def plain(u, it, m):
        return fused_topk_scores_plain(u, it, m, k=K)

    dense_masks = [unpack_bitmap(m, n) for _, _, m in inputs]

    def library(u, it, mask):  # yardstick only; the port never calls this
        return torch.topk((u @ it.T).masked_fill_(mask, NEG_INF), K, dim=1)

    ms = time_ms(fused, inputs, 30)
    plain_ms = time_ms(plain, inputs, 6)
    library_ms = time_ms(
        library, [(u, it, mk) for (u, it, _), mk in zip(inputs, dense_masks)], 30
    )
    # the selection's share grows with k, the score product does not
    by_k = {
        kk: time_ms(lambda u, it, m, kk=kk: fused_topk_scores(u, it, m, k=kk),
                    inputs, 20)
        for kk in (1, 10, 100)
    }
    by_k[K] = ms
    w = -(-n // 32)
    bytes_moved = 4 * (B * D + n * D + B * w) + 8 * B * K
    flops = 2 * B * n * D
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    log("kernel_ms by k: " + " ".join(f"k={kk}:{t:.4f}" for kk, t in sorted(by_k.items()))
        + f" (bound {max(t_bytes, t_ops):.4f} ms; k={K} / k=1: {ms / by_k[1]:.3f})")
    log(f"timing B={B} N={n} D={D} k={K}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (matmul + mask + torch.topk) "
        f"bytes_ms={t_bytes:.4f} ops_ms={t_ops:.4f} "
        f"max_abs_err={max_abs_err:.3e} index_agreement={idx_agree:.6f}")
    return {
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
    }


# ----------------------------------------------------------------- serving


def build_model():
    spec = InductiveSpec(
        mapper="random", add_oov_buckets=True,
        n_user_buckets=100, n_item_buckets=100, hash_function="3round",
    )
    return BPR(
        N_OLD_USERS, N_OLD_ITEMS, D, spec, device=DEVICE,
        generator=torch_generator(SEED, DEVICE),
    )


@torch.no_grad()
def synth_interactions(model, mapper):
    """Seeded test users (a quarter new) with histories (≤ 64) and
    positives (≤ 16). Half of each user's positives and a few history items
    come from the user's top-24 old and top-24 new items under the model,
    so every slice and the history mask have something to show."""
    rng = np.random.default_rng(SEED)
    n_items = N_OLD_ITEMS + N_NEW_ITEMS
    n_new = N_TEST_USERS // 4
    users = np.concatenate([
        rng.choice(np.arange(1, N_OLD_USERS), N_TEST_USERS - n_new, replace=False),
        rng.choice(np.arange(N_OLD_USERS, N_OLD_USERS + N_NEW_USERS), n_new,
                   replace=False),
    ])
    ids = torch.arange(n_items, device=DEVICE)
    buckets = torch.from_numpy(
        np.where(np.arange(n_items) >= N_OLD_ITEMS,
                 mapper.item_buckets(np.arange(n_items)), 0)
    ).to(DEVICE)
    item_e = model.all_item_embeddings(ids, buckets)
    oov = users >= N_OLD_USERS
    batch = {
        "user_id": torch.from_numpy(users).to(DEVICE),
        "user_id_oov": torch.from_numpy(oov.astype(np.int64)).to(DEVICE),
        "user_id_bucket": torch.from_numpy(
            np.where(oov, mapper.user_buckets(users), 0)).to(DEVICE),
    }
    scores = model.score_against(batch, item_e)
    # old and new items separately: bucket rows outscore the IV table at init
    top_old = torch.topk(scores[:, 1:N_OLD_ITEMS], 24, dim=1).indices + 1
    top_new = torch.topk(scores[:, N_OLD_ITEMS:], 24, dim=1).indices + N_OLD_ITEMS
    top = torch.cat([top_old, top_new], dim=1).cpu().numpy()
    del scores

    hist_u, hist_i, pos_u, pos_i = [], [], [], []
    for r, u in enumerate(users):
        n_pos = int(rng.integers(1, MAX_POS + 1))
        n_hist = int(rng.integers(0, MAX_HIST + 1))
        near = rng.permutation(top[r])
        far = rng.choice(np.arange(1, n_items), n_pos + n_hist, replace=False)
        pool = list(dict.fromkeys(np.concatenate([near[: n_pos // 2 + 4], far])))
        pos = pool[: n_pos]
        hist = pool[n_pos: n_pos + n_hist]
        pos_u += [u] * len(pos)
        pos_i += pos
        hist_u += [u] * len(hist)
        hist_i += hist
    as_split = lambda uu, ii, n_u, n_i: DatasetSplit(  # noqa: E731
        {"user_id": np.asarray(uu, np.int64), "item_id": np.asarray(ii, np.int64)},
        n_u, n_i,
    )
    n_users = N_OLD_USERS + N_NEW_USERS
    train = as_split(hist_u, hist_i, n_users, n_items)
    test = as_split(pos_u, pos_i, n_users, n_items)
    # the IV full-sort corpus: old users, old items
    keep_h = (np.asarray(hist_u) < N_OLD_USERS) & (np.asarray(hist_i) < N_OLD_ITEMS)
    keep_p = (np.asarray(pos_u) < N_OLD_USERS) & (np.asarray(pos_i) < N_OLD_ITEMS)
    iv_train = as_split(np.asarray(hist_u)[keep_h], np.asarray(hist_i)[keep_h],
                        N_OLD_USERS, N_OLD_ITEMS)
    iv_test = as_split(np.asarray(pos_u)[keep_p], np.asarray(pos_i)[keep_p],
                       N_OLD_USERS, N_OLD_ITEMS)
    return (train, test), (iv_train, iv_test)


def loader(splits, cfg):
    train, test = splits
    sampler = Sampler(["train", "test"], [train, test], seed=SEED)
    return FullSortEvalBatcher(test, sampler, cfg, phase="test")


def agree(a, b, what, tol=1e-9):
    require(list(a) == list(b), f"{what}: keys differ")
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            agree(x, y, f"{what}[{key}]", tol)
        else:
            require(abs(x - y) < tol, f"{what}[{key}]: {x} vs {y}")


def serving_cfg(fused, n_items):
    return Config({
        "topk": TOPK, "seed": SEED, "eval_batch_size": B * n_items,
        "use_perturbed_hits": False, "use_fused_topk": "auto" if fused else False,
    })


def serving():
    model = build_model()
    mapper = RandomOOVMapper(
        model.spec, N_OLD_USERS, N_OLD_ITEMS,
        N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS,
    )
    mapper.set_eval()
    t0 = time.perf_counter()
    ind_splits, iv_splits = synth_interactions(model, mapper)
    log(f"serving data: {len(ind_splits[1])} test positives, "
        f"{len(ind_splits[0])} history rows, {time.perf_counter() - t0:.1f} s")

    cfg = serving_cfg
    launches = seven_slices_fused_vs_dense(model, mapper, ind_splits, cfg)

    iv = {}
    for fused in (True, False):
        c = cfg(fused, N_OLD_ITEMS)
        iv_loader = loader(iv_splits, c)
        runner = EvalRunner(model, c)
        topk_score.fused_topk_scores.launches = 0
        t0 = time.perf_counter()
        iv[fused] = runner.evaluate(iv_loader)
        sync()
        wall = time.perf_counter() - t0
        n_launch = topk_score.fused_topk_scores.launches
        require(runner._use_fused(iv_loader.item_num) is fused, "runner fused path")
        require(n_launch == (len(iv_loader) if fused else 0), f"runner launches {n_launch}")
        log(f"full-sort eval {'fused' if fused else 'dense'}: {len(iv_loader)} batches, "
            f"{wall / len(iv_loader) * 1e3:.1f} ms per batch, kernel launches {n_launch}")
    log(f"[full-sort] {dict(iv[True])}")
    agree(iv[True], iv[False], "full-sort fused vs dense")
    log("full-sort eval: fused == dense (1e-9)")
    # after the counted runs: where the time of the default (perturbed)
    # fused inductive eval goes on the device
    c = cfg(True, N_OLD_ITEMS + N_NEW_ITEMS)
    c["use_perturbed_hits"] = True
    breakdown(InductiveEvaluator(model, c, N_OLD_USERS, N_OLD_ITEMS, mapper=mapper),
              loader(ind_splits, c))
    return launches


def seven_slices_fused_vs_dense(model, mapper, ind_splits, cfg, what="inductive eval"):
    """The 7-slice inductive eval on the fused path and on the dense path:
    equal to 1e-9, the fused one launching the top-k kernel 4 times a
    batch. → the fused run's launch count."""
    results, counts = {}, {}
    for fused in (True, False):
        c = cfg(fused, N_OLD_ITEMS + N_NEW_ITEMS)
        test_loader = loader(ind_splits, c)
        require(test_loader.users_per_batch == B, "users_per_batch")
        ev = InductiveEvaluator(model, c, N_OLD_USERS, N_OLD_ITEMS, mapper=mapper)
        topk_score.fused_topk_scores.launches = 0
        sync()
        t0 = time.perf_counter()
        results[fused] = ev.evaluate_model(test_loader)
        sync()
        wall = time.perf_counter() - t0
        counts[fused] = topk_score.fused_topk_scores.launches
        require(ev._fused is fused, f"{what} fused path active: {ev._fused}")
        log(f"{what} {'fused' if fused else 'dense'}: {len(test_loader)} "
            f"user batches of {B}, {wall / len(test_loader) * 1e3:.1f} ms per batch "
            f"(wall, host included), kernel launches {counts[fused]}")
    launches = counts[True]
    require(launches == 4 * len(test_loader), f"{what}: fused launches {launches}")
    require(counts[False] == 0, f"{what}: the dense path launched the kernel")
    for s, r in results[True].items():
        log(f"[{s}] {dict(r)}")
    agree(results[True], results[False], f"{what} fused vs dense")
    require(results[True]["overall"]["hit@20"] > 0, f"{what}: overall hit@20 is 0")
    log(f"{what}: fused == dense on all 7 slices (1e-9)")
    return launches


def breakdown(evaluator, test_loader, what="fused inductive eval (perturbed hits on)",
              shares=(("top-k kernel", ("topk_range_kernel",)),)):
    """torch.profiler over one warm inductive eval pass: device time by
    kernel, a batch's wall and device time and the device's busy share of
    the wall time."""
    evaluator.evaluate_model(test_loader)  # warm: allocator, library load
    sync()
    n = len(test_loader)
    wall_ms, busy_ms = profiled(lambda: evaluator.evaluate_model(test_loader),
                                f"profile {what}: {n} batches", shares)
    log(f"  a batch: wall {wall_ms / n:.2f} ms under the profiler, device {busy_ms / n:.3f} ms")


def profiled(run, what, shares=()):
    """torch.profiler around `run()`: the wall, the device's busy share of
    it, the largest device kernels and, for each (label, name prefixes) of
    `shares`, those kernels' share of the device time, launches and device
    ms a launch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched
    rows = sorted(
        ((device_us(e), e.key, e.count) for e in prof.key_averages()
         if e.device_type != torch.autograd.DeviceType.CPU and device_us(e) > 0),
        reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"{what}, wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for label, prefixes in shares:
        mine = [(us, n) for us, key, n in rows if any(p in key for p in prefixes)]
        ms = sum(us for us, _ in mine) / 1e3
        n = sum(c for _, c in mine)
        log(f"  {label}: {ms:.3f} ms ({100 * ms / max(busy_ms, 1e-9):.1f} % of device time), "
            f"{n} launches, {ms / max(n, 1):.4f} ms a launch")
    for us, key, count in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return wall_ms, busy_ms


# ------------------------------------------------------------ CIN kernel

# name, B, H, F, D, L, n_hidden, pool_all; n_hidden None is `cin_layer`
CIN_CASES = [
    ("layer0", CTR_B, 7, 7, CTR_D, 100, 50, False),
    ("layer1", CTR_B, 50, 7, CTR_D, 100, 50, False),
    ("layer2", CTR_B, 50, 7, CTR_D, 100, 0, True),
    ("direct", 1000, 7, 7, CTR_D, 100, 100, True),
    ("cin_layer", CTR_B, 50, 7, CTR_D, 100, None, False),
    ("depth16", 4096, 50, 7, 16, 100, 50, False),
    ("F39", 512, 50, 39, CTR_D, 100, 50, False),  # W 1950x100: 780 KB
    ("F39-cin_layer", 256, 39, 39, CTR_D, 100, None, False),
    ("ragged37", 37, 50, 7, CTR_D, 100, 50, False),
    ("ragged1000", 1000, 50, 7, CTR_D, 100, 0, True),
    ("odd-D7-L33", 300, 7, 7, 7, 33, 16, False),
    ("odd-D7-L33-last", 301, 16, 7, 7, 33, 0, True),
    ("odd-cin_layer", 37, 7, 7, 7, 33, None, False),
    # the edges of the geometry (ops/cin_fused.py:fwd_geometry, fwd_plan,
    # bwd_plan): 128 columns in one pass, 200 in two (two column groups in
    # the backward), one and 128 rows (b, d) a batch row, a pair axis of
    # 700; D = 200 in two spans, and A's rows at H = 350, D = 128 beyond
    # shared memory (two spans of 64)
    ("L128", 1000, 50, 7, CTR_D, 128, 64, False),
    ("L200", 700, 50, 7, CTR_D, 200, 100, False),
    ("L200-cin_layer", 300, 50, 7, CTR_D, 200, None, False),
    ("D1", 300, 50, 7, 1, 100, 50, False),
    ("D128", 20, 50, 7, 128, 100, 50, False),
    ("direct-H100", 1000, 100, 7, CTR_D, 100, 100, True),
    ("D200", 20, 50, 7, 200, 100, 50, False),
    ("D200-L200-direct", 9, 16, 7, 200, 200, 200, True),
    ("H350-D128", 8, 350, 7, 128, 100, 50, False),
]


def cin_inputs(b, h, f, d, l, seed, exact):
    """(a, b0, w, bias) on the card. `exact`: A, B0 in {-1, 0, 1}, W in
    {-2..2}, integer bias, so every product and sum is an exact integer in
    f32 (and in bf16 operands) and kernel and plain must agree bit for
    bit. Otherwise normal values scaled to outputs of order 1."""
    rng = np.random.default_rng(seed)
    if exact:
        arrays = (rng.integers(-1, 2, (b, h, d)), rng.integers(-1, 2, (b, f, d)),
                  rng.integers(-2, 3, (h * f, l)), rng.integers(-3, 4, l))
    else:
        arrays = (rng.standard_normal((b, h, d)), rng.standard_normal((b, f, d)),
                  rng.standard_normal((h * f, l)) / math.sqrt(h * f),
                  rng.standard_normal(l) * 0.1)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(DEVICE) for x in arrays)


def cin_pair(inputs, nh, pool_all, mxu):
    """(kernel outputs, plain outputs) as flat tensor lists."""
    if nh is None:
        got = [cin_layer(*inputs, mxu_dtype=mxu)]
        sync()
        return got, [cin_layer_plain(*inputs, mxu_dtype=mxu)]
    got = cin_layer_pooled(*inputs, mxu_dtype=mxu, n_hidden=nh, pool_all=pool_all)
    sync()
    want = cin_layer_pooled_plain(*inputs, mxu_dtype=mxu, n_hidden=nh, pool_all=pool_all)
    return ([t for t in got if t is not None], [t for t in want if t is not None])


def cin_cases():
    """The CIN kernel against its plain version on the card: bit for bit on
    exact inputs, to CIN_TOL on random ones, in both precision modes, and
    against itself on a repeat run."""
    for i, (name, b, h, f, d, l, nh, pool_all) in enumerate(CIN_CASES):
        errs = {}
        for mxu in ("float32", "bfloat16"):
            got, want = cin_pair(cin_inputs(b, h, f, d, l, SEED + 300 + i, True),
                                 nh, pool_all, mxu)
            require(len(got) == len(want) and all(
                g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)),
                f"cin {name} {mxu}: kernel differs from the plain version on exact inputs")
            inputs = cin_inputs(b, h, f, d, l, SEED + 400 + i, False)
            got, want = cin_pair(inputs, nh, pool_all, mxu)
            errs[mxu] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            require(errs[mxu] <= CIN_TOL, f"cin {name} {mxu}: max |kernel - plain| {errs[mxu]}")
            again, _ = cin_pair(inputs, nh, pool_all, mxu)
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"cin {name} {mxu}: a repeat run gave other bits")
        spans = fwd_plan(b, h, f, d, l)
        geo = fwd_geometry(b, h, f, spans[0][1], l)
        log(f"cin check {name}: B={b} H={h} F={f} D={d} L={l} n_hidden={nh} "
            f"pool_all={pool_all} ({len(spans)} D span(s), {geo.tb} batch rows a block, "
            f"{geo.passes} pass(es) of {geo.cols} columns): exact (f32, bf16); random "
            f"max_abs_err f32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; a repeat "
            "run gives the same bits")


def cin_library(a, b0, w, bias, nh=None, ps=0):
    """Yardstick only (the port never calls it): the slab path as
    torch.einsum + torch.matmul + relu (+ split and sum)."""
    bsz, h, d = a.shape
    z = torch.einsum("bhd,bfd->bhfd", a, b0).reshape(bsz, -1, d)
    o = torch.relu(torch.matmul(w.T, z) + bias[:, None])
    return o if nh is None else (o[:, :nh], o[:, ps:].sum(dim=2))


def cin_bound(layers):
    """(bound ms, bound_by) of the CIN layers (b, h, f, d, l, nh, lp): f32
    FMAs over the card's f32 rate against each input read and each output
    written once."""
    flops = sum(2 * b * d * h * f * l for b, h, f, d, l, nh, lp in layers)
    nbytes = sum(4 * (b * h * d + b * f * d + h * f * l + l + b * nh * d + b * lp)
                 for b, h, f, d, l, nh, lp in layers)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations"), t_ops, t_bytes


def cin_timing():
    """Per layer and per 3-layer forward at the serving shapes (B = 8192,
    D = 10), f32: kernel, plain and library ms beside the bound, with the
    kernel's largest difference from the plain version (tolerance CIN_TOL)."""
    f = 7
    modes = []  # (h, l, nh, pool_all) of the three layers
    h = f
    for i, size in enumerate(CIN_SIZES):
        last = i == len(CIN_SIZES) - 1
        modes.append((h, size, 0 if last else size // 2, last))
        h = size // 2
    sets = []
    for r in range(2):
        b0 = cin_inputs(CTR_B, f, f, CTR_D, 1, SEED + 500 + r, False)[1]
        layers = [cin_inputs(CTR_B, hh, f, CTR_D, ll, SEED + 510 + 10 * r + j, False)
                  for j, (hh, ll, _, _) in enumerate(modes)]
        sets.append((b0, layers))

    def forward(pooled_fn, b0, layers):
        hidden, parts = b0, []
        for (_, _, nh, pool_all), (_, _, w, bias) in zip(modes, layers):
            hidden, p = pooled_fn(hidden, b0, w, bias, n_hidden=nh, pool_all=pool_all)
            parts.append(p)
        return parts

    def library_pooled(a, b0, w, bias, n_hidden, pool_all):
        return cin_library(a, b0, w, bias, n_hidden, 0 if pool_all else n_hidden)

    out = {}
    err = 0.0
    for j, (hh, ll, nh, pool_all) in enumerate(modes):
        inputs = [(layers[j][0], b0, layers[j][2], layers[j][3]) for b0, layers in sets]
        got, want = cin_pair(inputs[0], nh, pool_all, "float32")
        err = max([err] + [float((g - w).abs().max()) for g, w in zip(got, want)])
        kw = dict(n_hidden=nh, pool_all=pool_all)
        ms = time_ms(lambda *x: cin_layer_pooled(*x, **kw), inputs, 30)
        b2b_ms = back_to_back_ms(lambda *x: cin_layer_pooled(*x, **kw), inputs)
        plain_ms = time_ms(lambda *x: cin_layer_pooled_plain(*x, **kw), inputs, 10)
        lib_ms = time_ms(lambda *x: library_pooled(*x, **kw), inputs, 30)
        bound, by, t_ops, t_bytes = cin_bound(
            [(CTR_B, hh, f, CTR_D, ll, nh, ll - (0 if pool_all else nh))])
        log(f"cin timing layer {j}: B={CTR_B} H={hh} F={f} D={CTR_D} L={ll} "
            f"n_hidden={nh}: kernel_ms={ms:.4f} (back to back {b2b_ms:.4f}) "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by}; "
            f"ops {t_ops:.4f}, bytes {t_bytes:.4f})")
    require(err <= CIN_TOL, f"cin serving layers: max |kernel - plain| {err}")

    fwd = [(b0, layers) for b0, layers in sets]
    layer_shapes = [(CTR_B, hh, f, CTR_D, ll, nh, ll - (0 if pa else nh))
                    for hh, ll, nh, pa in modes]
    bound, by, t_ops, t_bytes = cin_bound(layer_shapes)
    out["cin_layer_pooled"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda *x: forward(cin_layer_pooled, *x), fwd, 30),
        "plain_ms": time_ms(lambda *x: forward(cin_layer_pooled_plain, *x), fwd, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(lambda *x: forward(library_pooled, *x), fwd, 30),
        "ms_back_to_back": back_to_back_ms(lambda *x: forward(cin_layer_pooled, *x), fwd),
    }
    out["cin_layer_pooled"]["ms_per_launch"] = out["cin_layer_pooled"]["ms"] / len(modes)
    log("cin timing 3-layer forward (3 launches): " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer_pooled"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")

    # kernel 2 (`cin_layer`) at the widest serving layer
    hh, ll = modes[1][0], modes[1][1]
    inputs = [(layers[1][0], b0, layers[1][2], layers[1][3]) for b0, layers in sets]
    got, want = cin_pair(inputs[0], None, False, "float32")
    e2 = float((got[0] - want[0]).abs().max())
    require(e2 <= CIN_TOL, f"cin_layer: max |kernel - plain| {e2}")
    bound, by, t_ops, t_bytes = cin_bound([(CTR_B, hh, f, CTR_D, ll, ll, 0)])
    out["cin_layer"] = {
        "max_abs_err": e2,
        "ms": time_ms(cin_layer, inputs, 30),
        "plain_ms": time_ms(cin_layer_plain, inputs, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(cin_library, inputs, 30),
        "ms_back_to_back": back_to_back_ms(cin_layer, inputs),
    }
    out["cin_layer"]["ms_per_launch"] = out["cin_layer"]["ms"]
    log(f"cin_layer timing B={CTR_B} H={hh} F={f} D={CTR_D} L={ll}: " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")
    return out


# --------------------------------------------------- CIN backward kernel


def cin_pre_f64(a, b0, w, bias, mxu):
    """The pre-activation (B, L, D) in f64 from the operands as the kernel
    rounds them: where a gradient may be masked."""
    bsz, h, d = a.shape
    a, b0, w = a.double(), b0.double(), w.double()
    if mxu == "bfloat16":
        r = lambda x: x.float().to(torch.bfloat16).double()  # noqa: E731
        a, b0, w = r(a), r(b0), r(w)
        z = r(a[:, :, None, :] * b0[:, None, :, :])
    else:
        z = a[:, :, None, :] * b0[:, None, :, :]
    z = z.reshape(bsz, -1, d)
    return torch.einsum("bkd,kl->bld", z, w) + bias.double()[None, :, None]


def cin_grads(inputs, nh, ps, seed, exact, mxu):
    """(gh, gp) for one layer: gh (B, nh, D) or None, gp (B, L - ps) or None.
    `exact`: integers in -3..3, so every sum of the backward is exact.
    Otherwise normal values, zeroed where |pre| < CIN_MASK_BAND."""
    a, _, w, _ = inputs
    b, _, d = a.shape
    l = w.shape[1]
    rng = np.random.default_rng(seed)
    if exact:
        gh, gp = rng.integers(-3, 4, (b, nh, d)), rng.integers(-3, 4, (b, l - ps))
    else:
        gh, gp = rng.standard_normal((b, nh, d)), rng.standard_normal((b, l - ps))
        near = (cin_pre_f64(*inputs, mxu).abs() < CIN_MASK_BAND).cpu().numpy()
        gh[near[:, :nh]] = 0
        gp[near[:, ps:].any(axis=2)] = 0
    dev = lambda x: torch.from_numpy(x.astype(np.float32)).to(DEVICE)  # noqa: E731
    return (dev(gh) if nh else None), (dev(gp) if l > ps else None)


def cin_bwd_err(got, want):
    """Largest |kernel - plain| of the four gradients, each relative to
    max(1, the plain gradient's largest magnitude)."""
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def cin_bwd_pair(inputs, grads, nh, pool_all, mxu):
    """(kernel gradients, plain gradients) of one layer; nh None is
    `cin_layer`, whose gradient is gh alone."""
    gh, gp = grads
    if nh is None:
        got = cin_layer_bwd(*inputs, gh, mxu_dtype=mxu)
        sync()
        return got, cin_layer_bwd_plain(*inputs, gh, mxu_dtype=mxu)
    kw = dict(mxu_dtype=mxu, n_hidden=nh, pool_all=pool_all)
    got = cin_layer_pooled_bwd(*inputs, gh, gp, **kw)
    sync()
    return got, cin_layer_pooled_bwd_plain(*inputs, gh, gp, **kw)


def cin_bwd_cases():
    """The CIN backward kernel against its plain version on the card: bit
    for bit on integer inputs and gradients, to CIN_TOL on random ones, in
    both precision modes, at every case of the forward."""
    for i, (name, b, h, f, d, l, nh, pool_all) in enumerate(CIN_CASES):
        ps = l if nh is None else (0 if pool_all else nh)
        n_hidden = l if nh is None else nh
        errs = {}
        for mxu in ("float32", "bfloat16"):
            inputs = cin_inputs(b, h, f, d, l, SEED + 300 + i, True)
            grads = cin_grads(inputs, n_hidden, ps, SEED + 600 + i, True, mxu)
            got, want = cin_bwd_pair(inputs, grads, nh, pool_all, mxu)
            require(all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)),
                    f"cin bwd {name} {mxu}: kernel differs from the plain version on exact inputs")
            inputs = cin_inputs(b, h, f, d, l, SEED + 400 + i, False)
            grads = cin_grads(inputs, n_hidden, ps, SEED + 700 + i, False, mxu)
            got, want = cin_bwd_pair(inputs, grads, nh, pool_all, mxu)
            errs[mxu] = cin_bwd_err(got, want)
            require(errs[mxu] <= CIN_TOL, f"cin bwd {name} {mxu}: relative error {errs[mxu]}")
            again, _ = cin_bwd_pair(inputs, grads, nh, pool_all, mxu)
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"cin bwd {name} {mxu}: a repeat run gave other bits")
        cols, spans = bwd_plan(b, h, f, d, l)
        log(f"cin bwd check {name}: B={b} H={h} F={f} D={d} L={l} n_hidden={nh} "
            f"pool_all={pool_all} ({len(cols)} column group(s) x {len(spans)} D span(s)): "
            f"exact (f32, bf16); random error "
            f"f32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; a repeat run "
            "gives the same bits")


def cin_bwd_bound(layers):
    """(bound ms, bound_by, ops ms, bytes ms) of CIN backward layers (b, h,
    f, d, l, nh, lp): three f32 products (pre, dW, dz) against each input
    (a, b0, w, bias, gh, gp) read and each output (da, db0, dw, dbias)
    written once."""
    flops = sum(3 * 2 * b * d * h * f * l for b, h, f, d, l, nh, lp in layers)
    nbytes = sum(4 * (2 * (b * h * d + b * f * d + h * f * l + l) + b * nh * d + b * lp)
                 for b, h, f, d, l, nh, lp in layers)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations"), t_ops, t_bytes


def autograd_yardstick(inputs, nh, ps, grads):
    """Yardstick only (the port never calls it): a closure that runs
    autograd's backward through the einsum + matmul slab path."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = cin_library(*leaves, nh, ps)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.numel()]

    def run():
        return torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [g for _, g in pairs], retain_graph=True)

    return run


def cin_bwd_timing():
    """The backward per layer and for the 3-layer stack at the training
    shapes (B = 8192, D = 10), f32: kernel, plain and library ms beside the
    bound, with the kernel's largest relative error against the plain
    version (tolerance CIN_TOL)."""
    f = 7
    modes = []
    h = f
    for i, size in enumerate(CIN_SIZES):
        last = i == len(CIN_SIZES) - 1
        nh, pool_all = (0, True) if last else (size // 2, False)
        modes.append((h, size, nh, pool_all))
        h = size // 2
    sets = []  # per input set: per layer (inputs, grads)
    for r in range(2):
        b0 = cin_inputs(CTR_B, f, f, CTR_D, 1, SEED + 800 + r, False)[1]
        layers = []
        for j, (hh, ll, nh, pool_all) in enumerate(modes):
            a, _, w, bias = cin_inputs(CTR_B, hh, f, CTR_D, ll, SEED + 810 + 10 * r + j, False)
            inputs = (a, b0, w, bias)
            ps = 0 if pool_all else nh
            layers.append((inputs, cin_grads(inputs, nh, ps, SEED + 900 + 10 * r + j,
                                             False, "float32")))
        sets.append(layers)

    out = {}
    err = 0.0
    shapes = []
    for j, (hh, ll, nh, pool_all) in enumerate(modes):
        ps = 0 if pool_all else nh
        kw = dict(n_hidden=nh, pool_all=pool_all)
        calls = [layers[j] for layers in sets]
        got, want = cin_bwd_pair(*calls[0], nh, pool_all, "float32")
        err = max(err, cin_bwd_err(got, want))
        ms = time_ms(lambda x, g: cin_layer_pooled_bwd(*x, *g, **kw), calls, 30)
        plain_ms = time_ms(lambda x, g: cin_layer_pooled_bwd_plain(*x, *g, **kw), calls, 10)
        yard = [(autograd_yardstick(x, nh, ps, (g[0], g[1])),) for x, g in calls]
        lib_ms = time_ms(lambda run: run(), yard, 30)
        shape = (CTR_B, hh, f, CTR_D, ll, nh, ll - ps)
        shapes.append(shape)
        bound, by, t_ops, t_bytes = cin_bwd_bound([shape])
        log(f"cin bwd timing layer {j}: B={CTR_B} H={hh} F={f} D={CTR_D} L={ll} "
            f"n_hidden={nh}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by}; ops {t_ops:.4f}, "
            f"bytes {t_bytes:.4f})")
        del yard
    require(err <= CIN_TOL, f"cin bwd training layers: relative error {err}")

    def stack(fn, *layers):
        return [fn(*x, *g, n_hidden=nh, pool_all=pa)
                for (x, g), (_, _, nh, pa) in zip(layers, modes)]

    def stack_library(*runs):
        return [run() for run in runs]

    yard = [tuple(autograd_yardstick(x, nh, 0 if pa else nh, g)
                  for (x, g), (_, _, nh, pa) in zip(layers, modes)) for layers in sets]
    bound, by, t_ops, t_bytes = cin_bwd_bound(shapes)
    out["cin_layer_pooled_bwd"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda *ls: stack(cin_layer_pooled_bwd, *ls), sets, 30),
        "plain_ms": time_ms(lambda *ls: stack(cin_layer_pooled_bwd_plain, *ls), sets, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(stack_library, yard, 30),
    }
    out["cin_layer_pooled_bwd"]["ms_per_launch"] = out["cin_layer_pooled_bwd"]["ms"] / len(modes)
    del yard
    log("cin bwd timing 3-layer backward (3 calls): " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer_pooled_bwd"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")

    # kernel 3 (`cin_layer_bwd`) at the widest layer: every row hidden
    hh, ll = modes[1][0], modes[1][1]
    calls = []
    for r, layers in enumerate(sets):
        inputs = layers[1][0]
        calls.append((inputs, cin_grads(inputs, ll, ll, SEED + 950 + r, False, "float32")))
    got, want = cin_bwd_pair(*calls[0], None, False, "float32")
    e3 = cin_bwd_err(got, want)
    require(e3 <= CIN_TOL, f"cin_layer_bwd: relative error {e3}")
    yard = [(autograd_yardstick(x, None, 0, g),) for x, g in calls]
    bound, by, t_ops, t_bytes = cin_bwd_bound([(CTR_B, hh, f, CTR_D, ll, ll, 0)])
    out["cin_layer_bwd"] = {
        "max_abs_err": e3,
        "ms": time_ms(lambda x, g: cin_layer_bwd(*x, g[0]), calls, 30),
        "plain_ms": time_ms(lambda x, g: cin_layer_bwd_plain(*x, g[0]), calls, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(lambda run: run(), yard, 30),
    }
    out["cin_layer_bwd"]["ms_per_launch"] = out["cin_layer_bwd"]["ms"]
    del yard
    log(f"cin_layer_bwd timing B={CTR_B} H={hh} F={f} D={CTR_D} L={ll}: " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer_bwd"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")
    return out


# ---------------------------------------------------------- ranking serving


def ctr_fields():
    return FieldSpec(
        token_names=("user_id", "item_id", "gender", "category", "hour"),
        token_dims=(N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, 3, 64, 25),
        float_names=("age", "price"),
        float_dims=(2, 2),
        user_token_idx=(0, 2),
        item_token_idx=(1, 3),
    )


def build_ranking_model(seed=SEED + 1, cin_sizes=CIN_SIZES):
    spec = InductiveSpec(
        mapper="random", add_oov_buckets=True,
        n_user_buckets=100, n_item_buckets=100, hash_function="3round",
    )
    return xDeepFM(
        ctr_fields(), embedding_size=CTR_D, spec=spec, mlp_hidden_size=MLP_SIZES,
        dropout_prob=0.2, direct=False, cin_layer_size=cin_sizes,
        device=DEVICE, generator=torch_generator(seed, DEVICE),
    )


@torch.no_grad()
def synth_ctr(model, mapper, cfg):
    """Seeded users (age, gender) and items (category, price), 10 % of
    each new, and CTR_B * CTR_BATCHES rows with an hour. Labels come from
    the model's own logits (standardised) plus unit normal noise, so AUC
    sits well away from 0.5 and every slice holds both labels."""
    rng = np.random.default_rng(SEED + 2)
    n_u = N_CTR_OLD_USERS + N_CTR_NEW_USERS
    n_i = N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS
    user_feat = {
        "user_id": np.arange(n_u), "gender": rng.integers(1, 3, n_u),
        "age": rng.random(n_u).astype(np.float32), "age__bucket": np.ones(n_u, np.int64),
    }
    item_feat = {
        "item_id": np.arange(n_i), "category": rng.integers(1, 64, n_i),
        "price": rng.random(n_i).astype(np.float32), "price__bucket": np.ones(n_i, np.int64),
    }
    n = CTR_B * CTR_BATCHES
    inter = {
        "user_id": rng.integers(1, n_u, n), "item_id": rng.integers(1, n_i, n),
        "hour": rng.integers(0, 25, n),
    }
    split = DatasetSplit(inter, n_u, n_i, user_feat=user_feat, item_feat=item_feat)
    model.eval()
    fused, model.fused_cin = model.fused_cin, False
    logits = []
    for batch in PlainEvalBatcher(split, cfg):
        batch = mapper.annotate(batch, "user_id", "item_id")
        logits.append(model(to_device_batch(batch, DEVICE)).float().cpu().numpy())
    model.fused_cin = fused
    logit = np.concatenate(logits)[:n]
    z = (logit - logit.mean()) / logit.std() + rng.standard_normal(n)
    inter["label"] = (z > 0).astype(np.float32)
    ind = DatasetSplit(inter, n_u, n_i, user_feat=user_feat, item_feat=item_feat)
    iv_rows = (inter["user_id"] < N_CTR_OLD_USERS) & (inter["item_id"] < N_CTR_OLD_ITEMS)
    iv = DatasetSplit({k: v[iv_rows] for k, v in inter.items()},
                      N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, user_feat=user_feat, item_feat=item_feat)
    return ind, iv


def ranking():
    """xDeepFM value eval and 7 value slices, CIN kernel vs plain slab path.
    Returns the launch counts of the fused 7-slice run, the labelled rows
    and the mapper."""
    model = build_ranking_model()
    mapper = RandomOOVMapper(
        model.spec, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS,
        N_CTR_OLD_USERS + N_CTR_NEW_USERS, N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS,
    )
    mapper.set_eval()
    cfg = Config({"metrics": ["AUC", "LogLoss"], "seed": SEED,
                  "eval_batch_size": CTR_B, "metric_decimal_place": 12})
    set_policy(cfg["compute_dtype"])  # the default, f32
    t0 = time.perf_counter()
    ind, iv = synth_ctr(model, mapper, cfg)
    labels = ind.inter["label"]
    log(f"ranking data: {len(ind)} rows ({len(iv)} IV), positives {labels.mean():.4f}, "
        f"{time.perf_counter() - t0:.1f} s")

    def counted(what, run, loader):
        cin_layer_pooled.launches = cin_layer.launches = 0
        sync()
        t0 = time.perf_counter()
        result = run(loader)
        sync()
        wall = time.perf_counter() - t0
        counts = {"cin_layer_pooled": cin_layer_pooled.launches,
                  "cin_layer": cin_layer.launches}
        log(f"{what}: {len(loader)} batches of {CTR_B}, "
            f"{wall / len(loader) * 1e3:.1f} ms per batch (wall, host included), "
            f"kernel launches {counts}")
        return result, counts

    runs = {}
    n_layers = len(CIN_SIZES)
    for fused in (True, False):
        model.fused_cin = cfg["fused_cin"] if fused else False  # default "auto"
        tag = "fused" if fused else "plain"
        iv_loader = PlainEvalBatcher(iv, cfg)
        res_iv, c_iv = counted(f"value eval {tag}", EvalRunner(model, cfg).evaluate, iv_loader)
        ind_loader = PlainEvalBatcher(ind, cfg)
        ev = InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper)
        res_ind, c_ind = counted(f"7-slice value eval {tag}", ev.evaluate_model, ind_loader)
        want = (n_layers if fused else 0)
        require(c_iv["cin_layer_pooled"] == want * len(iv_loader),
                f"value eval {tag}: CIN launches {c_iv}")
        require(c_ind["cin_layer_pooled"] == want * len(ind_loader),
                f"7-slice value eval {tag}: CIN launches {c_ind}")
        runs[fused] = (res_iv, res_ind, c_ind)
    log(f"[value eval] {dict(runs[True][0])}")
    for s, r in runs[True][1].items():
        log(f"[{s}] {dict(r)}")
    agree(runs[True][0], runs[False][0], "value eval fused vs plain", tol=1e-6)
    agree(runs[True][1], runs[False][1], "7-slice value eval fused vs plain", tol=1e-6)
    for s, r in runs[True][1].items():
        require(list(r) == ["auc", "logloss"] and all(math.isfinite(v) for v in r.values()),
                f"slice {s}: {dict(r)}")
    require(runs[True][0]["auc"] > 0.6, f"value eval AUC {runs[True][0]['auc']}")
    log("ranking eval: fused == plain on AUC, LogLoss and all 7 slices (1e-6)")

    model.fused_cin = cfg["fused_cin"]
    breakdown(InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper),
              PlainEvalBatcher(ind, cfg), what="fused 7-slice value eval (xDeepFM)",
              shares=(("CIN forward kernel", ("cin_fused_kernel",)),))
    return runs[True][2], ind, mapper


# --------------------------------------------------------- ranking training


def ctr_train_cfg(**over):
    d = {
        "metrics": ["AUC", "LogLoss"], "valid_metric": "AUC", "seed": SEED,
        "eval_batch_size": CTR_B, "metric_decimal_place": 12,
        "train_batch_size": CTR_B, "learner": "adam", "learning_rate": 1e-3,
        "epochs": 1, "train_neg_sample_args": {"distribution": "none"},
        "train_oov": True, "oov_only_epoch": True, "oov_train_ratio": 0.2,
        "oov_feature_mask_rate": 0.2, "oov_freeze_embedding": True,
    }
    d.update(over)
    return Config(d)


def rows_of(split, keep, n_users, n_items):
    return DatasetSplit({k: v[keep] for k, v in split.inter.items()}, n_users, n_items,
                        user_feat=split.user_feat, item_feat=split.item_feat)


def ranking_training(ind, mapper):
    """xDeepFM through `Trainer.fit` on the card: one epoch over the IV rows
    of the first CTR_TRAIN_FRACTION of the rows plus the frozen OOV-only
    sub-epoch, from a seed other than the labels' model. → the CIN launch
    counts of the fit."""
    n = len(ind)
    cut = int(CTR_TRAIN_FRACTION * n)
    row = np.arange(n)
    old = ((ind.inter["user_id"] < N_CTR_OLD_USERS)
           & (ind.inter["item_id"] < N_CTR_OLD_ITEMS))
    n_u, n_i = N_CTR_OLD_USERS + N_CTR_NEW_USERS, N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS
    train = rows_of(ind, (row < cut) & old, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS)
    held = rows_of(ind, row >= cut, n_u, n_i)
    held_iv = rows_of(ind, (row >= cut) & old, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS)
    cfg = ctr_train_cfg()
    model = build_ranking_model(SEED + 7)
    auc0 = EvalRunner(model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))["auc"]

    trainer = Trainer(cfg, model)
    loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
    require(loader.mode == "plain" and len(loader) > 1, f"train loader {loader.mode}")
    iv_names = [n for n in trainer.params if n not in trainer.oov_params]
    require(len(trainer.oov_params) == 4, f"OOV parameters {sorted(trainer.oov_params)}")
    inner, seen = trainer._train_epoch, {}

    def watched(loader, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        steps = trainer._global_step
        total = inner(loader, epoch_idx, oov_transform, keep_ratio, frozen)
        seen["frozen" if frozen else "normal"] = {
            "losses": trainer.last_losses, "steps": trainer._global_step - steps,
            "moved": {n for n in trainer.params if not torch.equal(before[n], trainer.params[n])},
        }
        return total

    trainer._train_epoch = watched
    cin_layer_pooled.launches = cin_layer_pooled_bwd.launches = 0
    cin_layer.launches = cin_layer_bwd.launches = 0
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    counts = {"cin_layer_pooled": cin_layer_pooled.launches,
              "cin_layer_pooled_bwd": cin_layer_pooled_bwd.launches,
              "cin_layer": cin_layer.launches, "cin_layer_bwd": cin_layer_bwd.launches}
    steps = trainer._global_step
    normal, frozen = seen["normal"], seen["frozen"]
    n_layers = len(CIN_SIZES)
    log(f"ranking training: {len(train)} rows, {normal['steps']} steps + {frozen['steps']} "
        f"frozen OOV steps of {CTR_B} rows, {wall / steps * 1e3:.2f} ms per step (wall, host included), "
        f"kernel launches {counts}")
    require(counts["cin_layer_pooled"] == n_layers * steps
            and counts["cin_layer_pooled_bwd"] == n_layers * steps,
            f"CIN launches {counts} over {steps} steps")
    require(normal["steps"] == len(loader) and frozen["steps"] > 0, "training steps")
    require(not frozen["moved"] & set(iv_names),
            f"the frozen sub-epoch moved IV tables {sorted(frozen['moved'] & set(iv_names))}")
    require(frozen["moved"] == trainer.oov_params,
            f"the frozen sub-epoch moved {sorted(frozen['moved'])}")
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(frozen["losses"]).all(), "loss not finite")
    require(last < first, f"loss did not fall: first tenth {first}, last tenth {last}")
    auc1 = trainer.evaluate(PlainEvalBatcher(held_iv, cfg), load_best_model=False)["auc"]
    log(f"ranking training: loss first tenth {first:.5f} last tenth {last:.5f}, "
        f"frozen OOV loss {float(frozen['losses'].mean()):.5f}; held-out IV AUC "
        f"{auc0:.5f} before, {auc1:.5f} after; IV tables bitwise unchanged by the "
        f"frozen sub-epoch, bucket tables moved")
    require(auc1 > auc0, f"held-out AUC {auc0} before, {auc1} after")
    ev = InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper)
    slices = ev.evaluate_model(PlainEvalBatcher(held, cfg))
    for s, r in slices.items():
        log(f"[trained {s}] {dict(r)}")
        require(list(r) == ["auc", "logloss"] and all(math.isfinite(v) for v in r.values()),
                f"trained slice {s}: {dict(r)}")

    # where a training step's time goes, after the counted run
    profile_loader = TrainBatcher(rows_of(train, np.arange(len(train)) < 8 * CTR_B,
                                          N_CTR_OLD_USERS, N_CTR_OLD_ITEMS),
                                  None, cfg, InputType.POINTWISE)
    inner(profile_loader, 1)
    sync()
    wall_ms, _ = profiled(
        lambda: inner(profile_loader, 2),
        f"profile {len(profile_loader)} fused xDeepFM training steps",
        shares=(("CIN forward kernel", ("cin_fused_kernel",)),
                ("CIN backward kernels", ("cin_bwd_",)),
                ("  launch 1, rows (pre, dpre, dz, dA, dB0)", ("cin_bwd_rows_kernel",)),
                ("  launch 2, dW / dbias partials", ("cin_bwd_dw_kernel",)),
                ("  launch 3, partial sums", ("cin_bwd_reduce_kernel",))))
    log(f"ranking training profile: {wall_ms / len(profile_loader):.2f} ms per step "
        "under the profiler")
    kernel_vs_plain_training(train)
    wide_cin_training(train)
    return counts


def wide_cin_training(train):
    """xDeepFM at cin_layer_size WIDE_CIN_SIZES through `fused_cin: auto`:
    WIDE_STEPS training steps on the CIN kernels against the same steps on
    the slab path (`kernel_vs_plain_training`), each backward in two column
    groups (ops/cin_fused.py:bwd_plan); the backward kernel against its
    plain version at each trained layer's shape on one batch; then one
    batch served through the forward kernel (two column passes), equal to
    the slab path to CIN_TOL."""
    model, counts, wall, wall_plain, part, cfg = kernel_vs_plain_training(
        train, WIDE_STEPS, WIDE_CIN_SIZES, SEED + 9)
    shapes = model.cin_layer_shapes(CTR_B)
    launches_bwd = sum(len(c) * len(s) for c, s in (bwd_plan(*x) for x in shapes))
    launches_fwd = sum(len(fwd_plan(*x)) for x in shapes)
    log(f"wide CIN training (cin_layer_size {WIDE_CIN_SIZES}, fused_cin auto): {WIDE_STEPS} "
        f"steps of {CTR_B} rows, {wall / WIDE_STEPS * 1e3:.2f} ms per step (wall, host "
        f"included; the slab path {wall_plain / WIDE_STEPS * 1e3:.2f}), kernel launches {counts}")
    require(counts["cin_layer_pooled"] == WIDE_STEPS * launches_fwd
            and counts["cin_layer_pooled_bwd"] == WIDE_STEPS * launches_bwd,
            f"wide CIN training launches {counts}, want {launches_fwd} forward and "
            f"{launches_bwd} backward a step")

    db = to_device_batch(next(iter(PlainEvalBatcher(part, cfg))), DEVICE)
    model.eval()
    with torch.no_grad():
        b0 = model.concat_embed_input_fields(db).float().contiguous()
        hidden, err = b0, 0.0
        for i, (conv, (nh, pool_all)) in enumerate(zip(model.conv1d_list, model._layer_modes())):
            inputs = (hidden, b0, conv.kernel.detach(), conv.bias.detach())
            grads = cin_grads(inputs, nh, 0 if pool_all else nh, SEED + 990 + i, False,
                              "float32")
            err = max(err, cin_bwd_err(*cin_bwd_pair(inputs, grads, nh, pool_all, "float32")))
            hidden, _ = cin_layer_pooled(*inputs, n_hidden=nh, pool_all=pool_all)
        log(f"wide CIN backward kernel vs plain at the trained layers' shapes {shapes}: "
            f"relative error {err:.3e}")
        require(err <= CIN_TOL, f"wide CIN backward: relative error {err}")
        cin_layer_pooled.launches = 0
        got = model.predict(db)
        launches = cin_layer_pooled.launches
        model.fused_cin = False
        want = model.predict(db)
        model.fused_cin = "auto"
    err = float((got - want).abs().max())
    log(f"wide CIN serving through auto: {launches} forward kernel launches for one batch of "
        f"{CTR_B}; max |kernel - slab| {err:.3e} on the predicted probabilities")
    require(launches == launches_fwd, f"wide CIN serving launches {launches}")
    require(err <= CIN_TOL, f"wide CIN serving: max |kernel - slab| {err}")


def kernel_vs_plain_training(train, steps=None, cin_sizes=CIN_SIZES, seed=SEED + 7):
    """`steps` (default COMPARE_STEPS) training steps of xDeepFM at
    `cin_sizes` on the CIN kernel path and on the plain slab path from
    identical weights and dropout generators: per-step losses to LOSS_RTOL
    relative, parameters to PARAM_ATOL absolute. Returns the kernel path's
    model, CIN launch counts and wall seconds, the plain path's wall
    seconds, the rows and the config.

    Adam scales each element's step by that element's own gradient history,
    so an element whose gradient at some step is decided by more than
    summation rounding (a ReLU mask at a pre-activation within rounding of
    0, or a gradient that cancels to within rounding of 0) can move by a
    fraction of lr on one path and not the other. Such elements are held
    apart: each one beyond PARAM_ATOL is printed with both values and the
    step at which its gradient differed between the paths by more than
    EXPLAINED_GRAD_RTOL relative; any element beyond PARAM_ATOL without
    such a step, or more than MAX_EXPLAINED_FRACTION of all elements, fails
    the phase."""
    steps = steps or COMPARE_STEPS
    part = rows_of(train, np.arange(len(train)) < steps * CTR_B,
                   N_CTR_OLD_USERS, N_CTR_OLD_ITEMS)
    cfg = ctr_train_cfg(train_oov=False)
    runs = {}
    for fused in (True, False):
        model = build_ranking_model(seed, cin_sizes)
        require(model.fused_cin == "auto", f"fused_cin {model.fused_cin}")
        model.fused_cin = cfg["fused_cin"] if fused else False
        trainer = Trainer(cfg, model)
        grads, step = [], trainer.optimizer.step

        def recording(params, g, state, trainable=None, grads=grads, step=step):
            grads.append({n: t.detach().clone() for n, t in g.items()})
            return step(params, g, state, trainable)

        trainer.optimizer.step = recording
        cin_layer_pooled.launches = cin_layer_pooled_bwd.launches = 0
        cin_layer.launches = cin_layer_bwd.launches = 0
        sync()
        t0 = time.perf_counter()
        trainer._train_epoch(TrainBatcher(part, None, cfg, InputType.POINTWISE), 0)
        sync()
        wall = time.perf_counter() - t0
        counts = {"cin_layer_pooled": cin_layer_pooled.launches,
                  "cin_layer_pooled_bwd": cin_layer_pooled_bwd.launches,
                  "cin_layer": cin_layer.launches, "cin_layer_bwd": cin_layer_bwd.launches}
        require((counts["cin_layer_pooled_bwd"] > 0) is fused, f"CIN backward path {counts}")
        require(fused or not any(counts.values()), f"the slab path launched {counts}")
        runs[fused] = (trainer.last_losses,
                       {n: p.detach() for n, p in model.named_parameters()}, grads,
                       (model, counts, wall))
    (lk, pk, gk, fused_run), (lp, pp, gp, plain_run) = runs[True], runs[False]
    require(len(lk) == len(lp) == steps, f"steps {len(lk)}, {len(lp)}")
    what = ("kernel vs plain training" if cin_sizes == CIN_SIZES
            else f"kernel vs plain training (cin_layer_size {cin_sizes})")
    compare_trajectories(
        what, ("kernel", "plain"), lk, lp, pk, pp,
        lambda n, i: torch.stack([g[n].flatten()[i] for g in gk]),
        lambda n, i: torch.stack([g[n].flatten()[i] for g in gp]))
    return fused_run + (plain_run[2], part, cfg)


def compare_trajectories(what, names, la, lb, pa, pb, grad_a, grad_b):
    """Two COMPARE_STEPS training runs from identical weights: per-step
    losses `la`, `lb` to LOSS_RTOL relative, parameter dicts `pa`, `pb` to
    PARAM_ATOL absolute, each element beyond it explained by a step at which
    its gradient (`grad_a(name, flat index)`, `grad_b`: one value a step)
    differed between the runs by more than EXPLAINED_GRAD_RTOL, and at most
    MAX_EXPLAINED_FRACTION of all elements beyond it."""
    rel = np.abs(la - lb) / np.abs(lb)
    worst = max(((float((pa[n] - pb[n]).abs().max()), n) for n in pa))
    n_elements = sum(p.numel() for p in pa.values())
    beyond = []
    for n in pa:
        idx = torch.nonzero(((pa[n] - pb[n]).abs() > PARAM_ATOL).flatten()).flatten()
        for i in idx.tolist():
            a, b = grad_a(n, i), grad_b(n, i)
            grel = (a - b).abs() / torch.maximum(torch.maximum(a.abs(), b.abs()),
                                                  torch.tensor(1e-30, device=a.device))
            s = int(grel.argmax())
            beyond.append((n, i, float(pa[n].flatten()[i]), float(pb[n].flatten()[i]),
                           s, float(a[s]), float(b[s]), float(grel[s])))
    log(f"{what}, {len(la)} steps: loss max relative "
        f"difference {rel.max():.3e} (step {int(rel.argmax())}), parameters max "
        f"absolute difference {worst[0]:.3e} ({worst[1]}); {len(beyond)} of "
        f"{n_elements} elements beyond {PARAM_ATOL}")
    for n, i, va, vb, s, ga, gb, grel in beyond[:20]:
        log(f"  {n}[{i}]: {names[0]} {va:.6e}, {names[1]} {vb:.6e}; at step {s} its gradient "
            f"was {ga:.6e} ({names[0]}) vs {gb:.6e} ({names[1]}), relative difference "
            f"{grel:.3e}")
    require(rel.max() <= LOSS_RTOL, f"{what}: losses differ: step {int(rel.argmax())}, "
            f"{la[rel.argmax()]} vs {lb[rel.argmax()]}")
    unexplained = [b for b in beyond if b[-1] <= EXPLAINED_GRAD_RTOL]
    require(not unexplained, f"{what}: parameters differ beyond {PARAM_ATOL} where no "
            f"gradient of the element differed by more than rounding: {unexplained[:5]}")
    require(len(beyond) <= MAX_EXPLAINED_FRACTION * n_elements,
            f"{what}: {len(beyond)} elements beyond {PARAM_ATOL}")


# ------------------------------------------------------- retrieval training


def retrieval_training():
    """BPR through `Trainer.fit` at the serving scale, then the 7-slice eval
    on the trained weights, fused vs dense."""
    model = build_model()
    mapper = RandomOOVMapper(
        model.spec, N_OLD_USERS, N_OLD_ITEMS,
        N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS,
    )
    mapper.set_eval()
    rng = np.random.default_rng(SEED + 30)
    n_rows = BPR_TRAIN_STEPS * BPR_TRAIN_B
    train = DatasetSplit({"user_id": rng.integers(1, N_OLD_USERS, n_rows),
                          "item_id": rng.integers(1, N_OLD_ITEMS, n_rows)},
                         N_OLD_USERS, N_OLD_ITEMS)
    t0 = time.perf_counter()
    sampler = Sampler(["train"], [train], seed=SEED)
    cfg = Config({"seed": SEED, "topk": TOPK, "train_batch_size": BPR_TRAIN_B,
                  "learner": "adam", "learning_rate": 1e-3, "epochs": 1,
                  "train_oov": True, "oov_only_epoch": True, "oov_train_ratio": 0.2,
                  "oov_feature_mask_rate": 0.2, "device_epoch": False})
    trainer = Trainer(cfg, model)
    loader = TrainBatcher(train, sampler, cfg, InputType.PAIRWISE)
    require(loader.mode == "pairwise" and len(loader) == BPR_TRAIN_STEPS, "BPR loader")
    require(trainer._maybe_device_epoch(loader) is None, "the host path is not driven")
    log(f"retrieval training data: {n_rows} rows, {time.perf_counter() - t0:.1f} s")
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    steps = trainer._global_step
    moved = {n for n in before if not torch.equal(before[n], trainer.params[n])}
    loss, oov_loss = trainer.train_loss_dict[0], trainer.oov_loss_dict.get(0)
    log(f"retrieval training: {steps} steps ({len(loader)} + {steps - len(loader)} OOV) of "
        f"{BPR_TRAIN_B} rows, {wall / steps * 1e3:.2f} ms per step (wall, host included), "
        f"mean loss {loss / len(loader):.5f}, OOV sub-epoch mean loss "
        f"{(oov_loss or float('nan')) / max(1, steps - len(loader)):.5f}")
    require(steps > BPR_TRAIN_STEPS and math.isfinite(loss) and oov_loss is not None
            and math.isfinite(oov_loss), "retrieval training")
    require({"user_embedding.weight", "item_embedding.weight"} <= moved
            and moved & trainer.oov_params, f"parameters that moved: {sorted(moved)}")
    ind_splits, _ = synth_interactions(model, mapper)
    seven_slices_fused_vs_dense(model, mapper, ind_splits, serving_cfg,
                                what="trained BPR inductive eval")


# ------------------------------------------------------------- kernel 6


def sparse_rows_inputs(v, d, n, seed, dup_runs=False, zero_ids=0, edges=False,
                       ids_dtype=torch.int64):
    """Tables (p, mu, nu) of (v, d) with moments as a trained table holds
    them, and one step's coalesced (sorted ids, row gradients) of n rows on
    the card. `dup_runs`: half the ids from v // 50 rows (long runs);
    `zero_ids`: that many distinct ids get all-zero coalesced rows; `edges`:
    the first and last table rows."""
    rng = np.random.default_rng(seed)
    dev = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)  # noqa: E731
    tables = (dev(rng.standard_normal((v, d))), dev(rng.standard_normal((v, d)) * 0.01),
              dev(rng.random((v, d)) * 1e-3))
    return tables, sparse_rows_step(rng, v, d, n, dup_runs, zero_ids, edges, ids_dtype)


def sparse_rows_step(rng, v, d, n, dup_runs=False, zero_ids=0, edges=False,
                     ids_dtype=torch.int64):
    ids = rng.integers(0, v, n)
    if dup_runs:
        ids[: n // 2] = rng.integers(0, max(1, v // 50), n // 2)
    if edges:
        ids[0], ids[-1] = 0, v - 1
    rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(DEVICE)
    sid, g = coalesce_rows(torch.from_numpy(ids).to(DEVICE), rows)
    if zero_ids:
        zero = torch.from_numpy(rng.choice(np.unique(ids), zero_ids, replace=False)).to(DEVICE)
        g[torch.isin(sid, zero)] = 0.0
    return sid.to(ids_dtype), g


# name, V, D, n, options
SPARSE_ROWS_CASES = [
    ("random", SP_USERS, D, SP_B, {}),
    ("dup-runs", SP_ITEMS, D, 2 * SP_B, dict(dup_runs=True)),
    ("zero-rows", 1000, D, 700, dict(zero_ids=50)),
    ("edges", 5000, D, 333, dict(edges=True)),
    ("n1", 10, D, 1, {}),
    ("D10", 3000, 10, 999, dict(dup_runs=True, zero_ids=5, edges=True)),
    ("odd-D13", 777, 13, 500, dict(dup_runs=True, zero_ids=5, edges=True)),
    ("int32-ids", SP_USERS, D, SP_B, dict(ids_dtype=torch.int32, edges=True)),
    # CLI phase C's item table (90,001 rows) and a step's item rows
    # (2,048 positives + 2,048 negatives)
    ("cli-c-items", 90_001, D, 4096, dict(dup_runs=True)),
]


def sparse_rows_cases():
    """Kernel 6 against its plain version on the card, bit for bit, over two
    consecutive steps of each case; rows with an all-zero gradient and rows
    not in the step keep their bits."""
    for i, (name, v, d, n, opt) in enumerate(SPARSE_ROWS_CASES):
        tables, step = sparse_rows_inputs(v, d, n, SEED + 1000 + i, **opt)
        rng = np.random.default_rng(SEED + 1100 + i)
        k = [t.clone() for t in tables]
        p = [t.clone() for t in tables]
        for count in (7, 8):
            sid, g = step
            sparse_adam_rows_kernel(*k, sid, g, count, SP_LR)
            sync()
            sparse_adam_rows_plain(*p, sid, g, count, SP_LR)
            require(all(torch.equal(a, b) for a, b in zip(k, p)),
                    f"kernel 6 {name} step {count}: differs from the plain version")
            still = torch.ones(v, dtype=torch.bool, device=DEVICE)
            still[sid.long()[(g != 0).any(dim=1)]] = False
            require(all(torch.equal(a[still], t[still]) for a, t in zip(k, tables)),
                    f"kernel 6 {name}: an untouched row changed")
            tables = [t.clone() for t in k]
            step = sparse_rows_step(rng, v, d, n, **opt)
        log(f"kernel 6 check {name}: V={v} D={d} n={n} {opt}: exact over 2 steps")


def sparse_rows_timing():
    """Kernel 6 at the sparse training step's shapes (8,192 user ids into
    200,000 x 64, 16,384 item ids into 100,000 x 64; one step is two
    launches) beside its bound from the inputs' distinct rows, the plain
    version and, as a yardstick only, `torch.optim.SparseAdam.step` on the
    same rows as sparse COO gradients. SparseAdam puts eps inside the bias
    correction (eps·sqrt(bc2)), so it is not the same function and its
    output is not compared."""
    rng = np.random.default_rng(SEED + 1200)
    sides = {}
    for side, v, n in (("user", SP_USERS, SP_B), ("item", SP_ITEMS, 2 * SP_B)):
        tables, _ = sparse_rows_inputs(v, D, 1, SEED + 1210 + v)
        steps = [sparse_rows_step(rng, v, D, n) for _ in range(3)]
        sides[side] = (tables, steps)
    inputs = [tuple(steps[r] for _, steps in sides.values()) for r in range(3)]
    tabs = [tables for tables, _ in sides.values()]

    err = 0.0
    for (tables, _), (sid, g) in zip(sides.values(), inputs[0]):
        k = [t.clone() for t in tables]
        p = [t.clone() for t in tables]
        sparse_adam_rows_kernel(*k, sid, g, 10, SP_LR)
        sync()
        sparse_adam_rows_plain(*p, sid, g, 10, SP_LR)
        err = max([err] + [float((a - b).abs().max()) for a, b in zip(k, p)])
    require(err == 0.0, f"kernel 6 at the step's shapes: max |kernel - plain| {err}")

    def kernel(*steps):
        for t, (sid, g) in zip(tabs, steps):
            sparse_adam_rows_kernel(*t, sid, g, 10, SP_LR)

    def plain(*steps):
        for t, (sid, g) in zip(tabs, steps):
            sparse_adam_rows_plain(*t, sid, g, 10, SP_LR)

    params = [torch.nn.Parameter(t[0].clone()) for t in tabs]
    yard = torch.optim.SparseAdam(params, lr=SP_LR)
    coo = []
    for steps in inputs:
        grads = []
        for prm, (sid, g) in zip(params, steps):
            head = torch.ones_like(sid, dtype=torch.bool)
            head[1:] = sid[1:] != sid[:-1]
            grads.append(torch.sparse_coo_tensor(sid[head].long()[None], g[head], prm.shape,
                                                 check_invariants=True))
        coo.append(tuple(grads))

    def library(*grads):  # yardstick only; the port never calls it
        for prm, gr in zip(params, grads):
            prm.grad = gr
        yard.step()

    ms = time_ms(kernel, inputs, 50)
    plain_ms = time_ms(plain, inputs, 20)
    library_ms = time_ms(library, coo, 20)
    distinct = [int(torch.unique(sid).numel()) for sid, _ in inputs[0]]
    nbytes = sum(r * (3 * 2 * D * 4 + D * 4 + 8) for r in distinct)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 16 * sum(distinct) * D / PEAK_F32_FLOPS * 1e3
    log(f"kernel 6 timing, one step (2 launches: user {SP_B} ids into {SP_USERS}x{D}, item "
        f"{2 * SP_B} ids into {SP_ITEMS}x{D}; distinct rows {distinct}): kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (torch.optim.SparseAdam.step, "
        f"another eps placement) bound_ms={max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes > t_ops else 'operations'}; {nbytes / 1e6:.1f} MB, "
        f"ops {t_ops:.5f}, bytes {t_bytes:.4f})")
    return {
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
    }


# ------------------------------------- retrieval training, device epoch


def structured_pairs(rng, n_rows):
    """(users, items): users uniform, each in group user % SP_GROUPS, and
    SP_IN_GROUP of the rows take an item from the group's slice of the
    item ids, the rest any item."""
    users = rng.integers(1, SP_USERS, n_rows)
    width = (SP_ITEMS - 1) // SP_GROUPS
    in_group = rng.random(n_rows) < SP_IN_GROUP
    items = np.where(in_group, 1 + (users % SP_GROUPS) * width + rng.integers(0, width, n_rows),
                     rng.integers(1, SP_ITEMS, n_rows))
    return users, items


def sparse_cfg(impl, **over):
    d = {"seed": SEED, "train_batch_size": SP_B, "learner": "sparse_adam",
         "learning_rate": SP_LR, "epochs": 1, "train_oov": True, "oov_only_epoch": True,
         "oov_train_ratio": 0.2, "oov_feature_mask_rate": 0.2, "device_epoch": True,
         "sparse_update_impl": impl}
    d.update(over)
    return Config(d)


def sparse_model():
    """BPR at D = 64 with SP_BUCKETS random-mapper buckets a side, from one
    seed."""
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=SP_BUCKETS,
                         n_item_buckets=SP_BUCKETS, hash_function="3round")
    return BPR(SP_USERS, SP_ITEMS, D, spec, device=DEVICE,
               generator=torch_generator(SEED + 40, DEVICE))


def sparse_fit(loader, impl, **over):
    """A fresh BPR from one seed through `Trainer.fit` on the device epoch.
    → (trainer, per sub-epoch records: losses, steps run, wall, examples/s;
    and the normal epoch's set-up seconds, built before `fit`)."""
    trainer = Trainer(sparse_cfg(impl, **over), sparse_model())
    inner, seen = trainer._train_epoch, {}

    def watched(ldr, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        sync()
        t0 = time.perf_counter()
        total = inner(ldr, epoch_idx, oov_transform, keep_ratio, frozen)
        sync()
        de = trainer._device_epochs.get((id(ldr), keep_ratio is not None, frozen))
        seen["oov" if keep_ratio is not None else "normal"] = {
            "losses": trainer.last_losses, "steps": de.steps_run if de else None,
            "wall": time.perf_counter() - t0, "eps": trainer.last_examples_per_sec,
            "sparse": de is not None and de.sparse_impl}
        return total

    trainer._train_epoch = watched
    sync()
    t0 = time.perf_counter()
    trainer._maybe_device_epoch(loader)  # set-up: columns and bitmap to the card
    sync()
    seen["setup"] = time.perf_counter() - t0
    trainer.fit(loader, None, saved=False)
    trainer._train_epoch = inner
    return trainer, seen


def state_of(trainer):
    """Parameters and Adam moments, cloned."""
    out = {n: p.detach().clone() for n, p in trainer.params.items()}
    for part in ("mu", "nu"):
        out.update({f"{part}:{n}": t.clone() for n, t in trainer.opt_state[part].items()})
    return out


def recorded_sparse_run(loader, impl):
    """COMPARE_STEPS steps of one epoch (no OOV sub-epoch) with every step's
    gradients kept: the tables' (ids, row gradients) on the sparse path, the
    dense gradients otherwise. → (losses, parameters, gradient of element
    (name, flat index) at each step)."""
    from oovrec_tpu_torch.train import device_epoch as de_mod

    tables_seen, rest_seen = {}, []
    update = de_mod.sparse_adam_update_table

    def recording_update(table, state, ids, grows, *a, **k):
        name = next(n for n, p in trainer.params.items() if p is table)
        tables_seen.setdefault(name, []).append((ids.clone(), grows.clone()))
        return update(table, state, ids, grows, *a, **k)

    de_mod.sparse_adam_update_table = recording_update
    try:
        trainer = Trainer(sparse_cfg(impl, train_oov=False), sparse_model())
        step = trainer.optimizer.step

        def recording_step(params, g, state, trainable=None):
            rest_seen.append({n: t.detach().clone() for n, t in g.items()})
            return step(params, g, state, trainable)

        trainer.optimizer.step = recording_step
        trainer._train_epoch(loader, 0)
    finally:
        de_mod.sparse_adam_update_table = update

    def grad(n, i):
        if n in tables_seen:
            r, c = divmod(i, D)
            return torch.stack([g[ids == r, c].sum() for ids, g in tables_seen[n]])
        return torch.stack([g[n].flatten()[i] for g in rest_seen])

    return trainer.last_losses, {n: p.detach() for n, p in trainer.params.items()}, grad


def gather_backward_ms():
    """Autograd's backward of one `table[ids]` gather of SP_B rows from the
    (SP_BUCKETS, D) bucket table: ids all 0 (an IV row's bucket, routed
    branchlessly) against ids spread over the table. Diagnostic only."""
    table = torch.zeros((SP_BUCKETS, D), device=DEVICE, requires_grad=True)
    grad = torch.ones((SP_B, D), device=DEVICE)
    spread = torch.randint(0, SP_BUCKETS, (SP_B,), device=DEVICE,
                           generator=torch_generator(SEED, DEVICE))
    out = {}
    for what, ids in (("all 0", torch.zeros_like(spread)), ("spread", spread)):
        out[what] = time_ms(lambda i: torch.autograd.grad(table[i], table, grad), [(ids,)], 20)
    log(f"index backward of {SP_B} gathered rows into a ({SP_BUCKETS}, {D}) table: "
        + ", ".join(f"ids {k} {v:.4f} ms" for k, v in out.items()))


def retrieval_sparse_training():
    """BPR at bench.py's sparse-adam shape on the device-resident epoch with
    `learner: sparse_adam`: one epoch plus the unfrozen OOV sub-epoch under
    `sparse_update_impl` auto (kernel 6), xla (plain) and dense, a second
    auto run, 16 steps auto vs dense, the frozen OOV device sub-epoch, then
    where a step's time goes. → kernel 6's launches in the auto run."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 50)
    users, items = structured_pairs(rng, SP_B * SP_STEPS)
    train = DatasetSplit({"user_id": users, "item_id": items}, SP_USERS, SP_ITEMS)
    sampler = Sampler(["train"], [train], seed=SEED)
    cfg = sparse_cfg("auto")
    loader = TrainBatcher(train, sampler, cfg, InputType.PAIRWISE)
    require(loader.mode == "pairwise" and len(loader) == SP_STEPS, "sparse BPR loader")
    log(f"sparse retrieval training data: {len(train)} rows, {SP_USERS} users, {SP_ITEMS} "
        f"items, {SP_GROUPS} groups ({SP_IN_GROUP:.0%} in group), {time.perf_counter() - t0:.1f} s")

    sparse_adam_rows_kernel.launches = 0
    sync()
    trainer, seen = sparse_fit(loader, "auto")
    launches = sparse_adam_rows_kernel.launches
    normal, oov = seen["normal"], seen["oov"]
    ran = normal["steps"] + oov["steps"]
    de = trainer._device_epochs[(id(loader), False, False)]
    log(f"sparse retrieval training (auto): {normal['steps']} steps + {oov['steps']} kept OOV "
        f"steps of {len(oov['losses'])} ({normal['sparse']}, {oov['sparse']}); set-up "
        f"{seen['setup']:.2f} s; epoch {normal['wall'] * 1e3 / normal['steps']:.2f} ms per step "
        f"(wall, host included), {normal['eps']:.0f} examples/s; OOV sub-epoch "
        f"{oov['wall'] * 1e3 / max(1, oov['steps']):.2f} ms per kept step (its set-up "
        f"included); kernel 6 launches "
        f"{launches}; used-pair bitmap {de.bitmap.numel() * 4 / 1e9:.3f} GB")
    require(normal["steps"] == SP_STEPS and oov["steps"] > 0, "sparse training steps")
    require(normal["sparse"] == oov["sparse"] == "pallas", "the sparse path with kernel 6")
    require(launches == 2 * ran, f"kernel 6 launches {launches} for {ran} steps")
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(oov["losses"]).all(), "loss not finite")
    log(f"sparse retrieval training: loss first tenth {first:.6f}, last tenth {last:.6f}")
    require(last < first, f"loss did not fall: first tenth {first}, last tenth {last}")

    # negatives on a sample of steps: never PAD, never a used pair (with
    # ~4 used items a user of 99,999 a give-up after 64 rounds has
    # probability ~1e-270)
    n_neg = used = pad = 0
    bitmap, W = de.bitmap.view(-1), de.bitmap.shape[1]
    for i, (step, batch) in enumerate(de.batches(7)):
        u, neg = batch["user_id"], batch["neg_item_id"]
        bits = (bitmap[u * W + (neg >> 5)] >> (neg & 31)) & 1
        used += int(bits.sum())
        pad += int((neg == 0).sum())
        n_neg += neg.numel()
        if i == 3:
            break
    log(f"negatives on 4 sampled steps: {n_neg} drawn, {pad} PAD, {used} used pairs")
    require(pad == 0 and used == 0, "a negative was PAD or a used pair")
    auto1 = state_of(trainer)

    # the frozen OOV device sub-epoch: the sparse path is off, as in JAX
    iv = [n for n in trainer.params if n not in trainer.oov_params]
    before = state_of(trainer)
    k0 = sparse_adam_rows_kernel.launches
    trainer._train_epoch(loader, 1, oov_transform=trainer.oov_simulator,
                         keep_ratio=trainer.oov_train_ratio, frozen=True)
    fde = trainer._device_epochs[(id(loader), True, True)]
    moved = {n for n in trainer.params if not torch.equal(before[n], trainer.params[n])}
    log(f"frozen OOV device sub-epoch: {fde.steps_run} kept steps, sparse path "
        f"{fde.sparse_tables}, moved {sorted(moved)}")
    require(fde.sparse_tables is None and sparse_adam_rows_kernel.launches == k0,
            "the frozen sub-epoch took the sparse path")
    require(fde.steps_run > 0 and not moved & set(iv) and moved == trainer.oov_params,
            f"the frozen sub-epoch moved {sorted(moved)}")
    del trainer, de, fde, before

    # xla (the plain write-back) and a second auto run: the same bits
    for impl in ("xla", "auto"):
        other, oseen = sparse_fit(loader, impl)
        got = state_of(other)
        same = [n for n in auto1 if torch.equal(auto1[n], got[n])]
        log(f"sparse retrieval training ({impl}): {oseen['normal']['steps']} + "
            f"{oseen['oov']['steps']} steps, {oseen['normal']['wall'] * 1e3 / SP_STEPS:.2f} ms "
            f"per step; {len(same)} of {len(auto1)} parameters and moments equal the first "
            f"auto run bit for bit")
        require(len(same) == len(auto1), f"{impl} run differs from the auto run")
        del other, got

    # auto vs the dense lazy sweep over the first COMPARE_STEPS steps
    part = DatasetSplit({"user_id": users[: COMPARE_STEPS * SP_B],
                         "item_id": items[: COMPARE_STEPS * SP_B]}, SP_USERS, SP_ITEMS)
    part_loader = TrainBatcher(part, sampler, cfg, InputType.PAIRWISE)
    la, pa, ga = recorded_sparse_run(part_loader, "auto")
    lb, pb, gb = recorded_sparse_run(part_loader, "dense")
    compare_trajectories("sparse (kernel 6) vs dense lazy-Adam training", ("sparse", "dense"),
                         la, lb, pa, pb, ga, gb)
    del pa, pb, ga, gb

    # where a step's time goes: 8 steps on the device epoch under the
    # profiler and under the sync check, then the host per-batch path
    short = DatasetSplit({"user_id": users[: 8 * SP_B], "item_id": items[: 8 * SP_B]},
                         SP_USERS, SP_ITEMS)
    short_loader = TrainBatcher(short, sampler, cfg, InputType.PAIRWISE)
    trainer, _ = sparse_fit(short_loader, "auto", train_oov=False)
    de = trainer._device_epochs[(id(short_loader), False, False)]
    de.run(1)
    sync()
    wall_ms, busy_ms = profiled(
        lambda: de.run(2), f"profile {de.n_steps} device-epoch steps (sparse_adam, kernel 6)",
        shares=(("kernel 6", ("sparse_adam_rows_kernel",)),))
    log(f"device-epoch profile: {wall_ms / de.n_steps:.2f} ms per step under the profiler, "
        f"{busy_ms / de.n_steps:.3f} ms of device time a step")
    gather_backward_ms()
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        de.run(3)
    torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    log(f"host syncs in a {de.n_steps}-step device epoch: {len(syncs)} {sorted(set(syncs))[:4]}")
    del trainer, de
    host = Trainer(sparse_cfg("auto", device_epoch=False, train_oov=False), sparse_model())
    host._train_epoch(short_loader, 0)
    sync()
    t0 = time.perf_counter()
    host._train_epoch(short_loader, 1)
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(short_loader)
    require(not host._device_epochs, "the host path took the device epoch")
    log(f"host per-batch path, same shape: {host_ms:.2f} ms per step (wall, host included)")
    return launches


# -------------------------------------------------------------- CLI phases

# the `python -m oovrec_tpu_torch.cli.run` entry on the tracked corpus
# dataset/synth-ind (EXPERIMENTS.md:40-45 with the random mapper in place of
# the lsh embedder), its float_seq `*_vector` columns left out
CLI_DIR = os.path.join("build", "cli")
SYNTH_LOAD_COL = ("--load_col={'inter': ['user_id','item_id','timestamp','is_new'], "
                  "'user': ['user_id','age','group'], 'item': ['item_id','price','category']}")
CLI_OOV = ["--inductive_mapper=random", "--add_oov_buckets=True", "--n_user_oov_buckets=200",
           "--n_item_oov_buckets=200", "--train_oov=True", "--oov_train_ratio=0.3",
           "--inductive_eval=True"]
CLI_EPOCHS_A, CLI_EPOCHS_B = 5, 3
SLICE_NAMES = ("overall", "old_users", "new_users", "old_old", "old_new", "new_old", "new_new")
# phase C: an atomic-file family the card notices (tools/make_synth_dataset.py's
# generator at 50,000 users x 100,000 items x 1,000,000 rows, 10 % new), BPR
# at D = 64 with 1,024 buckets a side, full-sort eval, sparse adam on the
# device epoch at the sparse phase's lr 1e-2; 256 users a full-sort batch
C_USERS, C_ITEMS, C_INTERS, C_NEW_RATIO, C_SEED = 50_000, 100_000, 1_000_000, 0.1, 7
C_BUCKETS, C_EVAL_USERS = 1024, 256


def cli_out(name):
    out = os.path.join(CLI_DIR, name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    return out


def cli_flags(out):
    return [f"--checkpoint_dir={out}", f"--nfs_backup_path={os.path.join(out, 'backup')}",
            f"--results_json={os.path.join(out, 'results.json')}", "--metric_decimal_place=12"]


def agree_slices(a, b, what, tol):
    """`agree` over the 7 slices, where a metric a slice cannot define
    (AUC of a slice whose rows carry one label) must be NaN in both."""
    require(list(a) == list(b), f"{what}: slices differ")
    for s in a:
        require(list(a[s]) == list(b[s]), f"{what}[{s}]: keys differ")
        for k, x in a[s].items():
            y = b[s][k]
            if math.isnan(x) or math.isnan(y):
                require(math.isnan(x) and math.isnan(y), f"{what}[{s}][{k}]: {x} vs {y}")
            else:
                require(abs(x - y) < tol, f"{what}[{s}][{k}]: {x} vs {y}")


def finite_metrics(result, what):
    require(result and all(math.isfinite(float(v)) for v in result.values()),
            f"{what}: metrics not finite: {result}")


def cli_retrieval():
    """Phase A: the real entry as a subprocess, BPR on synth-ind with the
    OOV regime, uni250 valid/test and the 7-slice inductive eval; then
    `--eval_only` on its checkpoint in this process reproduces its test
    metrics and slices to 1e-9. → the subprocess wall seconds."""
    out = cli_out("a")
    argv = ["--model=BPR", "--dataset=synth-ind", "--data_path=dataset", SYNTH_LOAD_COL,
            *CLI_OOV, f"--epochs={CLI_EPOCHS_A}", *cli_flags(out)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "oovrec_tpu_torch.cli.run", *argv],
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = (proc.stdout + proc.stderr).splitlines()
    for line in lines:
        if "training [" in line or "test result" in line or "] {" in line:
            log(f"  [A] {line.split(' INFO ')[-1][:160]}")
    require(proc.returncode == 0, f"phase A: rc {proc.returncode}: " + "\n".join(lines[-30:]))
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    finite_metrics(res["test_result"], "phase A test")
    require(tuple(res["inductive"]) == SLICE_NAMES, f"phase A slices {list(res['inductive'])}")
    finite_metrics(res["inductive"]["overall"], "phase A overall slice")
    log(f"phase A: python -m oovrec_tpu_torch.cli.run (BPR, synth-ind, {CLI_EPOCHS_A} epochs, "
        f"uni250) rc 0 in {wall:.1f} s (wall, process start and the corpus included)")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'BPR-synth-ind.pth')}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "phase A eval_only test", tol=1e-9)
    agree_slices(res["inductive"], again["inductive_results"], "phase A eval_only slices",
                 tol=1e-9)
    log("phase A: --eval_only == the run on test metrics and the 7 slices (1e-9)")
    return wall


def cin_counts():
    return {"cin_layer_pooled": cin_layer_pooled.launches, "cin_layer": cin_layer.launches,
            "cin_layer_pooled_bwd": cin_layer_pooled_bwd.launches,
            "cin_layer_bwd": cin_layer_bwd.launches}


def reset_cin_counts():
    cin_layer_pooled.launches = cin_layer.launches = 0
    cin_layer_pooled_bwd.launches = cin_layer_bwd.launches = 0


def hold_cin_at(model, db, seed):
    """The CIN forward and backward kernels against their plain versions
    (f32) at the layer shapes `model` gives one batch `db`; random
    gradients, masked near the ReLU. → the largest error, each relative to
    max(1, the plain output's largest magnitude)."""
    err = 0.0
    with torch.no_grad():
        b0 = model.concat_embed_input_fields(db).float().contiguous()
        hidden = b0
        for i, (conv, (nh, pool_all)) in enumerate(zip(model.conv1d_list, model._layer_modes())):
            inputs = (hidden, b0, conv.kernel.detach(), conv.bias.detach())
            err = max(err, cin_bwd_err(*cin_pair(inputs, nh, pool_all, "float32")))
            grads = cin_grads(inputs, nh, 0 if pool_all else nh, seed + i, False, "float32")
            err = max(err, cin_bwd_err(*cin_bwd_pair(inputs, grads, nh, pool_all, "float32")))
            hidden, _ = cin_layer_pooled(*inputs, n_hidden=nh, pool_all=pool_all)
    return err


def cli_ranking():
    """Phase B: `cli.run.main` in this process, xDeepFM at its published
    widths on synth-ind under the ranking protocol (uni250 rows, AUC and
    RMSE), with the CIN kernels counted around the run; then `--eval_only`
    with the CIN on the kernels and on the slab path agree to 1e-6. → the
    run's CIN launch counts and wall seconds."""
    out = cli_out("b")
    argv = ["--model=xDeepFM", "--model_eval_type=ranking", "--dataset=synth-ind",
            "--data_path=dataset", SYNTH_LOAD_COL, *CLI_OOV,
            "--numerical_features=['age','price']", f"--epochs={CLI_EPOCHS_B}", *cli_flags(out)]
    reset_cin_counts()
    sync()
    t0 = time.perf_counter()
    res = cli_run.main(argv)
    sync()
    wall = time.perf_counter() - t0
    counts = cin_counts()
    log(f"phase B: cli.run.main (xDeepFM, synth-ind, {CLI_EPOCHS_B} epochs, uni250) "
        f"{wall:.1f} s (wall), CIN launches {counts}")
    require(counts["cin_layer_pooled"] > 0 and counts["cin_layer_pooled_bwd"] > 0,
            f"phase B: the CIN kernels were not launched: {counts}")
    finite_metrics(res["test_result"], "phase B test")
    require(tuple(res["inductive_results"]) == SLICE_NAMES, "phase B slices")
    log(f"[B test] {dict(res['test_result'])}")
    for s, r in res["inductive_results"].items():
        log(f"[B {s}] {dict(r)}")
    model = res["trainer"].model
    model.eval()
    train_loader, _, test_loader = data_preparation(res["config"], res["dataset"])
    for what, loader_, seed in (("a training batch", train_loader, SEED + 1200),
                                ("a uni250 test batch", test_loader, SEED + 1210)):
        batch = next(iter(loader_))
        err = hold_cin_at(model, to_device_batch(batch, DEVICE), seed)
        log(f"phase B CIN kernels vs plain at {what}, layers (B, H, F, D, L) "
            f"{model.cin_layer_shapes(len(batch['weight']))}: relative error {err:.3e}")
        require(err <= CIN_TOL, f"phase B CIN at {what}: relative error {err}")
    ckpt = res["trainer"].saved_model_file
    runs = {}
    for fused in (True, False):
        reset_cin_counts()
        runs[fused] = cli_run.main([f"--eval_only={ckpt}", "--inductive_eval=True",
                                    f"--fused_cin={fused}"])
        n = cin_layer_pooled.launches
        require((n > 0) == fused, f"phase B eval_only fused_cin={fused}: {n} CIN launches")
    agree(runs[True]["test_result"], runs[False]["test_result"], "phase B kernel vs slab test",
          tol=1e-6)
    agree_slices(runs[True]["inductive_results"], runs[False]["inductive_results"],
                 "phase B kernel vs slab slices", tol=1e-6)
    log("phase B: --eval_only on the CIN kernels == on the slab path: AUC, RMSE and the "
        "7 value slices (1e-6)")
    return counts, wall


def generate(out: str, name: str, n_users: int, n_items: int, n_inters: int,
             new_ratio: float = 0.1, dim: int = 8, seed: int = 7,
             feat_dims: int = 4, feat_noise: float = 0.3):
    """A copy of `tools/make_synth_dataset.py:generate` (the tool imports
    the JAX package's config, which the card's machine cannot import):
    `<name>/` (the training corpus with is_new rows and feature files) and
    `<name>_ind/` (benchmark train/empty/test_filt and the full feature
    files) in the atomic-file format, with latent-factor structure."""
    rng = np.random.default_rng(seed)
    n_new_u = int(n_users * new_ratio)
    n_new_i = int(n_items * new_ratio)
    n_old_u, n_old_i = n_users - n_new_u, n_items - n_new_i

    U = rng.standard_normal((n_users, dim)) * 0.7
    I = rng.standard_normal((n_items, dim)) * 0.7
    u_age = (U[:, 0] * 10 + 35 + rng.standard_normal(n_users)).round(1)
    u_group = (U[:, 1] > 0).astype(int)
    i_price = (I[:, 0] * 20 + 50 + rng.standard_normal(n_items)).round(2)
    i_cat = np.argmax(I[:, 1:4], axis=1)

    def sample_inters(users, items_pool, n, t0):
        uu = rng.integers(0, len(users), n)
        ii = np.empty(n, np.int64)
        order = np.argsort(uu, kind="stable")
        uu_sorted = uu[order]
        uniq, starts = np.unique(uu_sorted, return_index=True)
        ends = np.append(starts[1:], n)
        Ip = I[items_pool].astype(np.float32).T
        block = max(1, (1 << 26) // max(1, len(items_pool)))
        for bs in range(0, len(uniq), block):
            ub = uniq[bs:bs + len(uniq[bs:bs + block])]
            logits = U[users[ub]].astype(np.float32) @ Ip
            logits -= logits.max(axis=1, keepdims=True)
            cdf = np.cumsum(np.exp(logits), axis=1)
            for k in range(len(ub)):
                s, e = starts[bs + k], ends[bs + k]
                r = rng.random(e - s).astype(np.float32) * cdf[k, -1]
                ii[order[s:e]] = np.searchsorted(cdf[k], r, side="right")
        np.clip(ii, 0, len(items_pool) - 1, out=ii)
        return users[uu], items_pool[ii], t0 + np.arange(n)

    old_users = np.arange(n_old_u)
    old_items = np.arange(n_old_i)
    all_users = np.arange(n_users)
    all_items = np.arange(n_items)

    n_old_inters = int(n_inters * (1 - new_ratio))
    tu, ti, tt = sample_inters(old_users, old_items, n_old_inters, 0)
    missing_u = np.setdiff1d(old_users, np.unique(tu))
    missing_i = np.setdiff1d(old_items, np.unique(ti))
    n_fix = max(len(missing_u), len(missing_i))
    if n_fix:
        fu = np.concatenate([missing_u, rng.choice(old_users, n_fix - len(missing_u))])
        fi = np.concatenate([missing_i, rng.choice(old_items, n_fix - len(missing_i))])
        ft = ((tt[-1] + 1) if len(tt) else 0) + np.arange(n_fix)
        tu, ti, tt = (np.concatenate([tu, fu]), np.concatenate([ti, fi]),
                      np.concatenate([tt, ft]))
    n_new_rows = n_inters - n_old_inters
    nu, ni, nt = sample_inters(all_users, all_items, n_new_rows, n_old_inters)
    touch_new = (nu >= n_old_u) | (ni >= n_old_i)
    nu, ni, nt = nu[touch_new], ni[touch_new], nt[touch_new]
    seen_u = np.zeros(n_users, bool)
    seen_u[np.unique(tu)] = True
    seen_i = np.zeros(n_items, bool)
    seen_i[np.unique(ti)] = True
    ok = ((nu >= n_old_u) | seen_u[nu]) & ((ni >= n_old_i) | seen_i[ni])
    nu, ni, nt = nu[ok], ni[ok], nt[ok]

    def w(path, lines):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    u_vec = (U[:, :feat_dims] + feat_noise * rng.standard_normal((n_users, feat_dims))).round(4)
    i_vec = (I[:, :feat_dims] + feat_noise * rng.standard_normal((n_items, feat_dims))).round(4)

    def user_rows(ids):
        return [f"u{u}\t{u_age[u]}\tg{u_group[u]}\t" + " ".join(map(str, u_vec[u])) for u in ids]

    def item_rows(ids):
        return [f"i{i}\t{i_price[i]}\tc{i_cat[i]}\t" + " ".join(map(str, i_vec[i])) for i in ids]

    uh = "user_id:token\tage:float\tgroup:token\tuser_vector:float_seq"
    ih = "item_id:token\tprice:float\tcategory:token\titem_vector:float_seq"
    d = os.path.join(out, name)
    inter = ["user_id:token\titem_id:token\ttimestamp:float\tis_new:token"]
    inter += [f"u{u}\ti{i}\t{t}\t-1" for u, i, t in zip(tu, ti, tt)]
    inter += [f"u{u}\ti{i}\t{t}\t1" for u, i, t in zip(nu, ni, nt)]
    w(f"{d}/{name}.inter", inter)
    w(f"{d}/{name}.user", [uh] + user_rows(old_users))
    w(f"{d}/{name}.item", [ih] + item_rows(old_items))
    d2 = os.path.join(out, f"{name}_ind")
    w(f"{d2}/{name}_ind.train.inter", ["user_id:token\titem_id:token\ttimestamp:float"]
      + [f"u{u}\ti{i}\t{t}" for u, i, t in zip(tu, ti, tt)])
    w(f"{d2}/{name}_ind.empty.inter", ["user_id:token\titem_id:token\ttimestamp:float"])
    w(f"{d2}/{name}_ind.test_filt.inter", ["user_id:token\titem_id:token\ttimestamp:float"]
      + [f"u{u}\ti{i}\t{t}" for u, i, t in zip(nu, ni, nt)])
    w(f"{d2}/{name}_ind.user", [uh] + user_rows(all_users))
    w(f"{d2}/{name}_ind.item", [ih] + item_rows(all_items))
    return len(tu), len(nu)


class timed:
    """Wall seconds of every call of `owner.name` while in the block (the
    card synchronised after each), on `calls`."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        inner = self.inner = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            sync()
            self.calls.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)


def c_config(data_path, out):
    return {
        "model": "BPR", "dataset": "synth-c", "data_path": data_path, "load_col": {
            "inter": ["user_id", "item_id", "timestamp", "is_new"],
            "user": ["user_id", "age", "group"], "item": ["item_id", "price", "category"]},
        "epochs": 1, "learner": "sparse_adam", "learning_rate": SP_LR, "device_epoch": True,
        "inductive_mapper": "random", "add_oov_buckets": True,
        "n_user_oov_buckets": C_BUCKETS, "n_item_oov_buckets": C_BUCKETS,
        "train_oov": True, "oov_train_ratio": 0.3, "eval_args": {"mode": "full"},
        "eval_batch_size": C_EVAL_USERS * (C_ITEMS + 1), "checkpoint_dir": out,
        "metric_decimal_place": 12, "seed": SEED,
    }


def cli_corpus():
    """Phase C: a written atomic-file family at 50,000 users x 100,000
    items x 1,000,000 rows through `quick_start.run` (BPR, D 64, sparse adam
    on the device epoch, the OOV sub-epoch, full-sort eval) and
    `perform_inductive_eval`, with kernels 6 and 1 counted around them and
    the wall time of each stage; then `--eval_only` with `use_fused_topk`
    True and False (perturbed hits off) agree to 1e-9. → (kernel 6 launches, kernel 1
    launches, stage seconds)."""
    out = cli_out("c")
    data = os.path.join(out, "data")
    t0 = time.perf_counter()
    n_rows, n_new = generate(data, "synth-c", C_USERS, C_ITEMS, C_INTERS, C_NEW_RATIO, seed=C_SEED)
    log(f"phase C corpus: {n_rows} transductive + {n_new} inductive rows written in "
        f"{time.perf_counter() - t0:.1f} s")
    stages = {}
    sparse_adam_rows_kernel.launches = 0
    topk_score.fused_topk_scores.launches = 0
    sync()
    with timed(dataset_module, "load_atomic_file") as t_load, \
            timed(quick_start, "create_dataset") as t_ds, \
            timed(quick_start, "data_preparation") as t_prep, \
            timed(Trainer, "_train_epoch") as t_epoch, \
            timed(Trainer, "evaluate") as t_test, \
            timed(EvalRunner, "evaluate") as t_eval:
        t0 = time.perf_counter()
        res = quick_start.run(config_dict=c_config(data, out))
        stages["run"] = time.perf_counter() - t0
    k6 = sparse_adam_rows_kernel.launches
    t0 = time.perf_counter()
    ind = perform_inductive_eval(res["dataset"], res["trainer"].saved_model_file,
                                 config=res["config"])
    sync()
    stages["inductive eval"] = time.perf_counter() - t0
    k1 = topk_score.fused_topk_scores.launches
    stages["atomic-file load (3 files)"] = sum(t_load.calls[:3])
    stages["Dataset build (load included)"] = t_ds.calls[0]
    stages["data_preparation"] = t_prep.calls[0]
    stages["epoch (device epoch)"] = t_epoch.calls[0]
    stages["OOV sub-epoch"] = t_epoch.calls[1]
    stages["valid eval"] = t_eval.calls[0]
    stages["test eval"] = t_test.calls[0]
    for k, v in stages.items():
        log(f"phase C wall: {k}: {v:.2f} s")
    trainer = res["trainer"]
    de = trainer._device_epochs
    require(any(d.sparse_impl == "pallas" for d in de.values()),
            "phase C: the device epoch did not take kernel 6")
    require(k6 > 0 and k1 > 0, f"phase C: kernel 6 launches {k6}, kernel 1 launches {k1}")
    finite_metrics(res["test_result"], "phase C test")
    require(tuple(ind) == SLICE_NAMES, "phase C slices")
    log(f"phase C: kernel 6 launches {k6} (training), kernel 1 launches {k1} (inductive eval)")
    log(f"[C test] {dict(res['test_result'])}")
    for s, r in ind.items():
        log(f"[C {s}] {dict(r)}")
    runs = {}
    for fused in (True, False):
        topk_score.fused_topk_scores.launches = 0
        t0 = time.perf_counter()
        # unperturbed ties (bucket-sharing new items score alike): both
        # paths then break them to the lowest index, while perturbed hits
        # draw one permutation a batch on the fused path and three on the
        # dense one
        runs[fused] = cli_run.main([f"--eval_only={trainer.saved_model_file}",
                                    "--inductive_eval=True", f"--use_fused_topk={fused}",
                                    "--use_perturbed_hits=False"])
        n = topk_score.fused_topk_scores.launches
        log(f"phase C eval_only use_fused_topk={fused}: {time.perf_counter() - t0:.1f} s "
            f"(wall, corpus rebuilt), kernel 1 launches {n}")
        require((n > 0) == fused, f"phase C eval_only fused={fused}: {n} kernel 1 launches")
    agree(runs[True]["test_result"], runs[False]["test_result"], "phase C fused vs dense test")
    agree_slices(runs[True]["inductive_results"], runs[False]["inductive_results"],
                 "phase C fused vs dense slices", tol=1e-9)
    agree(res["test_result"], runs[False]["test_result"], "phase C eval_only vs the run")
    log("phase C: --eval_only fused == dense on test metrics and the 7 slices (1e-9)")
    return k6, k1, stages


# -------------------------------------------------------------------- main


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    t_start = t0 = time.perf_counter()
    built = cuda_build.build_kernels(["topk_score", "cin_fused", "cin_fused_bwd", "sparse_rows"])
    log(f"build: {built} ({time.perf_counter() - t0:.1f} s)")
    for name, out in cuda_build.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    kernel_cases()
    cin_cases()
    cin_bwd_cases()
    sparse_rows_cases()
    timing = kernel_timing()
    cin_times = cin_timing()
    cin_times.update(cin_bwd_timing())
    sparse_times = sparse_rows_timing()
    launches = serving()
    cin_launches, ind, mapper = ranking()
    train_launches = ranking_training(ind, mapper)
    retrieval_training()
    sparse_launches = retrieval_sparse_training()
    t0 = time.perf_counter()
    cli_retrieval()
    cli_b, _ = cli_ranking()
    k6_c, k1_c, _ = cli_corpus()
    log(f"CLI phases A-C: {time.perf_counter() - t0:.1f} s")
    cli = {  # each kernel's launches on the CLI paths (A launches none)
        "fused_topk_scores": {"C": k1_c},
        "cin_layer_pooled": {"B": cli_b["cin_layer_pooled"]},
        "cin_layer": {"B": cli_b["cin_layer"]},
        "cin_layer_pooled_bwd": {"B": cli_b["cin_layer_pooled_bwd"]},
        "cin_layer_bwd": {"B": cli_b["cin_layer_bwd"]},
        "sparse_adam_rows_kernel": {"C": k6_c},
    }

    kernels = [{
        "name": "fused_topk_scores",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/topk_score.cu",
        "replaces": "oovrec_tpu/ops/topk_score.py:134",
        "launches": launches,
        **timing,
    }, {
        "name": "cin_layer_pooled",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:368",
        "launches": cin_launches["cin_layer_pooled"],
        **cin_times["cin_layer_pooled"],
    }, {
        "name": "cin_layer",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:129",
        "launches": cin_launches["cin_layer"],
        **cin_times["cin_layer"],
    }, {
        "name": "cin_layer_pooled_bwd",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused_bwd.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:414",
        "launches": train_launches["cin_layer_pooled_bwd"],
        **cin_times["cin_layer_pooled_bwd"],
    }, {
        "name": "cin_layer_bwd",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused_bwd.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:155",
        "launches": train_launches["cin_layer_bwd"],
        **cin_times["cin_layer_bwd"],
    }, {
        "name": "sparse_adam_rows_kernel",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/sparse_rows.cu",
        "replaces": "oovrec_tpu/ops/sparse_rows.py:127",
        "launches": sparse_launches,
        **sparse_times,
    }]
    for k in kernels:
        k["launches_cli"] = cli[k["name"]]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
        3) agree to 1e-9;
  8. phase D, the embedders, at the published widths (BPR at D 64, DHE at
     128 hashes and towers of 512, xDeepFM at xDeepFM.yaml):
     D1. EXPERIMENTS.md:40-45 verbatim (lsh, the *_vector columns, 200
         buckets a side, OOV ratio 0.3, the inductive eval; 5 epochs)
         through `python -m oovrec_tpu_torch.cli.run` as a subprocess, its
         `--eval_only` equal to 1e-9, then the same command through
         `cli.run.main` with slsh, dnn, knn, dhe and fdhe (32 hashes); every
         run's 7 slices finite;
     D2. xDeepFM with lsh through `cli.run.main`, 3 epochs, the CIN kernels
         counted;
     D3. fdhe serving over phase 3's 1,000,000 items: the ids hashed on
         the card equal to the numpy hasher on every id, the tower pass
         over all items timed, the 7-slice eval fused vs dense to 1e-9;
     D4. the gathers' backward of `ops/embed_grad.py` (its kernel) and the
         routes it was measured against (BACKWARD_ROUTES: a call and device
         time, each repeated bit for bit), and BPR with lsh on the
         device epoch with sparse adam, auto == xla bit for bit.
  9. phase E, the paper's other three models at their published widths
     (WideDeep.yaml, DCNV2.yaml, DirectAU.yaml):
     E1. EXPERIMENTS.md:79, the ranking track (WideDeep, lsh over the
         *_vector columns, 200 buckets a side, OOV ratio 0.3; 3 epochs of
         8) through `python -m oovrec_tpu_torch.cli.run` as a subprocess:
         the training loss falls, the 7 slices are finite, `--eval_only`
         equal to 1e-9; then the same command through `cli.run.main`;
     E2. DCNv2 through `cli.run.main` on synth-ind (random mapper, 2
         epochs) stacked, parallel and with mixed experts, each
         `--eval_only` equal to 1e-9 and its BatchNorm statistics moved;
         stacked at `--worker=2` (batch prefetch) equal to `worker: 0`;
     E3. WideDeep, DCNv2 stacked and mixed through `Trainer.fit` at phase
         4's shape (one epoch + the frozen OOV sub-epoch): the loss falls,
         held-out AUC rises, the 7 value slices; 64 rows score alike alone
         and inside a batch of 8,192 in eval mode (1e-6); then WideDeep
         with a token_seq item field, 16 steps, the loss falling and the
         gathers' backward launched for the field's tables;
     E4. DirectAU at D 64: 64 pointwise steps of 2,048 rows + the OOV
         sub-epoch with adam and with `learner: sparse_adam` (kernel 6 on
         the host path); the serving cell's corpus, fused == dense on the 7
         slices and the full sort (1e-9); DirectAU on synth-ind through
         `cli.run.main`, `--eval_only` equal to 1e-9.
 10. phase F, the device-resident and scanned paths, each dense step
     replayed from its captured CUDA graph (`train/cuda_graph.py`):
     F1. xDeepFM at the ranking cell's shape on the plain device epoch
         through `Trainer.fit` (`device_epoch: true`; the frozen OOV
         sub-epoch on the host path): the loss falls, held-out AUC rises,
         CIN kernels 4 and 5 (3 + 3 a step) and the gathers' backward
         launched by their wrappers at the warm-ups and the captures;
         16 graphed steps against 16 eager ones on the same
         batches from the same weights, bit for bit (losses, parameters,
         moments); eager vs graphed ms a step, wall and device, with the
         busy share, and the kernels in each pass's profiler trace: the
         graphed pass calls no wrapper and its trace holds each kernel as
         often as the eager trace, which holds it as often as the eager
         wrappers launched it; a whole epoch's ms a step;
     F2. WideDeep and DCNv2 on the pointwise device epoch (uniform, one
         negative a row) at the same shape: the loss falls, DCNv2's
         BatchNorm statistics move; graphed == eager over 8 steps; times;
     F3. BPR with fdhe (128 hashes, towers of 512) hashed on the card
         (`dhe_on_device`) on the pairwise device epoch with `learner:
         sparse_adam` (kernel 6, eager by rule) and its OOV sub-epoch at
         the sparse phase's shape; one OOV batch's codes == the host
         hasher's; then BPR's dense step graphed == eager, and times; a
         dropped trainer's captures do not break the next capture;
     F4. `host_scan_steps` 64 against 1 on xDeepFM's host path: the same
         losses and weights bit for bit; then over 3 groups of 64
         batches K = 64 against K = 1 (both replaying) and K = 1 eagerly
         (what the grouping adds beyond the graph), wall, device and busy
         share, the replays' kernels counted in the traces;
     F5. the scanned eval against the per-batch eval over phase 3's
         900,000 IV items: the full sort on kernel 1 and uni100, the same
         metrics; walls and host syncs of each pass.
     Phases 5, 6, E3 and E4 and the sparse phase pin `device_epoch: False`
     and `host_scan_steps: 1` where they measure or watch the host path,
     and run its dense steps eagerly (`eager_steps`: they count launches a
     step, swap a kernel's route between steps, or time the eager step);
     the serving phases pin `device_eval: False` (`serving_cfg`).
Phase 2 also holds the gathers' backward kernel (`csrc/embed_grad.cu`)
against its plain version (bit for bit on integer-valued cotangents, to
1e-5 on random ones, against a repeat run) and times it; phase 6 profiles
the device-epoch step under each backward route and phase 5 the xDeepFM
step under the kernel and the index route.
Phase 2 also holds the CIN backward kernel against its plain version,
bit for bit on integer inputs and gradients (and against itself on a
repeat run), and times it per layer and for the 3-layer stack.
The last line is the device record; the line before it lists the kernels,
each with its launches on the earlier phases' paths (`launches`), on the
CLI phases (`launches_cli`) and on phase D's, E's and F's parts
(`launches_d`, `launches_e`, `launches_f`), each counted by the kernel's
wrapper where it launches (`ops/launches.py`; a CUDA graph's replays run
no wrapper), and the kernels that phase F's graphed passes replayed, as
their profiler traces show them (`launches_f_trace`); before them, phase
F's times as one JSON line (`phase F times`).

TF32 is switched off for matmuls and cuDNN below: the plain versions and
the dense path must compute in full f32, as the kernel does.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
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
from oovrec_tpu_torch.data.transfer import to_device_batch
from oovrec_tpu_torch.data.utils import data_preparation
from oovrec_tpu_torch.data import (
    DatasetSplit,
    FullSortEvalBatcher,
    NegSampleEvalBatcher,
    PlainEvalBatcher,
    Sampler,
    TrainBatcher,
)
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator
from oovrec_tpu_torch.inductive import DHEHasher, InductiveSpec, RandomOOVMapper
from oovrec_tpu_torch.models import BPR, FieldSpec, get_model_class, xDeepFM
from oovrec_tpu_torch.ops import embed_grad, launches, topk_score
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
from oovrec_tpu_torch.ops.siphash import siphash24_batch
from oovrec_tpu_torch.ops.siphash_device import MAX_HASH, dhe_codes_device
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
    oov = users >= N_OLD_USERS
    batch = {
        "user_id": torch.from_numpy(users).to(DEVICE),
        "user_id_oov": torch.from_numpy(oov.astype(np.int64)).to(DEVICE),
    }
    if mapper is None:  # a DHE model: the ids hashed on the card
        item_e = model.all_item_embeddings(ids, item_dhe_ids=ids)
        batch["user_id_dhe_id"] = batch["user_id"]
    else:
        buckets = torch.from_numpy(
            np.where(np.arange(n_items) >= N_OLD_ITEMS,
                     mapper.item_buckets(np.arange(n_items)), 0)
        ).to(DEVICE)
        item_e = model.all_item_embeddings(ids, buckets)
        batch["user_id_bucket"] = torch.from_numpy(
            np.where(oov, mapper.user_buckets(users), 0)).to(DEVICE)
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


def serving_cfg(fused, n_items, device_eval=False):
    """The serving eval's config; the per-batch eval unless `device_eval`
    (phase 3 times it a batch; phase F5 holds the scanned eval to it)."""
    return Config({
        "topk": TOPK, "seed": SEED, "eval_batch_size": B * n_items,
        "use_perturbed_hits": False, "use_fused_topk": "auto" if fused else False,
        "device_eval": device_eval,
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
    full_sort_fused_vs_dense(model, iv_splits)
    SERVING.update(model=model, iv_splits=iv_splits)  # phase F5
    # after the counted runs: where the time of the default (perturbed)
    # fused inductive eval goes on the device
    c = cfg(True, N_OLD_ITEMS + N_NEW_ITEMS)
    c["use_perturbed_hits"] = True
    breakdown(InductiveEvaluator(model, c, N_OLD_USERS, N_OLD_ITEMS, mapper=mapper),
              loader(ind_splits, c))
    return launches


def full_sort_fused_vs_dense(model, iv_splits, what="full-sort eval"):
    """The IV full-sort eval on the fused path (one top-k launch a batch)
    and on the dense path: equal to 1e-9. → the fused run's launches."""
    iv, counts = {}, {}
    for fused in (True, False):
        c = serving_cfg(fused, N_OLD_ITEMS)
        iv_loader = loader(iv_splits, c)
        runner = EvalRunner(model, c)
        topk_score.fused_topk_scores.launches = 0
        t0 = time.perf_counter()
        iv[fused] = runner.evaluate(iv_loader)
        sync()
        wall = time.perf_counter() - t0
        counts[fused] = n_launch = topk_score.fused_topk_scores.launches
        require(runner._use_fused(iv_loader.item_num) is fused, f"{what}: runner fused path")
        require(n_launch == (len(iv_loader) if fused else 0), f"{what}: launches {n_launch}")
        log(f"{what} {'fused' if fused else 'dense'}: {len(iv_loader)} batches, "
            f"{wall / len(iv_loader) * 1e3:.1f} ms per batch, kernel launches {n_launch}")
    log(f"[{what}] {dict(iv[True])}")
    agree(iv[True], iv[False], f"{what} fused vs dense")
    log(f"{what}: fused == dense (1e-9)")
    return counts[True]


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


GATHER_NODE = "_GatherRowsBackward"
# the gathers' backward measurements of phases D4 and 6, for the last lines
GATHER_RESULTS = {}


def trace_launches(rows):
    """Each registered kernel's launches in a profiler trace's device
    rows (time, name, count), by the name of its `__global__` function."""
    out = {fn.kernel: 0 for fn in launches.WRAPPERS.values()}
    for _, key, n in rows:
        for kernel in out:
            if re.search(rf"(^|[\s:]){kernel}[<(]", key):
                out[kernel] += n
    return out


def profiled(run, what, shares=(), quiet=False):
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
    profiled.kernels = trace_launches(rows)
    log(f"{what}, wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    # the row gathers' backward (ops/embed_grad.py): the device time of the
    # kernels its autograd node launched, sort and segment sums included
    spans = [(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0), e.count)
             for e in prof.key_averages() if e.key.endswith(GATHER_NODE)]
    g_us, g_n = max(spans, default=(0, 0))
    profiled.gathers_ms = g_us / 1e3
    log(f"  gathers' backward ({backward_route.name} route): {g_us / 1e3:.3f} ms "
        f"({100 * g_us / 1e3 / max(busy_ms, 1e-9):.1f} % of device time), {g_n} calls")
    for label, prefixes in shares:
        mine = [(us, n) for us, key, n in rows if any(p in key for p in prefixes)]
        ms = sum(us for us, _ in mine) / 1e3
        n = sum(c for _, c in mine)
        log(f"  {label}: {ms:.3f} ms ({100 * ms / max(busy_ms, 1e-9):.1f} % of device time), "
            f"{n} launches, {ms / max(n, 1):.4f} ms a launch")
    for us, key, count in ([] if quiet else rows[:12]):
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
        # the host per-batch path (phases 5 and E3 measure it): `auto` would
        # take the plain device epoch at these 700,000+ rows
        "device_epoch": False, "host_scan_steps": 1,
    }
    d.update(over)
    return Config(d)


def rows_of(split, keep, n_users, n_items):
    return DatasetSplit({k: v[keep] for k, v in split.inter.items()}, n_users, n_items,
                        user_feat=split.user_feat, item_feat=split.item_feat)


def ctr_splits(ind):
    """→ (the IV rows of the first CTR_TRAIN_FRACTION of the labelled rows,
    the rest, the IV rows of the rest)."""
    n = len(ind)
    cut = int(CTR_TRAIN_FRACTION * n)
    row = np.arange(n)
    old = ((ind.inter["user_id"] < N_CTR_OLD_USERS)
           & (ind.inter["item_id"] < N_CTR_OLD_ITEMS))
    n_u, n_i = N_CTR_OLD_USERS + N_CTR_NEW_USERS, N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS
    return (rows_of(ind, (row < cut) & old, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS),
            rows_of(ind, row >= cut, n_u, n_i),
            rows_of(ind, (row >= cut) & old, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS))


def ranking_training(ind, mapper):
    """xDeepFM through `Trainer.fit` on the card: one epoch over the IV rows
    of the first CTR_TRAIN_FRACTION of the rows plus the frozen OOV-only
    sub-epoch, from a seed other than the labels' model. → the CIN launch
    counts of the fit."""
    train, held, held_iv = ctr_splits(ind)
    cfg = ctr_train_cfg()
    model = build_ranking_model(SEED + 7)
    auc0 = EvalRunner(model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))["auc"]

    trainer = eager_steps(Trainer(cfg, model))
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
    # the same steps with the gathers' backward on torch's indexing route
    # (the port's before this kernel), for the share it took
    with backward_route("index"):
        inner(profile_loader, 3)
        sync()
        _, busy = profiled(lambda: inner(profile_loader, 4),
                           f"profile {len(profile_loader)} xDeepFM training steps, the "
                           "gathers' backward on the index route", quiet=True)
    log(f"ranking training profile, index route: {busy / len(profile_loader):.3f} ms of "
        f"device time a step, the gathers' backward "
        f"{profiled.gathers_ms / len(profile_loader):.3f} ms")
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
        trainer = eager_steps(Trainer(cfg, model))
        grads, step = [], trainer.optimizer.step

        def recording(params, g, state, trainable=None, grads=grads, step=step, **kw):
            grads.append({n: t.detach().clone() for n, t in g.items()})
            return step(params, g, state, trainable, **kw)

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
                  "oov_feature_mask_rate": 0.2, "device_epoch": False,
                  "host_scan_steps": 1})
    trainer = eager_steps(Trainer(cfg, model))
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
    # E4's DirectAU tables on the host path: a pointwise step's 2,048 ids a
    # side into 100,000 users and 900,000 items
    ("directau-users", N_OLD_USERS, D, 2048, {}),
    ("directau-items", N_OLD_ITEMS, D, 2048, {}),
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


# ------------------------------------- the gathers' backward (embed_grad)

# (name, n, table rows, D, ids from [0, high), "perm" (a permutation) or
# "pads" (the kept rows from [1, table rows), the others at the pad row
# 0), share of rows kept): the device epoch's bucket gathers (every IV row
# at bucket 0, discarded or kept; the OOV rows' spread buckets), its row
# overrides (positions, each once), xDeepFM's packed token table (8,192
# rows x 7 fields, a small-vocabulary field's few rows), DCNv2's (D 16,
# ids over the whole table), the first-order twin at D 1, E3's token_seq
# field (8,192 rows x 16 positions, 47 % of them live, into 1,000 rows at
# D 10 and its twin at D 1), a width past one warp, a ragged short input
# and none
EMBED_GRAD_CASES = [
    ("bucket-0-discarded", SP_B, SP_BUCKETS, D, 1, 0.0),
    ("bucket-0-kept", SP_B, SP_BUCKETS, D, 1, 1.0),
    ("oov-spread", SP_B, SP_BUCKETS, D, SP_BUCKETS, 0.3),
    ("row-overrides", 2 * SP_B, 2 * SP_B, D, "perm", 1.0),
    ("ctr-tokens", 7 * CTR_B, 330_000, CTR_D, 3, 0.9),
    ("dcnv2-tokens", 7 * CTR_B, 330_000, 16, 330_000, 0.9),
    ("first-order-D1", 7 * CTR_B, 330_000, 1, 40, 1.0),
    ("tags-seq", 16 * CTR_B, 1000, CTR_D, "pads", 0.47),
    ("tags-seq-D1", 16 * CTR_B, 1000, 1, "pads", 0.47),
    ("D100", 3000, 500, 100, 50, 0.8),
    ("ragged31", 31, 8, 2, 8, 1.0),
    ("empty", 0, 16, 4, 1, 1.0),
]
EMBED_GRAD_TOL = 1e-5


def embed_grad_inputs(n, n_rows, d, high, p_live, seed, integer, ids_dtype=torch.int64):
    gen = torch_generator(seed, DEVICE)
    if high == "perm":
        ids = torch.randperm(n, generator=gen, device=DEVICE)
    else:
        ids = torch.randint(1 if high == "pads" else 0, n_rows if high == "pads" else high,
                            (n,), generator=gen, device=DEVICE)
    live = torch.rand(n, generator=gen, device=DEVICE) < p_live
    if high == "pads":
        ids = torch.where(live, ids, 0)
    if integer:
        g = torch.randint(-8, 9, (n, d), generator=gen, device=DEVICE).float()
    else:
        g = torch.randn((n, d), generator=gen, device=DEVICE)
    return g, ids.to(ids_dtype), live, n_rows


def embed_grad_cases():
    """The gathers' backward kernel (`csrc/embed_grad.cu`) against its plain
    version on the card: bit for bit on integer-valued cotangents (int64
    and int32 ids), to EMBED_GRAD_TOL relative to max(1, the plain
    result's largest magnitude) on random ones, and against a repeat run
    bit for bit. → the largest relative error."""
    worst = 0.0
    for i, (name, n, n_rows, d, high, p_live) in enumerate(EMBED_GRAD_CASES):
        for integer in (True, False):
            for ids_dtype in ((torch.int64, torch.int32) if integer else (torch.int64,)):
                g, ids, live, rows = embed_grad_inputs(n, n_rows, d, high, p_live,
                                                       SEED + 1300 + i, integer, ids_dtype)
                got = embed_grad.scatter_rows_kernel(g, ids, rows, live)
                again = embed_grad.scatter_rows_kernel(g, ids, rows, live)
                sync()
                want = embed_grad.scatter_rows_plain(g, ids, rows, live)
                require(got.shape == want.shape == (rows, d), f"embed_grad {name}: shape")
                require(torch.equal(got, again), f"embed_grad {name}: a repeat gave other bits")
                if integer:
                    require(torch.equal(got, want),
                            f"embed_grad {name} ({ids_dtype}): differs from the plain version")
                else:
                    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
                    err = float((got - want).abs().max()) / scale if want.numel() else 0.0
                    worst = max(worst, err)
                    require(err <= EMBED_GRAD_TOL, f"embed_grad {name}: relative error {err}")
        log(f"embed_grad check {name}: n={n} rows={n_rows} D={d} ids<{high} kept {p_live}: "
            "exact on integers (int64 and int32 ids), a repeat the same bits")
    return worst


def embed_grad_timing(err):
    """The kernel at the device epoch's bucket gathers (8,192 rows into
    1,024 x 64: ids spread over the buckets and kept, as in the OOV
    sub-epoch) beside its bound (the cotangent and ids read once, the
    touched rows written once), its plain version and the library call
    (`embedding_dense_backward`, torch.nn.functional.embedding's
    backward). A call's time, host included, and the device time a call
    from a profile."""
    g, ids, live, rows = embed_grad_inputs(SP_B, SP_BUCKETS, D, SP_BUCKETS, 1.0, SEED + 1400,
                                           False)
    kernel = lambda: embed_grad.scatter_rows_kernel(g, ids, rows, live)  # noqa: E731
    plain = lambda: embed_grad.scatter_rows_plain(g, ids, rows, live)  # noqa: E731
    library = lambda: torch.ops.aten.embedding_dense_backward(  # noqa: E731
        g, ids, rows, -1, False)
    ms, plain_ms, library_ms = (time_ms(f, [()], 50) for f in (kernel, plain, library))
    touched = int(torch.unique(ids[live]).numel())
    nbytes = SP_B * D * 4 + SP_B * 8 + touched * D * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = SP_B * D / PEAK_F32_FLOPS * 1e3
    _, busy = profiled(lambda: [kernel() for _ in range(20)],
                       "profile 20 calls of the gathers' backward kernel", quiet=True)
    log(f"embed_grad timing {SP_B} rows into {rows}x{D} ({touched} rows touched): "
        f"kernel_ms={ms:.4f} ({busy / 20:.4f} ms of device time a call) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (embedding_dense_backward) bound_ms={max(t_bytes, t_ops):.5f} "
        f"({'bytes' if t_bytes > t_ops else 'operations'}; {nbytes / 1e6:.2f} MB)")
    return {
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
        "device_ms": busy / 20,
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
         "sparse_update_impl": impl, "host_scan_steps": 1}
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


def eager_steps(trainer):
    """`trainer` with its dense steps run eagerly, uncaptured: for the
    phases that count a kernel's launches a step, swap a kernel's route
    between steps of one trainer, or time the eager step against the
    numbers recorded for it (a replayed graph runs no wrapper and keeps
    the route it was captured with). → trainer."""
    trainer.step_graphs.step = lambda batch, trainable=None: trainer._apply_step(
        batch, trainable)
    return trainer


def recorded_run(trainer, loader):
    """One epoch of `trainer` over `loader` (no OOV sub-epoch) with every
    step's gradients kept: the tables' (ids, row gradients) on the sparse
    path, the dense gradients otherwise. → (losses, parameters, gradient of
    element (name, flat index) at each step). A dense device-epoch step
    runs eagerly here: a replayed CUDA graph runs no Python, so it could
    not hand each step's gradients over."""
    from oovrec_tpu_torch.train import trainer as trainer_mod

    tables_seen, rest_seen = {}, []
    update = trainer_mod.sparse_adam_update_table

    def recording_update(table, state, ids, grows, *a, **k):
        name = next(n for n, p in trainer.params.items() if p is table)
        tables_seen.setdefault(name, []).append((ids.clone(), grows.clone()))
        return update(table, state, ids, grows, *a, **k)

    trainer_mod.sparse_adam_update_table = recording_update
    try:
        step = trainer.optimizer.step

        def recording_step(params, g, state, trainable=None, **kw):
            rest_seen.append({n: t.detach().clone() for n, t in g.items()})
            return step(params, g, state, trainable, **kw)

        trainer.optimizer.step = recording_step
        eager_steps(trainer)._train_epoch(loader, 0)
    finally:
        trainer_mod.sparse_adam_update_table = update

    def grad(n, i):
        if n in tables_seen:
            r, c = divmod(i, trainer.params[n].shape[1])
            return torch.stack([g[ids == r, c].sum() for ids, g in tables_seen[n]])
        return torch.stack([g[n].flatten()[i] for g in rest_seen])

    return trainer.last_losses, {n: p.detach() for n, p in trainer.params.items()}, grad


def _skip_backward(g, ids, n_rows, live=None):
    """The kernel's plain version on the card: `embedding_dense_backward`
    with the discarded rows sent to a padding row that it skips."""
    return embed_grad.scatter_rows_plain(g, ids, n_rows, live)


def _embedding_backward(g, ids, n_rows, live=None):
    """`torch.nn.functional.embedding`'s backward over every row."""
    return torch.ops.aten.embedding_dense_backward(g, ids.long(), n_rows, -1, False)


def _index_backward(g, ids, n_rows, live=None):
    """torch's indexing backward over every row (`index_put_` with
    accumulate), the port's gathers' backward before `csrc/embed_grad.cu`."""
    return g.new_zeros((n_rows, g.shape[-1])).index_put_((ids.long(),), g, accumulate=True)


# D4's backward routes of the row gathers: the port's (the kernel) and the
# three it was measured against, each patched in for `embed_grad.scatter_rows`
BACKWARD_ROUTES = {"kernel": embed_grad.scatter_rows, "skip": _skip_backward,
                   "embedding": _embedding_backward, "index": _index_backward}


@contextlib.contextmanager
def backward_route(route):
    """Run the block with `ops/embed_grad.py`'s backward replaced by the
    route `route` of BACKWARD_ROUTES."""
    old, old_name = embed_grad.scatter_rows, backward_route.name
    embed_grad.scatter_rows, backward_route.name = BACKWARD_ROUTES[route], route
    try:
        yield
    finally:
        embed_grad.scatter_rows, backward_route.name = old, old_name


backward_route.name = "kernel"


def gather_backward_ms():
    """D4: the row gathers' backward (`ops/embed_grad.py`) at the device
    epoch's shape: SP_B rows of the (SP_BUCKETS, D) bucket table under each
    of its routes, with ids all 0 and every row thrown away (an IV row's
    placeholder bucket, as branchless routing makes it) and with ids spread
    and every row kept; each twice on the same random cotangents: the same
    bits. The bound: the cotangent and ids read once, the touched rows
    written once. → {route: {case: {call_ms, device_ms}}} and the bound of
    each case in ms."""
    table = torch.zeros((SP_BUCKETS, D), device=DEVICE, requires_grad=True)
    gen = torch_generator(SEED, DEVICE)
    grad = torch.randn((SP_B, D), device=DEVICE, generator=gen)
    spread = torch.randint(0, SP_BUCKETS, (SP_B,), device=DEVICE, generator=gen)
    cases = {
        "all 0, discarded": (torch.zeros_like(spread),
                             torch.zeros(SP_B, dtype=torch.bool, device=DEVICE)),
        "spread, kept": (spread, torch.ones(SP_B, dtype=torch.bool, device=DEVICE)),
    }

    def bwd(ids, live):
        return torch.autograd.grad(embed_grad.gather_rows(table, ids, live), table, grad)[0]

    bound = {}
    for case, (ids, live) in cases.items():
        touched = int(torch.unique(ids[live]).numel())
        bound[case] = (SP_B * D * 4 + SP_B * 8 + touched * D * 4) / PEAK_BYTES_PER_S * 1e3
    out = {}
    for route in BACKWARD_ROUTES:
        out[route] = {}
        with backward_route(route):
            for case, (ids, live) in cases.items():
                first, again = bwd(ids, live), bwd(ids, live)
                require(torch.equal(first, again), f"{route} backward, ids {case}: a repeat "
                        "gave other bits")
                call_ms = time_ms(bwd, [(ids, live)], 20)
                profiled(lambda: [bwd(ids, live) for _ in range(20)],
                         f"profile 20 backward calls, {route} route, ids {case}", quiet=True)
                out[route][case] = {"call_ms": call_ms, "device_ms": profiled.gathers_ms / 20}
        log(f"gathers' backward, {route} route, {SP_B} rows into a ({SP_BUCKETS}, {D}) table: "
            + ", ".join(f"ids {c} {v['call_ms']:.4f} ms a call, {v['device_ms']:.4f} ms of "
                        "device time" for c, v in out[route].items())
            + " (a repeat: the same bits)")
    log("gathers' backward bound: " + ", ".join(f"ids {c} {v:.5f} ms" for c, v in bound.items()))
    return out, bound


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
    embed_grad.scatter_rows_kernel.launches = 0
    sync()
    trainer, seen = sparse_fit(loader, "auto")
    launches = sparse_adam_rows_kernel.launches
    gather_launches = embed_grad.scatter_rows_kernel.launches
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
    # the gathers' backward: the 3 bucket gathers (the IV row overrides are
    # read as slices of the gathered rows, without a gather)
    require(gather_launches == 3 * ran,
            f"gathers' backward kernel launches {gather_launches} for {ran} steps")
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
    la, pa, ga = recorded_run(Trainer(sparse_cfg("auto", train_oov=False), sparse_model()),
                              part_loader)
    lb, pb, gb = recorded_run(Trainer(sparse_cfg("dense", train_oov=False), sparse_model()),
                              part_loader)
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
    # D4: the same steps under each backward route of the gathers
    routes = {}
    for route in BACKWARD_ROUTES:
        with backward_route(route):
            de.run(4)
            sync()
            t0 = time.perf_counter()
            de.run(5)
            sync()
            step_ms = (time.perf_counter() - t0) * 1e3 / de.n_steps
            _, busy = profiled(lambda: de.run(6), f"profile {de.n_steps} device-epoch steps, "
                               f"gathers' backward route {route}")
            routes[route] = {"step_ms": step_ms, "device_ms": busy / de.n_steps,
                             "gathers_ms": profiled.gathers_ms / de.n_steps}
        log(f"device-epoch step, {route} route: {step_ms:.3f} ms a step (wall), "
            f"{routes[route]['device_ms']:.3f} ms of device time, the gathers' backward "
            f"{routes[route]['gathers_ms']:.3f} ms "
            f"({100 * routes[route]['gathers_ms'] / routes[route]['device_ms']:.1f} %)")
    GATHER_RESULTS["device_epoch"] = routes
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        de.run(3)
    torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    log(f"host syncs in a {de.n_steps}-step device epoch: {len(syncs)} {sorted(set(syncs))[:4]}")
    del trainer, de
    # the host per-batch path at the same shape: the row-sparse step
    # (`Trainer._sparse_step`, kernel 6) and the dense lazy-Adam sweep, each
    # warmed by an epoch, then timed an epoch at a time in the order
    # sparse, dense, dense, sparse
    hosts = {impl: eager_steps(Trainer(sparse_cfg(impl, device_epoch=False, train_oov=False),
                                       sparse_model())) for impl in ("auto", "dense")}
    host_ms = {impl: [] for impl in hosts}
    for impl, host in hosts.items():
        require(bool(host.sparse_tables) == (impl == "auto"), f"host path {impl}: sparse tables")
        host._train_epoch(short_loader, 0)
    for epoch, impl in enumerate(("auto", "dense", "dense", "auto"), 1):
        sync()
        t0 = time.perf_counter()
        hosts[impl]._train_epoch(short_loader, epoch)
        sync()
        host_ms[impl].append((time.perf_counter() - t0) * 1e3 / len(short_loader))
    require(not any(h._device_epochs for h in hosts.values()),
            "the host path took the device epoch")
    del hosts
    log("host per-batch path, same shape, ms per step (wall, host included): "
        f"{', '.join(f'{t:.2f}' for t in host_ms['auto'])} with the row-sparse step (kernel 6), "
        f"{', '.join(f'{t:.2f}' for t in host_ms['dense'])} with the dense lazy-Adam sweep "
        "(run in the order sparse, dense, dense, sparse)")
    return launches, gather_launches


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


CIN_WRAPPERS = ("cin_layer_pooled", "cin_layer", "cin_layer_pooled_bwd", "cin_layer_bwd")


def cin_counts():
    return {k: launches.WRAPPERS[k].launches for k in CIN_WRAPPERS}


def reset_cin_counts():
    for k in CIN_WRAPPERS:
        launches.WRAPPERS[k].launches = 0


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



# ------------------------------------------------- phase D, the embedders

# the embedders at the models' published widths: BPR at embedding_size 64
# (BPR.yaml), DHE at dhe_num_hashes 128 and dhe_layer_size 512
# (config/defaults.yaml:115-116), xDeepFM at xDeepFM.yaml. D1 is the
# paper's reproduce command (EXPERIMENTS.md:40-45: lsh, the *_vector
# columns, 200 buckets a side, OOV ratio 0.3, the inductive eval), cut to
# CLI_EPOCHS_A epochs as phase A is. Key files come from the seed, under
# build/ (without a file DHEHasher would draw random keys)
SYNTH_VEC_LOAD_COL = ("--load_col={'inter': ['user_id','item_id','timestamp','is_new'], "
                      "'user': ['user_id','age','group','user_vector'], "
                      "'item': ['item_id','price','category','item_vector']}")
EXPERIMENTS_FLAGS = ["--model=BPR", "--dataset=synth-ind", "--data_path=dataset",
                     SYNTH_VEC_LOAD_COL, "--inductive_embedder=lsh", "--add_oov_buckets=True",
                     "--n_user_oov_buckets=200", "--n_item_oov_buckets=200", "--train_oov=True",
                     "--oov_train_ratio=0.3", "--inductive_eval=True"]
D_EMBEDDERS = (("slsh", []), ("dnn", []), ("knn", []), ("dhe", []),
               ("fdhe", ["--dhe_num_hashes=32"]))  # EXPERIMENTS.md:20
D_KEYS = os.path.join("build", "hash_keys")
D_HASHES, D_LAYER, D_FEATS = 128, 512, 6
D_HASH_CHUNK, D_HASH_THREADS = 1024, 8
D_LSH_STEPS = 8


def kernel_counts():
    """Every kernel wrapper's launch count (`ops/launches.py`)."""
    return launches.launch_counts()


def reset_kernel_counts():
    launches.reset_launch_counts()


def write_hash_keys(counts):
    """`<D_KEYS>/<n>.hashes` for each n: n SipHash keys drawn from the seed,
    hex-encoded, the reference's format."""
    os.makedirs(D_KEYS, exist_ok=True)
    for n in counts:
        rng = np.random.default_rng(SEED + n)
        with open(os.path.join(D_KEYS, f"{n}.hashes"), "w") as f:
            json.dump([rng.bytes(16).hex() for _ in range(n)], f)


def slices_finite(slices, what):
    """All 7 slices, each with finite metrics where it has rows (synth-ind's
    inductive test rows all touch a new user or item, so old_old has none);
    one line of them."""
    require(tuple(slices) == SLICE_NAMES, f"{what}: slices {list(slices)}")
    require(all(slices[name] for name in ("overall", "old_users", "new_users")),
            f"{what}: an empty user slice")
    for name, r in slices.items():
        if r:
            finite_metrics(r, f"{what} [{name}]")
    log(f"[{what}] recall@20 / ndcg@20 by slice: " + ", ".join(
        f"{name} {r['recall@20']:.4f} / {r['ndcg@20']:.4f}" if r else f"{name} (no rows)"
        for name, r in slices.items()))


def d1_embedders():
    """D1: the paper's reproduce command (lsh) through `python -m
    oovrec_tpu_torch.cli.run` as a subprocess on dataset/synth-ind, its
    `--eval_only` equal to the run to 1e-9 (the planes come back from the
    checkpoint); then the same command in this process through
    `cli.run.main` with slsh, dnn, knn, dhe and fdhe (32 hashes). Each run's
    test metrics and 7 slices finite, its wall logged. → {} (no count
    reset)."""
    write_hash_keys((32, D_HASHES))
    common = [f"--epochs={CLI_EPOCHS_A}", f"--hash_key_dir={D_KEYS}"]
    out = cli_out("d1-lsh")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "oovrec_tpu_torch.cli.run", *EXPERIMENTS_FLAGS,
                           *common, *cli_flags(out)], capture_output=True, text=True, timeout=600)
    walls = {"lsh": time.perf_counter() - t0}
    lines = (proc.stdout + proc.stderr).splitlines()
    for line in lines:
        if "training [" in line or "test result" in line:
            log(f"  [D1 lsh] {line.split(' INFO ')[-1][:160]}")
    require(proc.returncode == 0, f"D1 lsh: rc {proc.returncode}: " + "\n".join(lines[-30:]))
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    finite_metrics(res["test_result"], "D1 lsh test")
    slices_finite(res["inductive"], "D1 lsh")
    log(f"D1: python -m oovrec_tpu_torch.cli.run, EXPERIMENTS.md:40-45 (lsh, {CLI_EPOCHS_A} "
        f"epochs) rc 0 in {walls['lsh']:.1f} s (wall, process start and the corpus included)")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'BPR-synth-ind.pth')}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "D1 lsh eval_only test", tol=1e-9)
    agree_slices(res["inductive"], again["inductive_results"], "D1 lsh eval_only slices",
                 tol=1e-9)
    log("D1: lsh --eval_only == the run on test metrics and the 7 slices (1e-9)")
    for emb, extra in D_EMBEDDERS:
        out = cli_out(f"d1-{emb}")
        argv = [a.replace("=lsh", f"={emb}") for a in EXPERIMENTS_FLAGS]
        sync()
        t0 = time.perf_counter()
        res = cli_run.main([*argv, *common, *cli_flags(out), *extra])
        sync()
        walls[emb] = time.perf_counter() - t0
        require(res["trainer"].model.spec.embedder == emb, f"D1 {emb}: the embedder")
        finite_metrics(res["test_result"], f"D1 {emb} test")
        slices_finite(res["inductive_results"], f"D1 {emb}")
        log(f"D1: cli.run.main with {emb} {' '.join(extra)}: {walls[emb]:.1f} s (wall)")
    return {}


def d2_ranking_lsh():
    """D2: the ranking track with lsh (the SKILL.md ranking command on
    xDeepFM, WideDeep not being ported) through `cli.run.main` on synth-ind,
    CLI_EPOCHS_B epochs, the CIN kernels counted. → {} (no count reset)."""
    out = cli_out("d2")
    argv = ["--model=xDeepFM", "--model_eval_type=ranking", *EXPERIMENTS_FLAGS[1:],
            "--numerical_features=['age','price']", f"--epochs={CLI_EPOCHS_B}", *cli_flags(out)]
    reset_cin_counts()
    sync()
    t0 = time.perf_counter()
    res = cli_run.main(argv)
    sync()
    wall = time.perf_counter() - t0
    counts = cin_counts()
    require(res["trainer"].model.spec.embedder == "lsh", "D2: the embedder")
    require(counts["cin_layer_pooled"] > 0 and counts["cin_layer_pooled_bwd"] > 0,
            f"D2: the CIN kernels were not launched: {counts}")
    finite_metrics(res["test_result"], "D2 test")
    require(tuple(res["inductive_results"]) == SLICE_NAMES, "D2 slices")
    finite_metrics(res["inductive_results"]["overall"], "D2 overall slice")
    log(f"D2: cli.run.main (xDeepFM, lsh, synth-ind, {CLI_EPOCHS_B} epochs, uni250) {wall:.1f} s "
        f"(wall), CIN launches {counts}")
    log(f"[D2 test] {dict(res['test_result'])}")
    for name, r in res["inductive_results"].items():
        log(f"[D2 {name}] {dict(r)}")
    return {}


def hashes_match_host(codes, keys):
    """The card's DHE codes of ids 0..n-1 against the numpy hasher
    (`ops/siphash.py`), chunk by chunk on D_HASH_THREADS threads. → the
    number of chunks that differ."""
    from concurrent.futures import ThreadPoolExecutor

    got = codes.cpu().numpy()
    n = got.shape[0]

    def differs(a):
        ids = np.arange(a, min(a + D_HASH_CHUNK, n), dtype=np.uint64)
        want = (siphash24_batch(ids, keys) % np.uint64(MAX_HASH)).astype(np.float32)
        return not np.array_equal(got[a:a + len(ids)], want)

    with ThreadPoolExecutor(D_HASH_THREADS) as pool:
        return sum(pool.map(differs, range(0, n, D_HASH_CHUNK)))


def dhe_cfg(fused, n_items):
    c = serving_cfg(fused, n_items)
    c["dhe_on_device"] = True
    c["hash_key_dir"] = D_KEYS
    return c


def d3_fdhe_serving():
    """D3: fdhe serving at the serving phase's scale (1,000,000 items, D 64,
    128 hashes, towers of 512): synthetic unit features from the seed, the
    1M item ids hashed on the card (`dhe_codes_device`) equal to the numpy
    hasher bit for bit, the tower pass over all items, then the 7-slice eval
    fused vs dense to 1e-9. → kernel 1's launches on the fused run."""
    write_hash_keys((D_HASHES,))
    keys = DHEHasher(D_HASHES, D_KEYS).keys
    rng = np.random.default_rng(SEED + 90)
    n_users, n_items = N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS

    def unit_rows(n):
        m = rng.standard_normal((n, D_FEATS)).astype(np.float32)
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    state = {"user_feat_mat": unit_rows(n_users), "item_feat_mat": unit_rows(n_items),
             "dhe_keys": keys}
    spec = InductiveSpec(embedder="fdhe", dhe_num_hashes=D_HASHES, dhe_layer_size=D_LAYER,
                         embedding_size=D)
    model = BPR(N_OLD_USERS, N_OLD_ITEMS, D, spec, device=DEVICE,
                generator=torch_generator(SEED + 91, DEVICE), embedder_state=state)
    model.eval()
    ids = torch.arange(n_items, device=DEVICE)
    key_t = model.embedder_state["dhe_keys"]
    hash_ms = time_ms(lambda: dhe_codes_device(ids, key_t), [()], 5)
    t0 = time.perf_counter()
    bad = hashes_match_host(dhe_codes_device(ids, key_t), keys)
    log(f"D3: {n_items} item ids x {D_HASHES} keys hashed on the card in {hash_ms:.3f} ms; "
        f"the numpy hasher's check took {time.perf_counter() - t0:.1f} s")
    require(bad == 0, f"D3: {bad} chunks of card hashes differ from the numpy hasher")
    with torch.no_grad():
        tower_ms = time_ms(lambda: model.all_item_embeddings(ids, item_dhe_ids=ids), [()], 3)
        item_e = model.all_item_embeddings(ids, item_dhe_ids=ids)
    require(item_e.shape == (n_items, D) and bool(torch.isfinite(item_e).all()),
            "D3: tower pass output")
    log(f"D3: card hashes == numpy hasher on all {n_items} ids (bit for bit); the fdhe item "
        f"pass over {n_items} items (hashes, features, towers {D_HASHES}+{D_FEATS} -> {D_LAYER} "
        f"x3 -> {D}): {tower_ms:.3f} ms")
    del item_e
    t0 = time.perf_counter()
    ind_splits, _ = synth_interactions(model, None)
    log(f"D3 data: {len(ind_splits[1])} test positives, {time.perf_counter() - t0:.1f} s")
    launches = seven_slices_fused_vs_dense(model, None, ind_splits, dhe_cfg,
                                           what="D3 fdhe 7-slice eval")
    return {"fused_topk_scores": launches}


def lsh_device_epoch():
    """D4: BPR with lsh (SP_BUCKETS hash bits a side over synthetic unit
    features) on the device epoch with `learner: sparse_adam`: D_LSH_STEPS
    steps of SP_B rows plus the OOV sub-epoch under `sparse_update_impl`
    auto (kernel 6) and xla, the same bits. → the auto run's kernel 6
    launches."""
    rng = np.random.default_rng(SEED + 95)
    users, items = structured_pairs(rng, D_LSH_STEPS * SP_B)
    split = DatasetSplit({"user_id": users, "item_id": items}, SP_USERS, SP_ITEMS)
    sampler = Sampler(["train"], [split], seed=SEED)
    loader = TrainBatcher(split, sampler, sparse_cfg("auto"), InputType.PAIRWISE)
    state = {}
    for side, n in (("user", SP_USERS), ("item", SP_ITEMS)):
        m = rng.standard_normal((n, D_FEATS)).astype(np.float32)
        state[f"{side}_feat_mat"] = m / np.linalg.norm(m, axis=1, keepdims=True)
        state[f"{side}_planes"] = rng.standard_normal((SP_BUCKETS, D_FEATS)).astype(np.float32)
    spec = InductiveSpec(embedder="lsh", add_oov_buckets=True, n_user_buckets=SP_BUCKETS,
                         n_item_buckets=SP_BUCKETS)
    runs, launches, gathers = {}, {}, {}
    for impl in ("auto", "xla"):
        # every OOV step kept, so the sub-epoch surely runs lsh's flagged rows
        trainer = Trainer(sparse_cfg(impl, oov_train_ratio=1.0), BPR(
            SP_USERS, SP_ITEMS, D, spec, device=DEVICE,
            generator=torch_generator(SEED + 40, DEVICE), embedder_state=state))
        sparse_adam_rows_kernel.launches = 0
        embed_grad.scatter_rows_kernel.launches = 0
        sync()
        t0 = time.perf_counter()
        trainer.fit(loader, None, saved=False)
        sync()
        wall = time.perf_counter() - t0
        launches[impl] = sparse_adam_rows_kernel.launches
        gathers[impl] = embed_grad.scatter_rows_kernel.launches
        des = list(trainer._device_epochs.values())
        require(len(des) == 2 and all(d.sparse_impl == ("xla" if impl == "xla" else "pallas")
                                      for d in des), f"D4 lsh {impl}: the sparse device epoch")
        require(trainer.oov_loss_dict and math.isfinite(trainer.oov_loss_dict[0]),
                f"D4 lsh {impl}: the OOV sub-epoch")
        runs[impl] = state_of(trainer)
        log(f"D4 lsh on the device epoch ({impl}): {D_LSH_STEPS} + {des[1].steps_run} OOV "
            f"steps in {wall:.2f} s (wall, set-up included), kernel 6 launches {launches[impl]}")
        del trainer, des
    same = [n for n in runs["auto"] if torch.equal(runs["auto"][n], runs["xla"][n])]
    require(len(same) == len(runs["auto"]), "D4 lsh: auto and xla differ")
    require(launches["auto"] > 0 and launches["xla"] == 0, f"D4 lsh: kernel 6 {launches}")
    # lsh reads its bucket table through a product and the IV rows as
    # slices of the gathered rows: no row gather has a backward here
    require(gathers["auto"] == 0, f"D4 lsh: gathers' backward launches {gathers}")
    log(f"D4 lsh: auto == xla bit for bit ({len(same)} parameters and moments)")
    return {"sparse_adam_rows_kernel": launches["auto"]}


# ---------------------------------------------------------------- phase E
#
# The paper's other three models at their published widths (the port's
# copies of oovrec_tpu/config/model/{WideDeep,DCNV2,DirectAU}.yaml):
# WideDeep (embedding 10, MLP 32/16/8, dropout 0.1), DCNv2 (embedding 16, 3
# cross layers, MLP 768/768 with BatchNorm, dropout 0.2, reg_weight 2; mixed:
# 4 experts of rank 128) and DirectAU (embedding 64, gamma 1).

E_EPOCHS_RANK = 3  # EXPERIMENTS.md:79 runs 8 epochs; cut as phase B is
E_EPOCHS_CLI = 2
E_BN_ROWS = 64
E_TAGS_VOCAB, E_TAGS_LEN, E_TAGS_STEPS = 1000, 16, 16
E_DAU_STEPS, E_DAU_B = 64, 2048
E_DCNV2 = (("stacked", []), ("parallel", ["--structure=parallel"]), ("mixed", ["--mixed=True"]),
           ("stacked-worker2", ["--worker=2"]))
E3_MODELS = (("WideDeep", "WideDeep", {}), ("DCNV2", "DCNV2", {}),
             ("DCNV2-mixed", "DCNV2", {"mixed": True}))


def published(model):
    """(the constructor's hyper-parameters from the model file, its
    embedding_size), as `cli/quick_start.py:build_model_and_state` takes
    them."""
    cfg = Config({"model": model})
    return quick_start.model_kwargs(cfg, get_model_class(model)), int(cfg["embedding_size"])


def bn_stats(model):
    """The BatchNorm running statistics of `model`, by state_dict name."""
    return {k: v for k, v in model.state_dict().items()
            if ".BatchNorm_" in k and k.endswith((".mean", ".var"))}


def require_trained_stats(model, what):
    """DCNv2's running statistics moved off their initial values (mean 0,
    var 1) in every BatchNorm."""
    stats = bn_stats(model)
    require(len(stats) == 4, f"{what}: BatchNorm statistics {sorted(stats)}")
    for k, v in stats.items():
        start = 0.0 if k.endswith(".mean") else 1.0
        require(bool(torch.isfinite(v).all()) and float((v - start).abs().max()) > 1e-3,
                f"{what}: {k} did not move from {start}")


def value_slices_finite(slices, what):
    """The 7 value slices: RMSE finite in every slice with rows, AUC in
    the overall slice (a one-label slice's AUC is NaN); one line of them."""
    require(tuple(slices) == SLICE_NAMES, f"{what}: slices {list(slices)}")
    require(slices["overall"] and math.isfinite(slices["overall"]["auc"]),
            f"{what}: overall slice {slices['overall']}")
    for name, r in slices.items():
        if r:
            require(math.isfinite(r["rmse"]), f"{what} [{name}]: {r}")
    log(f"[{what}] auc / rmse by slice: " + ", ".join(
        f"{name} {r['auc']:.4f} / {r['rmse']:.4f}" if r else f"{name} (no rows)"
        for name, r in slices.items()))


def e1_ranking_track():
    """E1: EXPERIMENTS.md:79, the paper's ranking track (the lsh command of
    D1 with --model=WideDeep --model_eval_type=ranking), through `python -m
    oovrec_tpu_torch.cli.run` as a subprocess on dataset/synth-ind: the
    training loss falls, the 7 slices are finite, `--eval_only` reproduces
    them to 1e-9; then the same command through `cli.run.main` in this
    process, where the gathers' backward is counted. → {} (no reset)."""
    argv = ["--model=WideDeep", "--model_eval_type=ranking", *EXPERIMENTS_FLAGS[1:],
            f"--epochs={E_EPOCHS_RANK}"]
    out = cli_out("e1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "oovrec_tpu_torch.cli.run", *argv,
                           *cli_flags(out)], capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = (proc.stdout + proc.stderr).splitlines()
    losses = []
    for line in lines:
        if "training [" in line or "test result" in line:
            log(f"  [E1] {line.split(' INFO ')[-1][:160]}")
        if "train loss: " in line:
            losses.append(float(line.split("train loss: ")[1].split(",")[0].rstrip("]")))
    require(proc.returncode == 0, f"E1: rc {proc.returncode}: " + "\n".join(lines[-30:]))
    require(len(losses) == E_EPOCHS_RANK and all(map(math.isfinite, losses))
            and losses[-1] < losses[0], f"E1: epoch losses {losses}")
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    finite_metrics(res["test_result"], "E1 test")
    value_slices_finite(res["inductive"], "E1 WideDeep lsh")
    log(f"E1: python -m oovrec_tpu_torch.cli.run, EXPERIMENTS.md:79 (WideDeep, lsh, "
        f"{E_EPOCHS_RANK} epochs) rc 0 in {wall:.1f} s (wall, process start and the corpus "
        f"included), epoch losses {[round(x, 4) for x in losses]}")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'WideDeep-synth-ind.pth')}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "E1 eval_only test", tol=1e-9)
    agree_slices(res["inductive"], again["inductive_results"], "E1 eval_only slices", tol=1e-9)
    log("E1: --eval_only == the run on AUC, RMSE and the 7 slices (1e-9)")
    sync()
    t0 = time.perf_counter()
    res = cli_run.main([*argv, *cli_flags(cli_out("e1-in-process"))])
    sync()
    require(type(res["trainer"].model).__name__ == "WideDeep", "E1: the model")
    value_slices_finite(res["inductive_results"], "E1 in-process")
    log(f"E1: the same command through cli.run.main: {time.perf_counter() - t0:.1f} s (wall)")
    return {}


def e2_dcnv2():
    """E2: DCNv2 through `cli.run.main` on synth-ind, the random mapper and
    the OOV regime, E_EPOCHS_CLI epochs each: stacked, parallel and with
    mixed experts, each `--eval_only` equal to its run to 1e-9 (the running
    statistics come back from the checkpoint) and its statistics moved;
    stacked again at `--worker=2` equal to `worker: 0` to 1e-9. → {}."""
    base = ["--model=DCNV2", "--model_eval_type=ranking", "--dataset=synth-ind",
            "--data_path=dataset", SYNTH_LOAD_COL, *CLI_OOV, f"--epochs={E_EPOCHS_CLI}"]
    runs = {}
    for tag, extra in E_DCNV2:
        out = cli_out(f"e2-{tag}")
        sync()
        t0 = time.perf_counter()
        res = runs[tag] = cli_run.main([*base, *extra, *cli_flags(out)])
        sync()
        wall = time.perf_counter() - t0
        model = res["trainer"].model
        require((model.structure, model.mixed) == ("parallel" if tag == "parallel" else "stacked",
                                                   tag == "mixed"), f"E2 {tag}: the model")
        require(res["config"]["worker"] == (2 if "worker" in tag else 0), f"E2 {tag}: worker")
        finite_metrics(res["test_result"], f"E2 {tag} test")
        value_slices_finite(res["inductive_results"], f"E2 DCNv2 {tag}")
        require_trained_stats(model, f"E2 {tag}")
        log(f"E2: cli.run.main (DCNv2 {tag}, {E_EPOCHS_CLI} epochs) {wall:.1f} s (wall), "
            f"test {dict(res['test_result'])}")
        if "worker" in tag:
            continue
        again = cli_run.main([f"--eval_only={res['trainer'].saved_model_file}",
                              "--inductive_eval=True"])
        agree(res["test_result"], again["test_result"], f"E2 {tag} eval_only test", tol=1e-9)
        agree_slices(res["inductive_results"], again["inductive_results"],
                     f"E2 {tag} eval_only slices", tol=1e-9)
    agree(runs["stacked"]["test_result"], runs["stacked-worker2"]["test_result"],
          "E2 worker 2 vs 0 test", tol=1e-9)
    agree_slices(runs["stacked"]["inductive_results"], runs["stacked-worker2"]["inductive_results"],
                 "E2 worker 2 vs 0 slices", tol=1e-9)
    log("E2: each --eval_only == its run (1e-9); the running statistics moved; stacked at "
        "--worker=2 == --worker=0 on the test metrics and the 7 slices (1e-9)")
    return {}


def e_ranking_model(name, seed, fields=None, **over):
    """A ranking model at its published widths over the CTR fields, with
    phase 4's random-mapper buckets."""
    kw, emb = published(name)
    kw.update(over)
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=100,
                         n_item_buckets=100, hash_function="3round")
    return get_model_class(name)(fields or ctr_fields(), embedding_size=emb, spec=spec,
                                 device=DEVICE, generator=torch_generator(seed, DEVICE), **kw)


def e3_train(tag, model, mapper, train, held, held_iv):
    """One model through `Trainer.fit` at the ranking cell's shape: one
    epoch + the frozen OOV sub-epoch, the loss falling, held-out AUC up, IV
    tables unchanged by the frozen sub-epoch, the 7 value slices; then the
    eval-mode BatchNorm check: E_BN_ROWS rows scored alone equal to the
    same rows inside a batch of CTR_B (1e-6)."""
    cfg = ctr_train_cfg()
    auc0 = EvalRunner(model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))["auc"]
    trainer = eager_steps(Trainer(cfg, model))
    loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
    iv_names = [n for n in trainer.params if n not in trainer.oov_params]
    inner, seen = trainer._train_epoch, {}

    def watched(ldr, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        stats = {k: v.clone() for k, v in bn_stats(model).items()}
        total = inner(ldr, epoch_idx, oov_transform, keep_ratio, frozen)
        seen["frozen" if frozen else "normal"] = {
            "losses": trainer.last_losses,
            "moved": {n for n in trainer.params if not torch.equal(before[n], trainer.params[n])},
            "stats_moved": all(not torch.equal(v, bn_stats(model)[k]) for k, v in stats.items())}
        return total

    trainer._train_epoch = watched
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    steps = trainer._global_step
    normal, frozen = seen["normal"], seen["frozen"]
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(frozen["losses"]).all(),
            f"E3 {tag}: loss not finite")
    require(last < first, f"E3 {tag}: loss did not fall: {first} -> {last}")
    require(frozen["moved"] and not frozen["moved"] & set(iv_names),
            f"E3 {tag}: the frozen sub-epoch moved {sorted(frozen['moved'])}")
    if bn_stats(model):
        require(frozen["stats_moved"], f"E3 {tag}: the frozen sub-epoch left the statistics")
        require_trained_stats(model, f"E3 {tag}")
    auc1 = trainer.evaluate(PlainEvalBatcher(held_iv, cfg), load_best_model=False)["auc"]
    log(f"E3 {tag}: {len(loader)} + {steps - len(loader)} frozen OOV steps of {CTR_B} rows, "
        f"{wall / steps * 1e3:.2f} ms per step (wall, host included); loss first tenth "
        f"{first:.5f} last tenth {last:.5f}; held-out IV AUC {auc0:.5f} -> {auc1:.5f}")
    require(auc1 > auc0, f"E3 {tag}: held-out AUC {auc0} -> {auc1}")
    ev = InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper)
    sync()
    t0 = time.perf_counter()
    slices = ev.evaluate_model(PlainEvalBatcher(held, cfg))
    sync()
    log(f"E3 {tag}: 7-slice value eval over {len(held)} rows in {time.perf_counter() - t0:.2f} s")
    for name, r in slices.items():
        require(list(r) == ["auc", "logloss"] and all(math.isfinite(v) for v in r.values()),
                f"E3 {tag} slice {name}: {dict(r)}")
    log(f"[E3 {tag}] " + ", ".join(f"{n} {r['auc']:.4f}" for n, r in slices.items()))
    # eval mode normalises with the running statistics: E_BN_ROWS rows
    # score the same alone (a batch of their own, tiled to the batch's
    # CTR_B rows, so that every product runs the same kernels and only
    # the statistics could tell the two apart) and inside a batch of CTR_B
    model.eval()
    db = to_device_batch(next(iter(PlainEvalBatcher(held_iv, cfg))), DEVICE)
    reps = len(db["weight"]) // E_BN_ROWS
    alone_b = {k: v[:E_BN_ROWS].repeat((reps,) + (1,) * (v.dim() - 1)) for k, v in db.items()}
    few = {k: v[:E_BN_ROWS] for k, v in db.items()}
    with torch.no_grad():
        whole = model.predict(db)[:E_BN_ROWS]
        err = float((model.predict(alone_b)[:E_BN_ROWS] - whole).abs().max())
        small = float((model.predict(few) - whole).abs().max())
        # in train mode (on a copy, without dropout) the batch's own
        # statistics decide
        gen, model.mlp_layers.generator = model.mlp_layers.generator, None
        trained = copy.deepcopy(model)
        model.mlp_layers.generator = gen
        trained.mlp_layers.dropout = 0.0
        gap = float((trained(alone_b, train=True) - trained(db, train=True))[:E_BN_ROWS]
                    .abs().max())
    del trained
    log(f"E3 {tag}: {E_BN_ROWS} rows alone (tiled to {len(db['weight'])}) vs inside a batch of "
        f"{len(db['weight'])}: eval mode max |diff| {err:.3e} (a batch of {E_BN_ROWS}, whose "
        f"products take other kernels: {small:.3e}); train mode (batch statistics) {gap:.3e}")
    require(err <= 1e-6, f"E3 {tag}: eval-mode scores depend on the batch: {err}")
    require(small <= 1e-5, f"E3 {tag}: eval-mode scores of a {E_BN_ROWS}-row batch: {small}")
    if bn_stats(model):
        require(gap > 1e-4, f"E3 {tag}: train-mode scores do not depend on the batch: {gap}")
    return normal


def e3_prefetch(train, models=("WideDeep", "DCNV2")):
    """The batch prefetch (`data/prefetch.py`, `worker` > 0) against the
    loop without it at the ranking cell's shape: one epoch of each model on
    the host path without the OOV regime, run with `worker` 0, 2, 2, 0 on
    one trainer after a warm-up epoch, and the loader's batches assembled
    alone, without training. → {model: {worker: [ms per step]}, "alone":
    ms per batch}."""
    out = {}
    cfg = ctr_train_cfg(train_oov=False)
    for i, name in enumerate(models):
        trainer = eager_steps(Trainer(cfg, e_ranking_model(name, SEED + 330 + i)))
        loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
        trainer._train_epoch(loader, 0)
        out[name] = {0: [], 2: []}
        for epoch, worker in enumerate((0, 2, 2, 0), 1):
            cfg["worker"] = worker
            sync()
            t0 = time.perf_counter()
            trainer._train_epoch(loader, epoch)
            sync()
            out[name][worker].append((time.perf_counter() - t0) * 1e3 / len(loader))
        cfg["worker"] = 0
        log(f"E3 prefetch, {name}: {len(loader)} steps of {CTR_B} rows, ms per step (wall, host "
            f"included) at worker 0: {', '.join(f'{t:.3f}' for t in out[name][0])}; at worker "
            f"2: {', '.join(f'{t:.3f}' for t in out[name][2])} (run in the order 0, 2, 2, 0)")
        del trainer
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    out["alone"] = (time.perf_counter() - t0) * 1e3 / n
    log(f"E3 prefetch: the loader alone assembles a batch of {CTR_B} rows in "
        f"{out['alone']:.3f} ms (host)")
    return out


def e3_tags_step_launches(fields, item_feat, train, seed):
    """WideDeep over `fields`, E_TAGS_STEPS steps of CTR_B rows without the
    OOV regime. → (losses, the gathers' backward launches)."""
    rows = rows_of(train, np.arange(len(train)) < E_TAGS_STEPS * CTR_B,
                   N_CTR_OLD_USERS, N_CTR_OLD_ITEMS)
    rows = DatasetSplit(rows.inter, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS,
                        user_feat=rows.user_feat, item_feat=item_feat)
    cfg = ctr_train_cfg(train_oov=False)
    trainer = eager_steps(Trainer(cfg, e_ranking_model("WideDeep", seed, fields)))
    loader = TrainBatcher(rows, None, cfg, InputType.POINTWISE)
    require(len(loader) == E_TAGS_STEPS, f"E3 tags: {len(loader)} steps")
    embed_grad.scatter_rows_kernel.launches = 0
    trainer.fit(loader, None, saved=False)
    return trainer.last_losses, embed_grad.scatter_rows_kernel.launches


def e3_ranking(ind, mapper):
    """E3: WideDeep, DCNv2 stacked and DCNv2 mixed at the ranking cell's
    shape (phase 4's rows and fields), each through `e3_train`; the batch
    prefetch timed against the loop without it (`e3_prefetch`); then
    WideDeep with a token_seq item field `tags` (vocabulary E_TAGS_VOCAB,
    lengths 1..E_TAGS_LEN from the seed, mean pooling): its E_TAGS_STEPS
    steps lower the loss and launch the gathers' backward twice more a step
    (the field's table and its first-order twin) than without the field.
    → the gathers' backward launches (the tags runs reset the count: the
    launches of the fits before them are added)."""
    train, held, held_iv = ctr_splits(ind)
    embed_grad.scatter_rows_kernel.launches = 0
    for i, (tag, name, over) in enumerate(E3_MODELS):
        e3_train(tag, e_ranking_model(name, SEED + 300 + i, **over), mapper, train, held, held_iv)
    e3_prefetch(train)
    gathers = embed_grad.scatter_rows_kernel.launches
    rng = np.random.default_rng(SEED + 310)
    n_i = N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS
    lengths = rng.integers(1, E_TAGS_LEN + 1, n_i)
    tags = rng.integers(1, E_TAGS_VOCAB, (n_i, E_TAGS_LEN))
    tags[np.arange(E_TAGS_LEN)[None, :] >= lengths[:, None]] = 0
    tagged = dataclasses.replace(ctr_fields(), token_seq_names=("tags",),
                                 token_seq_dims=(E_TAGS_VOCAB,))
    sync()
    t0 = time.perf_counter()
    losses, with_tags = e3_tags_step_launches(tagged, dict(train.item_feat, tags=tags), train,
                                              SEED + 320)
    _, without = e3_tags_step_launches(ctr_fields(), train.item_feat, train, SEED + 320)
    sync()
    q = E_TAGS_STEPS // 4
    first, last = float(losses[:q].mean()), float(losses[-q:].mean())
    log(f"E3 tags: WideDeep with a token_seq field (vocabulary {E_TAGS_VOCAB}, mean length "
        f"{lengths.mean():.2f}), {E_TAGS_STEPS} steps: loss first quarter {first:.5f} last "
        f"{last:.5f}; gathers' backward launches {with_tags} with the field, {without} without "
        f"({time.perf_counter() - t0:.1f} s for both)")
    require(np.isfinite(losses).all() and last < first, f"E3 tags: losses {losses}")
    require(with_tags - without == 2 * E_TAGS_STEPS,
            f"E3 tags: gathers' backward launches {with_tags} with the field, {without} without")
    return {"scatter_rows_kernel": gathers + with_tags}


def e4_cfg(learner, **over):
    d = {"seed": SEED, "topk": TOPK, "train_batch_size": E_DAU_B, "learner": learner,
         "learning_rate": 1e-3, "epochs": 1, "train_oov": True, "oov_only_epoch": True,
         "oov_train_ratio": 0.2, "oov_feature_mask_rate": 0.2, "oov_freeze_embedding": True,
         "host_scan_steps": 1}
    d.update(over)
    return Config(d)


def e4_trainer(cfg, rows, steps=None):
    """A fresh DirectAU at its published widths (D 64, the serving scale's
    tables, random-mapper buckets) from one seed, its trainer under `cfg`,
    and a loader of `steps` pointwise steps over the first rows of `rows`
    with a sampler of its own (every run draws the same negatives). →
    (trainer, loader)."""
    steps = steps or E_DAU_STEPS
    kw, emb = published("DirectAU")
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=100,
                         n_item_buckets=100, hash_function="3round")
    model = get_model_class("DirectAU")(N_OLD_USERS, N_OLD_ITEMS, emb, spec, device=DEVICE,
                                        generator=torch_generator(SEED + 401, DEVICE), **kw)
    n = steps * E_DAU_B // 2  # a pointwise batch: positives, then one negative each
    train = DatasetSplit({k: v[:n] for k, v in rows.items()}, N_OLD_USERS, N_OLD_ITEMS)
    loader = TrainBatcher(train, Sampler(["train"], [train], seed=SEED), cfg,
                          InputType.POINTWISE)
    trainer = eager_steps(Trainer(cfg, model))
    require(loader.mode == "pointwise" and len(loader) == steps
            and trainer._maybe_device_epoch(loader) is None,
            f"E4: the host path's {len(loader)} pointwise steps are not driven")
    return trainer, loader


def e4_directau():
    """E4: DirectAU at D 64 (DirectAU.yaml) over the serving scale, E_DAU_STEPS
    pointwise steps of E_DAU_B rows plus the frozen OOV sub-epoch through
    `Trainer.fit`, with adam and with `learner: sparse_adam` (the ID tables
    through kernel 6 in `Trainer._sparse_step`, two launches a normal step);
    the sparse run again with `sparse_update_impl: xla` (the plain
    write-back: the same bits), and COMPARE_STEPS steps of the row-sparse
    step against the dense lazy-Adam sweep (`sparse_update_impl: dense`)
    from the same weights; then the sparse-adam model served over the
    serving cell's corpus (1M items, B 256, 4 user batches): the 7 slices
    and the IV full sort fused == dense (1e-9); then DirectAU on synth-ind
    through `cli.run.main`, `--eval_only` to 1e-9. → the fused runs' top-k
    launches and the sparse run's kernel-6 launches."""
    rng = np.random.default_rng(SEED + 400)
    n_rows = E_DAU_STEPS * E_DAU_B // 2
    rows = {"user_id": rng.integers(1, N_OLD_USERS, n_rows),
            "item_id": rng.integers(1, N_OLD_ITEMS, n_rows)}
    k6 = 0
    for learner in ("adam", "sparse_adam"):
        trainer, loader = e4_trainer(e4_cfg(learner), rows)
        require(bool(trainer.sparse_tables) == (learner == "sparse_adam"),
                f"E4 {learner}: sparse tables {trainer.sparse_tables}")
        sparse_adam_rows_kernel.launches = 0
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        sync()
        t0 = time.perf_counter()
        trainer.fit(loader, None, saved=False)
        sync()
        wall = time.perf_counter() - t0
        steps, k6 = trainer._global_step, sparse_adam_rows_kernel.launches
        moved = {n for n in before if not torch.equal(before[n], trainer.params[n])}
        loss, oov_loss = trainer.train_loss_dict[0], trainer.oov_loss_dict.get(0)
        log(f"E4 DirectAU {learner}: {len(loader)} + {steps - len(loader)} OOV steps of "
            f"{E_DAU_B} rows, {wall / steps * 1e3:.2f} ms per step (wall, host included), mean "
            f"loss {loss / len(loader):.5f}, kernel 6 launches {k6}")
        require(math.isfinite(loss) and oov_loss is not None and math.isfinite(oov_loss)
                and {"user_embedding.weight", "item_embedding.weight"} <= moved,
                f"E4 {learner}: training, moved {sorted(moved)}")
        require(k6 == (2 * len(loader) if learner == "sparse_adam" else 0),
                f"E4 {learner}: kernel 6 launches {k6} over {len(loader)} steps")
    model, sparse = trainer.model, state_of(trainer)
    del trainer, before
    # the plain write-back (xla) from the same seed: the same bits; the
    # comparison runs' gathers are not counted
    gathers = embed_grad.scatter_rows_kernel.launches
    other, loader = e4_trainer(e4_cfg("sparse_adam", sparse_update_impl="xla"), rows)
    other.fit(loader, None, saved=False)
    got = state_of(other)
    same = [n for n in sparse if torch.equal(sparse[n], got[n])]
    log(f"E4 DirectAU sparse_adam (xla): {len(same)} of {len(sparse)} parameters and moments "
        "equal the kernel-6 run bit for bit")
    require(len(same) == len(sparse), "E4: the xla run differs from the kernel-6 run")
    del other, got, sparse
    # the row-sparse step vs the dense lazy sweep over COMPARE_STEPS steps
    runs = [recorded_run(*e4_trainer(e4_cfg("sparse_adam", sparse_update_impl=impl,
                                            train_oov=False), rows, COMPARE_STEPS))
            for impl in ("auto", "dense")]
    compare_trajectories("E4 DirectAU row-sparse step (kernel 6) vs dense lazy-Adam sweep",
                         ("sparse", "dense"), runs[0][0], runs[1][0], runs[0][1], runs[1][1],
                         runs[0][2], runs[1][2])
    del runs
    embed_grad.scatter_rows_kernel.launches = gathers
    spec = model.spec
    mapper = RandomOOVMapper(spec, N_OLD_USERS, N_OLD_ITEMS, N_OLD_USERS + N_NEW_USERS,
                             N_OLD_ITEMS + N_NEW_ITEMS)
    mapper.set_eval()
    model.eval()
    t0 = time.perf_counter()
    ind_splits, iv_splits = synth_interactions(model, mapper)
    log(f"E4 serving data: {len(ind_splits[1])} test positives, "
        f"{time.perf_counter() - t0:.1f} s")
    k1 = seven_slices_fused_vs_dense(model, mapper, ind_splits, serving_cfg,
                                     what="E4 DirectAU 7-slice eval")
    k1 += full_sort_fused_vs_dense(model, iv_splits, what="E4 DirectAU full-sort eval")
    out = cli_out("e4")
    sync()
    t0 = time.perf_counter()
    res = cli_run.main(["--model=DirectAU", "--dataset=synth-ind", "--data_path=dataset",
                        SYNTH_LOAD_COL, *CLI_OOV, f"--epochs={E_EPOCHS_CLI}", *cli_flags(out)])
    sync()
    wall = time.perf_counter() - t0
    finite_metrics(res["test_result"], "E4 DirectAU test")
    slices_finite(res["inductive_results"], "E4 DirectAU synth-ind")
    again = cli_run.main([f"--eval_only={res['trainer'].saved_model_file}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "E4 eval_only test", tol=1e-9)
    agree_slices(res["inductive_results"], again["inductive_results"], "E4 eval_only slices",
                 tol=1e-9)
    log(f"E4: cli.run.main (DirectAU, synth-ind, {E_EPOCHS_CLI} epochs) {wall:.1f} s (wall); "
        "--eval_only == the run (1e-9)")
    return {"fused_topk_scores": k1, "sparse_adam_rows_kernel": k6}


# -------------------------------------------------------------------- main


# ---------------------------------------------------------------- phase F
#
# The device-resident and scanned paths: the plain and pointwise
# device epochs of the ranking models, DHE ids on the device epoch,
# `host_scan_steps`, the scanned eval, and the dense step replayed as a
# captured CUDA graph (train/cuda_graph.py) on each of them.

F_COMPARE_STEPS = 16   # graphed against eager steps, bit for bit
F_TIME_STEPS = 16      # steps a timed pass, eager and graphed in turns
F_BPR_STEPS = 16       # F3: steps of SP_B rows
F_SCAN_K = 64          # F4: host_scan_steps
F_SCAN_GROUPS = 3      # F4: groups an epoch in the grouping's timing
F_TRACE_STEPS = 16     # steps of a traced pass whose kernels are counted
F_UNI_N, F_UNI_ROWS = 100, 100_000  # F5: uni-N negatives, rows a batch
F_POINTWISE = {"distribution": "uniform", "sample_num": 1}


def f_batches(de, n):
    """The first n batches of `de`'s epoch 0, cloned."""
    out = []
    for _, batch in de.batches(0):
        out.append({k: v.clone() for k, v in batch.items()})
        if len(out) == n:
            break
    return out


def f_state(trainer):
    """Parameters, Adam moments, BatchNorm statistics and the count."""
    return {**state_of(trainer), **{f"bn:{k}": v.clone() for k, v in bn_stats(trainer.model).items()}}


def graph_vs_eager(make, what, steps=F_COMPARE_STEPS):
    """Two trainers from one seed (`make()` → (trainer, loader)): the same
    `steps` device-epoch batches through the captured graph (the first
    step is the warm-up, eager on a side stream; the others replays) and
    through the eager `_apply_step`. Losses, parameters, moments and
    BatchNorm statistics bit for bit; the kernel wrappers of the graphed
    run launched at the warm-up and the capture only, the eager run's at
    every step. → (graphed trainer, its device epoch, eager trainer, the
    batches)."""
    (a, loader), (b, _) = make(), make()
    de = a._maybe_device_epoch(loader)
    require(de is not None and not de.sparse_tables, f"{what}: the dense device epoch")
    batches = f_batches(de, steps)
    a.model.train()
    b.model.train()
    reset_kernel_counts()
    sync()
    la = torch.stack([de.train_step(x) for x in batches])
    sync()
    ca = kernel_counts()
    reset_kernel_counts()
    lb = torch.stack([b._apply_step(x) for x in batches])
    sync()
    cb = kernel_counts()
    g = a.step_graphs
    require(g.captures == 1 and g.replays == steps - 1, f"{what}: {g.captures} captures, "
            f"{g.replays} replays")
    require(a.opt_state.get("count") == b.opt_state.get("count"), f"{what}: Adam counts")
    sa, sb = f_state(a), f_state(b)
    differ = {n: float((sa[n] - sb[n]).abs().max()) for n in sa if not torch.equal(sa[n], sb[n])}
    log(f"{what}: {steps} steps graphed ({g.replays} replays) vs eager: losses "
        f"{'equal' if torch.equal(la, lb) else 'DIFFER'} ({float(la[0]):.6f} -> "
        f"{float(la[-1]):.6f}), {len(sa) - len(differ)} of {len(sa)} tensors equal bit for bit; "
        f"launches graphed {ca}, eager {cb}")
    require(torch.equal(la, lb) and not differ, f"{what}: graph vs eager differ {differ}")
    require(all(ca[k] * steps == 2 * cb[k] for k in cb),
            f"{what}: wrapper launches graphed {ca} (a warm-up and a capture) vs eager {cb} "
            f"({steps} steps)")
    return a, de, b, batches


def graph_trace_check(eager_counts, eager_trace, graph_counts, graph_trace, what):
    """The kernels a graphed pass ran, as its profiler trace shows them,
    against an eager pass over the same batches: the eager trace (where it
    was taken) has each kernel as often as its wrappers counted launches,
    the graphed trace has them as often as the eager wrappers, and the
    graphed pass called no wrapper (its steps were replays). → each
    wrapper's kernel launches in the graphed trace (the eager pass says
    which wrapper of a shared kernel ran)."""
    by_kernel = {k: 0 for k in graph_trace}
    users = {k: [] for k in graph_trace}
    for name, fn in launches.WRAPPERS.items():
        by_kernel[fn.kernel] += eager_counts[name]
        if eager_counts[name]:
            users[fn.kernel].append(name)
    log(f"{what}: kernels in the traces, eager {eager_trace}, graph {graph_trace}; wrapper "
        f"launches eager {eager_counts}, graph {graph_counts}")
    require(eager_trace in (None, by_kernel), f"{what}: eager trace {eager_trace} vs its "
            f"wrappers' launches {by_kernel}")
    require(graph_trace == by_kernel, f"{what}: graphed trace {graph_trace} vs the eager "
            f"wrappers' launches {by_kernel}")
    require(not any(graph_counts.values()), f"{what}: a replayed pass called wrappers "
            f"{graph_counts}")
    require(all(len(u) <= 1 for u in users.values()), f"{what}: wrappers sharing a kernel "
            f"both ran {users}")
    return {name: graph_trace[fn.kernel] if eager_counts[name] else 0
            for name, fn in launches.WRAPPERS.items()}


F_TRACE = {}  # phase F part → each wrapper's kernel launches in its graphed traces


def add_trace(part, seen):
    F_TRACE[part] = {k: F_TRACE.get(part, {}).get(k, 0) + n for k, n in seen.items()}


def dead_capture_check(make, batch, what):
    """A trainer's captures, dropped in a reference cycle (the trainer and
    its `StepGraphs` hold each other), do not break a later trainer's
    capture. The collector is off until the second capture begins and then
    runs at every allocation, so the dropped graphs are freed before the
    capture (`StepGraphs` collects first) or inside it, which the capture
    refuses."""
    import gc

    a, _ = make()
    a.step_graphs.step(batch)
    require(a.step_graphs.captures == 1, f"{what}: no capture")
    threshold = gc.get_threshold()
    begin, end = torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end

    def collecting_begin(self, *args, **kw):
        begin(self, *args, **kw)
        gc.set_threshold(1, 1, 1)
        gc.enable()

    def collecting_end(self, *args, **kw):
        gc.disable()
        gc.set_threshold(*threshold)
        end(self, *args, **kw)

    gc.disable()
    del a
    b, _ = make()
    torch.cuda.CUDAGraph.capture_begin = collecting_begin
    torch.cuda.CUDAGraph.capture_end = collecting_end
    b.step_graphs.step(batch)
    torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end = begin, end
    gc.enable()
    sync()
    require(b.step_graphs.captures == 1, f"{what}: no second capture")
    log(f"{what}: a dropped trainer's captures are collected before the next capture")


def graph_vs_eager_times(de, eager, batches, what, part):
    """Wall ms a step (host clock around a synchronised pass) of the
    graphed and the eager step on the same batches, in the order eager,
    graph, graph, eager; then one pass of each under the profiler: device
    ms a step, the device's busy share, and the kernels each trace shows
    (`graph_trace_check`, added to `part`'s in F_TRACE). → the numbers,
    also logged."""
    runs = {"eager": lambda: [eager._apply_step(x) for x in batches],
            "graph": lambda: [de.train_step(x) for x in batches]}
    n = len(batches)
    wall = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        sync()
        t0 = time.perf_counter()
        runs[name]()
        sync()
        wall[name].append((time.perf_counter() - t0) * 1e3 / n)
    out, seen = {}, {}
    for name in ("eager", "graph"):
        reset_kernel_counts()
        w, busy = profiled(runs[name], f"profile {n} {what} steps, {name}", quiet=True)
        out[name] = {"wall_ms": wall[name], "device_ms": busy / n,
                     "busy_pct": 100 * busy / max(w, 1e-9)}
        seen[name] = (kernel_counts(), profiled.kernels)
    add_trace(part, graph_trace_check(*seen["eager"], *seen["graph"], what))
    log(f"{what}, ms a step of {batches[0]['weight'].numel()} rows (wall, host included; "
        f"order eager, graph, graph, eager): eager "
        f"{', '.join(f'{t:.3f}' for t in wall['eager'])}, graph "
        f"{', '.join(f'{t:.3f}' for t in wall['graph'])}; device ms a step eager "
        f"{out['eager']['device_ms']:.3f} (busy {out['eager']['busy_pct']:.1f} %), graph "
        f"{out['graph']['device_ms']:.3f} (busy {out['graph']['busy_pct']:.1f} %)")
    F_TIMES[what] = out
    return out


F_TIMES = {}


def f_epoch_times(de, what):
    """A whole device epoch after the fit, its batches assembled on the
    card and its dense steps replayed: wall ms a step (host clock around a
    synchronised epoch; no profiler: a whole epoch's events take it tens of
    seconds to sum on a slow host)."""
    sync()
    t0 = time.perf_counter()
    de.run(1)
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / de.n_steps
    F_TIMES[f"{what} epoch"] = {"wall_ms": wall}
    log(f"{what}: a device epoch of {de.n_steps} steps, {wall:.3f} ms a step (wall)")


def f_fit(trainer, loader, what, falls=True):
    """`Trainer.fit` for one epoch + the OOV sub-epoch, each sub-epoch's
    losses and steps kept; the loss must fall where `falls`. → (normal,
    oov records, wall s)."""
    inner, seen = trainer._train_epoch, {}

    def watched(ldr, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        steps = trainer._global_step
        total = inner(ldr, epoch_idx, oov_transform, keep_ratio, frozen)
        seen["oov" if keep_ratio is not None else "normal"] = {
            "losses": trainer.last_losses, "steps": trainer._global_step - steps}
        return total

    trainer._train_epoch = watched
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    trainer._train_epoch = inner
    normal = seen["normal"]
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(seen["oov"]["losses"]).all(),
            f"{what}: loss not finite")
    log(f"{what}: {normal['steps']} device-epoch steps + {seen['oov']['steps']} OOV steps in "
        f"{wall:.2f} s ({wall * 1e3 / trainer._global_step:.2f} ms a step, wall, host and set-up "
        f"included); loss first tenth {first:.5f} last tenth {last:.5f}")
    require(last < first or not falls, f"{what}: the loss did not fall ({first} -> {last})")
    return normal, seen["oov"], wall


def f1_xdeepfm_plain(ind):
    """F1: xDeepFM at the ranking cell's shape on the plain device epoch
    through `Trainer.fit` (`device_epoch: true`; the frozen OOV sub-epoch
    on the host path, as in JAX): the loss falls, held-out AUC rises, the
    CIN kernels 4 and 5 launched by their wrappers (3 + 3 a step) at the
    warm-ups and captures of the epoch's step and the OOV step, and the
    gathers' backward; then 16 graphed steps against 16 eager ones, bit for
    bit, and their times, the replayed kernels counted in the trace. → the
    fit's kernel launches."""
    train, _, held_iv = ctr_splits(ind)
    cfg = ctr_train_cfg(device_epoch=True)
    trainer = Trainer(cfg, build_ranking_model(SEED + 501))
    auc0 = EvalRunner(trainer.model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))["auc"]
    loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
    reset_kernel_counts()
    normal, oov, _ = f_fit(trainer, loader, "F1 xDeepFM, plain device epoch")
    counts = kernel_counts()
    de = trainer._device_epochs[(id(loader), False, False)]
    steps = trainer._global_step
    g = trainer.step_graphs
    require(de.mode == "plain" and normal["steps"] == de.n_steps == len(loader)
            and (id(loader), True, True) not in trainer._device_epochs,
            "F1: the plain device epoch, the OOV sub-epoch on the host path")
    # one capture for the epoch's step; the frozen OOV steps one for each
    # signature the simulator gives (user ids OOV, item ids, or both)
    require(2 <= g.captures <= 4 and g.replays == steps - g.captures,
            f"F1: {g.captures} captures, {g.replays} replays for {steps} steps")
    eager = 2 * g.captures  # each capture's warm-up step and the capture
    require(counts["cin_layer_pooled"] == 3 * eager and counts["cin_layer_pooled_bwd"] == 3 * eager
            and counts["scatter_rows_kernel"] > 0,
            f"F1: wrapper launches {counts} over {steps} steps, {eager} of them not replays")
    auc1 = trainer.evaluate(PlainEvalBatcher(held_iv, cfg), load_best_model=False)["auc"]
    log(f"F1: held-out IV AUC {auc0:.5f} before, {auc1:.5f} after; launches {counts}")
    require(auc1 > auc0, f"F1: held-out AUC {auc0} -> {auc1}")
    f_epoch_times(de, "F1 xDeepFM plain")
    del trainer, de

    def make():
        c = ctr_train_cfg(device_epoch=True, train_oov=False)
        return Trainer(c, build_ranking_model(SEED + 502)), TrainBatcher(
            train, None, c, InputType.POINTWISE)

    a, gde, b, batches = graph_vs_eager(make, "F1 xDeepFM")
    graph_vs_eager_times(gde, b, batches[:F_TIME_STEPS], "F1 xDeepFM plain", "F1")
    return counts


def f2_pointwise(ind):
    """F2: WideDeep and DCNv2 on the pointwise device epoch (uniform, one
    negative a row, 4,096 positives + 4,096 negatives a step) at the
    ranking cell's shape through `Trainer.fit`: the loss falls, DCNv2's
    BatchNorm statistics move; then graphed against eager steps, bit for
    bit, and their times. → the fits' kernel launches."""
    train, _, _ = ctr_splits(ind)
    sampler = Sampler(["train"], [train], seed=SEED)
    counts = {}
    for i, name in enumerate(("WideDeep", "DCNV2")):
        cfg = ctr_train_cfg(device_epoch=True, train_neg_sample_args=F_POINTWISE)
        model = e_ranking_model(name, SEED + 510 + i)
        trainer = Trainer(cfg, model)
        loader = TrainBatcher(train, sampler, cfg, InputType.POINTWISE)
        stats = {k: v.clone() for k, v in bn_stats(model).items()}
        reset_kernel_counts()
        f_fit(trainer, loader, f"F2 {name}, pointwise device epoch")
        counts = {k: counts.get(k, 0) + n for k, n in kernel_counts().items()}
        de = trainer._device_epochs[(id(loader), False, False)]
        require(de.mode == "pointwise" and de.times == 2 and de.B * 2 == CTR_B,
                f"F2 {name}: the pointwise device epoch")
        moved = [k for k, v in bn_stats(model).items() if not torch.equal(v, stats[k])]
        require(len(moved) == len(stats), f"F2 {name}: statistics moved {moved} of {list(stats)}")
        log(f"F2 {name}: {len(moved)} BatchNorm statistics moved")
        f_epoch_times(de, f"F2 {name} pointwise")
        del trainer, de

        def make(name=name, i=i):
            c = ctr_train_cfg(device_epoch=True, train_oov=False,
                              train_neg_sample_args=F_POINTWISE)
            return Trainer(c, e_ranking_model(name, SEED + 520 + i)), TrainBatcher(
                train, sampler, c, InputType.POINTWISE)

        a, gde, b, batches = graph_vs_eager(make, f"F2 {name}", steps=8)
        graph_vs_eager_times(gde, b, batches, f"F2 {name} pointwise", "F2")
        del a, gde, b, batches
    return counts


def f3_bpr_fdhe():
    """F3: BPR with fdhe (128 hashes, towers of 512, D 64) hashed on the
    card (`dhe_on_device`) on the pairwise device epoch with `learner:
    sparse_adam` (kernel 6, eager by rule) at the sparse phase's shape,
    the OOV sub-epoch included; one OOV batch's ids hashed on the card equal
    the host hasher's codes. Then BPR's dense step (`sparse_update_impl:
    dense`) graphed against eager at the same shape, and its times. → the
    fit's kernel launches."""
    write_hash_keys((D_HASHES,))
    keys = DHEHasher(D_HASHES, D_KEYS).keys
    rng = np.random.default_rng(SEED + 600)
    users, items = structured_pairs(rng, F_BPR_STEPS * SP_B)
    split = DatasetSplit({"user_id": users, "item_id": items}, SP_USERS, SP_ITEMS)
    sampler = Sampler(["train"], [split], seed=SEED)
    state = {"dhe_keys": keys}
    for side, n in (("user", SP_USERS), ("item", SP_ITEMS)):
        m = rng.standard_normal((n, D_FEATS)).astype(np.float32)
        state[f"{side}_feat_mat"] = m / np.linalg.norm(m, axis=1, keepdims=True)
    spec = InductiveSpec(embedder="fdhe", dhe_num_hashes=D_HASHES, dhe_layer_size=D_LAYER,
                         embedding_size=D, add_oov_buckets=True, n_user_buckets=SP_BUCKETS,
                         n_item_buckets=SP_BUCKETS)
    cfg = sparse_cfg("auto", dhe_on_device=True, hash_key_dir=D_KEYS, oov_train_ratio=1.0)
    trainer = Trainer(cfg, BPR(SP_USERS, SP_ITEMS, D, spec, device=DEVICE,
                               generator=torch_generator(SEED + 601, DEVICE),
                               embedder_state=state))
    require(trainer.dhe_hasher is not None and trainer.dhe_hasher.on_device, "F3: hasher")
    loader = TrainBatcher(split, sampler, cfg, InputType.PAIRWISE)
    reset_kernel_counts()
    normal, oov, _ = f_fit(trainer, loader, "F3 BPR fdhe, pairwise device epoch, sparse adam",
                           falls=False)
    counts = kernel_counts()
    des = trainer._device_epochs
    de, ode = des[(id(loader), False, False)], des[(id(loader), True, False)]
    ran = de.steps_run + ode.steps_run
    require(de.sparse_impl == ode.sparse_impl == "pallas" and de.dhe_pad == spec.prime_pad,
            "F3: the sparse device epochs with DHE ids")
    require(counts["sparse_adam_rows_kernel"] == 2 * ran,
            f"F3: kernel 6 launches {counts} for {ran} steps")
    _, batch = next(ode.batches(1))
    host = {k: v.cpu().numpy() for k, v in batch.items() if not k.endswith("_dhe_id")}
    hasher = DHEHasher(D_HASHES, D_KEYS, keys_u64=keys)
    key_t = trainer.model.embedder_state["dhe_keys"]
    flagged = 0
    for f in ("user_id", "item_id", "neg_item_id"):
        hasher.annotate_batch(host, f, spec.prime_pad, padded_when_flagged=True)
        got = dhe_codes_device(batch[f + "_dhe_id"], key_t).cpu().numpy()
        require(np.array_equal(got, host[f + "_dhe"]), f"F3: {f} codes differ from the host's")
        flagged += int((host.get(f + "_oov", np.zeros(1)) > 0).sum())
    require(flagged > 0, "F3: no flagged id in the OOV batch")
    log(f"F3: one OOV batch's user, item and negative ids hashed on the card == the host "
        f"hasher ({flagged} flagged ids padded by prime_pad); launches {counts}")
    del trainer, des, de, ode

    def make():
        c = sparse_cfg("dense", train_oov=False)
        return Trainer(c, sparse_model()), TrainBatcher(split, sampler, c, InputType.PAIRWISE)

    a, gde, b, batches = graph_vs_eager(make, "F3 BPR dense step", steps=8)
    graph_vs_eager_times(gde, b, batches, "F3 BPR dense lazy-Adam step", "F3")
    del a, gde, b
    dead_capture_check(make, batches[0], "F3 BPR dense step")
    return counts


def f4_host_scan(ind):
    """F4: xDeepFM on the host path, one epoch at `host_scan_steps`
    F_SCAN_K (one group stacked and copied at once; the remainder per step)
    against 1, every step but the first replayed from the captured graph:
    the same losses and weights bit for bit. Then what the grouping adds
    beyond the graph (`f4_grouping`). → the K run's kernel launches."""
    train, _, _ = ctr_splits(ind)
    runs = {}
    for k in (F_SCAN_K, 1):
        reset_kernel_counts()
        cfg = ctr_train_cfg(train_oov=False, host_scan_steps=k)
        trainer = Trainer(cfg, build_ranking_model(SEED + 530))
        loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
        require(trainer._host_scan_k(loader) == k, f"F4: K {trainer._host_scan_k(loader)}")
        sync()
        t0 = time.perf_counter()
        trainer.fit(loader, None, saved=False)
        sync()
        wall = time.perf_counter() - t0
        g = trainer.step_graphs
        runs[k] = (trainer.last_losses, f_state(trainer), wall, g.replays, kernel_counts())
        log(f"F4: host_scan_steps {k}: {len(loader)} steps in {wall:.2f} s "
            f"({wall * 1e3 / len(loader):.2f} ms a step, wall, the capture included), "
            f"{g.captures} capture, {g.replays} replays")
        require(g.captures == 1 and g.replays == len(loader) - 1,
                f"F4 K {k}: {g.captures} captures, {g.replays} replays")
        del trainer
    (lk, sk, _, _, counts), (l1, s1, _, _, _) = runs[F_SCAN_K], runs[1]
    same = [n for n in s1 if torch.equal(sk[n], s1[n])]
    log(f"F4: K {F_SCAN_K} vs 1: losses {'equal' if np.array_equal(lk, l1) else 'DIFFER'}, "
        f"{len(same)} of {len(s1)} tensors equal bit for bit")
    require(np.array_equal(lk, l1) and len(same) == len(s1), "F4: the trajectories differ")
    f4_grouping(train)
    return counts


def f4_grouping(train):
    """What `host_scan_steps` adds beyond the graph, on an epoch of
    F_SCAN_GROUPS groups of F_SCAN_K batches (the rows of `train` repeated):
    wall ms a step at K = F_SCAN_K (a group stacked, one copy, replays), at
    K = 1 (a copy a batch, replays) and at K = 1 with the steps eager
    (`eager_steps`, the uncaptured step), the graphed trainers after
    an untimed epoch that captures, in the order K, 1 graphed, 1 eager, 1
    eager, 1 graphed, K. Then the replayed kernels: an epoch of
    F_TRACE_STEPS batches at K = F_TRACE_STEPS (one group) and at K = 1
    under the profiler (a trace of 64 steps or more has lost kernel
    records), counted in the trace against an eager epoch's wrappers over
    the same batches, with the device's busy share."""
    n_rows = len(train.inter[train.uid_field])
    pick = np.arange(F_SCAN_GROUPS * F_SCAN_K * CTR_B) % n_rows
    rows = DatasetSplit({k: v[pick] for k, v in train.inter.items()}, N_CTR_OLD_USERS,
                        N_CTR_OLD_ITEMS, user_feat=train.user_feat, item_feat=train.item_feat)
    steps = F_SCAN_GROUPS * F_SCAN_K
    order = (f"K {F_SCAN_K}", "1 graphed", "1 eager")
    out = {}
    for name, k in zip(order, (F_SCAN_K, 1, 1)):
        cfg = ctr_train_cfg(train_oov=False, host_scan_steps=k)
        trainer = Trainer(cfg, build_ranking_model(SEED + 531))
        loader = TrainBatcher(rows, None, cfg, InputType.POINTWISE)
        require(len(loader) == steps, f"F4: {len(loader)} batches")
        if name == "1 eager":
            eager_steps(trainer)
        else:
            trainer._train_epoch(loader, 0)
        out[name] = {"trainer": trainer, "loader": loader, "wall_ms": []}
    for i, name in enumerate(order + order[::-1]):
        sync()
        t0 = time.perf_counter()
        out[name]["trainer"]._train_epoch(out[name]["loader"], 1 + i)
        sync()
        out[name]["wall_ms"].append((time.perf_counter() - t0) * 1e3 / steps)
    for rec in out.values():
        del rec["trainer"], rec["loader"]
    short = rows_of(rows, np.arange(len(pick)) < F_TRACE_STEPS * CTR_B, N_CTR_OLD_USERS,
                    N_CTR_OLD_ITEMS)
    seen = {}
    for name, k in (("1 eager", 1), (f"K {F_SCAN_K}", F_TRACE_STEPS), ("1 graphed", 1)):
        cfg = ctr_train_cfg(train_oov=False, host_scan_steps=k)
        trainer = Trainer(cfg, build_ranking_model(SEED + 532))
        loader = TrainBatcher(short, None, cfg, InputType.POINTWISE)
        require(len(loader) == F_TRACE_STEPS, f"F4: {len(loader)} batches")
        if name == "1 eager":
            eager_steps(trainer)
            reset_kernel_counts()
            trainer._train_epoch(loader, 0)
            seen[name] = (kernel_counts(), None)
            continue
        trainer._train_epoch(loader, 0)  # the capture
        reset_kernel_counts()
        w, busy = profiled(lambda: trainer._train_epoch(loader, 1),
                           f"profile F4 {name}: an epoch of {F_TRACE_STEPS} steps (K {k})",
                           quiet=True)
        seen[name] = (kernel_counts(), profiled.kernels)
        out[name].update(device_ms=busy / F_TRACE_STEPS, busy_pct=100 * busy / max(w, 1e-9))
    replayed = {name: graph_trace_check(*seen["1 eager"], *seen[name], f"F4 {name}")
                for name in order[:2]}
    add_trace("F4", replayed[order[0]])
    log(f"F4 host path, ms a step of {CTR_B} rows over {steps} steps (wall, host included; "
        f"order {', '.join(order + order[::-1])}): " + "; ".join(
            f"{name} {', '.join(f'{t:.3f}' for t in out[name]['wall_ms'])}" + (
                f" (device {out[name]['device_ms']:.3f}, busy {out[name]['busy_pct']:.1f} % "
                f"over {F_TRACE_STEPS} steps)" if "busy_pct" in out[name] else "")
            for name in order))
    F_TIMES["F4 host path"] = out


def f5_scanned_eval():
    """F5: phase 3's BPR over its 900,000 IV items: the scanned full sort
    (kernel 1, by the per-batch rule) against the per-batch one, and the
    scanned uni-N eval against the per-batch one, the same metrics; each
    pass run in the order scanned, per batch, per batch, scanned after an
    untimed warm-up pass, with its wall and host syncs. → kernel 1's
    launches in the scanned full sort."""
    import warnings

    model, iv_splits = SERVING["model"], SERVING["iv_splits"]
    out = {}

    def run(what, make_loader, scanned):
        cfg = serving_cfg(True, N_OLD_ITEMS, device_eval=scanned)
        ldr = make_loader(cfg)
        runner = EvalRunner(model, cfg)
        topk_score.fused_topk_scores.launches = 0
        sync()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            result = runner.evaluate(ldr)
            sync()
            wall = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        n = topk_score.fused_topk_scores.launches
        log(f"F5 {what} {'scanned' if scanned else 'per batch'}: {len(ldr)} batches in "
            f"{wall * 1e3:.1f} ms, {syncs} host syncs, kernel 1 launches {n}")
        rec = out.setdefault((what, scanned), {"ms": [], "syncs": syncs, "launches": n})
        rec["ms"].append(wall * 1e3)
        return result, n

    def neg_loader(cfg):
        train, test = iv_splits
        sampler = Sampler(["train", "test"], [train, test], seed=SEED)
        return NegSampleEvalBatcher(test, sampler, cfg, "test", {"sample_num": F_UNI_N},
                                    batch_size=F_UNI_ROWS)

    results = {}
    for what, make_loader in (("full sort", lambda c: loader(iv_splits, c)),
                              (f"uni{F_UNI_N}", neg_loader)):
        run(what, make_loader, True)  # warm-up: the allocator, the libraries
        out.clear()
        for scanned in (True, False, False, True):
            result = run(what, make_loader, scanned)
            first = results.setdefault((what, scanned), result)
            agree(result[0], first[0], f"F5 {what} repeat", tol=1e-12)
        agree(results[(what, True)][0], results[(what, False)][0], f"F5 {what} scanned vs per "
              "batch", tol=1e-12)
        log(f"F5 {what}: scanned == per batch {dict(results[(what, True)][0])}")
        F_TIMES[f"F5 {what}"] = {("scanned" if s else "per batch"): v
                                 for (w, s), v in out.items() if w == what}
    k1 = results[("full sort", True)][1]
    require(k1 > 0 and k1 == results[("full sort", False)][1], f"F5: kernel 1 launches {k1}")
    return {"fused_topk_scores": k1}


SERVING = {}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    log(f"card: {smi}")
    t_start = t0 = time.perf_counter()
    built = cuda_build.build_kernels(["topk_score", "cin_fused", "cin_fused_bwd", "sparse_rows",
                                      "embed_grad"])
    log(f"build: {built} ({time.perf_counter() - t0:.1f} s)")
    for name, out in cuda_build.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    kernel_cases()
    cin_cases()
    cin_bwd_cases()
    sparse_rows_cases()
    embed_grad_times = embed_grad_timing(embed_grad_cases())
    timing = kernel_timing()
    cin_times = cin_timing()
    cin_times.update(cin_bwd_timing())
    sparse_times = sparse_rows_timing()
    launches = serving()
    cin_launches, ind, mapper = ranking()
    train_launches = ranking_training(ind, mapper)
    retrieval_training()
    sparse_launches, gather_launches = retrieval_sparse_training()
    t0 = time.perf_counter()
    cli_retrieval()
    embed_grad.scatter_rows_kernel.launches = 0
    cli_b, _ = cli_ranking()
    gathers_b = embed_grad.scatter_rows_kernel.launches
    embed_grad.scatter_rows_kernel.launches = 0
    k6_c, k1_c, _ = cli_corpus()
    gathers_c = embed_grad.scatter_rows_kernel.launches
    log(f"CLI phases A-C: {time.perf_counter() - t0:.1f} s")
    # phase D, the embedders; each kernel's launches counted by part
    t0 = time.perf_counter()
    on_d = {}
    for part, run in (("D1", d1_embedders), ("D2", d2_ranking_lsh), ("D3", d3_fdhe_serving),
                      ("D4", lsh_device_epoch)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        # a part that compares a kernel with its plain path resets that
        # kernel's count itself and returns the main run's
        on_d[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_d[part]}")
    gathers, gather_bound = gather_backward_ms()
    log(f"phase D: {time.perf_counter() - t0:.1f} s")
    require(on_d["D2"]["cin_layer_pooled"] > 0 and on_d["D2"]["cin_layer_pooled_bwd"] > 0
            and on_d["D3"]["fused_topk_scores"] > 0 and on_d["D4"]["sparse_adam_rows_kernel"] > 0
            and all(on_d[p]["scatter_rows_kernel"] > 0 for p in ("D1", "D2")),
            f"phase D launches {on_d}")
    # phase E, the paper's other three models; counted by part as D is
    t0 = time.perf_counter()
    on_e = {}
    for part, run in (("E1", e1_ranking_track), ("E2", e2_dcnv2),
                      ("E3", lambda: e3_ranking(ind, mapper)), ("E4", e4_directau)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_e[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_e[part]}")
    log(f"phase E: {time.perf_counter() - t0:.1f} s")
    require(on_e["E4"]["fused_topk_scores"] > 0 and on_e["E4"]["sparse_adam_rows_kernel"] > 0
            and all(on_e[p]["scatter_rows_kernel"] > 0 for p in ("E1", "E2", "E3")),
            f"phase E launches {on_e}")
    # phase F, the device-resident and scanned paths; counted by part
    t0 = time.perf_counter()
    on_f = {}
    for part, run in (("F1", lambda: f1_xdeepfm_plain(ind)), ("F2", lambda: f2_pointwise(ind)),
                      ("F3", f3_bpr_fdhe), ("F4", lambda: f4_host_scan(ind)),
                      ("F5", f5_scanned_eval)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_f[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_f[part]}")
    log(f"phase F: {time.perf_counter() - t0:.1f} s")
    require(on_f["F1"]["cin_layer_pooled"] > 0 and on_f["F1"]["cin_layer_pooled_bwd"] > 0
            and on_f["F4"]["cin_layer_pooled"] > 0 and on_f["F3"]["sparse_adam_rows_kernel"] > 0
            and on_f["F5"]["fused_topk_scores"] > 0
            and all(on_f[p]["scatter_rows_kernel"] > 0 for p in ("F1", "F2", "F4")),
            f"phase F launches {on_f}")
    # the graphed passes' kernels, as their profiler traces show them
    require(all(F_TRACE[p]["cin_layer_pooled"] > 0 and F_TRACE[p]["cin_layer_pooled_bwd"] > 0
                for p in ("F1", "F4"))
            and all(F_TRACE[p]["scatter_rows_kernel"] > 0 for p in ("F1", "F2", "F3", "F4")),
            f"phase F graphed traces {F_TRACE}")
    log("phase F kernels replayed, from the traces: " + json.dumps(F_TRACE))
    log("phase F times: " + json.dumps(F_TIMES))
    cli = {  # each kernel's launches on the CLI paths (A launches none)
        "fused_topk_scores": {"C": k1_c},
        "cin_layer_pooled": {"B": cli_b["cin_layer_pooled"]},
        "cin_layer": {"B": cli_b["cin_layer"]},
        "cin_layer_pooled_bwd": {"B": cli_b["cin_layer_pooled_bwd"]},
        "cin_layer_bwd": {"B": cli_b["cin_layer_bwd"]},
        "sparse_adam_rows_kernel": {"C": k6_c},
        "scatter_rows_kernel": {"B": gathers_b, "C": gathers_c},
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
    }, {
        # not a Pallas kernel: the backward of the JAX package's custom-VJP
        # gather; its launches are the device-epoch run's (3 a step)
        "name": "scatter_rows_kernel",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/embed_grad.cu",
        "replaces": "oovrec_tpu/ops/embed_grad.py:90",
        "launches": gather_launches,
        **embed_grad_times,
    }]
    for k in kernels:
        k["launches_cli"] = cli[k["name"]]
        k["launches_d"] = {part: c[k["name"]] for part, c in on_d.items()}
        k["launches_e"] = {part: c[k["name"]] for part, c in on_e.items()}
        k["launches_f"] = {part: c[k["name"]] for part, c in on_f.items()}
        k["launches_f_trace"] = {part: c[k["name"]] for part, c in F_TRACE.items()}
    log("gathers' backward (ops/embed_grad.py, not a Pallas kernel): " + json.dumps({
            "ms": gathers, "bound_ms": gather_bound,
            "device_epoch": GATHER_RESULTS.get("device_epoch")}))
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

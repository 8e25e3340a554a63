"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase failure is caught):
  1. build: `nvcc` builds every kernel of the port from `oovrec_tpu_torch/csrc`,
     one process per source, all at once;
  2. kernels: each kernel against its plain PyTorch version on the card,
     exactly, on ragged, tied and all-masked shapes (top-k) and on
     integer-valued inputs at every CIN layer mode, odd and ragged shape
     (CIN); the CIN kernel also on random inputs to a stated tolerance;
     then each timed at the main-path shapes beside its bound and a
     PyTorch yardstick;
  3. retrieval serving: BPR at embedding_size 64 with random-mapper OOV
     buckets over 110,000 users and 1,000,000 items (10 % new), 7-slice
     inductive eval and IV full-sort eval, fused path vs dense path to
     1e-9, with the top-k kernel's launch count read around the fused run;
  4. ranking serving: xDeepFM at its published widths (embedding_size 10,
     CIN 100/100/100, MLP 128/128/128) over 7 fields, 220,000 users and
     110,000 items (10 % new) with OOV buckets, 1,048,576 labelled rows in
     batches of 8,192: value eval (AUC, LogLoss) and the 7 value slices,
     CIN kernel vs plain slab path to 1e-6, with the CIN kernel's launch
     count read around each run; then a profile of one fused pass.
The last line is the device record; the line before it lists the kernels.

TF32 is switched off for matmuls and cuDNN below: the plain versions and
the dense path must compute in full f32, as the kernel does.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from oovrec_tpu_torch.config import Config
from oovrec_tpu_torch.data import (
    DatasetSplit,
    FullSortEvalBatcher,
    PlainEvalBatcher,
    Sampler,
)
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator
from oovrec_tpu_torch.eval.runner import to_device_batch
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper
from oovrec_tpu_torch.models import BPR, FieldSpec, xDeepFM
from oovrec_tpu_torch.ops import topk_score
from oovrec_tpu_torch.ops.cin_fused import (
    cin_layer,
    cin_layer_plain,
    cin_layer_pooled,
    cin_layer_pooled_plain,
)
from oovrec_tpu_torch.ops.topk_score import (
    NEG_INF,
    build_hist_bitmap,
    fused_topk_scores,
    fused_topk_scores_plain,
    pack_bitplane,
    unpack_bitmap,
)
from oovrec_tpu_torch.utils import cuda_build
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
# and plain version round the same operands and products to bf16
CIN_TOL = 1e-4


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
    ]
    for i, (name, b, n, d, k, ex) in enumerate(cases):
        u, it = exact_inputs(b, n, d, seed=SEED + i)
        hist, hist_len = random_hist(b, n, min(64, n - 1), seed=SEED + 100 + i)
        bm = build_hist_bitmap(hist, hist_len, n, exclude_col0=ex)
        check_exact(name, u, it, bm, k)
        log(f"kernel check {name}: B={b} N={n} D={d} k={k} "
            f"exclude_col0={ex}: exact")

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
    # the selection rounds scale with k, the score product does not
    by_k = {
        kk: time_ms(lambda u, it, m, kk=kk: fused_topk_scores(u, it, m, k=kk),
                    inputs, 20)
        for kk in (1, 10)
    }
    log("kernel_ms by k: " + " ".join(f"k={kk}:{t:.4f}" for kk, t in by_k.items())
        + f" k={K}:{ms:.4f}")
    w = -(-n // 32)
    bytes_moved = 4 * (B * D + n * D + B * w) + 8 * B * K
    flops = 2 * B * n * D
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
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

    def cfg(fused, n_items):
        return Config({
            "topk": TOPK, "seed": SEED, "eval_batch_size": B * n_items,
            "use_perturbed_hits": False, "use_fused_topk": "auto" if fused else False,
        })

    results, launches, counts = {}, 0, {}
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
        require(ev._fused is fused, f"inductive fused path active: {ev._fused}")
        log(f"inductive eval {'fused' if fused else 'dense'}: {len(test_loader)} "
            f"user batches of {B}, {wall / len(test_loader) * 1e3:.1f} ms per batch "
            f"(wall, host included), kernel launches {counts[fused]}")
    launches = counts[True]
    require(launches == 4 * len(test_loader), f"fused launches {launches}")
    require(counts[False] == 0, "the dense path launched the kernel")
    for s, r in results[True].items():
        log(f"[{s}] {dict(r)}")
    agree(results[True], results[False], "inductive fused vs dense")
    require(results[True]["overall"]["hit@20"] > 0, "overall hit@20 is 0")
    log("inductive eval: fused == dense on all 7 slices (1e-9)")

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


def breakdown(evaluator, test_loader, what="fused inductive eval (perturbed hits on)"):
    """torch.profiler over one warm inductive eval pass: device time by
    kernel and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    evaluator.evaluate_model(test_loader)  # warm: allocator, library load
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluator.evaluate_model(test_loader)
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
    log(f"profile {what}: "
        f"{len(test_loader)} batches, wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for us, key, count in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


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
    exact inputs, to CIN_TOL on random ones, in both precision modes."""
    for i, (name, b, h, f, d, l, nh, pool_all) in enumerate(CIN_CASES):
        errs = {}
        for mxu in ("float32", "bfloat16"):
            got, want = cin_pair(cin_inputs(b, h, f, d, l, SEED + 300 + i, True),
                                 nh, pool_all, mxu)
            require(len(got) == len(want) and all(
                g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)),
                f"cin {name} {mxu}: kernel differs from the plain version on exact inputs")
            got, want = cin_pair(cin_inputs(b, h, f, d, l, SEED + 400 + i, False),
                                 nh, pool_all, mxu)
            errs[mxu] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            require(errs[mxu] <= CIN_TOL, f"cin {name} {mxu}: max |kernel - plain| {errs[mxu]}")
        log(f"cin check {name}: B={b} H={h} F={f} D={d} L={l} n_hidden={nh} "
            f"pool_all={pool_all}: exact (f32, bf16); random max_abs_err "
            f"f32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}")


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
        plain_ms = time_ms(lambda *x: cin_layer_pooled_plain(*x, **kw), inputs, 10)
        lib_ms = time_ms(lambda *x: library_pooled(*x, **kw), inputs, 30)
        bound, by, t_ops, t_bytes = cin_bound(
            [(CTR_B, hh, f, CTR_D, ll, nh, ll - (0 if pool_all else nh))])
        log(f"cin timing layer {j}: B={CTR_B} H={hh} F={f} D={CTR_D} L={ll} "
            f"n_hidden={nh}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by}; ops {t_ops:.4f}, "
            f"bytes {t_bytes:.4f})")
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
    }
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
    }
    log(f"cin_layer timing B={CTR_B} H={hh} F={f} D={CTR_D} L={ll}: " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")
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


def build_ranking_model():
    spec = InductiveSpec(
        mapper="random", add_oov_buckets=True,
        n_user_buckets=100, n_item_buckets=100, hash_function="3round",
    )
    return xDeepFM(
        ctr_fields(), embedding_size=CTR_D, spec=spec, mlp_hidden_size=MLP_SIZES,
        dropout_prob=0.2, direct=False, cin_layer_size=CIN_SIZES,
        device=DEVICE, generator=torch_generator(SEED + 1, DEVICE),
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
    Returns the launch counts of the fused 7-slice run."""
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
              PlainEvalBatcher(ind, cfg), what="fused 7-slice value eval (xDeepFM)")
    return runs[True][2]


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

    t0 = time.perf_counter()
    built = cuda_build.build_kernels(["topk_score", "cin_fused"])
    log(f"build: {built} ({time.perf_counter() - t0:.1f} s)")
    for name, out in cuda_build.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    kernel_cases()
    cin_cases()
    timing = kernel_timing()
    cin_times = cin_timing()
    launches = serving()
    cin_launches = ranking()

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
    }]
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

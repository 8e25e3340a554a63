"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase failure is caught):
  1. build: `nvcc` builds every kernel of the port from `oovrec_tpu_torch/csrc`;
  2. kernels: each kernel against its plain PyTorch version on the card,
     exactly, on ragged, tied and all-masked shapes; then timed at the
     main-path shapes beside its bound and a PyTorch yardstick;
  3. serving: BPR at embedding_size 64 with random-mapper OOV buckets over
     110,000 users and 1,000,000 items (10 % new), 7-slice inductive eval
     and IV full-sort eval, fused path vs dense path to 1e-9, with the
     kernel's launch count read around the fused run.
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
from oovrec_tpu_torch.data import DatasetSplit, FullSortEvalBatcher, Sampler
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator
from oovrec_tpu_torch.inductive import InductiveSpec, RandomOOVMapper
from oovrec_tpu_torch.models import BPR
from oovrec_tpu_torch.ops import topk_score
from oovrec_tpu_torch.ops.topk_score import (
    NEG_INF,
    build_hist_bitmap,
    fused_topk_scores,
    fused_topk_scores_plain,
    pack_bitplane,
    unpack_bitmap,
)
from oovrec_tpu_torch.utils import cuda_build
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


def agree(a, b, what):
    require(list(a) == list(b), f"{what}: keys differ")
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            agree(x, y, f"{what}[{key}]")
        else:
            require(abs(x - y) < 1e-9, f"{what}[{key}]: {x} vs {y}")


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


def breakdown(evaluator, test_loader):
    """torch.profiler over one warm fused inductive eval pass: device time
    by kernel and the device's busy share of the wall time."""
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
    log(f"profile fused inductive eval (perturbed hits on): "
        f"{len(test_loader)} batches, wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for us, key, count in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


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
    built = cuda_build.build_kernels(["topk_score"])
    log(f"build: {built} ({time.perf_counter() - t0:.1f} s)")
    for name, out in cuda_build.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    kernel_cases()
    timing = kernel_timing()
    launches = serving()

    kernels = [{
        "name": "fused_topk_scores",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/topk_score.cu",
        "replaces": "oovrec_tpu/ops/topk_score.py:134",
        "launches": launches,
        **timing,
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

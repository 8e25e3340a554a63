"""The per-layer metrics' readings, shared by the readers of `metrics/`.

Each takes the reader's context (`main.Context`: the trace, the run's counts
and spans, the configuration's roofline counts, the card's peaks) and gives
a number, or None where the run has nothing to read: then the metric is left
out of the result line. A share of a roofline or a peak is never made up as
0.
"""

from __future__ import annotations

CIN_KERNELS = ("cin_fused_kernel", "cin_bwd_rows_kernel", "cin_bwd_dw_kernel",
               "cin_bwd_reduce_kernel")
GATHER_BWD_KERNELS = ("make_keys", "sort_block", "segment_pass", "plan_tables",
                      "DeviceRadixSortOnesweepKernel", "DeviceRadixSortHistogramKernel",
                      "DeviceRadixSortExclusiveSumKernel", "DeviceRadixSortSingleTileKernel",
                      "DeviceRadixSortDownsweepKernel", "DeviceRadixSortUpsweepKernel",
                      "RadixSortScanBinsKernel")
TOPK_KERNELS = ("topk_range_kernel",)


def _steps(ctx) -> int:
    return sum((ctx.out.get("steps") or {}).values())


def device_idle(ctx):
    """The share of the traced stretch in which no device activity ran."""
    t = ctx.trace
    return None if t is None or not t.window_s else 100.0 * (1.0 - t.busy_s / t.window_s)


def batcher_ms(ctx):
    """The mean time of the wrapped eval batcher's `__next__`, ms a batch."""
    spans = ctx.out.get("batcher_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None


def train_mfu(ctx):
    """The whole training step's share of its roofline: the larger of its
    operations over the float32 peak and its required bytes over the
    bandwidth (`roofline/<config>.py:train_step`), over the traced
    stretch's wall per step."""
    f = getattr(ctx.roofline, "train_step", None)
    steps = _steps(ctx)
    if f is None or not steps:
        return None
    flops, nbytes = f(ctx.cell.config, ctx.cell.traffic)
    return 100.0 * steps * ctx.bound_s(flops, nbytes) / ctx.out["wall_s"]


def eval_mfu(ctx):
    """One score per user and corpus item of every batch (2·B·N·D
    operations, however many launches compute it) over the traced
    stretch's wall per batch and the float32 peak."""
    f = getattr(ctx.roofline, "eval_batch_flops", None)
    n = ctx.out.get("batches") or 0
    if f is None or not n:
        return None
    per_batch_s = ctx.out["wall_s"] / n
    return 100.0 * f(ctx.cell.config, ctx.cell.traffic) / (per_batch_s * ctx.peaks["f32_flops"])


def topk_roofline(ctx):
    """Kernel 1's launches: their bound over their device time."""
    f = getattr(ctx.roofline, "topk_launch", None)
    seconds, launches = ctx.trace.kernels(TOPK_KERNELS)
    if f is None or not launches:
        return None
    return 100.0 * launches * ctx.bound_s(*f(ctx.cell.config, ctx.cell.traffic)) / seconds


def cin_roofline(ctx):
    """Kernels 4 and 5 (every `__global__` of the CIN forward and backward
    sources): each traced step's bound over their device time."""
    f = getattr(ctx.roofline, "cin_step", None)
    seconds, launches = ctx.trace.kernels(CIN_KERNELS)
    steps = _steps(ctx)
    if f is None or not launches or not steps:
        return None
    return 100.0 * steps * ctx.bound_s(*f(ctx.cell.config, ctx.cell.traffic)) / seconds


def gather_bwd_roofline(ctx):
    """The gathers' backward (its `__global__`s and the CUB radix sort it
    runs above one block): the bytes of each traced step's calls over their
    device time. A step's bytes are the mean over the first three recorded
    steps of its stage, counted by `roofline/<config>.py:gather_bwd_step`;
    the zeroing of the dense gradient is counted in neither."""
    f = getattr(ctx.roofline, "gather_bwd_step", None)
    seconds, launches = ctx.trace.kernels(GATHER_BWD_KERNELS)
    steps = ctx.out.get("steps") or {}
    if f is None or not launches or not sum(steps.values()):
        return None
    nbytes = 0.0
    for stage, n in steps.items():
        recorded = ctx.out["recorded"][stage]
        per_step = sum(f(ctx.cell.config, ctx.adapter.gathers(b)) for b in recorded) / len(recorded)
        nbytes += n * per_step
    return 100.0 * ctx.bound_s(0, nbytes) / seconds

"""How often a profiler trace of the port's training step loses kernel
records, with the window opened at the run and with `chip_smoke.profiled`'s
window (a lead-in and pauses; the run's records found by correlation id).

Runs on the card only. From the repo's root:

    python tools/torch_trace_records.py [--passes 15] [--graph-passes 10]
        [--windows "at the run,profiled"]

It builds the CIN and gather kernels, makes two xDeepFM trainers at
`xDeepFM.yaml` widths under `learner: rmsprop` (phase G1's), checks that 16
graphed steps equal 16 eager ones, and then profiles eager and graphed
passes of those 16 steps again and again. For each pass it counts the
kernel-launch calls whose kernels left no device record (`lost_records`)
and compares the kernels the trace names (`trace_launches`) with the
wrappers' launches of an eager pass. It prints one line a pass that lost
records or miscounted (in `profiled`'s window with the device activities
whose count differs from a whole pass's, and each registered kernel's
records by launch call), a summary a window, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def at_the_run(run):
    """The window as `profiled` opened it before: a launch and a
    synchronise, then the run. → the kernel-launch calls in the window
    whose kernels left no device record, and the registered kernels that
    its `key_averages` name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        cs.sync()
        run()
        cs.sync()
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    on_device = {e.correlation_id() for e in events if e.device_type() != cpu}
    lost = sum(1 for e in events if e.device_type() == cpu
               and e.name().startswith(cs.LAUNCH_CALLS) and e.correlation_id() not in on_device)
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type != cpu and e.self_device_time_total > 0]
    return lost, cs.trace_launches(rows), None


TRACE = {}  # the kineto events of the last profile `profiled` took


def keep_events(events, rows=cs.device_rows):
    TRACE["events"] = events
    return rows(events)


def in_profiled(run):
    """`chip_smoke.profiled`'s window. → the run's lost records, the
    registered kernels its device rows name, and its device rows."""
    cs.profiled(run, "pass", quiet=True)
    return cs.profiled.lost, cs.profiled.kernels, cs.profiled.rows


def by_launch(events):
    """Each registered kernel's records by the launch call they carry (a
    graph replay's kernels share its call), as (ms after the first
    launch call, count) for the calls whose count is not the most common
    one."""
    cpu = torch.autograd.DeviceType.CPU
    calls = {e.correlation_id(): e.start_ns() for e in events
             if e.device_type() == cpu and e.name().startswith(cs.LAUNCH_CALLS)}
    t0 = min(calls.values(), default=0)
    out = {}
    for kernel in cs.trace_launches([]):
        per = {}
        for e in events:
            if e.device_type() != cpu and cs.trace_launches([(0, e.name(), 1)])[kernel]:
                per[e.correlation_id()] = per.get(e.correlation_id(), 0) + 1
        if per:
            counts = list(per.values())
            mode = max(set(counts), key=counts.count)
            out[kernel] = {"most": mode, "calls": len(per), "others": [
                (round((calls.get(c, t0) - t0) / 1e6, 3), n) for c, n in per.items() if n != mode]}
    return out


def row_changes(rows, ref):
    """The device activities whose count in `rows` differs from `ref`'s
    (name: (count, reference count)), and the total counts."""
    have = {name: n for _, name, n in rows}
    want = {name: n for _, name, n in ref}
    changed = {name[:80]: (have.get(name, 0), want.get(name, 0))
               for name in set(have) | set(want) if have.get(name, 0) != want.get(name, 0)}
    return changed, sum(have.values()), sum(want.values())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=15, help="eager passes a window")
    ap.add_argument("--graph-passes", type=int, default=10, help="graphed passes a window")
    ap.add_argument("--windows", default="at the run,profiled",
                    help="the windows to take, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_trace_records: no CUDA device", file=sys.stderr)
        return 1
    cs.cuda_build.build_kernels(["cin_fused", "cin_fused_bwd", "embed_grad"])
    cs.device_rows = keep_events
    model = cs.build_ranking_model()
    mapper = cs.RandomOOVMapper(model.spec, cs.N_CTR_OLD_USERS, cs.N_CTR_OLD_ITEMS,
                                cs.N_CTR_OLD_USERS + cs.N_CTR_NEW_USERS,
                                cs.N_CTR_OLD_ITEMS + cs.N_CTR_NEW_ITEMS)
    mapper.set_eval()
    cfg = cs.Config({"metrics": ["AUC", "LogLoss"], "seed": cs.SEED,
                     "eval_batch_size": cs.CTR_B, "metric_decimal_place": 12})
    ind, _ = cs.synth_ctr(model, mapper, cfg)
    del model
    train, _, _ = cs.ctr_splits(ind)
    over = dict(cs.G_RULES)["rmsprop"]

    def make():
        c = cs.ctr_train_cfg(device_epoch=True, train_oov=False, **over)
        return cs.Trainer(c, cs.build_ranking_model(cs.SEED + 611)), cs.TrainBatcher(
            train, None, c, cs.InputType.POINTWISE)

    _, gde, eager, batches = cs.graph_vs_eager(make, "rmsprop", steps=16)
    runs = {"eager": lambda: [eager._apply_step(x) for x in batches],
            "graph": lambda: [gde.train_step(x) for x in batches]}
    for run in runs.values():
        run()
    cs.reset_kernel_counts()
    runs["eager"]()
    cs.sync()
    expect = {k: 0 for k in cs.trace_launches([])}
    for name, fn in cs.launches.WRAPPERS.items():
        expect[fn.kernel] += cs.kernel_counts()[name]
    print(f"a pass's kernels by its wrappers: {expect}", flush=True)

    stats = {}
    takes = {"at the run": at_the_run, "profiled": in_profiled}
    for window in args.windows.split(","):
        take = takes[window]
        for name, n in (("eager", args.passes), ("graph", args.graph_passes)):
            lost = differ = 0
            ref = None
            t0 = time.perf_counter()
            for i in range(n):
                n_lost, seen, rows = take(runs[name])
                lost += n_lost > 0
                differ += seen != expect
                if rows is not None and seen == expect and ref is None:
                    ref = rows
                if n_lost or seen != expect:
                    print(f"{window}, {name} pass {i}: {n_lost} launch calls lost their "
                          f"records; the trace's kernels {seen}", flush=True)
                    if rows is not None and ref is not None:
                        print(f"  device activities (count, a whole pass's count; all "
                              f"of them): {row_changes(rows, ref)}", flush=True)
                        print(f"  records a launch call: {by_launch(TRACE['events'])}",
                              flush=True)
            stats[f"{window}, {name}"] = {"passes": n, "lost": lost, "miscounted": differ,
                                          "s": round(time.perf_counter() - t0, 1)}
            print(f"{window}, {name}: {stats[f'{window}, {name}']}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The traced stretch of a run: torch.profiler over the card.

Frozen copy of the profiler discipline of `chip_smoke.py` (`profiled`,
`run_calls`, `lost_records`, `device_rows`, `counted_trace`; commit
f404fe0): the trace keeps the device records inside its window by their
timestamps, which can be off from the host's clock by milliseconds, so a
window opened at the run loses its first kernels' records. The window opens
with LEAD_LAUNCHES small kernels, a synchronise and a pause, and closes a
pause after the run; the run's device records are those whose correlation id
is a CUDA call made inside the run's span (a graph replay's kernels carry the
replay's), so no device timestamp is compared with a host one; a take in
which a launch call left no device record is taken again, up to TRACE_TAKES
times.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Callable, Dict, Iterable, List, Tuple

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")
RUN_SPAN = "bench.run"
SPAN_PREFIX = "bench."
LEAD_LAUNCHES = 256
EDGE_PAUSE_S = 0.1
TRACE_TAKES = 3


def kernel_pattern(names: Iterable[str]) -> "re.Pattern":
    """Matches a trace name that holds one of the `__global__` names whole
    (a C++ kernel's trace name carries its signature or template)."""
    alts = "|".join(re.escape(n) for n in names)
    return re.compile(r"(?<![A-Za-z0-9_])(?:" + alts + r")(?![A-Za-z0-9_])")


class Trace:
    """The device activities and host spans of one traced run."""

    def __init__(self, events, wall_s: float):
        cpu = torch.autograd.DeviceType.CPU
        self.wall_s = wall_s
        runs = [(e.start_ns(), e.end_ns()) for e in events
                if e.device_type() == cpu and e.name() == RUN_SPAN]
        self.run_ns = (min(s for s, _ in runs), max(t for _, t in runs)) if runs else (0, 0)
        t0, t1 = self.run_ns
        calls = {e.correlation_id(): e.name() for e in events
                 if e.device_type() == cpu and e.name().startswith("cu")
                 and t0 <= e.start_ns() <= t1}
        on_device = set()
        self.device: List[Tuple[str, int, int]] = []
        for e in events:
            # a span's range on the device timeline (`record_function`) is no activity
            if e.device_type() == cpu or e.name().startswith(SPAN_PREFIX):
                continue
            on_device.add(e.correlation_id())
            if e.correlation_id() in calls and e.duration_ns() > 0:
                self.device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        self.lost = sum(1 for c, name in calls.items()
                        if name.startswith(LAUNCH_CALLS) and c not in on_device)
        self.spans = [(e.name(), e.start_ns(), e.end_ns()) for e in events
                      if e.device_type() == cpu and e.name().startswith(SPAN_PREFIX)
                      and e.name() != RUN_SPAN and t0 <= e.start_ns() <= t1]
        self._busy = self._union()

    def _union(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def window_s(self) -> float:
        return (self.run_ns[1] - self.run_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        return sum(e - s for s, e in self._busy) / 1e9

    def kernels(self, names: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, records) of the kernels with these names."""
        pat = kernel_pattern(names)
        mine = [e - s for n, s, e in self.device if pat.search(n)]
        return sum(mine) / 1e9, len(mine)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between device activities, each named by the
        innermost benchmark span the host was in at the gap's middle."""
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(self._busy, self._busy[1:])]
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            mid = (s + e) // 2
            around = [(t1 - t0, name) for name, t0, t1 in self.spans if t0 <= mid <= t1]
            label = min(around)[1] if around else "outside the benchmark's spans"
            out.append([label, length / 1e9])
        return out


def traced(run: Callable[[], None], device: torch.device) -> Trace:
    """`run()` under the profiler, taken again while records are lost."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(TRACE_TAKES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead = torch.zeros(1, device=device)
            for _ in range(LEAD_LAUNCHES):
                lead.add_(1)
            torch.cuda.synchronize(device)
            time.sleep(EDGE_PAUSE_S)
            with record_function(RUN_SPAN):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
            time.sleep(EDGE_PAUSE_S)
        trace = Trace(prof.profiler.kineto_results.events(), wall)
        if not trace.lost:
            return trace
    raise RuntimeError(f"{TRACE_TAKES} takes of the trace lost kernel records")


def span(name: str, on: bool):
    """A benchmark span in the trace (`record_function`), or nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)

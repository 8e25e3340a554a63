"""One run of one cell: set-up, the window, the check, the result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the result line holds the cell's end-to-end metrics, taken
by the host's clock around the window; with `--trace 1` its per-layer
metrics, read from a profiled stretch (`profiling.py`) by the readers of
`metrics/`. Either run checks what its timed path produced against the plain
reference (`checks`, each number beside its limit, `limits/<cell>.json`) and
prints the numbers as the last lines of standard error and under the last
key of the result. The run fails, and prints no result, without a card (or
with fewer than the cell asks for), and when the JAX package or JAX itself is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "oovrec_tpu")


class Clock:
    """Seconds since the process started (its age when the harness began,
    read from /proc, plus the harness's own clock), and the device's peak
    memory."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.age0 = _process_age()
        self.marks = []

    def since_start(self) -> float:
        return self.age0 + (time.perf_counter() - self.t0)

    def mark(self, what: str) -> None:
        """Note when a part of the set-up ended (printed with the result)."""
        self.marks.append((what, self.since_start()))

    @staticmethod
    def memory_peak(device) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _process_age() -> float:
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def limits(workload: str) -> Dict[str, float]:
    from benchmark.harness.manifest import BENCH_DIR

    with open(os.path.join(BENCH_DIR, "limits", workload + ".json")) as f:
        return json.load(f)


def p95(values) -> float:
    return float(statistics.quantiles(values, n=100, method="inclusive")[94]) if len(values) > 1 \
        else float(values[0])


def end_to_end(cell, out: dict) -> Dict[str, float]:
    """The cell's end-to-end metrics from the run's counts and clock. A
    metric is named by its quantity, with a part after the first dot that
    names the cells it is held over (`train_rows_per_s.ctr`)."""
    have = {"setup_s": out["setup_s"]}
    if "rows" in out:
        have["train_rows_per_s"] = out["rows"] / out["wall_s"]
    if "users" in out:
        have["eval_users_per_s"] = out["users"] / out["wall_s"]
        have["eval_batch_p95_ms"] = 1e3 * p95(out["latencies"])
    got = {}
    for m in cell.end_to_end:
        quantity = m["name"].split(".")[0]
        if quantity in have:
            got[m["name"]] = have[quantity]
    return got


class Context:
    """What a per-layer reader reads: the trace, the run's counts and spans,
    the configuration's roofline counts and the card's peaks."""

    def __init__(self, cell, out: dict, kind: str):
        from benchmark.harness import manifest, models, peaks

        self.cell, self.out = cell, out
        self.adapter = models.adapter(cell.config)
        self.trace = out.get("trace")
        self.roofline = manifest.roofline(cell.config_name)
        self.peaks = peaks.peaks(kind)

    def bound_s(self, flops: float, nbytes: float) -> float:
        return max(flops / self.peaks["f32_flops"], nbytes / self.peaks["bytes_per_s"])


def per_layer(cell, out: dict, kind: str) -> Dict[str, float]:
    ctx = Context(cell, out, kind)
    got = {}
    for name, reader in cell.readers().items():
        value = None if reader is None else reader.read(ctx)
        if value is not None:
            got[name] = value
    return got


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, clock, controls=()) -> dict:
    """One run of the cell's traffic: `kinds/<kind>.py:run`, by the mix's
    `kind`."""
    kind = importlib.import_module(f"benchmark.harness.kinds.{cell.traffic['kind']}")
    return kind.run(cell, seed, seconds, trace, device, clock, controls)


def verdict(checks: Dict[str, float], lim: Dict[str, float]) -> bool:
    return all(k in checks and not math.isnan(checks[k]) and checks[k] <= v
               for k, v in lim.items())


def result_line(cell, out: dict, trace: bool, device, kind: str, lim: dict) -> dict:
    metrics = per_layer(cell, out, kind) if trace else end_to_end(cell, out)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit": power_limit() if device.type == "cuda" else None}
    line = {"correct": verdict(out["checks"], lim), "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()
                        if k in units},
            "device": dev}
    if trace:
        t = out["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        line["breakdown"] = {"device_ops": t.top_ops(10), "idle_gaps": t.idle_gaps(10)}
    line["checks"] = {k: {"value": _number(out["checks"].get(k)), "limit": v}
                      for k, v in lim.items()}
    return line


def _number(x):
    """A finite float as it is; an infinite or missing reading as a string
    (JSON has no infinity)."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    os.environ["OOVREC_DISABLE_TENSORBOARD"] = "1"
    os.environ["USE_FLAX"] = "0"
    from benchmark.harness.manifest import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    clock = Clock(t0)
    clock.mark("imports and CUDA")
    lim = limits(cell.name)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, clock)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace), device, kind, lim)
    print("set-up: " + ", ".join(f"{w} {t:.2f} s" for w, t in clock.marks), file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0

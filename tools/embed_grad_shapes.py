"""Device ms of the gathers' backward without a plan
(`oovrec_tpu_torch/ops/embed_grad.py:scatter_rows_kernel`, the kernel
`csrc/embed_grad.cu`) at batch shapes of the port's models, for the
package of the tree it is run from: run it from the root of a checkout,
and again from the root of an older commit unpacked with `git archive`,
to compare two versions of the kernel on one card in one call (old, new,
new, old). It needs only `scatter_rows_kernel(g, ids, n_rows)`, which
every version of the port has.

    python /path/to/tools/embed_grad_shapes.py [--label NAME]

The shapes: 8,192, 12,288 and 16,384 ids into the device epoch's 1,024 x
64 buckets; RippleNet's lookups of a training step (2,048 users x 8
memories: the relation table's 42 rows of 64 x 64, skewed as phase N's
relations are, and the entity table's 59,645 rows of 64); and the two
batch shapes above the one-block sort's 16,384 ids: xDeepFM's packed
tokens (8,192 rows x 7 fields = 57,344 ids into the 330,000 x 10 packed
table) and phase E3's token_seq field (8,192 rows x 16 tokens = 131,072
ids into 1,000 x 10). Each line: the device ms a call (the profiler's
device time over 20 calls) and the device activities a call, then the
same for the plain version (`scatter_rows_plain`, where the tree has it)
and two PyTorch calls of the same sum: `embedding_dense_backward` and
`index_add_` into zeros. Runs on the card only.
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

SHAPES = (("8192", 8_192, 1_024, 64, "uniform"),
          ("12288", 12_288, 1_024, 64, "uniform"),
          ("16384", 16_384, 1_024, 64, "uniform"),
          ("ripplenet-relations", 16_384, 42, 64 * 64, "skew"),
          ("ripplenet-entities", 16_384, 59_645, 64, "uniform"),
          ("xdeepfm-tokens", 57_344, 330_000, 10, "uniform"),
          ("e3-token-seq", 131_072, 1_000, 10, "uniform"))
CALLS = 20


def device_ms(fn):
    """(device ms a call, device activities a call) over CALLS calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # pauses at the window's edges: device records timed near them by
        # a clock that differs from the host's can fall outside the window
        time.sleep(0.1)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    total_ns, count = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            total_ns += e.duration_ns()
            count += 1
    return total_ns / 1e6 / CALLS, count / CALLS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("embed_grad_shapes: no CUDA device", file=sys.stderr)
        return 1
    from oovrec_tpu_torch.ops import embed_grad

    gen = torch.Generator(device="cuda").manual_seed(20)
    out = {}
    for name, n, rows, d, spread in SHAPES:
        u = torch.rand(n, generator=gen, device="cuda")
        ids = ((u ** 1.5 if spread == "skew" else u) * rows).long()
        g = torch.randn((n, d), generator=gen, device="cuda")
        routes = {"kernel": lambda: embed_grad.scatter_rows_kernel(g, ids, rows),
                  "embedding_dense_backward": lambda: torch.ops.aten.embedding_dense_backward(
                      g, ids, rows, -1, False),
                  "index_add_": lambda: g.new_zeros((rows, d)).index_add_(0, ids, g)}
        if hasattr(embed_grad, "scatter_rows_plain"):
            routes["plain"] = lambda: embed_grad.scatter_rows_plain(g, ids, rows)
        out[name] = {"n": n, "rows": rows, "d": d}
        for route, fn in routes.items():
            ms, per = device_ms(fn)
            out[name][route] = {"device_ms": ms, "activities_a_call": per}
            print(f"{args.label} {name} {route}: {n} ids into {rows}x{d}: {ms:.4f} device ms, "
                  f"{per:.1f} device activities a call", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"label": args.label, "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

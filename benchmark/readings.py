"""The readings that the limits of `correct` are set from, on the card.

    python3 benchmark/readings.py --workload <name> --seeds 11,12,13 --seconds 2 \
        [--controls tf32,half] [--control-seeds 3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, the program's numbers against the plain reference (the lower
readings) and, for each control, the numbers of the reference put in the
program's place in a lower precision, or of a planted fault (the upper
readings). One JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.main import Clock, run_cell  # noqa: E402
from benchmark.harness.manifest import Cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the controls on the first this many seeds only")
    p.add_argument("--follow", choices=("chain", "per_step"), default=None,
                   help="how the reference follows a training cell, in place of its mix's")
    args = p.parse_args(argv)
    os.environ["OOVREC_DISABLE_TENSORBOARD"] = "1"
    os.environ["USE_FLAX"] = "0"
    import torch

    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = Cell(args.workload)
    if args.follow:
        cell.traffic["follow"] = args.follow
    controls = tuple(c for c in args.controls.split(",") if c)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        mine = controls if args.control_seeds is None or i < args.control_seeds else ()
        out = run_cell(cell, seed, args.seconds, False, device, Clock(t0), mine)
        print(json.dumps({"workload": cell.name, "seed": seed, "checks": out["checks"],
                          "control_checks": out["control_checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())

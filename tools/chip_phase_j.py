"""`chip_smoke.py`'s phase J alone: the fifteen plain sequence models on
the MovieLens-1M-shaped corpus, J1 and J2.

Runs on the card only. From the repo's root:

    python tools/chip_phase_j.py

It builds the gathers' backward kernel (`csrc/embed_grad.cu`), writes and
loads phase I's corpus (`chip_smoke.ml1m_inter_file`, `create_dataset`,
`data_preparation`), runs `chip_smoke.j1_sequential` and `j2_cli` with
their checks, and prints each part's launches, the kernels its graphed
passes replayed, the `phase J times` line and the card's name and power
limit. About 2-3 minutes on one H100.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not cs.torch.cuda.is_available():
        print("chip_phase_j: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"card: {smi}")
    t0 = time.perf_counter()
    cs.cuda_build.build_kernels(["embed_grad"])
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.ml1m_inter_file()
    base = cs.seq_cfg("GRU4Rec")
    ds = cs.create_dataset(base)
    cs.I_CORPUS.update(ds=ds, loaders=cs.data_preparation(base, ds))
    cs.log(f"corpus {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for part, run in (("J1", cs.j1_sequential), ("J2", cs.j2_cli)):
        cs.reset_kernel_counts()
        cs.sync()
        t1 = time.perf_counter()
        out = run()
        cs.sync()
        seen = {**cs.kernel_counts(), **out}
        cs.log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {seen}")
    cs.log(f"phase J: {time.perf_counter() - t0:.1f} s")
    cs.log("phase J kernels replayed, from the traces: " + json.dumps(cs.F_TRACE))
    cs.log("phase J times: " + json.dumps(cs.J_TIMES))
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

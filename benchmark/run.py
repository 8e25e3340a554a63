"""The port's benchmark: one run of one cell on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout of the repository. `BENCHMARK.json` names
the cells; `benchmark/harness/main.py` says what a run does and prints.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))

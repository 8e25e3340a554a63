"""The launch counts of the hand-written kernels' wrappers.

Each wrapper that launches a kernel of `csrc/` registers itself here with
the name of the `__global__` function that each of its launches runs once,
and adds one to its own `.launches` where it launches, nowhere else. A
launch made while a CUDA graph is captured records the kernel into the
graph and counts there, once; the graph's replays run no Python and count
nothing. A profiler trace sees each replayed kernel under the name
registered here.

The operation tallies (`operation_tally`, read by `utils/flops.py:
get_flops`): `torch.utils.flop_counter.FlopCounterMode` counts the
products of a wrapper's plain version on the CPU but cannot see a kernel
launched through ctypes. So a wrapper adds, where it launches its kernel,
the count that FlopCounterMode gives its plain version at the same shapes
(`add_operations`): kernel 1's scores (`topk_score.py:topk_operations`)
and the CIN layers (`cin_fused.py:cin_operations`). The plain versions of
kernel 6 and of the gathers' backward are elementwise work, sorts and
scatters, which FlopCounterMode counts as 0, so those wrappers add nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List

# wrapper name → the wrapper; its `.kernel` names the kernel it launches
WRAPPERS: Dict[str, Callable] = {}


def register(fn: Callable, kernel: str) -> Callable:
    """`fn` counted from 0, under its name, launching `kernel`."""
    fn.launches = 0
    fn.kernel = kernel
    WRAPPERS[fn.__name__] = fn
    return fn


def launch_counts() -> Dict[str, int]:
    """Each registered wrapper's launches."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


class OperationTally:
    """The operations that wrappers launched while the tally was open."""

    def __init__(self):
        self.total = 0


_TALLIES: List[OperationTally] = []  # the tallies open now


@contextlib.contextmanager
def operation_tally() -> Iterator[OperationTally]:
    """Open a tally for the block; every launch inside adds to it."""
    tally = OperationTally()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def add_operations(n: int) -> None:
    """Add a launch's `n` operations to every open tally."""
    for tally in _TALLIES:
        tally.total += n

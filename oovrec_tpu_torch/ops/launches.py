"""The launch counts of the hand-written kernels' wrappers.

Each wrapper that launches a kernel of `csrc/` registers itself here with
the name of the `__global__` function that each of its launches runs once,
and adds one to its own `.launches` where it launches, nowhere else. A
launch made while a CUDA graph is captured records the kernel into the
graph and counts there, once; the graph's replays run no Python and count
nothing. A profiler trace sees each replayed kernel under the name
registered here.
"""

from __future__ import annotations

from typing import Callable, Dict

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

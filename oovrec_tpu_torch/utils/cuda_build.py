"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` compiles at first use into
`build/oovrec_tpu_torch/lib<name>.so` beside the package (a directory that
`.gitignore` lists) for `sm_90a`, with a plain C interface: no PyTorch
headers, so a build takes seconds. `build_kernels` starts one `nvcc` per
source, all at once. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "oovrec_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    return (
        os.path.join(CSRC_DIR, name + ".cu"),
        os.path.join(BUILD_DIR, f"lib{name}.so"),
    )


def _fresh(name: str) -> bool:
    src, lib = _paths(name)
    return os.path.isfile(lib) and os.path.getmtime(lib) >= os.path.getmtime(src)


class KernelLibraries:
    """Compiled kernel libraries of one process, built once each."""

    def __init__(self):
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()
        self.build_log: Dict[str, str] = {}

    def build(self, names: Iterable[str]) -> Dict[str, float]:
        """Compile the stale sources in parallel; seconds per source built."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in names:
            if _fresh(name):
                continue
            src, lib = _paths(name)
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[name] = (
                subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp, lib,
            )
        seconds = {}
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            self.build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return seconds

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            if name not in self._libs:
                self.build([name])
                self._libs[name] = ctypes.CDLL(_paths(name)[1])
            return self._libs[name]


LIBRARIES = KernelLibraries()


def build_kernels(names: Iterable[str]) -> Dict[str, float]:
    return LIBRARIES.build(names)


def load_kernel(name: str) -> ctypes.CDLL:
    return LIBRARIES.get(name)


def check(err: int, what: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")

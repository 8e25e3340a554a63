"""Process-group bootstrap and the cross-rank metric reduction.

Port of `oovrec_tpu/parallel/distributed.py`. One process is one rank and
drives one device: rank r takes `cuda:{r % torch.cuda.device_count()}` on
the card. The backend is NCCL when the run's device is CUDA and gloo on
the CPU; there is no fallback from one to the other.

  * `initialize_distributed(coordinator_address, num_processes,
    process_id)`: with `num_processes` the explicit rendezvous (a TCP
    `host:port` or a `file://` path, which the CPU tests use) of
    `num_processes` ranks; with `coordinator_address` alone torchrun's
    environment (`env://`: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), the
    counterpart of the JAX package's auto-detection (`:42-43` there);
    neither: one process, nothing to start. A process group that is
    already up is kept. → JAX's four keys.
  * `map_reduce_metrics(result, num_samples, group)`: the sample-weighted
    mean of every rank's metric dict over an `all_gather` of
    `[metrics..., n]` (`:52-67` there, the reference's `_map_reduce`).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def backend_for(device) -> str:
    """NCCL for a CUDA run, gloo for a CPU run."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(coordinator_address: str) -> str:
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Dict[str, int]:
    """Join this process to the run's process group (module docstring);
    on the card, select the rank's device first."""
    if not dist.is_initialized() and (num_processes is not None or coordinator_address):
        backend = backend_for(device)
        timeout = datetime.timedelta(seconds=timeout_s)
        if num_processes is not None:
            if coordinator_address is None:
                raise ValueError("num_processes needs a coordinator_address to meet at")
            rank, world = int(process_id or 0), int(num_processes)
            init = _init_method(coordinator_address)
        else:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            init = "env://"
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=timeout)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return {"process_index": rank, "process_count": world,
            "local_device_count": 1, "global_device_count": world}


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def comm_device() -> torch.device:
    """Where a collective's tensors live: the rank's card under NCCL, the
    CPU under gloo or without a process group."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def map_reduce_metrics(result: Dict[str, float], num_samples: int, group=None):
    """Sample-count-weighted mean of the metric dicts of `group`'s ranks
    (all ranks when None); one rank alone keeps its dict."""
    if not dist.is_initialized():
        return result
    n = group_size(group if group is not None else dist.group.WORLD)
    if n == 1:
        return result
    keys = sorted(result.keys())
    vec = torch.tensor([float(result[k]) for k in keys] + [float(num_samples)],
                       dtype=torch.float64, device=comm_device())
    parts = [torch.empty_like(vec) for _ in range(n)]
    dist.all_gather(parts, vec, group=group)
    gathered = torch.stack(parts).cpu().numpy()  # (P, len+1)
    weights = gathered[:, -1:]
    vals = gathered[:, :-1]
    avg = (vals * weights).sum(axis=0) / np.maximum(weights.sum(), 1.0)
    return {k: float(v) for k, v in zip(keys, avg)}

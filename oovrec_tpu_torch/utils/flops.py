"""Model cost reports: parameters, operations of a training step, the
machine and the cards' memory.

Port of `oovrec_tpu/utils/flops.py`. The JAX package reads XLA's cost
analysis of the jitted loss; here `get_flops` runs one `calculate_loss`
and its backward under `torch.utils.flop_counter.FlopCounterMode`, which
counts matrix products, convolutions and attention (XLA also counts
elementwise work, so the two packages' numbers differ). The hand-written
kernels are launched through ctypes, where FlopCounterMode cannot see
them: each wrapper adds the count FlopCounterMode gives its plain version
to the open tally (`ops/launches.py:operation_tally`), so a model counts
the same on the card, where the kernels run, as on the CPU, where their
plain versions do.
"""

from __future__ import annotations

import platform
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch import nn

from oovrec_tpu_torch.models.layers import Dropout, MLPLayers, RandomDraws, set_dropout_generator
from oovrec_tpu_torch.ops import launches
from oovrec_tpu_torch.utils.seeding import torch_generator


def count_params(model: nn.Module) -> int:
    """The elements of the module's parameters (each shared one once)."""
    return int(sum(p.numel() for p in model.parameters()))


def get_flops(model: nn.Module, batch) -> Dict[str, Any]:
    """`params`, `flops_per_step` (the operations of one `calculate_loss`
    on `batch` and its backward to the parameters) and `bytes_per_step`,
    NaN: nothing counts the bytes a step moves. The step's dropout draws
    come from a generator of its own (a trainer's stream is left where it
    was) and no `.grad` is written. A model whose loss fails to run reports
    NaN operations, as the JAX package's does when its compile fails."""
    from torch.utils.flop_counter import FlopCounterMode

    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device if params else torch.device("cpu")
    drawing = [(m, m.generator) for m in model.modules()
               if isinstance(m, (MLPLayers, Dropout, RandomDraws))]
    set_dropout_generator(model, torch_generator(0, device))
    try:
        with launches.operation_tally() as launched, FlopCounterMode(display=False) as mode:
            loss = model.calculate_loss(batch)
            torch.autograd.grad(loss, params, allow_unused=True)
        flops = float(mode.get_total_flops() + launched.total)
    except Exception:  # noqa: BLE001 — JAX's contract: any failure reads NaN
        flops = float("nan")
    finally:
        for m, generator in drawing:
            m.generator = generator
    return {"params": count_params(model), "flops_per_step": flops,
            "bytes_per_step": float("nan")}


def get_environment() -> Dict[str, Any]:
    """The platform, the host's memory and cores where psutil is present,
    the cards and the process count."""
    info: Dict[str, Any] = {"platform": platform.platform()}
    try:
        import psutil
    except ImportError:
        pass
    else:
        vm = psutil.virtual_memory()
        info["ram_used_gb"] = round(vm.used / 2**30, 2)
        info["ram_total_gb"] = round(vm.total / 2**30, 2)
        info["cpu_count"] = psutil.cpu_count()
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        info["devices"] = [f"cuda:{i} {name}" for i, name in enumerate(names)]
        info["device_kind"] = names[0] if names else None
    else:
        info["devices"] = ["cpu"]
        info["device_kind"] = "cpu"
    info["process_count"] = dist.get_world_size() if dist.is_initialized() else 1
    return info


def get_device_usage() -> str:
    """Each card's allocated, peak allocated, free and total memory (GB)."""
    if not torch.cuda.is_available():
        return "no devices"
    parts = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        used = torch.cuda.memory_allocated(i) / 2**30
        peak = torch.cuda.max_memory_allocated(i) / 2**30
        parts.append(f"cuda:{i}: {used:.2f}/{total / 2**30:.2f} GB (peak {peak:.2f}, "
                     f"free {free / 2**30:.2f})")
    return "; ".join(parts) or "no devices"


def list_to_latex(convert_list, bigger_flag: bool = True, subset_columns=None):
    """Results table → LaTeX: rows of {'model': ..., metric: value} dicts,
    the best value of each column in bold. → (text, columns)."""
    if not convert_list:
        return "", None
    subset_columns = subset_columns or [k for k in convert_list[0] if k != "model"]
    cols = ["model"] + list(subset_columns)
    best = {}
    for c in subset_columns:
        vals = [row.get(c) for row in convert_list if row.get(c) is not None]
        if vals:
            best[c] = max(vals) if bigger_flag else min(vals)
    lines = ["\\begin{tabular}{" + "c" * len(cols) + "}", "\\toprule",
             " & ".join(cols) + " \\\\", "\\midrule"]
    for row in convert_list:
        cells = [str(row.get("model", ""))]
        for c in subset_columns:
            v = row.get(c)
            s = "" if v is None else f"{v:.4f}"
            if v is not None and v == best.get(c):
                s = "\\textbf{" + s + "}"
            cells.append(s)
        lines.append(" & ".join(cells) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines), cols

"""Global compute-precision policy.

Port of `oovrec_tpu/utils/precision.py`. Setting the policy to 'bfloat16'
makes the dense towers (MLPLayers, the CIN) compute in bf16 while
parameters and accumulation stay f32. Read when a forward runs, so a
change takes effect on the next call.
"""

from __future__ import annotations

import torch

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}
_POLICY = {"compute_dtype": torch.float32}


def set_policy(compute_dtype: str | None) -> None:
    _POLICY["compute_dtype"] = _DTYPES[compute_dtype]


def compute_dtype() -> torch.dtype:
    return _POLICY["compute_dtype"]

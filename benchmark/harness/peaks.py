"""Published peaks of the card, the yardstick of every roofline share.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full 700 W
power limit: 67 TFLOP/s in float32 outside the tensor cores (the precision the
configurations state, TF32 off) and 3.35 TB/s of HBM3. A kernel that moves its
float32 products onto the tensor cores needs a `benchmark` change that sets
the TF32 peak (495 TFLOP/s) for it first.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}
# the harness's CPU runs (its tests) read the card's peaks; no CPU number is
# ever written under a device metric
DEFAULT = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks(kind: str) -> dict:
    return PEAKS.get(kind, DEFAULT)


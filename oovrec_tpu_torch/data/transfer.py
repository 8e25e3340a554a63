"""Host batches onto the device.

A host batch is a dict of numpy columns; on the device its integers are
int64 and its f64 columns f32 (`device_array`). `to_device_batch` copies
one batch, a copy a column; `stack_to_device` copies several batches of
one signature (`host_signature`) at once, each column stacked on a
leading axis. The trainer's host scan and the scanned eval take the one
copy; the per-step and per-batch paths the other.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def device_array(v) -> np.ndarray:
    """A host column in its device dtype: integers as int64, f64 as f32."""
    v = np.asarray(v)
    if v.dtype.kind in "iu":
        return v.astype(np.int64)
    if v.dtype == np.float64:
        return v.astype(np.float32)
    return v


def to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch → device tensors (integers as int64, floats as f32)."""
    return {k: torch.from_numpy(device_array(v)).to(device) for k, v in batch.items()}


def host_signature(batch: Dict[str, np.ndarray]) -> tuple:
    """The keys, shapes and device dtypes of a host batch."""
    return tuple(sorted((k, np.shape(v), str(device_array(v).dtype)) for k, v in batch.items()))


def stack_to_device(batches, device) -> Dict[str, torch.Tensor]:
    """Host batches of one signature → each column stacked on a leading
    axis on `device`, through ONE host-to-device copy: the batches are
    written straight into one byte buffer (each column at an 8-byte
    offset, in its device dtype) and viewed back on the device."""
    n = len(batches)
    layout, total = {}, 0
    for k, v in batches[0].items():
        a = device_array(v)
        total = -(-total // 8) * 8
        layout[k] = (total, a.dtype, (n,) + a.shape)
        total += n * a.nbytes
    buf = np.empty(total, np.uint8)
    for k, (off, dtype, shape) in layout.items():
        col = buf[off:off + int(np.prod(shape)) * dtype.itemsize].view(dtype).reshape(shape)
        for i, b in enumerate(batches):
            col[i] = b[k]
    dev = torch.from_numpy(buf).to(device)
    out = {}
    for k, (off, dtype, shape) in layout.items():
        nbytes = int(np.prod(shape)) * dtype.itemsize
        out[k] = dev[off:off + nbytes].view(torch.from_numpy(np.empty(0, dtype)).dtype).view(shape)
    return out

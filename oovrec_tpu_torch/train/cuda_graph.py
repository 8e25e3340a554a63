"""The dense training step captured as a CUDA graph.

The counterpart of the JAX package's compiled step and scan bodies: its
per-step path runs one jitted program a step, and its device epoch and
host scan run their steps as one `lax.scan` program
(`train/device_epoch.py:391-594`, `train/trainer.py:276-330`). Here
`Trainer._apply_step` (the loss, its gradient and the optimizer update,
plain or with a `trainable` set for the frozen sub-epoch) is captured once
per batch signature into a `torch.cuda.CUDAGraph` and replayed for every
later batch of that signature, on every dense step of the trainer: the
host launches one graph a step instead of the step's hundreds of kernels.

  * A capture holds static input buffers (each batch is copied into them
    on the card) and a static loss, cloned after each replay.
  * The first batch of a signature is a real step, run eagerly on a side
    stream (the warm-up); the capture that follows executes nothing.
    Dead graphs are collected before a capture, never during it.
  * The trainer's dropout generator is registered with the graph, so
    each replay draws the masks the eager step would (the generator's
    offset advances per replay).
  * Adam's shared count lives on the card for the graph
    (`train/optimizers.py:device_corrections`); the state's Python count
    advances beside it, one a step.
  * The kernels' wrappers count their launches in Python
    (`ops/launches.py`): a capture's launches count once, where the
    wrappers record them; a replay runs no Python and counts nothing. A
    profiler trace sees the replayed kernels by name.

On a CPU model the same step runs eagerly, with the device count, and so
does the mesh step (`parallel/train_step.py`: its collectives are not
captured yet). The
row-sparse step (`Trainer._sparse_step`, `learner: sparse_adam`) is never
captured: kernel 6 takes its two bias corrections as host floats passed
by value at each launch (`ops/sparse_rows.py:sparse_adam_rows_kernel`), so
a replay would repeat the captured step's corrections. Its callers run it
eagerly.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import torch


def batch_signature(batch: Dict[str, torch.Tensor]) -> tuple:
    """The keys, shapes and dtypes that a captured step was built for."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))


class _Captured:
    def __init__(self, graph, inputs, loss):
        self.graph = graph
        self.inputs: Dict[str, torch.Tensor] = inputs
        self.loss: torch.Tensor = loss


class StepGraphs:
    """The trainer's captured dense steps, keyed by (batch signature,
    trainable set)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self._graphs: Dict[tuple, _Captured] = {}
        self._owner = None
        self.count: Optional[torch.Tensor] = None
        self._count_value: Optional[int] = None
        self.captures = 0
        self.replays = 0

    def step(self, batch: Dict[str, torch.Tensor],
             trainable: Optional[set] = None) -> torch.Tensor:
        """One dense step on `batch` (tensors on the model's device). → the
        loss, a tensor of its own."""
        t = self.trainer
        count = self._device_count()
        if t.model.device.type != "cuda" or t.mesh is not None:
            loss = t._apply_step(batch, trainable, count=count)
        else:
            owner = (id(t.params), id(t.opt_state))
            if owner != self._owner:  # state replaced: the captures write stale tensors
                self._graphs.clear()
                self._owner = owner
            key = (batch_signature(batch), None if trainable is None else frozenset(trainable))
            entry = self._graphs.get(key)
            if entry is None:
                entry, loss = self._capture(batch, trainable, count)
                self._graphs[key] = entry
            else:
                for k, v in entry.inputs.items():
                    v.copy_(batch[k])
                entry.graph.replay()
                loss = entry.loss.clone()
                self.replays += 1
        if count is not None:
            t.opt_state["count"] += 1
            self._count_value += 1
        return loss

    def _device_count(self) -> Optional[torch.Tensor]:
        """The shared count on the device, set from the state's count when
        they differ (an eager step, a rollback or a resume ran between)."""
        t = self.trainer
        if not t.optimizer.shared_count:
            return None
        if self.count is None:
            self.count = torch.zeros((), dtype=torch.int64, device=t.model.device)
        value = int(t.opt_state["count"])
        if self._count_value != value:
            self.count.fill_(value)
            self._count_value = value
        return self.count

    def _capture(self, batch, trainable, count):
        """Warm up with this batch's real step on a side stream, then
        capture the step. → (the capture, the warm-up step's loss)."""
        t = self.trainer
        device = t.model.device
        inputs = {k: v.clone() for k, v in batch.items()}
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss = t._apply_step(inputs, trainable, count=count)
        current.wait_stream(side)
        loss = loss.clone()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(t.dropout_generator)
        # dead captures (a dropped trainer's, held in a reference cycle) are
        # freed here: the collector, run during the capture (the backward's
        # Python code allocates), would destroy them there, which the
        # capture refuses
        gc.collect()
        with torch.cuda.graph(graph):
            out = t._apply_step(inputs, trainable, count=count)
        self.captures += 1
        return _Captured(graph, inputs, out), loss

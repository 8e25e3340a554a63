"""Host batching: the mean time of the port's eval batcher's `__next__`
(`data/dataloader.py:FullSortEvalBatcher`), ms a batch, from the
benchmark's span around it in the traced stretch."""

from benchmark.harness.readers import batcher_ms as read  # noqa: F401

"""Background batch prefetching.

Port of `oovrec_tpu/data/prefetch.py:17-57`. One daemon thread runs the
training loader's own iterator ahead of the consumer, into a bounded
queue: the host batches (numpy, with their negatives and shuffles drawn
by the batcher as usual) are assembled while the card trains on the
previous ones. The thread makes no CUDA call. Iteration order and random
streams are the unwrapped loader's, since the SAME iterator runs; what the
trainer draws per batch (the OOV keep draw, the simulator) stays on the
consumer side, so `worker` > 0 gives the batches and the run of `worker:
0` bit for bit. An exception in the thread is raised on the consumer
side.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class PrefetchIterator:
    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2):
        self._iterable = iterable
        self._depth = depth

    def __len__(self):
        return len(self._iterable)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        err = []

        def worker():
            try:
                for item in self._iterable:
                    q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield item


def maybe_prefetch(loader, config):
    """Wrap a train loader in a prefetcher when `worker` > 0."""
    workers = int(config.get("worker", 0) or 0)
    if workers > 0:
        return PrefetchIterator(loader, depth=max(2, workers))
    return loader
